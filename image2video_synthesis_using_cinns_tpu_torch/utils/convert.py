"""Weight bridge: a JAX-package variables tree -> a port module's state_dict.

The input is the tree of dicts and numpy arrays that ``checkpoint.load``
returns (``{"params": ..., "spectral": ..., "buffers": ..., "batch_stats":
..., "actnorm_stats": ...}``). This is the inverse of the JAX package's
torch -> JAX conversion (``utils/convert.py:34-45``, ``t_conv``/``t_linear``). The port's modules
carry the JAX modules' names, so a path in the tree is a state_dict key.
Leaves are recognised by the set of names in their dict:

* ``{kernel[, bias]}``: a conv kernel (*k, in, out) becomes (out, in, *k),
  a dense kernel (in, out) becomes (out, in); where the ``spectral``
  collection holds ``u``/``v`` for the same path, sigma = u^T W_mat v is
  folded into the weight once (``ops/spectral.py``), or, with
  ``fold_spectral=False`` (the trainable modules of stage-1 training), the
  raw weight is kept beside the ``u``/``v`` buffers;
* ``{scale, bias}``: an affine GroupNorm -> ``weight``/``bias``;
* ``{w, b}``: the flow's stacked coupling layer (n, in, out) -> ``weight``
  (n, out, in) and ``bias``;
* ``{loc, scale}``: the flow's stacked ActNorm, kept as it is;
* ``bn_mean``/``bn_var``/``bn_scale``/``bn_bias`` beside a ``conv``/``conv3d``
  leaf: the frozen BatchNorm of the metric backbones (I3D's ``Unit3D``,
  Inception's ``BasicConv2d``), and the BigGAN self-attention's ``gamma``,
  kept as they are.

``buffers`` leaves (the flow's shuffle permutations) are copied as int64:
they are always taken from the tree, never drawn again. ``batch_stats``
leaves (a BatchNorm's running ``mean``/``var``) become the port's BatchNorm
buffers of the same names. ``actnorm_stats`` (``loc_init``, ``scale_init``,
``initialized``) is the bookkeeping of ActNorm's data-dependent
initialisation; inference reads the ``loc``/``scale`` params, so it is
dropped.

``to_variables`` goes the other way for the backbones, the embedder, the
flow, the trainable stage-1 networks and the stage-2 AE (its BigGAN layers
keep the raw weight and ``u``/``v``, as ``fold_spectral=False`` loads them;
an affine-free BatchNorm has only ``batch_stats``), so that the port writes
checkpoints the JAX package reads.

The reference maps (``convert_*``, the counterparts of the JAX package's
``utils/convert.py``) take a state dict in the key layout of the reference
framework's ``.pth`` files and give the JAX-layout variables tree of the
same module, leaf for leaf as the JAX package gives it; ``to_state_dict``
then loads it into a port module. Each map is written once, as a plan over
a mapper: ``_Filler`` runs it from a reference state dict to a tree, and
``_Emitter`` runs it backwards, from a tree to the reference's keys
(``to_reference``), which is how tests write reference-layout files.
Conventions: torch conv weights (out, in, *k) <-> kernels (*k, in, out);
Linear (out, in) <-> (in, out); torch's spectral norm ``weight_orig`` /
``weight_u`` / ``weight_v`` <-> kernel and ``spectral/u``, ``spectral/v``;
BigGAN's ``weight_bar``/``weight_u`` likewise, its unused ``weight_v``
consumed and the template's ``v`` kept; ActNorm ``loc``/``scale`` (1, C, 1,
1) <-> (C,) and its ``initialized`` buffer <-> ``actnorm_stats``;
BatchNorm running statistics <-> ``batch_stats``, or the frozen metric
networks' ``bn_*`` params. numpy only, apart from ``torch.load``.
"""

from __future__ import annotations

import os
from typing import Any, Callable

import numpy as np
import torch

from ..ops import spectral
from . import checkpoint

_COLLECTIONS = {"params", "spectral", "buffers", "batch_stats", "actnorm_stats"}
_FROZEN_BN = ("bn_mean", "bn_var", "bn_scale", "bn_bias")
_PLAIN_LEAVES = _FROZEN_BN + ("gamma",)


def _tensor(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def torch_weight(kernel: np.ndarray) -> torch.Tensor:
    """JAX kernel -> torch weight: (*k, in, out) -> (out, in, *k); (in, out) -> (out, in)."""
    a = np.asarray(kernel, dtype=np.float32)
    k = torch.from_numpy(a if a.flags.writeable else a.copy())
    return k.permute(k.dim() - 1, k.dim() - 2, *range(k.dim() - 2)).clone(
        memory_format=torch.contiguous_format)


def _key(path: tuple, name: str) -> str:
    return ".".join(path + (name,))


def _walk(tree: dict, spectral_tree: dict, path: tuple, out: dict, fold: bool) -> None:
    names = set(tree)
    if "kernel" in names:
        if not names <= {"kernel", "bias"}:
            raise ValueError(f"{'/'.join(path)}: unexpected leaves {sorted(names)}")
        w = torch_weight(tree["kernel"])
        sn = spectral_tree if isinstance(spectral_tree, dict) else {}
        if "u" in sn and fold:
            w = spectral.fold(w, _tensor(sn["u"]), _tensor(sn["v"]))
        elif "u" in sn:
            out[_key(path, "u")] = _tensor(sn["u"])
            out[_key(path, "v")] = _tensor(sn["v"])
        out[_key(path, "weight")] = w
        if "bias" in tree:
            out[_key(path, "bias")] = _tensor(tree["bias"])
        return
    if names == {"scale", "bias"}:
        out[_key(path, "weight")] = _tensor(tree["scale"])
        out[_key(path, "bias")] = _tensor(tree["bias"])
        return
    if names == {"w", "b"}:
        out[_key(path, "weight")] = _tensor(np.swapaxes(np.asarray(tree["w"]), -1, -2))
        out[_key(path, "bias")] = _tensor(tree["b"])
        return
    if names == {"loc", "scale"}:
        out[_key(path, "loc")] = _tensor(tree["loc"])
        out[_key(path, "scale")] = _tensor(tree["scale"])
        return
    for name, sub in tree.items():
        if name in _PLAIN_LEAVES and not isinstance(sub, dict):
            out[_key(path, name)] = _tensor(sub)
            continue
        if not isinstance(sub, dict):
            raise ValueError(f"{'/'.join(path + (name,))}: unexpected leaf")
        _walk(sub, (spectral_tree or {}).get(name, {}), path + (name,), out, fold)


def _walk_leaves(tree: dict, path: tuple, out: dict, convert) -> None:
    for name, sub in tree.items():
        if isinstance(sub, dict):
            _walk_leaves(sub, path + (name,), out, convert)
        else:
            out[_key(path, name)] = convert(sub)


def _int64(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def to_state_dict(variables: dict, fold_spectral: bool = True) -> dict[str, torch.Tensor]:
    """Variables tree of one JAX module -> state_dict of its port: a serving
    module's (spectral norm folded), or with ``fold_spectral=False`` a
    trainable module's (raw weights and the ``u``/``v`` buffers)."""
    unknown = set(variables) - _COLLECTIONS
    if unknown:
        raise ValueError(f"collections the port cannot load yet: {sorted(unknown)}")
    out: dict[str, torch.Tensor] = {}
    _walk(variables.get("params", {}), variables.get("spectral", {}), (), out, fold_spectral)
    _walk_leaves(variables.get("buffers", {}), (), out, _int64)
    _walk_leaves(variables.get("batch_stats", {}), (), out, _tensor)
    return out


_COLLECTION_OF = {"fwd": "buffers", "inv": "buffers", "u": "spectral", "v": "spectral",
                  "mean": "batch_stats", "var": "batch_stats"}


def to_variables(state_dict: dict[str, torch.Tensor]) -> dict:
    """state_dict -> the JAX variables tree that ``to_state_dict`` maps back
    onto it: conv weights (out, in, *k) -> ``kernel`` (*k, in, out), dense
    weights (out, in) -> (in, out), a norm's per-channel ``weight`` ->
    ``scale``, ``bias``, ActNorm ``loc``/``scale`` and frozen-BN leaves to
    ``params``; the flow's stacked coupling layers (``weight`` (n, out, in)
    -> ``w`` (n, in, out), ``bias`` -> ``b``); shuffle permutations
    (``fwd``/``inv``) to ``buffers`` as int32; a trainable spectral layer's
    ``u``/``v`` to ``spectral``; a BatchNorm's ``mean``/``var`` to
    ``batch_stats``. Every array is a copy, so a tree handed to a background
    writer does not change with the module."""
    trees: dict = {"params": {}}
    for key, t in state_dict.items():
        *path, name = key.split(".")
        t = t.detach()
        t = t.float() if t.is_floating_point() else t
        if name == "weight" and t.dim() >= 2:  # the layout change, on the tensor's device
            t = t.transpose(-1, -2) if "coupling" in path else t.permute(*range(2, t.dim()), 1, 0)
        a = t.to("cpu", copy=True, memory_format=torch.contiguous_format).numpy()
        node = trees.setdefault(_COLLECTION_OF.get(name, "params"), {})
        for p in path:
            node = node.setdefault(p, {})
        if name in ("fwd", "inv"):
            node[name] = a.astype(np.int32)
        elif "coupling" in path and name in ("weight", "bias"):
            node["w" if name == "weight" else "b"] = a
        elif name == "weight" and a.ndim >= 2:
            node["kernel"] = a
        elif name == "weight" and a.ndim == 1:
            node["scale"] = a
        elif name in ("bias", "loc", "scale", "u", "v", "mean", "var") + _PLAIN_LEAVES:
            node[name] = a
        else:
            raise ValueError(f"{key}: a leaf the bridge cannot write back")
    return trees


def load_checkpoint(module: torch.nn.Module, path: str,
                    drop: tuple[str, ...] = ()) -> torch.nn.Module:
    """Load the variables tree of a ``.msgpack`` checkpoint (``{"state_dict":
    variables}`` or the bare tree) strictly into ``module``, less the
    ``params`` sub-trees named in ``drop`` (a head the module does not have).
    A reference-layout file raises, naming the converter."""
    tree = checkpoint.variables(checkpoint.load(path), path)
    if drop:
        tree = dict(tree, params={k: v for k, v in tree["params"].items() if k not in drop})
    module.load_state_dict(to_state_dict(tree))
    return module


def splice(variables: dict, key: str, sub_vars: dict) -> dict:
    """Graft each collection's tree of ``sub_vars`` under ``key`` in ``variables``
    (the facade's ``_splice``: the frozen embedder ships in its own checkpoint)."""
    out = {c: dict(v) for c, v in variables.items()}
    for col, tree in (sub_vars or {}).items():
        if not isinstance(tree, dict):
            continue
        out.setdefault(col, {})
        out[col][key] = tree.get(key, tree)  # accept wrapped and bare sub-trees
    return out


# -- the reference framework's checkpoints ---------------------------------------------------

def t_conv(w: np.ndarray) -> np.ndarray:
    """torch conv weight (out, in, *k) -> (*k, in, out)."""
    return np.transpose(w, tuple(range(2, w.ndim)) + (1, 0))


def t_linear(w: np.ndarray) -> np.ndarray:
    return np.transpose(w)


def t_vec(w: np.ndarray) -> np.ndarray:
    return np.reshape(w, (-1,))


def _torch_conv(kernel: np.ndarray) -> np.ndarray:
    """(*k, in, out) -> torch's (out, in, *k), the inverse of ``t_conv``."""
    k = np.asarray(kernel)
    return np.transpose(k, (k.ndim - 1, k.ndim - 2) + tuple(range(k.ndim - 2)))


def load_torch_checkpoint(path: str) -> dict:
    """A ``.pth`` file as its payload dict (a bare state dict is wrapped as
    ``{"state_dict": ...}``); the reference maps below convert its modules."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(payload, dict):
        payload = {"state_dict": payload}
    return payload


def load_torch_state_dict(path: str) -> dict:
    """The state dict of a ``.pth`` file (its ``state_dict`` entry, or the
    payload itself) with tensors as numpy arrays."""
    sd = load_torch_checkpoint(path)
    sd = sd.get("state_dict", sd)
    return {k: v.numpy() if hasattr(v, "numpy") else v for k, v in sd.items()}


def save_reference(path: str, state_dict: dict, wrap: bool = False) -> None:
    """Write a reference-layout state dict (numpy arrays) as a ``.pth`` file,
    as ``{"state_dict": ...}`` where ``wrap``, the way the reference's trainers
    save theirs, else bare."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state_dict.items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"epoch": 0, "state_dict": sd} if wrap else sd, path)


def _get(tree: dict, path: str) -> Any:
    node = tree
    for p in path.split("/"):
        if not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    return node


class _Filler:
    """A plan's mapper from a reference state dict to a variables tree:
    ``has`` asks the state dict, the layer methods take its keys and put
    the tree's leaves; ``used`` tracks the keys consumed."""

    def __init__(self, sd: dict):
        self.sd = dict(sd)
        self.used: set[str] = set()
        self.out: dict = {}

    def has(self, tree_path: str, key: str) -> bool:
        return key in self.sd

    def take(self, key: str) -> np.ndarray:
        self.used.add(key)
        return np.asarray(self.sd[key])

    def put(self, path: str, value: np.ndarray) -> None:
        *parts, name = path.split("/")
        node = self.out
        for p in parts:
            node = node.setdefault(p, {})
        node[name] = np.asarray(value)

    def consume(self, keys) -> None:
        """Mark keys of the file as read without mapping them."""
        self.used.update(k for k in keys if k in self.sd)

    def consume_prefix(self, prefix: str) -> None:
        self.consume([k for k in self.sd if k.startswith(prefix)])

    def scalar(self, path: str, key: str) -> None:
        """A 0-d parameter of the reference, (1,) in the tree."""
        self.put(f"params/{path}", np.reshape(self.take(key), (1,)))

    def _spectral_uv(self, path: str, key: str, skip_v: bool) -> None:
        self.put(f"spectral/{path}/u", t_vec(self.take(f"{key}.weight_u")))
        if f"{key}.weight_v" in self.sd:
            if skip_v:
                # BigGAN's own spectral norm sizes weight_v wrongly and never
                # reads it: consume the key, keep the template's v.
                self.used.add(f"{key}.weight_v")
            else:
                self.put(f"spectral/{path}/v", t_vec(self.take(f"{key}.weight_v")))

    def _layer(self, path: str, key: str, to_kernel, spectral: bool, bar: bool,
               bias: bool) -> None:
        if spectral:
            self.put(f"params/{path}/kernel",
                     to_kernel(self.take(f"{key}.{'weight_bar' if bar else 'weight_orig'}")))
            self._spectral_uv(path, key, skip_v=bar)
        else:
            self.put(f"params/{path}/kernel", to_kernel(self.take(f"{key}.weight")))
        if bias and f"{key}.bias" in self.sd:
            self.put(f"params/{path}/bias", self.take(f"{key}.bias"))

    def conv(self, path: str, key: str, spectral: bool = False, bar: bool = False,
             bias: bool = True) -> None:
        self._layer(path, key, t_conv, spectral, bar, bias)

    def linear(self, path: str, key: str, spectral: bool = False, bar: bool = False,
               bias: bool = True) -> None:
        self._layer(path, key, t_linear, spectral, bar, bias)

    def groupnorm(self, path: str, key: str) -> None:
        self.put(f"params/{path}/scale", self.take(f"{key}.weight"))
        self.put(f"params/{path}/bias", self.take(f"{key}.bias"))

    def batchnorm(self, path: str, key: str, affine: bool = True) -> None:
        if affine:
            self.groupnorm(path, key)
        self.put(f"batch_stats/{path}/mean", self.take(f"{key}.running_mean"))
        self.put(f"batch_stats/{path}/var", self.take(f"{key}.running_var"))
        self.used.add(f"{key}.num_batches_tracked")

    def actnorm(self, path: str, key: str) -> None:
        self.put(f"params/{path}/loc", t_vec(self.take(f"{key}.loc")))
        self.put(f"params/{path}/scale", t_vec(self.take(f"{key}.scale")))
        self.put(f"actnorm_stats/{path}/initialized",
                 np.asarray(self.take(f"{key}.initialized"), np.uint8).reshape(()))
        # the init's mirrors: unread after the init, kept so shapes stay valid
        self.put(f"actnorm_stats/{path}/loc_init", t_vec(np.asarray(self.sd[f"{key}.loc"])))
        self.put(f"actnorm_stats/{path}/scale_init", t_vec(np.asarray(self.sd[f"{key}.scale"])))

    def frozen_bn(self, path: str, key: str) -> None:
        """A frozen metric network's BatchNorm, as ``bn_*`` params."""
        for ours, theirs in _FROZEN_BN_KEYS:
            self.put(f"params/{path}/{ours}", self.take(f"{key}.{theirs}"))
        self.used.add(f"{key}.num_batches_tracked")

    def finish(self, strict: bool = False) -> dict:
        leftover = [k for k in self.sd
                    if k not in self.used and not k.endswith("num_batches_tracked")]
        if leftover and strict:
            raise KeyError(f"unconsumed torch keys: {leftover[:10]} "
                           f"(+{len(leftover) - 10 if len(leftover) > 10 else 0})")
        self.leftover = leftover
        return self.out


_FROZEN_BN_KEYS = (("bn_scale", "weight"), ("bn_bias", "bias"), ("bn_mean", "running_mean"),
                   ("bn_var", "running_var"))


class _Emitter:
    """A plan's mapper the other way: from a variables tree to the reference's
    state dict (numpy arrays). ``has`` asks the tree; ``unread`` lists the
    tree's leaves that no layer took."""

    def __init__(self, variables: dict):
        self.tree = variables
        self.read: set[str] = set()
        self.sd: dict[str, np.ndarray] = {}

    def has(self, tree_path: str, key: str) -> bool:
        return _get(self.tree, tree_path) is not None

    def get(self, path: str) -> np.ndarray:
        value = _get(self.tree, path)
        if value is None:
            raise KeyError(f"{path}: not in the variables tree")
        self.read.add(path)
        return np.asarray(value)

    def consume(self, keys) -> None:
        pass

    def consume_prefix(self, prefix: str) -> None:
        pass

    def scalar(self, path: str, key: str) -> None:
        self.sd[key] = self.get(f"params/{path}").reshape(())

    def _layer(self, path: str, key: str, to_weight, spectral: bool, bar: bool,
               bias: bool) -> None:
        w = to_weight(self.get(f"params/{path}/kernel"))
        if spectral:
            u = t_vec(self.get(f"spectral/{path}/u"))
            self.sd[f"{key}.{'weight_bar' if bar else 'weight_orig'}"] = w
            self.sd[f"{key}.weight_u"] = u
            # BigGAN's weight_v: wrongly sized in the reference and never read
            self.sd[f"{key}.weight_v"] = u.copy() if bar else t_vec(self.get(f"spectral/{path}/v"))
            if bar and _get(self.tree, f"spectral/{path}/v") is not None:
                self.read.add(f"spectral/{path}/v")
        else:
            self.sd[f"{key}.weight"] = w
        if bias and _get(self.tree, f"params/{path}/bias") is not None:
            self.sd[f"{key}.bias"] = self.get(f"params/{path}/bias")

    def conv(self, path: str, key: str, spectral: bool = False, bar: bool = False,
             bias: bool = True) -> None:
        self._layer(path, key, _torch_conv, spectral, bar, bias)

    def linear(self, path: str, key: str, spectral: bool = False, bar: bool = False,
               bias: bool = True) -> None:
        self._layer(path, key, np.transpose, spectral, bar, bias)

    def groupnorm(self, path: str, key: str) -> None:
        self.sd[f"{key}.weight"] = self.get(f"params/{path}/scale")
        self.sd[f"{key}.bias"] = self.get(f"params/{path}/bias")

    def batchnorm(self, path: str, key: str, affine: bool = True) -> None:
        if affine:
            self.groupnorm(path, key)
        self.sd[f"{key}.running_mean"] = self.get(f"batch_stats/{path}/mean")
        self.sd[f"{key}.running_var"] = self.get(f"batch_stats/{path}/var")
        self.sd[f"{key}.num_batches_tracked"] = np.asarray(0, np.int64)

    def actnorm(self, path: str, key: str) -> None:
        for name in ("loc", "scale"):
            self.sd[f"{key}.{name}"] = self.get(f"params/{path}/{name}").reshape(1, -1, 1, 1)
        flag = _get(self.tree, f"actnorm_stats/{path}/initialized")
        self.sd[f"{key}.initialized"] = np.asarray(1 if flag is None else flag, np.uint8)

    def frozen_bn(self, path: str, key: str) -> None:
        for ours, theirs in _FROZEN_BN_KEYS:
            self.sd[f"{key}.{theirs}"] = self.get(f"params/{path}/{ours}")
        self.sd[f"{key}.num_batches_tracked"] = np.asarray(0, np.int64)

    def unread(self) -> list[str]:
        leaves: list[str] = []

        def walk(node, path):
            for k, v in node.items():
                p = f"{path}/{k}" if path else k
                if isinstance(v, dict):
                    walk(v, p)
                elif not p.startswith("actnorm_stats/"):
                    leaves.append(p)

        walk(self.tree, "")
        return [p for p in leaves if p not in self.read]


def _fill(plan: Callable, sd: dict, *args, **kwargs) -> dict:
    f = _Filler(sd)
    plan(f, *args, **kwargs)
    return f.finish()


# -- stage 1 -----------------------------------------------------------------------------

RESNET3D = {"resnet18": (False, (2, 2, 2, 2)), "resnet34": (False, (3, 4, 6, 3)),
            "resnet50": (True, (3, 4, 6, 3)), "resnet101": (True, (3, 4, 23, 3))}


def _spectral(f, path: str, key: str) -> bool:
    """A conv is spectral where the file has ``weight_orig`` (the tree, ``u``)."""
    return f.has(f"spectral/{path}/u", f"{key}.weight_orig")


def _present(f, path: str, key: str) -> bool:
    return (f.has(f"params/{path}/kernel", f"{key}.weight")
            or f.has(f"params/{path}/kernel", f"{key}.weight_orig"))


def _plan_stage1_generator(f) -> None:
    f.linear("fc", "fc")
    for name in ("head_0", "g_0", "g_1", "g_2", "g_3", "g_4"):
        for conv in ("conv", "conv_gamma", "conv_beta"):  # Spade
            f.conv(f"{name}/norm_0/{conv}", f"{name}.norm_0.{conv}")
        f.linear(f"{name}/norm_1/linear", f"{name}.norm_1.linear")  # ADAIN
        for conv in ("conv_0", "conv_1"):
            f.conv(f"{name}/{conv}", f"{name}.{conv}",
                   spectral=_spectral(f, f"{name}/{conv}", f"{name}.{conv}"))
        if _present(f, f"{name}/conv_s", f"{name}.conv_s"):
            f.conv(f"{name}/conv_s", f"{name}.conv_s", bias=False,
                   spectral=_spectral(f, f"{name}/conv_s", f"{name}.conv_s"))
            f.groupnorm(f"{name}/norm_s/bn", f"{name}.norm_s.bn")
    f.conv("conv_img", "conv_img")


def _plan_resnet3d(f, prefix: str, res_type: str) -> None:
    """Spectral norm is read per conv from the file (``weight_orig``), which
    carries the reference's first-block-only spectral quirk as it is."""
    bottleneck, layers = RESNET3D[res_type]
    f.conv(f"{prefix}/conv1", "conv1")
    f.groupnorm(f"{prefix}/norm1", "norm1")
    for stage in range(4):
        for b in range(layers[stage]):
            key, path = f"layer.{stage}.{b}", f"{prefix}/layer{stage}_block{b}"
            for c in range(1, 4 if bottleneck else 3):
                f.conv(f"{path}/conv{c}", f"{key}.conv{c}", bias=False,
                       spectral=_spectral(f, f"{path}/conv{c}", f"{key}.conv{c}"))
                f.groupnorm(f"{path}/bn{c}", f"{key}.bn{c}")
            ds, ds_path = f"{key}.downsample.0", f"{path}/downsample_conv"
            if _present(f, ds_path, ds):
                f.conv(ds_path, ds, bias=False, spectral=_spectral(f, ds_path, ds))
                f.groupnorm(f"{path}/downsample_norm", f"{key}.downsample.1")


def _plan_stage1_encoder(f, res_type: str = "resnet18") -> None:
    _plan_resnet3d(f, "backbone", res_type)
    f.conv("conv_mu", "conv_mu")
    f.conv("conv_var", "conv_var")


def _plan_stage1_discriminator(f, res_type: str = "resnet18") -> None:
    _plan_resnet3d(f, "backbone", res_type)
    f.linear("fc", "fc", bias=False)


def _plan_patch_discriminator(f, n_layers: int = 3, use_actnorm: bool = True,
                              spectral: bool = True) -> None:
    f.conv("conv0", "main.0", spectral=spectral)
    idx = 2  # conv, lrelu
    for n in range(1, n_layers + 1):
        f.conv(f"conv{n}", f"main.{idx}", spectral=spectral)
        if use_actnorm:
            f.actnorm(f"norm{n}", f"main.{idx + 1}")
        else:
            f.batchnorm(f"norm{n}/bn", f"main.{idx + 1}")
        idx += 3  # conv, norm, lrelu
    f.conv("conv_out", f"main.{idx}", spectral=spectral)


def convert_stage1_generator(sd: dict) -> dict:
    return _fill(_plan_stage1_generator, sd)


def convert_stage1_encoder(sd: dict, res_type: str = "resnet18") -> dict:
    return _fill(_plan_stage1_encoder, sd, res_type)


def convert_stage1_discriminator(sd: dict, res_type: str = "resnet18") -> dict:
    return _fill(_plan_stage1_discriminator, sd, res_type)


def convert_patch_discriminator(sd: dict, n_layers: int = 3, use_actnorm: bool = True,
                                spectral: bool = True) -> dict:
    return _fill(_plan_patch_discriminator, sd, n_layers, use_actnorm, spectral)


# -- stage 2: the flow and the AE's ResnetEncoder -----------------------------------------

_COUPLINGS = (("s0", "s.0"), ("t0", "t.0"), ("s1", "s.1"), ("t1", "t.1"))


def convert_conditional_flow(sd: dict, n_flows: int, hidden_depth: int = 2,
                             in_channels: int = 64, embedding_dim: int = 64,
                             control: bool = False) -> dict:
    """A ConditionalFlow state dict (``cINN.pth``) -> stacked blocks and the
    shuffle buffers. Under control a 'cond' block's (``fl % 4 != 0``) first
    coupling layer takes the embedding only; the stacked layer takes
    (x_half, embedding) with x_half masked, so its x rows are zero."""
    half, n_linears = in_channels // 2, hidden_depth + 2
    loc, scale, fwd, inv = [], [], [], []
    layers = {(name, li): ([], []) for name, _ in _COUPLINGS for li in range(n_linears)}
    for fl in range(n_flows):
        base = f"sub_layers.{fl}"
        loc.append(t_vec(np.asarray(sd[f"{base}.norm_layer.loc"])))
        scale.append(t_vec(np.asarray(sd[f"{base}.norm_layer.scale"])))
        for name, theirs in _COUPLINGS:
            for li in range(n_linears):
                key = f"{base}.coupling.{theirs}.main.{2 * li}"
                w = t_linear(np.asarray(sd[f"{key}.weight"]))
                if li == 0 and control and fl % 4 != 0:  # (E, H) -> (half + E, H)
                    full = np.zeros((half + embedding_dim, w.shape[1]), w.dtype)
                    full[half:] = w
                    w = full
                layers[name, li][0].append(w)
                layers[name, li][1].append(np.asarray(sd[f"{key}.bias"]))
        fwd.append(np.asarray(sd[f"{base}.shuffle.forward_shuffle_idx"]))
        inv.append(np.asarray(sd[f"{base}.shuffle.backward_shuffle_idx"]))
    coupling = {name: {f"l{li}": {"w": np.stack(layers[name, li][0]),
                                  "b": np.stack(layers[name, li][1])}
                       for li in range(n_linears)} for name, _ in _COUPLINGS}
    blocks = {"actnorm": {"loc": np.stack(loc), "scale": np.stack(scale)}, "coupling": coupling}
    return {"params": {"blocks": blocks},
            "buffers": {"shuffle": {"fwd": np.stack(fwd).astype(np.int32),
                                    "inv": np.stack(inv).astype(np.int32)}}}


def _flow_reference(variables: dict, n_flows: int, hidden_depth: int = 2,
                    in_channels: int = 64, embedding_dim: int = 64,
                    control: bool = False) -> dict:
    blocks, shuffle = variables["params"]["blocks"], variables["buffers"]["shuffle"]
    sd: dict[str, np.ndarray] = {}
    for fl in range(n_flows):
        base = f"sub_layers.{fl}"
        for name in ("loc", "scale"):
            sd[f"{base}.norm_layer.{name}"] = np.asarray(
                blocks["actnorm"][name][fl]).reshape(1, -1, 1, 1)
        sd[f"{base}.norm_layer.initialized"] = np.asarray(1, np.uint8)
        for name, theirs in _COUPLINGS:
            for li in range(hidden_depth + 2):
                layer = blocks["coupling"][name][f"l{li}"]
                w = np.asarray(layer["w"][fl])
                if li == 0 and control and fl % 4 != 0:
                    w = w[in_channels // 2:]
                key = f"{base}.coupling.{theirs}.main.{2 * li}"
                sd[f"{key}.weight"] = np.ascontiguousarray(w.T)
                sd[f"{key}.bias"] = np.asarray(layer["b"][fl])
        sd[f"{base}.shuffle.forward_shuffle_idx"] = np.asarray(shuffle["fwd"][fl], np.int64)
        sd[f"{base}.shuffle.backward_shuffle_idx"] = np.asarray(shuffle["inv"][fl], np.int64)
    return sd


TV_BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3),
             "resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}
TV_BOTTLENECK = {"resnet18": False, "resnet34": False, "resnet50": True, "resnet101": True}


def _plan_resnet_encoder(f, encoder_type: str = "resnet50", norm: str = "in") -> None:
    """The AE's torchvision trunk; 'in' (InstanceNorm) has no parameters."""

    def norm_map(path: str, key: str) -> None:
        if norm == "bn":
            f.batchnorm(f"{path}/bn", key)
        elif norm == "an":
            f.actnorm(f"{path}/an", key)

    f.conv("model/conv1", "model.conv1", bias=False)
    norm_map("model/bn1", "model.bn1")
    for stage in range(4):
        for b in range(TV_BLOCKS[encoder_type][stage]):
            key, path = f"model.layer{stage + 1}.{b}", f"model/layer{stage + 1}_block{b}"
            for c in range(1, 4 if TV_BOTTLENECK[encoder_type] else 3):
                f.conv(f"{path}/conv{c}", f"{key}.conv{c}", bias=False)
                norm_map(f"{path}/bn{c}", f"{key}.bn{c}")
            if f.has(f"params/{path}/downsample_conv/kernel", f"{key}.downsample.0.weight"):
                f.conv(f"{path}/downsample_conv", f"{key}.downsample.0", bias=False)
                norm_map(f"{path}/downsample_norm", f"{key}.downsample.1")
    f.conv("fc", "model.fc.sub_layers.0")


def convert_resnet_encoder(sd: dict, encoder_type: str = "resnet50", norm: str = "in") -> dict:
    return _fill(_plan_resnet_encoder, sd, encoder_type, norm)


# -- metric backbones --------------------------------------------------------------------

VGG16_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


def _plan_vgg16(f, prefix: str = "") -> None:
    """torchvision vgg16 ``features`` (keyed ``features.i`` or bare ``i``)."""
    for ours, i in enumerate(VGG16_CONV_IDX):
        tv = f"{prefix}features.{i}"
        f.conv(f"conv{ours}", tv if f.has(f"params/conv{ours}/kernel", f"{tv}.weight")
               else f"{prefix}{i}")


def convert_vgg16(sd: dict, prefix: str = "") -> dict:
    return _fill(_plan_vgg16, sd, prefix)


_LPIPS_SLICES = ((1, range(0, 4)), (2, range(4, 9)), (3, range(9, 16)), (4, range(16, 23)),
                 (5, range(23, 30)))


def convert_lpips(lpips_sd: dict, vgg_sd: dict) -> dict:
    """LPIPS: the VGG16 slices (``net.slice{s}.{i}`` in the LPIPS file, else
    torchvision's ``features.{i}``) and the ``lin{k}`` heads of ``vgg.pth``."""
    net, n = {}, 0
    for s, idxs in _LPIPS_SLICES:
        for i in idxs:
            key = f"net.slice{s}.{i}.weight"
            src = lpips_sd if key in lpips_sd else vgg_sd
            if key in src:
                net[f"conv{n}"] = {"kernel": t_conv(np.asarray(src[key])),
                                   "bias": np.asarray(src[key.replace("weight", "bias")])}
            elif i in VGG16_CONV_IDX:
                net[f"conv{n}"] = {"kernel": t_conv(np.asarray(vgg_sd[f"features.{i}.weight"])),
                                   "bias": np.asarray(vgg_sd[f"features.{i}.bias"])}
            else:
                continue
            n += 1
    out: dict = {"params": {"net": net}}
    for k in range(5):
        key = f"lin{k}.model.1.weight"
        if key in lpips_sd:
            out["params"][f"lin{k}"] = {"kernel": t_conv(np.asarray(lpips_sd[key]))}
    return out


def _lpips_reference(variables: dict) -> tuple[dict, dict]:
    """(the ``vgg.pth`` heads, torchvision's vgg16 ``features``)."""
    params = variables["params"]
    heads = {f"lin{k}.model.1.weight": _torch_conv(params[f"lin{k}"]["kernel"])
             for k in range(5)}
    e = _Emitter({"params": params["net"]})
    _plan_vgg16(e)
    return heads, e.sd


I3D_BRANCHES = {"branch_0": "branch_0", "branch_1a": "branch_1.0", "branch_1b": "branch_1.1",
                "branch_2a": "branch_2.0", "branch_2b": "branch_2.1", "branch_3": "branch_3.1"}
DT_BRANCHES = {"branch_0": "b0", "branch_1a": "b1a", "branch_1b": "b1b",
               "branch_2a": "b2a", "branch_2b": "b2b", "branch_3": "b3b"}
MIXED_NAMES = ["mixed_3b", "mixed_3c", "mixed_4b", "mixed_4c", "mixed_4d",
               "mixed_4e", "mixed_4f", "mixed_5b", "mixed_5c"]


def _plan_i3d(f, dt: bool) -> None:
    """The kinetics I3D (``batch3d``, ``mixed_*``) or the DTDB one
    (``bn``, ``Mixed_*``, ``logits``)."""
    bn = "bn" if dt else "batch3d"

    def unit(path: str, key: str) -> None:
        f.conv(f"{path}/conv3d", f"{key}.conv3d", bias=False)
        f.frozen_bn(path, f"{key}.{bn}")

    for name in ("1a_7x7", "2b_1x1", "2c_3x3"):
        unit(f"conv3d_{name}", f"{'Conv3d' if dt else 'conv3d'}_{name}")
    for m in MIXED_NAMES:
        theirs = m.replace("mixed", "Mixed") if dt else m
        for ours, branch in (DT_BRANCHES if dt else I3D_BRANCHES).items():
            unit(f"{m}/{ours}", f"{theirs}.{branch}")
    f.conv("conv3d_0c_1x1/conv3d", f"{'logits' if dt else 'conv3d_0c_1x1'}.conv3d")


def convert_i3d_kinetics(sd: dict) -> dict:
    return _fill(_plan_i3d, sd, False)


def convert_i3d_dt(sd: dict) -> dict:
    return _fill(_plan_i3d, sd, True)


# the TF-hub i3d-kinetics-400/1 graph's scopes under "RGB/inception_i3d/"
TF_I3D_UNITS = {"conv3d_1a_7x7": "Conv3d_1a_7x7", "conv3d_2b_1x1": "Conv3d_2b_1x1",
                "conv3d_2c_3x3": "Conv3d_2c_3x3"}
TF_I3D_BRANCHES = {
    "branch_0": "Branch_0/Conv3d_0a_1x1", "branch_1a": "Branch_1/Conv3d_0a_1x1",
    "branch_1b": "Branch_1/Conv3d_0b_3x3", "branch_2a": "Branch_2/Conv3d_0a_1x1",
    "branch_2b": "Branch_2/Conv3d_0b_3x3", "branch_3": "Branch_3/Conv3d_0b_1x1",
}
_TF_I3D_PREFIX = "RGB/inception_i3d/"


def _tf_i3d_units():
    """(ours, the graph's scope, has batch norm) for every unit."""
    units = [(ours, theirs, True) for ours, theirs in TF_I3D_UNITS.items()]
    for m in MIXED_NAMES:
        units += [(f"{m}/{ours}", f"{m.replace('mixed', 'Mixed')}/{theirs}", True)
                  for ours, theirs in TF_I3D_BRANCHES.items()]
    return units + [("conv3d_0c_1x1", "Logits/Conv3d_0c_1x1", False)]


def convert_i3d_tf_hub(var_dict: dict) -> dict:
    """The TF-hub I3D's variables (names with or without the
    ``RGB/inception_i3d/`` prefix and ``:0``, e.g. an ``.npz`` dump) -> the
    I3D tree. TF's (D, H, W, In, Out) kernels are the tree's layout; its
    batch norm has no gamma, so ``bn_scale`` is ones."""
    sd = {}
    for k, v in var_dict.items():
        k = k.split(":", 1)[0]
        sd[k[len(_TF_I3D_PREFIX):] if k.startswith(_TF_I3D_PREFIX) else k] = np.asarray(v)
    f = _Filler(sd)
    for ours, theirs, bn in _tf_i3d_units():
        f.put(f"params/{ours}/conv3d/kernel", f.take(f"{theirs}/conv_3d/w"))
        if not bn:
            f.put(f"params/{ours}/conv3d/bias", f.take(f"{theirs}/conv_3d/b"))
            continue
        c = sd[f"{theirs}/batch_norm/beta"].reshape(-1).shape[0]
        f.put(f"params/{ours}/bn_bias", f.take(f"{theirs}/batch_norm/beta").reshape(-1))
        f.put(f"params/{ours}/bn_scale", np.ones((c,), np.float32))
        f.put(f"params/{ours}/bn_mean", f.take(f"{theirs}/batch_norm/moving_mean").reshape(-1))
        f.put(f"params/{ours}/bn_var",
              f.take(f"{theirs}/batch_norm/moving_variance").reshape(-1))
    return f.finish()


def _i3d_tf_reference(variables: dict) -> dict:
    """The graph's variables, named as the hub module's ``v.name``; a tree
    with ``bn_scale`` other than ones has no TF counterpart and raises."""
    params, out = variables["params"], {}
    for ours, theirs, bn in _tf_i3d_units():
        unit = _get(params, ours)
        name = f"{_TF_I3D_PREFIX}{theirs}"
        out[f"{name}/conv_3d/w:0"] = np.asarray(unit["conv3d"]["kernel"])
        if not bn:
            out[f"{name}/conv_3d/b:0"] = np.asarray(unit["conv3d"]["bias"])
            continue
        if not np.all(np.asarray(unit["bn_scale"]) == 1):
            raise ValueError(f"{ours}: the TF-hub I3D's batch norm has no scale")
        for ours_bn, theirs_bn in (("bn_bias", "beta"), ("bn_mean", "moving_mean"),
                                   ("bn_var", "moving_variance")):
            out[f"{name}/batch_norm/{theirs_bn}:0"] = np.asarray(unit[ours_bn]).reshape(
                1, 1, 1, 1, -1)
    return out


_INCEPTION_BRANCHES = {
    "a": ["branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1", "branch3x3dbl_2",
          "branch3x3dbl_3", "branch_pool"],
    "b": ["branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"],
    "c": ["branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3", "branch7x7dbl_1",
          "branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4", "branch7x7dbl_5", "branch_pool"],
    "d": ["branch3x3_1", "branch3x3_2", "branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3",
          "branch7x7x3_4"],
    "e": ["branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b", "branch3x3dbl_1",
          "branch3x3dbl_2", "branch3x3dbl_3a", "branch3x3dbl_3b", "branch_pool"],
}
_INCEPTION_PLAN = [("Mixed_5b", "a"), ("Mixed_5c", "a"), ("Mixed_5d", "a"), ("Mixed_6a", "b"),
                   ("Mixed_6b", "c"), ("Mixed_6c", "c"), ("Mixed_6d", "c"), ("Mixed_6e", "c"),
                   ("Mixed_7a", "d"), ("Mixed_7b", "e"), ("Mixed_7c", "e")]


def _plan_inception_fid(f) -> None:
    names = ["Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1", "Conv2d_4a_3x3"]
    names += [f"{m}/{b}" for m, kind in _INCEPTION_PLAN for b in _INCEPTION_BRANCHES[kind]]
    for path in names:
        key = path.replace("/", ".")
        f.conv(f"{path}/conv", f"{key}.conv", bias=False)
        f.frozen_bn(path, f"{key}.bn")


def convert_inception_fid(sd: dict) -> dict:
    return _fill(_plan_inception_fid, sd)


# -- BigGAN and the AE ---------------------------------------------------------------------

def _plan_biggan_generator(f, size: int = 64, skip_g_linear: bool = False) -> None:
    f.linear("linear", "linear", bias=False)
    if skip_g_linear:
        f.consume(f"G_linear.module.{s}" for s in ("weight_bar", "weight_u", "weight_v", "bias"))
    else:
        f.linear("G_linear", "G_linear.module", spectral=True, bar=True)
    for i in range(4 if size == 64 else 5):
        key, path = f"GBlock.{i}", f"GBlock_{i}"
        for cn in ("HyperBN", "HyperBN_1"):
            for embed in ("gamma_embed", "beta_embed"):
                f.linear(f"{path}/{cn}/{embed}", f"{key}.{cn}.{embed}.module",
                         spectral=True, bar=True, bias=False)
            if f.has(f"batch_stats/{path}/{cn}/bn/mean", f"{key}.{cn}.bn.running_mean"):
                f.batchnorm(f"{path}/{cn}/bn", f"{key}.{cn}.bn", affine=False)
        for conv in ("conv0", "conv1", "conv_sc"):
            f.conv(f"{path}/{conv}", f"{key}.{conv}.module", spectral=True, bar=True)
    # the self-attention runs only in the 128 px generator; at 64 px the
    # reference still holds its (dead) parameters, read and dropped here
    if size == 128:
        for name in ("theta", "phi", "g", "o_conv"):
            f.conv(f"attention/{name}", f"attention.{name}.module", spectral=True, bar=True,
                   bias=False)
        if f.has("params/attention/gamma", "attention.gamma"):
            f.scalar("attention/gamma", "attention.gamma")
    else:
        f.consume_prefix("attention.")
    if f.has("batch_stats/ScaledCrossReplicaBN/mean", "ScaledCrossReplicaBN.running_mean"):
        f.batchnorm("ScaledCrossReplicaBN", "ScaledCrossReplicaBN")
    f.conv("colorize", "colorize.module", spectral=True, bar=True)


def convert_biggan_generator(sd: dict, size: int = 64, skip_g_linear: bool = False) -> dict:
    """``skip_g_linear`` is the ImageNet init recipe: the checkpoint's
    ``G_linear`` is read but not mapped, so the template's fresh one (sized
    for the variable latent split) stays."""
    return _fill(_plan_biggan_generator, sd, size, skip_g_linear)


_CLASS_UP = (0, 2, 4, 6)  # ClassUp(depth=2): Linear at main 0, 2, 4 and the head at 6


def convert_bigae(sd: dict, config: dict) -> dict:
    """A whole BigAE state dict -> its tree (encoder and decoder wrapper); a
    partial one (an encoder-only save) gives what it has."""
    def part(prefix: str) -> dict:
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    enc_sd, dec_sd = part("encoder."), part("decoder.decoder.")
    cls_sd = part("decoder.map_to_class_embedding.")
    enc = convert_resnet_encoder(enc_sd, config["encoder_type"], config["norm"]) if enc_sd else {}
    dec = convert_biggan_generator(dec_sd, config["in_size"]) if dec_sd else {}
    cls_params = {}
    for i in _CLASS_UP:
        if f"main.{i}.weight" in cls_sd:
            cls_params[f"l{len(cls_params)}"] = {
                "kernel": t_linear(np.asarray(cls_sd[f"main.{i}.weight"])),
                "bias": np.asarray(cls_sd[f"main.{i}.bias"])}
    out: dict = {}
    for col in set(enc) | set(dec) | {"params"}:
        out.setdefault(col, {})
        if col in enc:
            out[col]["encoder"] = enc[col]
        wrap: dict = {}
        if col in dec:
            wrap["decoder"] = dec[col]
        if col == "params" and cls_params:
            wrap["map_to_class_embedding"] = cls_params
        if wrap:
            out[col]["decoder_wrap"] = wrap
    return out


def subtree(variables: dict, *path: str) -> dict:
    """Each collection's sub-tree at ``path`` (a module inside a bigger one)."""
    out = {}
    for col, tree in variables.items():
        node = _get(tree, "/".join(path)) if isinstance(tree, dict) else None
        if node is not None:
            out[col] = node
    return out


def _bigae_reference(variables: dict, config: dict) -> dict:
    sd = {f"encoder.{k}": v for k, v in to_reference(
        convert_resnet_encoder, subtree(variables, "encoder"), config["encoder_type"],
        config["norm"]).items()}
    sd.update({f"decoder.decoder.{k}": v for k, v in to_reference(
        convert_biggan_generator, subtree(variables, "decoder_wrap", "decoder"),
        config["in_size"]).items()})
    cls = variables["params"]["decoder_wrap"]["map_to_class_embedding"]
    for li, i in enumerate(_CLASS_UP):
        sd[f"decoder.map_to_class_embedding.main.{i}.weight"] = np.asarray(
            cls[f"l{li}"]["kernel"]).T
        sd[f"decoder.map_to_class_embedding.main.{i}.bias"] = np.asarray(cls[f"l{li}"]["bias"])
    return sd


def pretrained_init_biggan(gen_vars: dict, ae_cfg: dict, weights_root: str = "models",
                           sd: dict | None = None) -> dict:
    """``AE.pretrained: true``: the BigAE's tree with every decoder weight
    from the ImageNet BigGAN checkpoint except ``G_linear``, which keeps the
    template's fresh init (sized for the variable latent split), as the
    reference's ``load_state_dict`` then ``update_G_linear`` do; the encoder
    and ``ClassUp`` stay fresh too (the checkpoint has neither). ``sd`` is an
    already-loaded state dict; else it is read from
    ``{weights_root}/biggan/biggan_{size}.pth``."""
    size = int(ae_cfg["in_size"])
    if sd is None:
        path = os.path.join(weights_root, "biggan", f"biggan_{size}.pth")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"AE.pretrained=true but no ImageNet BigGAN checkpoint at "
                f"{path}; see docs/WEIGHTS.md (entry biggan_{size}) for how "
                f"to supply it, or set AE.pretrained: false")
        sd = load_torch_state_dict(path)
    dec = convert_biggan_generator(sd, size, skip_g_linear=True)
    nested = {col: {"decoder_wrap": {"decoder": tree}} for col, tree in dec.items()}
    merged, _missing = merge_into_template(gen_vars, nested)
    return merged


def _flatten(tree: dict, prefix: tuple = ()) -> dict:
    """Leaves by path; an empty dict has none, as flax's ``flatten_dict`` drops it."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return out


def merge_into_template(template: dict, converted: dict,
                        strict: bool = True) -> tuple[dict, list[tuple]]:
    """Overlay converted leaves onto a fresh variables tree: (merged, the
    template's paths that ``converted`` lacks, which keep their values).
    Shapes are checked leaf by leaf and each leaf takes the template's dtype."""
    flat_t, flat_c = _flatten(template), _flatten(converted)
    for path, value in flat_c.items():
        if path not in flat_t:
            if strict:
                raise KeyError(f"converted leaf {'/'.join(path)} not in template")
            continue
        tval = flat_t[path]
        if tuple(np.shape(value)) != tuple(np.shape(tval)):
            raise ValueError(f"shape mismatch at {'/'.join(path)}: "
                             f"converted {np.shape(value)} vs template {np.shape(tval)}")
        flat_t[path] = np.asarray(value, dtype=np.asarray(tval).dtype)
    return _unflatten(flat_t), [p for p in flat_t if p not in flat_c]


_PLANS = {convert_stage1_generator: _plan_stage1_generator,
          convert_stage1_encoder: _plan_stage1_encoder,
          convert_stage1_discriminator: _plan_stage1_discriminator,
          convert_patch_discriminator: _plan_patch_discriminator,
          convert_resnet_encoder: _plan_resnet_encoder, convert_vgg16: _plan_vgg16,
          convert_i3d_kinetics: lambda f: _plan_i3d(f, False),
          convert_i3d_dt: lambda f: _plan_i3d(f, True),
          convert_inception_fid: _plan_inception_fid,
          convert_biggan_generator: _plan_biggan_generator}
_INVERSES = {convert_conditional_flow: _flow_reference, convert_lpips: _lpips_reference,
             convert_i3d_tf_hub: _i3d_tf_reference, convert_bigae: _bigae_reference}


def to_reference(converter: Callable, variables: dict, *args, **kwargs):
    """The reference-layout state dict (numpy arrays) that ``converter``,
    with the same options, maps to ``variables``: its inverse. Every leaf of
    ``variables`` must be written (``actnorm_stats`` aside). ``convert_lpips``'s
    gives (the ``vgg.pth`` heads, torchvision's vgg16 ``features``),
    ``convert_i3d_tf_hub``'s the hub graph's variables by name."""
    if converter in _INVERSES:
        return _INVERSES[converter](variables, *args, **kwargs)
    e = _Emitter(variables)
    _PLANS[converter](e, *args, **kwargs)
    if e.unread():
        raise ValueError(f"{converter.__name__}: leaves with no reference key: "
                         f"{e.unread()[:10]}")
    return e.sd
