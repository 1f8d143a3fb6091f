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
  folded into the weight once (``ops/spectral.py``);
* ``{scale, bias}``: an affine GroupNorm -> ``weight``/``bias``;
* ``{w, b}``: the flow's stacked coupling layer (n, in, out) -> ``weight``
  (n, out, in) and ``bias``;
* ``{loc, scale}``: the flow's stacked ActNorm, kept as it is;
* ``bn_mean``/``bn_var``/``bn_scale``/``bn_bias`` beside a ``conv``/``conv3d``
  leaf: the frozen BatchNorm of the metric backbones (I3D's ``Unit3D``,
  Inception's ``BasicConv2d``), kept as they are.

``buffers`` leaves (the flow's shuffle permutations) are copied as int64:
they are always taken from the tree, never drawn again. ``batch_stats``
leaves (a BatchNorm's running ``mean``/``var``) become the port's BatchNorm
buffers of the same names. ``actnorm_stats`` (``loc_init``, ``scale_init``,
``initialized``) is the bookkeeping of ActNorm's data-dependent
initialisation; inference reads the ``loc``/``scale`` params, so it is
dropped.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops import spectral
from . import checkpoint

_COLLECTIONS = {"params", "spectral", "buffers", "batch_stats", "actnorm_stats"}
_FROZEN_BN = ("bn_mean", "bn_var", "bn_scale", "bn_bias")


def _tensor(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def torch_weight(kernel: np.ndarray) -> torch.Tensor:
    """JAX kernel -> torch weight: (*k, in, out) -> (out, in, *k); (in, out) -> (out, in)."""
    k = np.asarray(kernel, dtype=np.float32)
    order = (k.ndim - 1, k.ndim - 2) + tuple(range(k.ndim - 2))
    return _tensor(np.transpose(k, order))


def _key(path: tuple, name: str) -> str:
    return ".".join(path + (name,))


def _walk(tree: dict, spectral_tree: dict, path: tuple, out: dict) -> None:
    names = set(tree)
    if "kernel" in names:
        if not names <= {"kernel", "bias"}:
            raise ValueError(f"{'/'.join(path)}: unexpected leaves {sorted(names)}")
        w = torch_weight(tree["kernel"])
        sn = spectral_tree if isinstance(spectral_tree, dict) else {}
        if "u" in sn:
            w = spectral.fold(w, _tensor(sn["u"]), _tensor(sn["v"]))
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
        if name in _FROZEN_BN:
            out[_key(path, name)] = _tensor(sub)
            continue
        if not isinstance(sub, dict):
            raise ValueError(f"{'/'.join(path + (name,))}: unexpected leaf")
        _walk(sub, (spectral_tree or {}).get(name, {}), path + (name,), out)


def _walk_leaves(tree: dict, path: tuple, out: dict, convert) -> None:
    for name, sub in tree.items():
        if isinstance(sub, dict):
            _walk_leaves(sub, path + (name,), out, convert)
        else:
            out[_key(path, name)] = convert(sub)


def _int64(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def to_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """Variables tree of one JAX module -> state_dict of its port."""
    unknown = set(variables) - _COLLECTIONS
    if unknown:
        raise ValueError(f"collections the port cannot load yet: {sorted(unknown)}")
    out: dict[str, torch.Tensor] = {}
    _walk(variables.get("params", {}), variables.get("spectral", {}), (), out)
    _walk_leaves(variables.get("buffers", {}), (), out, _int64)
    _walk_leaves(variables.get("batch_stats", {}), (), out, _tensor)
    return out


def to_variables(state_dict: dict[str, torch.Tensor]) -> dict:
    """state_dict of a metric backbone (convolutions without spectral norm and
    frozen-BN leaves) -> the JAX variables tree ``{"params": ...}`` that
    ``to_state_dict`` maps back onto it: the inverse of the bridge for those
    modules, so the port can write backbone weights in the JAX package's
    format."""
    params: dict = {}
    for key, t in state_dict.items():
        *path, name = key.split(".")
        node = params
        for p in path:
            node = node.setdefault(p, {})
        a = t.detach().cpu().float().numpy()
        if name == "weight" and a.ndim >= 3:  # (out, in, *k) -> (*k, in, out)
            node["kernel"] = np.ascontiguousarray(np.transpose(a, tuple(range(2, a.ndim)) + (1, 0)))
        elif name in ("bias",) + _FROZEN_BN:
            node[name] = a
        else:
            raise ValueError(f"{key}: not a leaf of a metric backbone")
    return {"params": params}


def load_checkpoint(module: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load the variables tree of a ``.msgpack`` checkpoint (``{"state_dict":
    variables}`` or the bare tree) strictly into ``module``."""
    payload = checkpoint.load(path)
    module.load_state_dict(to_state_dict(payload.get("state_dict", payload)))
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
