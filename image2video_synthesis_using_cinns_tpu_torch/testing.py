"""Presets and an in-memory model builder (port of ``testing.py``).

``PRESETS`` are the JAX package's architecture presets ('tiny' for tests,
'bair' the reference BAIR architecture at full size, 'landscape' the 128 px
one). ``build_model`` makes a sampling ``Model`` from a preset with random
torch weights drawn from a seed, with no checkpoint directory and no YAML
reader: the configs are built in memory, with the keys of the saved ones.
``dryrun_multichip`` is the JAX system's multi-device dry run on a data x
model grid of devices. ``stage1_config``, ``stage2_ae_config`` and
``stage2_config`` are the trainers' configs of a preset, and
``make_bair_data_dir`` a synthetic BAIR dataset, as the JAX package's
fixtures write them (``cli/pipeline_drive.py`` trains from them).

``make_reference_model_dir`` writes a chained stage-1/AE/stage-2 directory
whose checkpoints are ``.pth`` files in the reference framework's key
layout (``convert.to_reference`` of seeded random port modules, the
sources that ``reference_sources`` rebuilds), and
``write_reference_backbone`` a metric network's reference-layout file:
what a user of the released models holds, for the converter to read.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import numpy as np
import torch

from . import config as cfg
from .config import Config
from .models.facade import Model, resolve_device
from .utils import convert

PRESETS = {
    "tiny": dict(
        img_size=32, seq_length=9, z_dim=16, nf=16,
        enc_channels=[16, 32, 32, 32, 32], enc_stride_t=[1, 2, 2, 2], enc_stride_s=[1, 2, 2, 1],
        upsample_s=[1, 1], upsample_t=[1, 1],
        n_flows=4, flow_factor=4, cond_z=16, ae_type="resnet18",
        # keep the temporal discriminator's last spatial size at 4 for 32 px inputs
        disc_channels=[16, 16, 32, 32, 32], disc_stride_s=[1, 1, 2, 1],
    ),
    # reference landscape/DTDB-style 128 px architecture
    "landscape": dict(
        img_size=128, seq_length=17, z_dim=64, nf=32,
        enc_channels=[64, 128, 128, 256, 512], enc_stride_t=[1, 2, 2, 2],
        enc_stride_s=[2, 2, 2, 2],
        upsample_s=[2, 2], upsample_t=[2, 1],
        n_flows=20, flow_factor=8, cond_z=128, ae_type="resnet50", ae_norm="bn",
        disc_channels=[64, 64, 128, 256, 512], disc_stride_s=[1, 2, 2, 2],
    ),
    # reference BAIR architecture (stage1_VAE, stage2_cINN and stage2_cINN/AE
    # bair_config.yaml)
    "bair": dict(
        img_size=64, seq_length=17, z_dim=64, nf=64,
        enc_channels=[64, 128, 256, 512, 512], enc_stride_t=[1, 2, 2, 2],
        enc_stride_s=[1, 2, 2, 2],
        upsample_s=[2, 1], upsample_t=[2, 1],
        n_flows=20, flow_factor=8, cond_z=64, ae_type="resnet50",
        disc_channels=[64, 64, 128, 256, 512], disc_stride_s=[1, 1, 2, 2],
    ),
}


def configs(preset: str, control: bool = False) -> tuple[Config, Config, Config]:
    """(stage-2 config, stage-1 config, AE section) with the keys of the
    sampling, transfer and evaluation paths; the stage-2 ``Data`` section is
    the JAX fixture's (``testing.stage2_config``), which the eval CLIs read
    from ``Model.config``."""
    p = PRESETS[preset]
    stage1 = Config({
        "Decoder": {
            "channel_factor": p["nf"], "z_dim": p["z_dim"], "upsample_s": p["upsample_s"],
            "upsample_t": p["upsample_t"], "spectral_norm": True,
        },
        "Encoder": {
            "res_type_encoder": "resnet18", "deterministic": False, "use_max_pool": False,
            "z_dim": p["z_dim"], "channels": p["enc_channels"], "stride_t": p["enc_stride_t"],
            "stride_s": p["enc_stride_s"],
        },
        "Data": {"img_size": p["img_size"], "sequence_length": p["seq_length"]},
    })
    ae = Config({"norm": p.get("ae_norm", "in"), "encoder_type": p["ae_type"],
                 "z_dim": p["cond_z"]})
    stage2 = Config({
        "Flow": {"n_flows": p["n_flows"], "flow_hidden_depth": 2,
                 "flow_mid_channels_factor": p["flow_factor"]},
        "Conditioning_Model": {"z_dim": p["cond_z"]},
        "Training": {"control": control},
        "Data": {
            "sequence_length": p["seq_length"], "img_size": p["img_size"],
            "dataset": "BAIR", "aug": True, "data_path": "",
            "Augmentation": {
                "brightness": 0.1, "contrast": 0.1, "saturation": 0.1,
                "hue": 0, "prob_hflip": 0.5,
            },
        },
    })
    return stage2, stage1, ae


def build_model(preset: str = "bair", vid_length: int = 16, seed: int = 0,
                use_kernel: bool = True, compute_dtype: str = "float32",
                control: bool = False, transfer: bool = False, device=None,
                data_parallel: bool | list = False,
                spatial_shard: bool | int = False) -> Model:
    """A ``Model`` of ``preset`` with random weights drawn from ``seed``."""
    stage2, stage1, ae = configs(preset, control)
    return Model.from_configs(stage2, stage1, ae, vid_length, transfer=transfer, seed=seed,
                              use_kernel=use_kernel, compute_dtype=compute_dtype, device=device,
                              data_parallel=data_parallel, spatial_shard=spatial_shard)


def dryrun_multichip(devices, preset: str = "tiny", seed: int = 0) -> dict:
    """The JAX system's ``dryrun_multichip`` (``__graft_entry__.py:92-372``)
    over ``devices`` (e.g. ``["cpu"] * 8`` or ``["cuda:0"] * 4``), with
    random weights of ``preset`` drawn from ``seed``. The devices form a 2-D
    data x model grid, 2 on ``model`` when there are 4 or more and their
    count is even, else 1. Raises where a check fails:

    * one stage-2 training step (``train.stage2.train_step``) of the
      tensor-parallel flow (``parallel/tp.py``) at 2 clips a device, its
      metrics finite;
    * the eval of a batch that does not divide the data rows, padded and its
      pad dropped, equal to the gathered flow's eval of the true batch on one
      device, to 1e-4 + 1e-4 |a|;
    * the cached-posterior loss equal to the uncached loss, to 1e-5 + 1e-5
      |a|, and one cached step, its metrics finite;
    * data-parallel sampling (``Model(data_parallel=...)`` over the rows'
      first devices) from the trained flow, gathered and packed, through
      ``flow_reverse_fused``: a finite video;
    * the width-sharded decode of one video over the data axis
      (``parallel/spatial.py``) and, with a model axis, the data x spatial
      decode of the batch, each within 2e-3 of the whole decode.

    Returns the metrics and the measured gaps."""
    import copy

    from .losses.flow_loss import flow_loss
    from .models.stage1.decoder import Generator
    from .models.stage1.resnet3d import Encoder
    from .models.stage2.inn import SupervisedTransformer
    from .parallel import spatial
    from .parallel.mesh import make_2d_mesh, make_mesh, pad_to_multiple, replicate
    from .parallel.tp import TensorParallelFlow, batch_sharded
    from .train import stage2
    from .train.optim import adam_torch

    devs = make_mesh(devices=devices)
    n = len(devs)
    n_model = 2 if n >= 4 and n % 2 == 0 else 1
    mesh = make_2d_mesh(n // n_model, n_model, devs)
    first = devs[0]
    s2, s1, ae = configs(preset)
    p = PRESETS[preset]
    img, seq_len, z_dim = p["img_size"], p["seq_length"], p["z_dim"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        encoder = Encoder.from_config(s1.Encoder)
        network = SupervisedTransformer.from_configs(s2, s1.Decoder, ae)
        decoder = Generator.from_config(s1.Decoder)
    encoder = encoder.to(first).eval().requires_grad_(False)
    network = network.to(first).eval()
    network.embedder.requires_grad_(False)
    decoder = decoder.to(first).eval()
    tp_net = copy.deepcopy(network)
    tp_net.flow = TensorParallelFlow(tp_net.flow, mesh)

    def adam(net):
        return adam_torch(list(net.flow.parameters()), 1e-4, betas=(0.9, 0.99), amsgrad=True)

    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed + 2)

    def clips(b):
        x = rng.uniform(-1, 1, (b, seq_len, img, img, 3)).astype(np.float32)
        return torch.from_numpy(x).to(first)

    def normal(b):
        return torch.randn((b, z_dim), generator=gen).to(first)

    def finite(label, aux):
        bad = {k: float(v) for k, v in aux.items() if not torch.isfinite(v)}
        if bad:
            raise AssertionError(f"{label}: non-finite metrics {bad}")
        return {k: float(v) for k, v in aux.items()}

    def gap(label, want, got, tol):
        g = {k: abs(float(want[k]) - float(got[k])) / (tol + tol * abs(float(want[k])))
             for k in want}
        if max(g.values()) > 1.0:
            raise AssertionError(f"{label}: {dict(want)} against {dict(got)}")
        return max(g.values())

    b = 2 * n
    seq, eps, ref = clips(b), normal(b), normal(b)
    cond = stage2.conditioning(seq, None)
    metrics = finite("tensor-parallel step", stage2.train_step(
        tp_net, adam(tp_net), encoder, seq, cond, eps, ref))

    # a batch that does not divide the rows: padded, the pad dropped
    true_b = n - 1 if n > 1 else 1
    seq_t, eps_t, ref_t = clips(true_b), normal(true_b), normal(true_b)
    whole = tp_net.flow.gather_into(copy.deepcopy(network.flow))
    with torch.no_grad():
        want = flow_loss(*whole.plain(stage2.posterior(encoder, seq_t, eps_t),
                                      network.embed(stage2.conditioning(seq_t, None))),
                         noise=ref_t)[1]
        (seq_p, eps_p), _ = pad_to_multiple([seq_t, eps_t], len(mesh))
        g, ld = tp_net.flow.plain(stage2.posterior(encoder, seq_p, eps_p),
                                  network.embed(stage2.conditioning(seq_p, None)))
        got = flow_loss(g[:true_b], ld[:true_b], noise=ref_t)[1]
    padded_gap = gap("padded data-parallel eval against the true batch", want, got, 1e-4)

    # the cached-posterior loss: moments of the same rows give the same loss
    with torch.no_grad():
        _, mu, logvar = encoder(seq[:, 1:].permute(0, 4, 1, 2, 3), noise=eps)
        moments = torch.stack([mu, logvar], dim=1)
        wids = torch.arange(b, device=first)
        emb = network.embed(cond)
        cached = flow_loss(*tp_net.flow.plain(stage2.cached_posterior(moments, wids, eps), emb),
                           noise=ref)[1]
        uncached = flow_loss(*tp_net.flow.plain(stage2.posterior(encoder, seq, eps), emb),
                             noise=ref)[1]
    cached_gap = gap("cached-posterior loss against the uncached loss", uncached, cached, 1e-5)
    fresh = copy.deepcopy(tp_net)
    cached_metrics = finite("cached step", stage2.cached_train_step(
        fresh, adam(fresh), moments, wids, cond, eps, ref))
    del fresh

    # data-parallel sampling from the trained flow, gathered and packed
    serving = copy.deepcopy(network)
    tp_net.flow.gather_into(serving.flow)
    model = Model.from_configs(s2, s1, ae, decoder.base_frames, seed=seed,
                               state_dicts={"decoder": decoder.state_dict(),
                                            "flow": serving.state_dict()},
                               data_parallel=[row[0] for row in mesh])
    x0 = torch.from_numpy(rng.uniform(-1, 1, (b, 3, img, img)).astype(np.float32)).to(first)
    vid, _ = model.sample(x0, residual=normal(b))
    if not bool(torch.isfinite(vid).all()):
        raise AssertionError("non-finite sampled video")
    sample_shape = tuple(vid.shape)
    del model, serving

    # the width-sharded decode of one video over the data axis, as JAX shards it
    row = spatial.spatial_sharding(mesh, "data")[0]
    z1 = normal(1)
    with torch.no_grad():
        want1 = decoder(x0[:1], z1)
        got1 = spatial.gather(decoder(x0[:1], z1, [decoder] + replicate(row[1:], decoder)))
    spatial_err = float((got1 - want1).abs().max())
    if spatial_err > 2e-3:
        raise AssertionError(f"width-sharded decode {spatial_err:.3e} from the whole decode")

    dp_spatial_err = None
    if n_model > 1:  # rows on 'data', width on 'model'
        zb = normal(b)
        with torch.no_grad():
            want_b = decoder(x0, zb)
            outs = []
            for grp, part in zip(spatial.spatial_sharding(mesh, "model", batch_axis="data"),
                                 batch_sharded(mesh, {"x0": x0, "z": zb})):
                peers = replicate(grp, decoder)
                outs.append(spatial.gather(peers[0](part["x0"], part["z"], peers)).to(first))
            got_b = torch.cat(outs)
        dp_spatial_err = float((got_b - want_b).abs().max())
        if dp_spatial_err > 2e-3:
            raise AssertionError(f"data x spatial decode {dp_spatial_err:.3e} from the whole "
                                 "decode")
    return {"mesh": (len(mesh), n_model), "metrics": metrics, "padded_eval_gap": padded_gap,
            "cached_gap": cached_gap, "cached_metrics": cached_metrics,
            "sample_shape": sample_shape, "spatial_err": spatial_err,
            "dp_spatial_err": dp_spatial_err}


@contextlib.contextmanager
def float64_training(trainer) -> Iterator[None]:
    """Within: the trainer module ``trainer`` (``train.stage1`` or
    ``train.stage2_ae``) builds its models in float64 and its augment gives
    float64 batches, so that its ``main`` runs in fp64 from the same seeded
    weights: the multi-process checks hold two ranks to one process there,
    where the order of a sum cannot move a rounding far (in fp32 Adam's
    first steps turn rounding on a near-zero gradient into a step of about
    lr either way)."""
    build, augment = trainer.build_models, trainer.build_augment

    def build64(*args, **kwargs):
        return build(*args, **kwargs).to(torch.float64)

    def augment64(*args, **kwargs):
        f = augment(*args, **kwargs)
        return lambda *a, **k: f(*a, **k).to(torch.float64)

    trainer.build_models, trainer.build_augment = build64, augment64
    try:
        yield
    finally:
        trainer.build_models, trainer.build_augment = build, augment


# -- the trainers' configs and a synthetic BAIR dataset ---------------------------------------

def stage1_config(p: dict) -> Config:
    """The stage-1 trainer's config of preset ``p`` (the JAX package's
    ``testing.stage1_config``)."""
    return Config({
        "Decoder": {
            "channel_factor": p["nf"], "z_dim": p["z_dim"], "upsample_s": p["upsample_s"],
            "upsample_t": p["upsample_t"], "spectral_norm": True,
        },
        "Encoder": {
            "res_type_encoder": "resnet18", "deterministic": False, "use_max_pool": False,
            "z_dim": p["z_dim"], "channels": p["enc_channels"], "stride_t": p["enc_stride_t"],
            "stride_s": p["enc_stride_s"],
        },
        "Discriminator_Temporal": {
            "eval_seq_length": 16, "res_type_encoder": "resnet18", "deterministic": False,
            "use_max_pool": True, "channels": p["disc_channels"], "stride_t": [2, 2, 2, 2],
            "stride_s": p["disc_stride_s"], "spectral_norm": True,
        },
        "Discriminator_Patch": _patch_discriminator(p),
        "Training": {
            "patch_GAN": "basic", "GAN_Loss": "hinge",
            "w_coup_s": 1, "w_coup_t": 1, "w_fmap_t": 10, "w_percep": 30,
            "w_recon": 10, "w_GP": 10, "w_kl": 1e-5,
            "subsample_length": 12 if p["seq_length"] > 12 else p["seq_length"] - 1,
            "pretrain": 1, "n_epochs": 55, "lr": 2e-4, "workers": 4,
            "bs": 10, "bs_eval": 10, "verbose_idx": 30,
            "weight_decay": 1e-5, "lr_gamma": 0.98, "FVD": "FVD",
            "savename": "fixture", "save_path": "", "reload_path": "",
        },
        "Data": {
            "sequence_length": p["seq_length"], "img_size": p["img_size"], "dataset": "BAIR",
            "reverse": False, "aug": True, "data_path": "",
            "Augmentation": {"brightness": 0.1, "contrast": 0.1, "saturation": 0.1, "hue": 0,
                             "prob_hflip": 0.5},
        },
        "Logging": {"entity": None, "project": None, "mode": "disabled"},
    })


def _patch_discriminator(p: dict) -> dict:
    return {"in_channels": 3, "ndf": 64 if p["nf"] >= 64 else 16, "n_layers": 3,
            "use_actnorm": True, "spectral_norm": True}


def stage2_ae_config(p: dict) -> Config:
    """The stage-2 AE trainer's config of preset ``p`` (the JAX package's
    ``testing.stage2_ae_config``)."""
    return Config({
        "AE": {
            "deterministic": False, "in_size": p["img_size"], "norm": p.get("ae_norm", "in"),
            "encoder_type": p["ae_type"], "use_actnorm_in_dec": False, "z_dim": p["cond_z"],
            "pre_process": False, "pretrained": False,
        },
        "Discriminator_Patch": _patch_discriminator(p),
        "Training": {
            "w_kl": 1e-5, "n_epochs": 60, "lr": 2e-4, "bs": 30, "weight_decay": 0,
            "workers": 4, "pretrain": 20, "savename": "fixture", "save_path": "",
        },
        "Data": {
            "sequence_length": 1, "img_size": p["img_size"], "dataset": "BAIR", "aug": True,
            "data_path": "",
            "Augmentation": {"brightness": 0.2, "contrast": 0.2, "saturation": 0.2, "hue": 0.1,
                             "prob_hflip": 0.5},
        },
        "Logging": {"entity": None, "project": None, "mode": "disabled"},
    })


def stage2_config(p: dict, stage1_path: str, ae_path: str, control: bool = False) -> Config:
    """The cINN trainer's config of preset ``p``, chained to the stage-1 run
    ``stage1_path`` and the AE run ``ae_path`` (the JAX package's
    ``testing.stage2_config``)."""
    def chain(path: str) -> dict:
        return {"model_name": os.path.basename(path.rstrip("/")),
                "model_path": os.path.dirname(path.rstrip("/")) + "/"}

    return Config({
        "Flow": {"n_flows": p["n_flows"], "flow_hidden_depth": 2,
                 "flow_mid_channels_factor": p["flow_factor"]},
        "Conditioning_Model": {"z_dim": p["cond_z"], "checkpoint_name": "Encoder_stage2",
                               **chain(ae_path)},
        "First_stage_model": {"checkpoint_encoder": "best_PFVD_ENC",
                              "checkpoint_decoder": "best_PFVD_GEN", **chain(stage1_path)},
        "Training": {
            "n_epochs": 31, "lr": 1e-5, "workers": 4, "bs": 50, "bs_eval": 10,
            "control": control, "control_dim": 3, "verbose_idx": 30, "weight_decay": 0,
            "gamma": 0.5, "step_size": 7, "beta1": 0.9, "beta2": 0.99, "amsgrad": True,
            "savename": "fixture", "save_path": "",
        },
        "Data": {
            "sequence_length": p["seq_length"], "img_size": p["img_size"], "dataset": "BAIR",
            "aug": True, "data_path": "",
            "Augmentation": {"brightness": 0.1, "contrast": 0.1, "saturation": 0.1, "hue": 0,
                             "prob_hflip": 0.5},
        },
        "Logging": {"entity": None, "project": None, "mode": "disabled"},
    })


def _random_state(module_fn, gen: torch.Generator, device: torch.device) -> dict:
    """A random state dict for the module that ``module_fn()`` builds, its
    keys and shapes taken from a build on the meta device, every value drawn
    on ``device`` from ``gen`` in key order: a weight of two or more axes
    and its bias from U(-1/sqrt(fan_in), +1/sqrt(fan_in)), as torch's layers
    draw them (the flow's stacked layers (n, out, in) have fan_in = in);
    a norm's per-channel weight 1 and its bias 0; ActNorm ``loc`` 0 and
    ``scale`` 1; running statistics 0 and 1; spectral vectors ``u``/``v``
    unit normals; each block's shuffle a random permutation beside its
    inverse."""
    with torch.device("meta"):
        shapes = {k: (tuple(t.shape), t.dtype) for k, t in module_fn().state_dict().items()}

    def uniform(shape, fan_in):
        bound = 1.0 / fan_in ** 0.5
        return torch.empty(shape, device=device).uniform_(-bound, bound, generator=gen)

    out: dict[str, torch.Tensor] = {}
    for key, (shape, dtype) in shapes.items():
        prefix, _, name = key.rpartition(".")
        weight = shapes.get(f"{prefix}.weight", ((), None))[0]
        if len(weight) < 2:
            fan_in = 0
        else:
            fan_in = weight[-1] if ".coupling." in key else int(np.prod(weight[1:]))
        if name in ("weight", "bias") and fan_in:
            out[key] = uniform(shape, fan_in)
        elif name in ("weight", "scale", "var"):
            out[key] = torch.ones(shape, device=device)
        elif name in ("bias", "loc", "mean"):
            out[key] = torch.zeros(shape, device=device)
        elif name in ("u", "v"):
            u = torch.randn(shape, device=device, generator=gen)
            out[key] = u / torch.linalg.vector_norm(u)
        elif name == "fwd":
            out[key] = torch.stack([torch.randperm(shape[1], device=device, generator=gen)
                                    for _ in range(shape[0])]).to(dtype)
        elif name == "inv":
            out[key] = torch.argsort(out[f"{prefix}.fwd"], dim=1).to(dtype)
        else:
            raise ValueError(f"{key}: no rule to draw this leaf")
    return out


def make_model_dir(root: str, preset: str = "tiny", seed: int = 0, control: bool = False,
                   device: str | torch.device | None = None) -> str:
    """The chained model directory that ``Model`` and the serving CLIs read,
    with random weights: ``stage1/`` (``config_stage1.yaml``,
    ``best_PFVD_{GEN,ENC}.msgpack``), ``AE/`` (``config_stage2_AE.yaml``,
    ``Encoder_stage2.msgpack``) and ``stage2/`` (``config_stage2.yaml``,
    chained to the other two, and ``cINN.msgpack``), as the JAX package's
    ``testing.make_model_dir`` writes them: the same configs, and
    checkpoints in the JAX variables layout, so that either package's
    ``Model`` serves the directory. The trainable decoder keeps its raw
    weights and spectral vectors, as a trainer saves it.

    The weights are drawn on ``device`` (the card unless ``device="cpu"``)
    from one ``torch.Generator`` per network, seeded from ``seed``
    (``_random_state``), so a full-size directory takes seconds to build;
    the values depend on the device's generator. Returns the stage-2
    directory."""
    from .models.stage1.decoder import Generator
    from .models.stage1.resnet3d import Encoder
    from .models.stage2.inn import SupervisedTransformer
    from .models.stage2.resnet2d import ResnetEncoder
    from .utils import checkpoint as ckpt_io

    device = resolve_device(device)
    p = PRESETS[preset]
    dirs = {name: os.path.join(root, name) for name in ("stage1", "AE", "stage2")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    s1_cfg = stage1_config(p)
    ae_cfg = stage2_ae_config(p)
    s2_cfg = stage2_config(p, dirs["stage1"], dirs["AE"], control)
    cfg.save(s1_cfg, os.path.join(dirs["stage1"], "config_stage1.yaml"))
    cfg.save(ae_cfg, os.path.join(dirs["AE"], "config_stage2_AE.yaml"))
    cfg.save(s2_cfg, os.path.join(dirs["stage2"], "config_stage2.yaml"))

    networks = (
        ("stage1", "best_PFVD_GEN", {"epoch": 0},
         lambda: Generator.from_config(s1_cfg.Decoder, trainable=True)),
        ("stage1", "best_PFVD_ENC", {"epoch": 0}, lambda: Encoder.from_config(s1_cfg.Encoder)),
        ("AE", "Encoder_stage2", {}, lambda: ResnetEncoder.from_config(ae_cfg.AE)),
        ("stage2", "cINN", {},
         lambda: SupervisedTransformer.from_configs(s2_cfg, s1_cfg.Decoder, ae_cfg.AE)),
    )
    for k, (d, name, extra, build) in enumerate(networks):
        gen = torch.Generator(device=device).manual_seed(4 * seed + k)
        tree = convert.to_variables(_random_state(build, gen, device))
        ckpt_io.save(os.path.join(dirs[d], f"{name}.msgpack"), dict(extra, state_dict=tree))
    return dirs["stage2"]


def make_bair_data_dir(root: str, n_videos: int = 2, img: int = 32,
                       modes: tuple = ("train", "eval", "test")) -> str:
    """A synthetic BAIR-layout dataset, the JAX package's
    ``testing.make_bair_data_dir`` file for file: per mode ``n_videos`` clips
    ``<root>/<mode>/traj_0/<k>/<frame>.png`` of 30 frames (noise and a moving
    square), each with its ``endeffector_positions.csv``. Returns ``root``."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for mode in modes:
        for k in range(n_videos):
            d = os.path.join(root, mode, "traj_0", str(k))
            os.makedirs(d, exist_ok=True)
            x0, y0 = rng.integers(0, img - 8, 2)
            dx, dy = rng.integers(-1, 2, 2)
            positions = []
            for f in range(30):
                frame = rng.integers(0, 40, (img, img, 3)).astype(np.uint8)
                xx = int(np.clip(x0 + f * dx, 0, img - 8))
                yy = int(np.clip(y0 + f * dy, 0, img - 8))
                frame[yy:yy + 8, xx:xx + 8] = [250, 120, 30]
                Image.fromarray(frame).save(os.path.join(d, f"{f}.png"))
                positions.append([0.4264 + 0.0002 * xx / img, -0.3 + 0.8 * yy / img,
                                  0.19 + 0.1 * f / 30])
            np.savetxt(os.path.join(d, "endeffector_positions.csv"), np.asarray(positions),
                       delimiter=",")
    return root


# -- reference-layout checkpoints ------------------------------------------------------------

def reference_sources(preset: str = "tiny", seed: int = 0, control: bool = False) -> dict:
    """The random port modules a reference directory of ``preset`` is written
    from, drawn from ``seed`` on the CPU: the trainable stage-1 decoder and
    encoder (spectral layers with their ``u``/``v``), the AE embedder and
    the flow. Under control the 'cond' blocks' x rows of the first coupling
    layers are zero, since the reference's layer has none."""
    from .models.stage1.decoder import Generator
    from .models.stage1.resnet3d import Encoder
    from .models.stage2.inn import SupervisedTransformer

    stage2, stage1, ae = configs(preset, control)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        decoder = Generator.from_config(stage1.Decoder, trainable=True)
        encoder = Encoder.from_config(stage1.Encoder, trainable=True)
        network = SupervisedTransformer.from_configs(stage2, stage1.Decoder, ae)
    if control:
        half = stage1.Decoder["z_dim"] // 2
        with torch.no_grad():
            for name in ("s0", "t0", "s1", "t1"):
                w = network.flow.blocks.coupling[name]["l0"].weight
                w[network.flow.mask == 0, :, :half] = 0
    return {"decoder": decoder, "encoder": encoder, "embedder": network.embedder,
            "flow": network.flow}


def reference_model(preset: str = "tiny", seed: int = 0, vid_length: int = 16,
                    control: bool = False, **kwargs) -> Model:
    """A ``Model`` given ``reference_sources``' weights directly (spectral
    norm folded, as a serving load does): what serving the converted
    ``make_reference_model_dir`` must reproduce. ``kwargs`` go to
    ``Model.from_configs``."""
    src = reference_sources(preset, seed, control)
    serving = {name: convert.to_state_dict(convert.to_variables(src[name].state_dict()))
               for name in ("decoder", "encoder")}
    serving["flow"] = {f"{part}.{k}": v for part in ("flow", "embedder")
                       for k, v in src[part].state_dict().items()}
    stage2, stage1, ae = configs(preset, control)
    return Model.from_configs(stage2, stage1, ae, vid_length, seed=seed, state_dicts=serving,
                              **kwargs)


def make_reference_model_dir(root: str, preset: str = "tiny", seed: int = 0,
                             control: bool = False) -> str:
    """A model directory as the reference's trainers leave it: the yamls (the
    stage-2 config chained to ``root/stage1`` and ``root/AE``) and
    ``stage1/best_PFVD_{GEN,ENC}.pth`` (``{"epoch", "state_dict"}``),
    ``AE/Encoder_stage2.pth`` and ``stage2/cINN.pth`` (bare state dicts), in
    the reference's key layout, from ``reference_sources``. Returns the
    stage-2 directory."""
    stage2, stage1, ae = configs(preset, control)
    chain = root.rstrip("/") + "/"
    stage2 = Config(dict(stage2.to_dict(), First_stage_model={
        "checkpoint_encoder": "best_PFVD_ENC", "checkpoint_decoder": "best_PFVD_GEN",
        "model_name": "stage1", "model_path": chain}))
    stage2.Conditioning_Model.update(checkpoint_name="Encoder_stage2", model_name="AE",
                                     model_path=chain)
    ae = Config(dict(ae.to_dict(), deterministic=False, in_size=PRESETS[preset]["img_size"],
                     use_actnorm_in_dec=False, pre_process=False, pretrained=False))
    src = reference_sources(preset, seed, control)
    dirs = {name: os.path.join(root, name) for name in ("stage1", "AE", "stage2")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    cfg.save(stage1, os.path.join(dirs["stage1"], "config_stage1.yaml"))
    cfg.save({"AE": ae}, os.path.join(dirs["AE"], "config_stage2_AE.yaml"))
    cfg.save(stage2, os.path.join(dirs["stage2"], "config_stage2.yaml"))

    def tree(name: str) -> dict:
        return convert.to_variables(src[name].state_dict())

    convert.save_reference(os.path.join(dirs["stage1"], "best_PFVD_GEN.pth"), convert.to_reference(
        convert.convert_stage1_generator, tree("decoder")), wrap=True)
    convert.save_reference(os.path.join(dirs["stage1"], "best_PFVD_ENC.pth"), convert.to_reference(
        convert.convert_stage1_encoder, tree("encoder"),
        stage1.Encoder["res_type_encoder"]), wrap=True)
    convert.save_reference(os.path.join(dirs["AE"], "Encoder_stage2.pth"), convert.to_reference(
        convert.convert_resnet_encoder, tree("embedder"), ae["encoder_type"], ae["norm"]))
    p = PRESETS[preset]
    convert.save_reference(os.path.join(dirs["stage2"], "cINN.pth"), convert.to_reference(
        convert.convert_conditional_flow, tree("flow"), p["n_flows"], 2, p["z_dim"],
        p["cond_z"] + (30 if control else 0), control))
    return dirs["stage2"]


def reference_backbone(kind: str, seed: int = 0) -> torch.nn.Module:
    """A random full-size metric network of ``kind`` (a ``convert_weights``
    kind: i3d, i3d_tf, dti3d16, dti3d32, fid, lpips) drawn from ``seed``, as
    its reference file holds it: the DT nets with their 18-class ``logits``
    head, the TF-hub I3D with unit batch-norm scales (its graph has none)."""
    from .metrics.inception import InceptionV3FID
    from .models.backbones.i3d import I3D
    from .models.backbones.lpips import LPIPS

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if kind in ("i3d", "i3d_tf"):
            module = I3D(num_classes=400)
        elif kind in ("dti3d16", "dti3d32"):
            module = I3D(num_classes=18, avg_pool_t=2 if kind == "dti3d16" else 4, bn_eps=1e-5)
        elif kind == "fid":
            module = InceptionV3FID()
        elif kind == "lpips":
            module = LPIPS()
        else:
            raise ValueError(kind)
        # drawn as trained weights look, so activations keep their scale
        # through the depth: kernels N(0, 2 / fan_in) (LPIPS's 1x1 heads
        # non-negative), biases and frozen batch norms near (1, 0, 0, 1)
        for name, t in module.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight" and t.dim() >= 3:
                t.normal_(0.0, (2.0 / t[0].numel()) ** 0.5)
                if name.startswith("lin"):
                    t.abs_()
            elif leaf in ("bias", "bn_bias", "bn_mean"):
                t.normal_(0.0, 0.05)
            elif leaf == "bn_scale":
                t.uniform_(0.8, 1.2)
            elif leaf == "bn_var":
                t.uniform_(0.5, 1.5)
    if kind == "i3d_tf":
        for name, t in module.state_dict().items():
            if name.endswith("bn_scale"):
                t.fill_(1.0)
    return module.eval()


REFERENCE_CONVERTERS = {"i3d": convert.convert_i3d_kinetics, "i3d_tf": convert.convert_i3d_tf_hub,
                        "dti3d16": convert.convert_i3d_dt, "dti3d32": convert.convert_i3d_dt,
                        "fid": convert.convert_inception_fid, "lpips": convert.convert_lpips}


def write_reference_backbone(kind: str, path: str, seed: int = 0,
                             vgg_path: str | None = None) -> torch.nn.Module:
    """Write ``reference_backbone(kind, seed)`` to ``path`` in its reference
    layout (kinetics ``model_rgb.pth``; DT ``I3D_*.pth.tar`` as
    ``{"state_dict"}``; pytorch-fid's inception; LPIPS's ``vgg.pth`` heads
    with torchvision's vgg16 at ``vgg_path``; the TF-hub I3D's variables as an
    ``.npz``) and return the module."""
    module = reference_backbone(kind, seed)
    tree = convert.to_variables(module.state_dict())
    sd = convert.to_reference(REFERENCE_CONVERTERS[kind], tree)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if kind == "i3d_tf":
        np.savez(path, **sd)
    elif kind == "lpips":
        convert.save_reference(path, sd[0])
        convert.save_reference(vgg_path, sd[1])
    else:
        convert.save_reference(path, sd, wrap=kind.startswith("dti3d"))
    return module
