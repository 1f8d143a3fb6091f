"""Presets and an in-memory model builder (port of ``testing.py``).

``PRESETS`` are the JAX package's architecture presets ('tiny' for tests,
'bair' the reference BAIR architecture at full size, 'landscape' the 128 px
one). ``build_model`` makes a sampling ``Model`` from a preset with random
torch weights drawn from a seed, with no checkpoint directory and no YAML
reader: the configs are built in memory, with the keys of the saved ones.

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
from .models.facade import Model
from .utils import convert

PRESETS = {
    "tiny": dict(
        img_size=32, seq_length=9, z_dim=16, nf=16,
        enc_channels=[16, 32, 32, 32, 32], enc_stride_t=[1, 2, 2, 2], enc_stride_s=[1, 2, 2, 1],
        upsample_s=[1, 1], upsample_t=[1, 1],
        n_flows=4, flow_factor=4, cond_z=16, ae_type="resnet18",
    ),
    # reference landscape/DTDB-style 128 px architecture
    "landscape": dict(
        img_size=128, seq_length=17, z_dim=64, nf=32,
        enc_channels=[64, 128, 128, 256, 512], enc_stride_t=[1, 2, 2, 2],
        enc_stride_s=[2, 2, 2, 2],
        upsample_s=[2, 2], upsample_t=[2, 1],
        n_flows=20, flow_factor=8, cond_z=128, ae_type="resnet50", ae_norm="bn",
    ),
    # reference BAIR architecture (stage1_VAE, stage2_cINN and stage2_cINN/AE
    # bair_config.yaml)
    "bair": dict(
        img_size=64, seq_length=17, z_dim=64, nf=64,
        enc_channels=[64, 128, 256, 512, 512], enc_stride_t=[1, 2, 2, 2],
        enc_stride_s=[1, 2, 2, 2],
        upsample_s=[2, 1], upsample_t=[2, 1],
        n_flows=20, flow_factor=8, cond_z=64, ae_type="resnet50",
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
                data_parallel: bool | list = False) -> Model:
    """A ``Model`` of ``preset`` with random weights drawn from ``seed``."""
    stage2, stage1, ae = configs(preset, control)
    return Model.from_configs(stage2, stage1, ae, vid_length, transfer=transfer, seed=seed,
                              use_kernel=use_kernel, compute_dtype=compute_dtype, device=device,
                              data_parallel=data_parallel)


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
