"""Presets and an in-memory model builder (port of ``testing.py``).

``PRESETS`` are the JAX package's architecture presets ('tiny' for tests,
'bair' the reference BAIR architecture at full size, 'landscape' the 128 px
one). ``build_model`` makes a sampling ``Model`` from a preset with random
torch weights drawn from a seed, with no checkpoint directory and no YAML
reader: the configs are built in memory, with the keys of the saved ones.
"""

from __future__ import annotations

from .config import Config
from .models.facade import Model

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
    sampling and transfer paths."""
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
    })
    return stage2, stage1, ae


def build_model(preset: str = "bair", vid_length: int = 16, seed: int = 0,
                use_kernel: bool = True, compute_dtype: str = "float32",
                control: bool = False, transfer: bool = False, device=None) -> Model:
    """A ``Model`` of ``preset`` with random weights drawn from ``seed``."""
    stage2, stage1, ae = configs(preset, control)
    return Model.from_configs(stage2, stage1, ae, vid_length, transfer=transfer, seed=seed,
                              use_kernel=use_kernel, compute_dtype=compute_dtype, device=device)
