"""Write the per-dataset training configs (the port of ``scripts/gen_configs.py``)::

    python -m image2video_synthesis_using_cinns_tpu_torch.cli.gen_configs [--out <root>]

Writes ``<root>/configs/{stage1,stage2,stage2_AE}/<dataset>_config.yaml`` for
the seven datasets and ``<root>/configs/stage2/bair_control_config.yaml``, 22
files, byte for byte those that ``scripts/gen_configs.py`` writes (the same
header, PyYAML's layout through ``config.save(..., pyyaml=True)``). The
values mirror the reference's configs, so saved-config chaining stays
compatible; ``--out`` defaults to the repository's root, where the committed
``configs/`` lives.
"""

from __future__ import annotations

import argparse
import io
import os

from .. import config as cfg

HEADER = (
    "# Generated by scripts/gen_configs.py for the TPU-native framework.\n"
    "# Section names and values track the corresponding reference config\n"
    "# so saved-config chaining stays compatible across implementations.\n"
)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (dataset key, stage1 overrides, stage2 overrides, AE overrides)
DATASETS = {
    "bair": dict(
        data=dict(dataset="BAIR", img_size=64, reverse=False),
        aug=dict(brightness=0.1, contrast=0.1, saturation=0.1, hue=0, prob_hflip=0.5),
        s1=dict(w_percep=30, w_kl=1e-5, w_recon=10, n_epochs=55, bs=10, workers=20,
                FVD="FVD", nf=64, enc_channels=[64, 128, 256, 512, 512],
                enc_stride_s=[1, 2, 2, 2], upsample_s=[2, 1],
                disc_channels=[64, 64, 128, 256, 512], disc_stride_s=[1, 1, 2, 2]),
        s2=dict(cond_z=64, step_size=7, workers=30),
        ae=dict(norm="in", z_dim=64, w_kl=1e-5, n_epochs=60,
                aug=dict(brightness=0.2, contrast=0.2, saturation=0.2, hue=0.1, prob_hflip=0.5)),
    ),
    "iPER": dict(
        data=dict(dataset="iPER", img_size=64, test_size=1000, iter_train=60, iter_eval=15),
        aug=dict(brightness=0.2, contrast=0.2, saturation=0.2, hue=0, prob_hflip=0.5),
        s1=dict(w_percep=40, w_kl=1e-4, w_recon=10, n_epochs=100, bs=10, workers=20,
                FVD="FVD", nf=64, enc_channels=[64, 128, 256, 512, 512],
                enc_stride_s=[1, 2, 2, 2], upsample_s=[2, 1],
                disc_channels=[64, 64, 128, 256, 512], disc_stride_s=[1, 1, 2, 2]),
        s2=dict(cond_z=128, step_size=7, workers=30,
                data_extra=dict(iter_train=80, iter_eval=15)),
        ae=dict(norm="in", z_dim=128, w_kl=1e-5, n_epochs=60,
                aug=dict(brightness=0.2, contrast=0.2, saturation=0.2, hue=0.1, prob_hflip=0.5)),
    ),
    "landscape": dict(
        data=dict(dataset="landscape", img_size=128, iter_train=10, iter_eval=7, iter_test=6),
        aug=dict(brightness=0.3, contrast=0.3, saturation=0.3, hue=0.15, prob_hflip=0.5),
        s1=dict(w_percep=30, w_kl=1e-6, w_recon=20, n_epochs=100, bs=7, workers=14,
                FVD="DTFVD", nf=32, enc_channels=[64, 128, 128, 256, 512],
                enc_stride_s=[2, 2, 2, 2], upsample_s=[2, 2],
                disc_channels=[64, 64, 128, 256, 512], disc_stride_s=[1, 2, 2, 2]),
        s2=dict(cond_z=128, step_size=6, workers=12,
                data_extra=dict(iter_train=20, iter_eval=7, iter_test=6)),
        ae=dict(norm="bn", z_dim=128, w_kl=1e-4, n_epochs=200,
                aug=dict(brightness=0.3, contrast=0.3, saturation=0.3, hue=0.10, prob_hflip=0.5),
                data_extra=dict(iter_train=20, iter_eval=2, iter_test=6)),
    ),
}

# DTDB textures share the architecture; per-texture knobs below
DTDB_TEXTURES = {
    "fire": dict(image_format="jpg", s1_iter_train=80, s2_iter_train=40),
    "clouds": dict(image_format="png", s1_iter_train=80, s2_iter_train=50),
    "vegetation": dict(image_format="jpg", s1_iter_train=80, s2_iter_train=40),
    "waterfall": dict(image_format="jpg", s1_iter_train=80, s2_iter_train=40),
}

for tex, knobs in DTDB_TEXTURES.items():
    DATASETS[f"DTDB_{tex}"] = dict(
        data=dict(dataset="DTDB", img_size=128, texture=tex,
                  image_format=knobs["image_format"],
                  iter_train=knobs["s1_iter_train"], iter_eval=5, iter_test=6),
        aug=dict(brightness=0.3, contrast=0.3, saturation=0.3, hue=0.15, prob_hflip=0.5),
        s1=dict(w_percep=30, w_kl=1e-6, w_recon=10, n_epochs=60, bs=7, workers=12,
                FVD="DTFVD", nf=32, enc_channels=[64, 64, 128, 256, 512],
                enc_stride_s=[2, 2, 2, 2], upsample_s=[2, 2],
                disc_channels=[64, 64, 128, 256, 512], disc_stride_s=[1, 2, 2, 2]),
        s2=dict(cond_z=128, step_size=6, workers=12,
                data_extra=dict(iter_train=knobs["s2_iter_train"], iter_eval=5, iter_test=5)),
        ae=dict(norm="bn", z_dim=128, w_kl=1e-4, n_epochs=200,
                aug=dict(brightness=0.3, contrast=0.3, saturation=0.3, hue=0.10, prob_hflip=0.5),
                data_extra=dict(iter_train=20, iter_eval=2, iter_test=6)),
    )

LOGGING = {"entity": "INSERT_WANDB_NAME", "project": "INSERT_PROJECT_NAME", "mode": "online"}
FIRST_STAGE = {"checkpoint_encoder": "best_PFVD_ENC", "checkpoint_decoder": "best_PFVD_GEN",
               "model_name": "save_name_stage1/", "model_path": "path_stage1"}


def data_section(d: dict, aug: dict, seq_len: int = 17, extra: dict | None = None):
    out = {"sequence_length": seq_len, **d, "aug": True,
           "data_path": "INSERT_DATA_PATH_HERE",
           # off | auto | <path>: packed uint8 frame cache (data/framestore.py)
           # replacing per-epoch image decoding in the input pipeline
           "framestore": "off",
           "Augmentation": dict(aug)}
    if extra:
        out.update(extra)
    return out


def stage1(spec: dict) -> dict:
    d, aug, s1 = spec["data"], spec["aug"], spec["s1"]
    return {
        "Decoder": {"channel_factor": s1["nf"], "z_dim": 64,
                    "upsample_s": s1["upsample_s"], "upsample_t": [2, 1],
                    "spectral_norm": True},
        "Encoder": {"res_type_encoder": "resnet18", "deterministic": False,
                    "use_max_pool": False, "z_dim": 64,
                    "channels": s1["enc_channels"], "stride_t": [1, 2, 2, 2],
                    "stride_s": s1["enc_stride_s"]},
        "Discriminator_Temporal": {"eval_seq_length": 16,
                                   "res_type_encoder": "resnet18",
                                   "deterministic": False, "use_max_pool": True,
                                   "channels": s1["disc_channels"],
                                   "stride_t": [2, 2, 2, 2],
                                   "stride_s": s1["disc_stride_s"],
                                   "spectral_norm": True},
        "Discriminator_Patch": {"in_channels": 3, "ndf": 64, "n_layers": 3,
                                "use_actnorm": True, "spectral_norm": True},
        "Training": {"patch_GAN": "basic", "GAN_Loss": "hinge", "w_coup_s": 1,
                     "w_coup_t": 1, "w_fmap_t": 10, "w_percep": s1["w_percep"],
                     "w_recon": s1["w_recon"], "w_GP": 10, "w_kl": s1["w_kl"],
                     "subsample_length": 12, "pretrain": 1,
                     "n_epochs": s1["n_epochs"], "lr": 2e-4,
                     "workers": s1["workers"], "bs": s1["bs"], "bs_eval": 10,
                     "verbose_idx": 30, "weight_decay": 1e-5, "lr_gamma": 0.98,
                     "FVD": s1["FVD"], "savename": "INSERT_NAME_HERE",
                     "save_path": "INSERT_PATH_HERE", "reload_path": ""},
        "Data": data_section(d, aug),
        "Logging": dict(LOGGING),
    }


def stage2(spec: dict, control: bool = False) -> dict:
    """The cINN's config; ``control``: the endpoint-control variant (BAIR)."""
    d, aug, s2 = spec["data"], spec["aug"], spec["s2"]
    training = {"n_epochs": 31, "lr": 1e-5, "workers": s2["workers"], "bs": 50,
                "bs_eval": 10, "control": control}
    if control:
        training["control_dim"] = 3
    training.update({"verbose_idx": 30, "weight_decay": 0, "gamma": 0.5,
                     "step_size": s2["step_size"], "beta1": 0.9, "beta2": 0.99,
                     "amsgrad": True, "steps_per_dispatch": 8,
                     "savename": "INSERT_NAME_HERE", "save_path": "INSERT_PATH_HERE"})
    return {
        "Flow": {"n_flows": 20, "flow_hidden_depth": 2, "flow_mid_channels_factor": 8},
        "Conditioning_Model": {"z_dim": s2["cond_z"],
                               "checkpoint_name": "Encoder_stage2",
                               "model_name": "save_name_AE_conditioning/",
                               "model_path": "path_AE_conditioning"},
        "First_stage_model": dict(FIRST_STAGE),
        "Training": training,
        "Data": data_section(d, aug, extra=None if control else s2.get("data_extra")),
        "Logging": dict(LOGGING),
    }


def stage2_ae(spec: dict) -> dict:
    d, ae = spec["data"], spec["ae"]
    return {
        "AE": {"deterministic": False, "in_size": d["img_size"],
               "norm": ae["norm"], "encoder_type": "resnet50",
               "use_actnorm_in_dec": False, "z_dim": ae["z_dim"],
               "pre_process": False, "pretrained": False},
        "Discriminator_Patch": {"in_channels": 3, "ndf": 64, "n_layers": 3,
                                "use_actnorm": True, "spectral_norm": True},
        "Training": {"w_kl": ae["w_kl"], "n_epochs": ae["n_epochs"], "lr": 2e-4,
                     "bs": 30, "weight_decay": 0, "workers": 30, "pretrain": 20,
                     "steps_per_dispatch": 8,
                     "savename": "INSERT_NAME_HERE",
                     "save_path": "INSERT_PATH_HERE"},
        "Data": data_section(d, ae["aug"], seq_len=1, extra=ae.get("data_extra")),
        "Logging": dict(LOGGING),
    }


def configs() -> dict[str, dict]:
    """Every config by its path under the root, in the JAX script's order."""
    out = {}
    for name, spec in DATASETS.items():
        out[f"configs/stage1/{name}_config.yaml"] = stage1(spec)
        out[f"configs/stage2/{name}_config.yaml"] = stage2(spec)
        out[f"configs/stage2_AE/{name}_config.yaml"] = stage2_ae(spec)
    out["configs/stage2/bair_control_config.yaml"] = stage2(DATASETS["bair"], control=True)
    return out


def write(path: str, conf: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    buf = io.StringIO()
    cfg.save(cfg.Config(conf), buf, pyyaml=True)
    with open(path, "w") as f:
        f.write(HEADER + buf.getvalue())
    print("wrote", path)


def main(argv: list[str] | None = None) -> list[str]:
    """Writes every config under ``--out``; returns their paths."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=REPO_ROOT, help="root directory of configs/")
    args = ap.parse_args(argv)
    paths = []
    for rel, conf in configs().items():
        path = os.path.join(args.out, rel)
        write(path, conf)
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
