"""A tiny copy of the benchmark for CPU tests: the port's ``tiny`` preset as
configuration files, the three traffic mixes at small batches, and a
``BENCHMARK.json`` naming them, written into a directory of its own."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent

TINY = {
    "name": "tiny",
    "source": "the port's tiny test preset",
    "reduced": [],
    "precision": {"decoder": "bfloat16", "chain_weights": "bfloat16", "embedder": "float32",
                  "encoder": "float32", "train": "float32"},
    "Data": {"img_size": 32, "sequence_length": 9,
             "Augmentation": {"brightness": 0.1, "contrast": 0.1, "saturation": 0.1, "hue": 0,
                              "prob_hflip": 0.5}},
    "Decoder": {"channel_factor": 16, "z_dim": 16, "upsample_s": [1, 1], "upsample_t": [1, 1],
                "spectral_norm": True},
    "Encoder": {"res_type_encoder": "resnet18", "deterministic": False, "use_max_pool": False,
                "z_dim": 16, "channels": [16, 32, 32, 32, 32], "stride_t": [1, 2, 2, 2],
                "stride_s": [1, 2, 2, 1]},
    "Discriminator_Temporal": {"eval_seq_length": 16, "res_type_encoder": "resnet18",
                               "deterministic": False, "use_max_pool": True,
                               "channels": [16, 16, 32, 32, 32], "stride_t": [2, 2, 2, 2],
                               "stride_s": [1, 1, 2, 1], "spectral_norm": True},
    "Discriminator_Patch": {"in_channels": 3, "ndf": 16, "n_layers": 3, "use_actnorm": True,
                            "spectral_norm": True},
    "Training": {"patch_GAN": "basic", "GAN_Loss": "hinge", "w_coup_s": 1, "w_coup_t": 1,
                 "w_fmap_t": 10, "w_percep": 30, "w_recon": 10, "w_GP": 10, "w_kl": 1e-05,
                 "subsample_length": 8, "pretrain": 1, "n_epochs": 55, "lr": 0.0002, "bs": 4,
                 "weight_decay": 1e-05, "lr_gamma": 0.98},
    "Flow": {"n_flows": 4, "flow_hidden_depth": 2, "flow_mid_channels_factor": 4},
    "AE": {"norm": "in", "encoder_type": "resnet18", "z_dim": 16},
}

TRAFFIC = {
    "tiny-sample": {"batch": 3, "vid_length": 12, "keep_calls": 2, "reference_rows": 2},
    "tiny-transfer": {"starts": 3, "query_frames": 9, "vid_length": 12, "keep_calls": 2,
                      "reference_rows": 2},
    "tiny-train": {"batch": 4, "n_clips": 16, "fetch_every": 2, "checked_steps": 3},
}


def tiny_config(**changes) -> dict:
    cfg = json.loads(json.dumps(TINY))
    cfg.update(changes)
    return cfg


def write_root(root: Path, limits: dict | None = None) -> Path:
    """A copy of ``portbench/`` under ``root`` with the tiny configuration,
    the tiny traffic mixes (their runners the real ones) and a
    ``BENCHMARK.json`` of three tiny cells, the real metrics beside them."""
    shutil.copytree(HERE, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    (root / "portbench" / "configs" / "tiny.json").write_text(json.dumps(TINY))
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {"sample": "bair-sample-b32", "transfer": "landscape-transfer-n16",
             "train": "bair-train-stage1-b10"}
    workloads = []
    for kind, real_cell in cells.items():
        real_traffic = next(c for c in real["workloads"] if c["name"] == real_cell)["traffic"]
        traffic = json.loads((HERE / "traffic" / f"{real_traffic}.json").read_text())
        traffic.update(TRAFFIC[f"tiny-{kind}"])
        traffic["trace_calls"] = 2
        if limits is not None:
            traffic["limits"] = limits[kind]
        (root / "portbench" / "traffic" / f"tiny-{kind}.json").write_text(json.dumps(traffic))
        workloads.append({"name": f"tiny-{kind}", "config": "tiny", "traffic": f"tiny-{kind}",
                          "chips": 1, "why": "CPU test"})
    rename = {c: f"tiny-{k}" for k, c in cells.items()}
    for key in ("end_to_end", "per_layer"):
        for m in real[key]:
            if "workloads" in m:
                m["workloads"] = [rename[w] for w in m["workloads"]]
    bench = dict(real, workloads=workloads,
                 configs=[{"name": "tiny", "source": "tests", "file": "portbench/configs/tiny.json",
                           "reduced": [], "why": "CPU tests"}])
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
