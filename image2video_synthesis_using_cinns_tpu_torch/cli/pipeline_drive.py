"""The reference workflow from an empty disk, with the port (the flags of
``scripts/pipeline_drive.py``)::

    python -m image2video_synthesis_using_cinns_tpu_torch.cli.pipeline_drive --root /tmp/pipe \
        [--preset tiny] [--steps 3] [--n-videos 6] [--bs 3] [-device cuda]

On a synthetic BAIR dataset (``testing.make_bair_data_dir``) it

1. trains the stage-1 video VAE (``train.stage1.main``);
2. trains the stage-2 conditioning AE (``train.stage2_ae.main``);
3. trains the cINN on a config that points at the directories those two
   runs wrote (``train.stage2.main``);
4. runs the ``generate_samples`` CLI on the cINN's directory (a GIF);
5. runs the eval CLI on it (the generation protocol; the scores too where
   ``weights_root`` holds the backbones);
6. builds ``Model`` from it and samples one batch.

No checkpoint directory in the chain is fabricated: each file a trainer
writes is asserted where the next consumer looks for it
(``best_PFVD_{GEN,ENC}.msgpack`` and ``config_stage1.yaml`` for the stage-2
trainers, ``Encoder_stage2.msgpack`` and ``config_stage2_AE.yaml`` for the
cINN's embedder, ``cINN.msgpack`` and ``config_stage2.yaml`` for ``Model``),
so that a drift between what one stage writes and what the next reads
fails here. Everything runs on ``cuda`` unless ``-device`` (``device=``)
asks for another device; the CLIs run from ``root``, where they read
``assets/`` and ``models/``. Prints the artifacts, then ``PIPELINE OK``.
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import time

import numpy as np
import torch

GT_FRAMES = 4  # start frames the generate CLI samples from


def run_pipeline(root: str, preset: str = "tiny", steps: int = 3, n_videos: int = 6,
                 bs: int = 3, vid_length: int | None = None, device=None,
                 weights_root: str | None = None) -> dict:
    """Run the chain under ``root`` on ``device``; returns the artifacts'
    paths, the eval CLI's scores (``eval``), the ``Model`` built from the
    cINN's directory (``model``), its video's shape and each stage's wall
    seconds (``seconds``). Raises where a trainer-written
    artifact is missing where the next consumer looks for it.
    ``weights_root``: a directory of backbone weights (``models/``'s layout)
    for the eval CLI's FID, LPIPS, DTFVD (16 frames) and FVD (16 clips or
    more); without it the CLI runs the protocol and scores nothing."""
    from ..models.facade import Model, resolve_device
    from ..testing import (PRESETS, make_bair_data_dir, stage1_config, stage2_ae_config,
                           stage2_config)
    from ..train import stage1, stage2, stage2_ae
    from . import eval_synthesis_quality, generate_samples

    dev = resolve_device(device)
    p = PRESETS[preset]
    seconds: dict[str, float] = {}

    def timed(stage: str, fn):
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds[stage] = time.perf_counter() - t0
        return out

    def expect(run_dir: str, files: tuple, who: str) -> None:
        for f in files:
            if not os.path.exists(os.path.join(run_dir, f)):
                raise FileNotFoundError(f"{who} did not write {f} in {run_dir}")

    data_dir = timed("data", lambda: make_bair_data_dir(
        os.path.join(root, "data") + "/", n_videos=n_videos, img=p["img_size"],
        modes=("train", "eval", "test")))
    out: dict = {"data": data_dir}

    def common(opt, runs: str):
        opt.Data["data_path"] = data_dir
        opt.Training.update(bs=bs, bs_eval=bs, workers=2, n_epochs=1,
                            save_path=os.path.join(root, runs))
        return opt

    # 1. the stage-1 video VAE
    opt1 = common(stage1_config(p), "stage1_runs")
    s1 = timed("stage1", lambda: stage1.main(opt1, max_steps=steps, eval_fvd=False,
                                             device=dev)["save_path"])
    expect(s1, ("config_stage1.yaml", "best_PFVD_GEN.msgpack", "best_PFVD_ENC.msgpack"),
           "the stage-1 trainer")
    out["stage1"] = s1

    # 2. the stage-2 conditioning AE
    opt_ae = common(stage2_ae_config(p), "ae_runs")
    if p["img_size"] < 64:
        # the BigGAN decoder exists at 64 and 128 px only and needs z_dim > 10 x
        # its blocks: the AE trains at the smallest real size, and the embedder
        # the cINN reads pools adaptively, so it serves any image size
        opt_ae.AE.update(in_size=64, z_dim=64, chn=8, encoder_type="resnet18")
        opt_ae.Data["img_size"] = 64
    ae = timed("ae", lambda: stage2_ae.main(opt_ae, max_steps=steps, device=dev)["save_path"])
    expect(ae, ("config_stage2_AE.yaml", "Encoder_stage2.msgpack"), "the AE trainer")
    out["ae"] = ae

    # 3. the cINN from the two directories just written; the conditioning
    # width must be the trained AE's (its architecture comes from its config)
    opt2 = common(stage2_config(p, s1, ae), "stage2_runs")
    opt2.Conditioning_Model["z_dim"] = opt_ae.AE["z_dim"]
    s2 = timed("stage2", lambda: stage2.main(opt2, max_steps=steps, eval_fvd=False,
                                             device=dev)["save_path"])
    expect(s2, ("config_stage2.yaml", "cINN.msgpack", "cINN_latest.msgpack"),
           "the cINN trainer")
    out["stage2"] = s2

    # 4. the generate CLI: start frames from ./assets/GT_samples/bair/, the GIF
    # to ./assets/results/bair/, both under the working directory
    T = vid_length or p["seq_length"] - 1
    gt_dir = os.path.join(root, "assets", "GT_samples", "bair")
    os.makedirs(gt_dir, exist_ok=True)
    starts = sorted(glob.glob(os.path.join(data_dir, "test", "traj_0", "*", "0.png")))
    for k, src in enumerate(starts[:GT_FRAMES]):
        shutil.copy(src, os.path.join(gt_dir, f"start_{k}.png"))
    serving = ["-ckpt_path", s2 + "/", "-seq_length", str(T), "-bs", str(bs),
               "-device", str(dev)]
    metrics = []
    if weights_root is not None:
        link = os.path.join(root, "models")
        if not os.path.exists(link):
            os.symlink(os.path.abspath(weights_root), link)
        metrics = ["-FID", "1", "-LPIPS", "1"]
        metrics += ["-DTFVD", "1"] if T >= 16 else []
        metrics += ["-FVD", "1"] if n_videos >= 16 else []
    cwd = os.getcwd()
    try:
        os.chdir(root)
        timed("generate", lambda: generate_samples.main(["-dataset", "bair", *serving]))
        gif = os.path.join(root, "assets", "results", "bair", "results.gif")
        if not os.path.exists(gif):
            raise FileNotFoundError(f"the generate CLI wrote no {gif}")
        out["gif"] = gif
        # 5. the eval CLI on the trained directory
        out["eval"] = timed("eval", lambda: eval_synthesis_quality.main(
            ["-dataset", "bair", "-data_path", data_dir, *serving, *metrics]))
    finally:
        os.chdir(cwd)

    # 6. Model straight from the trained directory: shape and range
    def sample():
        model = Model(s2 + "/", vid_length=T, seed=0, device=dev)
        x0 = np.random.default_rng(0).uniform(
            -1, 1, (2, 3, p["img_size"], p["img_size"])).astype(np.float32)
        return model, model(x0).cpu().numpy()

    out["model"], video = timed("model", sample)
    if video.shape != (2, T, 3, p["img_size"], p["img_size"]):
        raise AssertionError(f"Model from {s2}: video of shape {video.shape}")
    if not (np.isfinite(video).all() and np.abs(video).max() <= 1.0):
        raise AssertionError(f"Model from {s2}: video not finite in [-1, 1]")
    out["video_shape"] = video.shape
    out["seconds"] = seconds
    return out


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", required=True, help="working directory")
    ap.add_argument("--preset", default="tiny", help="testing.PRESETS key")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--n-videos", type=int, default=6)
    ap.add_argument("--bs", type=int, default=3)
    ap.add_argument("-device", type=str, default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)

    os.makedirs(args.root, exist_ok=True)
    out = run_pipeline(args.root, preset=args.preset, steps=args.steps,
                       n_videos=args.n_videos, bs=args.bs, device=args.device)
    print({k: str(v) for k, v in out.items() if k != "model"})
    print("PIPELINE OK")
    return out


if __name__ == "__main__":
    main()
