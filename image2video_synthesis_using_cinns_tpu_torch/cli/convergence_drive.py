"""Long-horizon convergence drives (the port of ``scripts/convergence_drive.py``).

Each drive runs one trainer's real step for O(10^3) optimisation steps on
synthetic moving-square clips (deterministic dynamics, so there is something
to learn), prints the loss curves and returns a summary with the JAX drive's
keys::

    python -m image2video_synthesis_using_cinns_tpu_torch.cli.convergence_drive stage1 --steps 1000
    python -m image2video_synthesis_using_cinns_tpu_torch.cli.convergence_drive stage2 --steps 400
    python -m image2video_synthesis_using_cinns_tpu_torch.cli.convergence_drive ae --steps 1000 \\
        --json ae.json --compare docs/evidence/convergence_ae_r5.json

* ``stage1``: ``train.stage1_step.Stage1Step`` at ``compute_dtype:
  bfloat16`` with three ``Adam(betas=(0.5, 0.9))`` and the gates open
  (epoch = ``pretrain``), after the patch discriminator's ActNorm init on the
  first batch's first 20 frames.
* ``stage2``: a frozen ``Encoder`` and a ``SupervisedTransformer``,
  ``train.stage2.train_step`` with AMSGrad ``Adam(lr, betas=(0.9, 0.99))``,
  the train augment at brightness, contrast and saturation 0.1, after the
  flow's ActNorm init on the first batch's posterior.
* ``ae``: ``train.stage2_ae.AEStep`` with the discriminator live (epoch =
  ``pretrain``), after its ActNorm init on the first batch. At presets below
  64 px the AE runs at the smallest real BigGAN size (64 px, z 64, chn 8,
  resnet18), as the JAX drive does.

The clips stay on the device as ``--pool`` chunks of ``k`` uint8 batches,
cycled; their batch indices are the JAX drive's ``default_rng(0)`` draws, so
the chunks are its chunks. The step runs one optimisation step a call; the
metrics stay on the device and are fetched once every ``k`` steps, where the
JAX drive, which scans ``k`` steps in one TPU program, fetches them. The
augment and posterior draws come from the trainers' ``Draws`` (CPU
generators keyed by step; a test injects the JAX drive's keys). The drives
run no validation or sampling, so they launch no flow chain.

``--json PATH`` writes ``{"which", "preset", "steps", "bs", "k", "metrics"}``
as the JAX drive does; ``--compare PATH`` diffs the run against such an
artifact (the JAX drive's loose slack) and exits 1 with ``REGRESSION`` lines
when convergence degraded. Everything runs on ``cuda`` unless ``-device``
asks for another device; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

STAGE2_AUGMENT = {"brightness": 0.1, "contrast": 0.1, "saturation": 0.1, "hue": 0}
N_CLIPS = 64  # the synthetic clips the drives sample their batches from


def moving_squares(n, T, img, seed=0):
    """``n`` uint8 clips (T, img, img, 3): an 8 px square on a static noise
    background, moving by (dx, dy) a frame."""
    rng = np.random.default_rng(seed)
    clips = np.zeros((n, T, img, img, 3), np.uint8)
    for i in range(n):
        x0, y0 = rng.integers(0, img - 8, 2)
        dx, dy = rng.integers(-2, 3, 2)
        base = rng.integers(0, 40, (img, img, 3)).astype(np.uint8)
        for f in range(T):
            fr = base.copy()
            xx = int(np.clip(x0 + f * dx, 0, img - 8))
            yy = int(np.clip(y0 + f * dy, 0, img - 8))
            fr[yy : yy + 8, xx : xx + 8] = [250, 120, 30]
            clips[i, f] = fr
    return clips


def steps_to(series, thresh, window=20, below=True):
    """First step index whose trailing-``window`` mean crosses ``thresh``
    (None if never) — the 'steps-to-threshold' field of the JSON artifact."""
    s = np.asarray(series, np.float64)
    for i in range(window, len(s)):
        m = s[i - window : i].mean()
        if (m < thresh) if below else (m > thresh):
            return i
    return None


def chunk_pool(clips: np.ndarray, k: int, bs: int, pool: int, device) -> list[torch.Tensor]:
    """``pool`` device-resident uint8 chunks (k, bs, T, H, W, 3) of ``clips``,
    at the JAX drive's batch indices."""
    rng = np.random.default_rng(0)
    return [torch.from_numpy(clips[rng.integers(0, clips.shape[0], (k, bs))]).to(device)
            for _ in range(pool)]


def raw_batch(chunks: list[torch.Tensor], gstep: int) -> torch.Tensor:
    """Step ``gstep``'s uint8 batch: the chunks cycled, k steps each."""
    k = chunks[0].shape[0]
    return chunks[(gstep // k) % len(chunks)][gstep % k]


def ae_config(preset: str):
    """The AE trainer's config of ``preset`` and its image size: at presets
    below 64 px the smallest real BigGAN size (the decoder exists at 64 and
    128 px only and needs z_dim > 10 x its blocks)."""
    from ..testing import PRESETS, stage2_ae_config

    ae_cfg = stage2_ae_config(PRESETS[preset])
    img = PRESETS[preset]["img_size"]
    if img < 64:
        ae_cfg.AE.update(in_size=64, z_dim=64, chn=8, encoder_type="resnet18")
        img = 64
    return ae_cfg, img


def stage2_models(preset: str):
    """The stage-2 drive's config and modules, on the CPU: the cINN's
    config, the frozen ``Encoder`` (seed 0) and the ``SupervisedTransformer``
    (seed 1)."""
    from ..models.stage1.resnet3d import Encoder
    from ..models.stage2.inn import SupervisedTransformer
    from ..testing import PRESETS, stage1_config, stage2_ae_config, stage2_config

    p = PRESETS[preset]
    s1, ae = stage1_config(p), stage2_ae_config(p)
    s2 = stage2_config(p, "/tmp/s1", "/tmp/ae")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        encoder = Encoder.from_config(s1.Encoder)
        torch.manual_seed(1)
        network = SupervisedTransformer.from_configs(s2, s1.Decoder, ae.AE)
    return s2, encoder, network


def run_steps(step, steps: int, k: int, device: torch.device, report) -> tuple[dict, float]:
    """``step(gstep)`` for ``steps`` steps: each step's metrics (0-d tensors)
    stay on the device and are fetched in one copy every ``k`` steps;
    ``report(last)`` (``last(key)``: the mean of the last k) prints a line
    every 100 steps. Returns the curves (float64 lists) and the wall seconds."""
    hist: dict[str, list] = {}
    window = []

    def last(key: str) -> float:
        return float(np.mean(hist[key][-k:]))

    t0 = time.time()
    for gstep in range(steps):
        window.append(step(gstep))
        if (gstep + 1) % k and gstep + 1 < steps:
            continue
        keys = list(window[0])
        rows = torch.stack([torch.stack([torch.as_tensor(m[key]).to(device, torch.float32)
                                         for key in keys]) for m in window])
        values = rows.cpu().double().numpy()  # the one wait for the device a window
        for j, key in enumerate(keys):
            hist.setdefault(key, []).extend(values[:, j].tolist())
        window = []
        if (gstep + 1) % 100 == 0:
            print(f"step {gstep + 1:5d}: {report(last)} ({time.time() - t0:.0f}s)", flush=True)
    return hist, time.time() - t0


def _finite(hist: dict) -> bool:
    return all(np.isfinite(np.asarray(v)).all() for v in hist.values())


def train_stage1(preset: str = "bair", steps: int = 1000, bs: int | None = None, k: int = 10,
                 pool: int = 4, device=None, *, n_clips: int = N_CLIPS,
                 compute_dtype: str = "bfloat16", draws=None) -> dict:
    """The stage-1 drive's run: ``{"hist", "wall_s", "build_s"}`` (the curves
    of every ``TRAIN_KEYS`` metric, the steps' wall seconds, the set-up's)."""
    from ..data.augment import build_augment
    from ..models.layers import init_actnorm
    from ..testing import PRESETS, stage1_config
    from ..train import stage1
    from ..train.stage1_step import N_PATCH, Stage1Step, make_optimizers

    dev = _device(device)
    t_build = time.time()
    p = PRESETS[preset]
    opt = stage1_config(p)
    tr = dict(opt.Training, compute_dtype=compute_dtype)
    img, T, z = p["img_size"], p["seq_length"], p["z_dim"]
    bs = bs or int(tr.get("bs", 10))
    draws = draws or stage1.Draws()
    models = stage1.build_models(opt).to(dev)
    epoch = int(tr["pretrain"])  # gates open: all three updates fire
    aug = build_augment(img, {}, False, True)
    chunks = chunk_pool(moving_squares(n_clips, T, img), k, bs, pool, dev)

    def augmented(gstep: int) -> torch.Tensor:
        return aug(raw_batch(chunks, gstep), draws=draws.augment(0, gstep, gstep, bs, {}, False))

    # the patch discriminator's data-dependent ActNorm init on the first
    # batch's first 20 frames, then its optimizer afresh
    seq0 = augmented(0)
    init_actnorm(models.disc_s, seq0.reshape((-1,) + seq0.shape[2:])[:N_PATCH].permute(0, 3, 1, 2))
    step = Stage1Step(models, make_optimizers(models, float(tr["lr"]), 0.0), tr)
    sub_len = int(tr["subsample_length"])
    _sync(dev)
    build_s = time.time() - t_build
    hist, wall_s = run_steps(
        lambda g: step(augmented(g), epoch, draws.step(0, g, g, bs, z, T - 1, sub_len))[0],
        steps, k, dev,
        lambda last: (f"L1 {last('Loss_L1'):.4f} PSNR {last('PSNR'):.2f} "
                      f"D_t {last('Loss_Disc_T'):+.3f} D_s {last('Loss_Disc_S'):+.3f} "
                      f"VAE {last('Loss_VAE'):.3f}"))
    return {"hist": hist, "wall_s": wall_s, "build_s": build_s}


def summarize_stage1(run: dict) -> dict:
    hist = run["hist"]
    for name in ("Loss_Disc_T", "Loss_Disc_S"):
        v = np.asarray(hist[name])
        print(f"{name}: max|.|={np.abs(v).max():.3f} last100 mean={v[-100:].mean():+.4f}")
    l1, ps = np.asarray(hist["Loss_L1"]), np.asarray(hist["PSNR"])
    print(f"L1 first100={l1[:100].mean():.4f} last100={l1[-100:].mean():.4f} "
          f"({1 - l1[-100:].mean() / l1[:100].mean():.1%} better) | "
          f"PSNR first100={ps[:100].mean():.2f} last100={ps[-100:].mean():.2f} "
          f"(+{ps[-100:].mean() - ps[:100].mean():.2f} dB)")
    finite = _finite(hist)
    print(f"all finite: {finite} | total {run['wall_s']:.0f}s")
    return {
        "finite": bool(finite),
        "l1_first100": float(l1[:100].mean()),
        "l1_last100": float(l1[-100:].mean()),
        "psnr_first100": float(ps[:100].mean()),
        "psnr_last100": float(ps[-100:].mean()),
        "max_abs_disc_t": float(np.abs(np.asarray(hist["Loss_Disc_T"])).max()),
        "max_abs_disc_s": float(np.abs(np.asarray(hist["Loss_Disc_S"])).max()),
        "steps_to_l1_70pct": steps_to(l1, 0.7 * float(l1[:100].mean())),
        "wall_s": float(run["wall_s"]),
    }


def train_stage2(preset: str = "bair", steps: int = 1000, bs: int | None = None, k: int = 10,
                 pool: int = 4, lr: float = 1e-4, device=None, *, n_clips: int = N_CLIPS,
                 draws=None) -> dict:
    """The stage-2 drive's run: ``{"hist", "wall_s", "build_s"}`` (the curves
    of the flow loss's terms)."""
    from ..data.augment import build_augment
    from ..testing import PRESETS
    from ..train import stage2
    from ..train.optim import adam_torch

    dev = _device(device)
    t_build = time.time()
    p = PRESETS[preset]
    img, T, z = p["img_size"], p["seq_length"], p["z_dim"]
    s2, encoder, network = stage2_models(preset)
    bs = bs or int(s2.Training.get("bs", 50))
    draws = draws or stage2.Draws()
    encoder = encoder.to(dev).eval().requires_grad_(False)
    network = network.to(dev).eval()
    network.embedder.requires_grad_(False)
    aug = build_augment(img, STAGE2_AUGMENT, False, True)
    chunks = chunk_pool(moving_squares(n_clips, T, img), k, bs, pool, dev)

    def batch(gstep: int):
        seq = aug(raw_batch(chunks, gstep),
                  draws=draws.augment(0, gstep, gstep, bs, STAGE2_AUGMENT, False))
        return seq, stage2.conditioning(seq, None)

    # the flow's ActNorm init on the first batch's posterior, then the optimizer
    seq0, cond0 = batch(0)
    network.init_actnorm(stage2.posterior(encoder, seq0, draws.normal("actnorm", 0, 0, 0, (bs, z))),
                         cond0)
    optimizer = adam_torch(list(network.flow.parameters()), lr, betas=(0.9, 0.99), amsgrad=True)
    _sync(dev)
    build_s = time.time() - t_build
    hist, wall_s = run_steps(
        lambda g: stage2.train_step(network, optimizer, encoder, *batch(g),
                                    draws.normal("posterior", 0, g, g, (bs, z)),
                                    draws.normal("reference", 0, g, g, (bs, z))),
        steps, k, dev,
        lambda last: f"loss {last('Loss'):.3f} ref {last('reference_nll_loss'):.3f}")
    return {"hist": hist, "wall_s": wall_s, "build_s": build_s}


def summarize_stage2(run: dict) -> dict:
    losses, refs = np.asarray(run["hist"]["Loss"]), np.asarray(run["hist"]["reference_nll_loss"])
    l0, lf, lref = losses[:10].mean(), losses[-30:].mean(), refs.mean()
    # reference_nll = mean(0.5 |eps|^2), about z / 2, is what a standard-normal
    # output scores with logdet 0; the data's entropy bounds the NLL, not this
    # floor, so on the low-entropy posteriors of the full size the flow trains
    # far below it: the evidence is the floor crossed and the NLL descending
    cross = steps_to(losses, float(lref))
    finite = bool(np.isfinite(losses).all())
    print(f"L0={l0:.3f} Lref={lref:.3f} Lf={lf:.3f} drop={l0 - lf:.3f} floor crossed at step "
          f"{cross} finite={finite} | total {run['wall_s']:.0f}s")
    return {
        "finite": finite,
        "nll_init": float(l0),
        "nll_final": float(lf),
        "nll_reference": float(lref),
        "nll_drop": float(l0 - lf),
        "steps_to_reference_floor": cross,
        "wall_s": float(run["wall_s"]),
    }


def train_ae(preset: str = "bair", steps: int = 1000, bs: int | None = None, k: int = 10,
             pool: int = 4, device=None, *, n_clips: int = N_CLIPS,
             augment: dict | None = None, draws=None) -> dict:
    """The AE drive's run: ``{"hist", "wall_s", "build_s"}`` (the curves of
    every ``LOG_KEYS`` metric). ``augment``: the colour augment's factors, by
    default the config's."""
    from ..data.augment import build_augment
    from ..models.layers import init_actnorm
    from ..train import stage2_ae

    dev = _device(device)
    t_build = time.time()
    ae_cfg, img = ae_config(preset)
    tr = ae_cfg.Training
    bs = bs or int(tr["bs"])
    draws = draws or stage2_ae.Draws()
    if augment is None:
        a = ae_cfg.Data["Augmentation"]
        augment = {kk: a[kk] for kk in ("brightness", "contrast", "saturation", "hue")}
    aug = build_augment(img, augment, False, True)
    models = stage2_ae.build_models(ae_cfg).to(dev)
    epoch = int(tr["pretrain"])  # the discriminator and the GAN terms live
    # single frames (the AE's Data.sequence_length is 1)
    chunks = chunk_pool(moving_squares(n_clips, 1, img), k, bs, pool, dev)

    def image(gstep: int) -> torch.Tensor:
        seq = aug(raw_batch(chunks, gstep), draws=draws.augment(0, gstep, gstep, bs, augment, False))
        return seq[:, 0].permute(0, 3, 1, 2).contiguous()

    # the patch discriminator's data-dependent ActNorm init on the first
    # batch, then its optimizer afresh
    init_actnorm(models.disc, image(0))
    step = stage2_ae.AEStep(models, stage2_ae.make_optimizers(
        models, float(tr["lr"]), float(tr["weight_decay"])), tr)
    _sync(dev)
    build_s = time.time() - t_build
    hist, wall_s = run_steps(
        lambda g: step(image(g), epoch)[0], steps, k, dev,
        lambda last: (f"recon {last('Loss_recon'):.4f} d_weight {last('Disc_weight'):.3f} "
                      f"L_disc {last('L_disc'):+.4f} logvar {last('Logvar'):+.3f}"))
    return {"hist": hist, "wall_s": wall_s, "build_s": build_s}


def summarize_ae(run: dict) -> dict:
    hist = run["hist"]
    finite = _finite(hist)
    rec, dw, ld = (np.asarray(hist[key]) for key in ("Loss_recon", "Disc_weight", "L_disc"))
    print(f"recon first100={rec[:100].mean():.4f} last100={rec[-100:].mean():.4f} "
          f"({1 - rec[-100:].mean() / rec[:100].mean():.1%} better) | "
          f"d_weight max={dw.max():.3f} last100 mean={dw[-100:].mean():.3f} | "
          f"max|L_disc|={np.abs(ld).max():.3f} | finite={finite} | total {run['wall_s']:.0f}s")
    return {
        "finite": bool(finite),
        "recon_first100": float(rec[:100].mean()),
        "recon_last100": float(rec[-100:].mean()),
        "d_weight_max": float(dw.max()),
        "d_weight_last100": float(dw[-100:].mean()),
        "max_abs_l_disc": float(np.abs(ld).max()),
        "logvar_final": float(np.asarray(hist["Logvar"])[-1]),
        "steps_to_recon_70pct": steps_to(rec, 0.7 * float(rec[:100].mean())),
        "wall_s": float(run["wall_s"]),
    }


def _device(device) -> torch.device:
    """The device asked for (``cuda`` when none was); raises, rather than
    running on the CPU, when it is a card and there is none. On a card TF32
    is off, as in the trainers, so that fp32 means fp32."""
    from ..models.facade import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass -device cpu to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def compare(which: str, new: dict, old: dict) -> list[str]:
    """Direction-aware regression diff of a fresh summary against a recorded
    ``--json`` artifact. Returns human-readable regression strings (empty =
    PASS). Tolerances are deliberately loose — these drives run on varying
    hosts/relays; the diff flags order-of-magnitude convergence regressions,
    not run-to-run noise."""
    regs = []
    if old.get("finite", True) and not new["finite"]:
        regs.append("metrics went non-finite (was finite in the recorded run)")

    def worse(key, factor, higher_is_better=False):
        o, n = old.get(key), new.get(key)
        if o is None or n is None:
            return
        bad = (n < o / factor) if higher_is_better else (n > o * factor)
        if bad:
            regs.append(f"{key}: {o:.4g} -> {n:.4g} (beyond {factor}x slack)")

    if which == "stage1":
        worse("l1_last100", 1.25)
        worse("max_abs_disc_t", 3.0)
        worse("max_abs_disc_s", 3.0)
        if new.get("psnr_last100", 99) < old.get("psnr_last100", 0) - 1.5:
            regs.append(
                f"psnr_last100: {old['psnr_last100']:.2f} -> "
                f"{new['psnr_last100']:.2f} (> 1.5 dB drop)"
            )
    elif which == "stage2":
        # final NLL materially higher than recorded (nats are comparable at
        # fixed z; 10 is far beyond run-to-run noise, far below a broken run)
        if new.get("nll_final", -1e9) > old.get("nll_final", 1e9) + 10.0:
            regs.append(
                f"nll_final: {old['nll_final']:.2f} -> {new['nll_final']:.2f} "
                "(> 10 nats worse)"
            )
        o_c, n_c = old.get("steps_to_reference_floor"), new.get(
            "steps_to_reference_floor"
        )
        if o_c is not None and (n_c is None or n_c > 2 * o_c + 50):
            regs.append(f"steps_to_reference_floor: {o_c} -> {n_c}")
    else:  # ae
        worse("recon_last100", 1.25)
        # d_weight is NOT diffed: sitting at the reference's 1e4 clamp with a
        # fresh disc is faithful behaviour (loss.py:8-19), so a run-to-run
        # max comparison would false-positive; non-finiteness is covered by
        # the finite check above and instability by recon/hinge.
        worse("max_abs_l_disc", 3.0)
    return regs


def drive(which: str, preset: str = "bair", steps: int = 1000, bs: int | None = None,
          k: int = 10, pool: int = 4, lr: float = 1e-4, device=None) -> tuple[dict, dict]:
    """One drive: (its summary, its run: the curves, ``wall_s``, ``build_s``)."""
    if which == "stage1":
        run = train_stage1(preset, steps, bs, k, pool, device)
        summary = summarize_stage1(run)
    elif which == "ae":
        run = train_ae(preset, steps, bs, k, pool, device)
        summary = summarize_ae(run)
    else:
        run = train_stage2(preset, steps, bs, k, pool, lr, device)
        summary = summarize_stage2(run)
    print(f"{which}: set-up {run['build_s']:.2f} s, {steps} steps in {run['wall_s']:.2f} s "
          f"({1e3 * run['wall_s'] / steps:.2f} ms a step)", flush=True)
    return summary, run


def main(argv: list[str] | None = None) -> dict:
    """The CLI; returns ``{"payload": the --json payload, "run": the run}``."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("which", choices=["stage1", "stage2", "ae"])
    ap.add_argument("--preset", default="bair")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--bs", type=int, default=None)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--pool", type=int, default=4,
                    help="device-resident uint8 chunk pool size (cycled)")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--json", default=None,
                    help="write the machine-comparable summary artifact here")
    ap.add_argument("--compare", default=None,
                    help="recorded --json artifact to regression-diff the "
                         "fresh run against; exits 1 and prints REGRESSION "
                         "lines if convergence materially degraded")
    ap.add_argument("-device", type=str, default="cuda", help="cuda or cpu")
    a = ap.parse_args(argv)
    summary, run = drive(a.which, a.preset, a.steps, a.bs, a.k, a.pool, a.lr, a.device)
    payload = {"which": a.which, "preset": a.preset, "steps": a.steps, "bs": a.bs, "k": a.k,
               "metrics": summary}
    if a.json:
        with open(a.json, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {a.json}")
    if a.compare:
        with open(a.compare) as f:
            old = json.load(f)
        if old.get("which") != a.which:
            raise SystemExit(
                f"--compare artifact is for {old.get('which')!r}, this run is {a.which!r}")
        regs = compare(a.which, summary, old["metrics"])
        if regs:
            for r in regs:
                print(f"REGRESSION vs {a.compare}: {r}")
            raise SystemExit(1)
        print(f"PASS: no convergence regression vs {a.compare}")
    return {"payload": payload, "run": run}


if __name__ == "__main__":
    main()
