#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Environment: versions, the card's name and power limit; TF32 off for
   matmuls and convolutions, so fp32 means fp32.
2. Build every CUDA source of the sampling path from ``csrc/`` (one nvcc per
   source, all started together: the chain kernel and its timeline build)
   and print the build time and ptxas report.
3. Kernel against its plain PyTorch version on the card at the BAIR flow
   shape (B=6, C=64, E=64 or 94 with control, hidden 512, 20 blocks), with
   seeded random weights and a non-trivial ActNorm (and one block alone, at
   a tighter tolerance): reverse, forward with logdet, a forward -> reverse
   round trip, in fp32- and bf16-weight mode. Then at the landscape flow
   shape (E=128): reverse at B=6, forward at B=6 and at B=1 (the transfer's
   query), the round trip at B=1, in both weight modes.
4. The sampling path at the full BAIR preset with random weights:
   ``Model.sample`` (bs=6, 64x64 x0) at 16 and 24 frames (the autoregressive
   extension), fp32 and bf16 decoder, and ``Model.forward``. Launch counters
   are zeroed just before these calls and read just after; every chain must
   have been one device kernel. Then, outside that window, the flow forward
   (``SupervisedTransformer``) maps the sampled z back to nu.
   4b. The transfer path at the full landscape preset with random weights:
   ``Model.transfer_sample`` (one 17-frame 128x128 query, 6 start frames),
   fp32 and bf16 decoder, and a landscape ``Model.sample`` (bs=6, 16 frames),
   in a second counted window: both chains must have launched, one device
   kernel each. Checks: videos, z against the plain chains, z the same
   across decoders, and the query's own motion back through its own frame.
   4c. Offline evaluation at the full BAIR preset: synthetic BAIR test
   splits (50 and 16 clips of 30 64x64 frames drawn from a seed, no image
   codec) packed into FrameStores; full-size I3D (kinetics, DT-16),
   Inception and LPIPS with random weights from a seed, written with the
   port's ``save`` where the loaders look for them. The eval CLIs' bodies
   run each in its own counted window: synthesis quality (fp32 decoder,
   bs=6, 16 frames, FID+LPIPS+FVD+DTFVD; 9 chains) and diversity (bf16
   decoder, 5 realisations, VGG+I3D+DTI3D; 15 chains), one device kernel per
   chain and no forward chain. Checks: every metric finite; FVD, DTFVD and
   FID of a set against itself near 0 (``self_distance``), LPIPS(x, x) = 0;
   each backbone on the card against the same module on the CPU
   (``BACKBONE_TOL``); the stream's Fréchet values against activations taken
   at another batch size (``BATCHING_TOL``). Then the eval's wall time and
   clips/s for each body and its stages, each timed alone.
5. Timings: each kernel's median ms beside its plain version and its bound;
   the reverse chain at B = 1, 6 and 16; where a chain's time goes, from the
   timeline build (per layer and pass, and the kernel's own span), and a
   probe of a grid barrier written by hand beside cooperative groups' grid
   sync (the chain itself has no grid barrier); and ``Model.forward``
   latency and frames/s. Then the transfer: its latency and frames/s, its
   stages each timed alone (encoder, embedder, flow forward at B=1, flow
   reverse at B=6, decoder), and both kernels at the landscape shape beside
   their plain versions and bounds. Each line carries the card's name and
   power limit.
6. ``torch.profiler`` traces of two bf16 ``Model.forward`` calls, of two
   bf16 landscape ``Model.transfer`` calls and of two synthesis-eval steps
   (sample a batch, all four backbones): the top device kernels, the flow
   chain's share, the device's idle share, and the host and device time
   before the first flow chain (the embedder; in transfer, the encoder and
   the query's embedding). The traces are written to ``smoke_out/`` (listed
   in ``.gitignore``).
7. A ``{"kernels": [...]}`` line (launches summed over the four counted
   windows), then the last line ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is visible, and when the
port's package is not beside it.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}  # dense; fp32 outside the tensor cores
# allclose tolerances (|a - b| <= tol + tol * |b|) for the 20-block chain:
# fp32 differs only in the order of sums; bf16 as tests/test_pallas_flow.py
# holds the Pallas kernel, since 20 blocks of exp(+-s) amplify the rare bf16
# input that a differently ordered fp32 sum rounds the other way
TOL = {"fp32": 1e-4, "bf16": 2e-2}
# one block alone: float rounding, plus in bf16 the odd input rounded the
# other way (a few 1e-5); a missed bf16 rounding point moves the output by
# about 1e-3, which phase 3 shows by holding the kernel against a plain
# version that does not round its activations
TOL_ONE_BLOCK = {"fp32": 1e-5, "bf16": 1e-4}
PALLAS_KERNEL = "image2video_synthesis_using_cinns_tpu/ops/pallas/flow_kernel.py"
SOURCE = "image2video_synthesis_using_cinns_tpu_torch/csrc/flow_chain.cu"
LIBRARIES = ("flow_chain", "flow_chain_timeline")  # csrc/<name>.cu, built at once
SWEEP = (1, 6, 16)  # batch sizes of the reverse chain's sweep
OUT_DIR = Path(__file__).resolve().parent / "smoke_out"
DEVICE = "cuda"
PRESET = "bair"  # the sampling path's model: full width, random weights
TRANSFER_PRESET = "landscape"  # the transfer path's model: full width, random weights
QUERY_FRAMES = 17  # the encoder sees the 16 after the first
BATCH = 6
# phase 4c, offline evaluation at the BAIR preset: a synthetic test split of
# 30-frame 64x64 clips; 50 clips give the synthesis run a ragged last batch
# (9 batches of 6, the last of 2), the FVD x16 drop (keeps 48) and the DTFVD
# drop (keeps 40); diversity takes 16 clips of 5 realisations (3 batches)
EVAL_CLIPS, DIVERSITY_CLIPS, N_REALIZ, EVAL_SEQ = 50, 16, 5, 16
BAIR_FRAMES, BAIR_PX = 30, 64
# card against CPU, relative to the largest output: fp32 through 20 (VGG) to
# 100 (Inception) layers, sums in another order on each side, TF32 off
BACKBONE_TOL = 1e-4
# the stream's Fréchet values against activations taken at another batch size
BATCHING_TOL = 1e-6


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int = 20, reps: int = 7) -> float:
    """Median over ``reps`` of the mean device time of ``iters`` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def close_ratio(a, b, tol: float) -> float:
    """max |a - b| / (tol + tol * |b|): at most 1 where allclose(rtol=atol=tol)
    holds; with tol 0, 0 where a equals b and infinity elsewhere."""
    a, b = a.float(), b.float()
    if tol == 0:
        return 0.0 if bool((a == b).all()) else float("inf")
    return float(((a - b).abs() / (tol + tol * b.abs())).max())


def check(key: str, a, b, tol: float) -> float:
    err, ratio = max_err(a, b), close_ratio(a, b, tol)
    ok = ratio <= 1.0
    log(f"  {key}: max_abs_err={err:.3e} max|b|={float(b.abs().max()):.3g} "
        f"allclose(rtol=atol={tol:g}) ratio={ratio:.3f} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{key}: disagrees beyond tolerance")
    return err


def flow_case(control: bool, n_flows: int = 20, seed: int = 0, cond_z: int = 64):
    """A ConditionalFlow of C=64, hidden 512 and embedding ``cond_z`` (+30 with
    control: the BAIR shape at 64, the landscape one at 128) on the card, with
    seeded random weights, and 6 rows of input."""
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.models.stage2.flow import ConditionalFlow

    e = cond_z + (30 if control else 0)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        flow = ConditionalFlow(64, e, 512, 2, n_flows, control=control)
        flow.blocks.actnorm.loc.data.normal_(0.0, 0.2)
        flow.blocks.actnorm.scale.data.uniform_(0.8, 1.25)
        x = torch.randn(BATCH, 64)
        emb = torch.randn(BATCH, e)
    return flow.to(DEVICE), x.to(DEVICE), emb.to(DEVICE)


def bf16_weights_only(blocks: dict) -> dict:
    """The flow's blocks with the coupling weights rounded to bf16: packed in
    fp32 mode, the plain version then rounds no activation."""
    import torch

    return {**blocks, "coupling": {
        net: [(w.to(torch.bfloat16).float(), b) for w, b in layers]
        for net, layers in blocks["coupling"].items()}}


def phase_kernel_vs_plain():
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.models.stage2 import flow as tflow
    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk

    errs = {}
    for control, n_flows in ((False, 1), (False, 20), (True, 20)):
        flow, x, emb = flow_case(control, n_flows)
        for mode, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            p = fk.PackedFlow(flow.blocks_dict(), flow.shuffle.fwd, flow.shuffle.inv, flow.mask,
                              dtype)
            tol = (TOL_ONE_BLOCK if n_flows == 1 else TOL)[mode]
            with torch.no_grad():
                z = fk.flow_reverse_fused(p, x, emb)
                z_ref = fk.flow_reverse_fused_ref(p, x, emb)
                y, ld = fk.flow_forward_fused(p, x, emb)
                y_ref, ld_ref = fk.flow_forward_fused_ref(p, x, emb)
                x_rt = fk.flow_reverse_fused(p, y, emb)
                torch.cuda.synchronize()
                cases = {
                    "reverse": (z, z_ref),
                    "forward": (y, y_ref),
                    "logdet": (ld, ld_ref),
                    "roundtrip": (x_rt, x),
                }
                if mode == "fp32":  # the fp32 mode is the plain exact flow
                    bd, sd = flow.blocks_dict(), flow.shuffle_dict()
                    cases["reverse_vs_flow_reverse"] = (
                        z, tflow.flow_reverse(bd, sd, x, emb, flow.mask))
                    cases["forward_vs_flow_forward"] = (
                        y, tflow.flow_forward(bd, sd, x, emb, flow.mask)[0])
                for name, (a, b) in cases.items():
                    key = f"blocks={n_flows} control={int(control)} {mode} {name}"
                    errs[key] = check(key, a, b, tol)
                if mode == "bf16" and n_flows == 1:
                    # the one-block tolerance must tell a kernel that rounds
                    # at the Pallas kernel's places from one that does not
                    p_fp32 = fk.PackedFlow(bf16_weights_only(flow.blocks_dict()),
                                           flow.shuffle.fwd, flow.shuffle.inv, flow.mask,
                                           torch.float32)
                    z_unrounded = fk.flow_reverse_fused_ref(p_fp32, x, emb)
                    ratio = close_ratio(z, z_unrounded, tol)
                    log(f"  blocks=1 bf16 reverse vs plain without activation rounding: "
                        f"max_abs_err={max_err(z, z_unrounded):.3e} ratio={ratio:.3f} "
                        f"(must exceed 1 at allclose {tol:g})")
                    if ratio <= 1.0:
                        raise AssertionError("the one-block bf16 tolerance cannot tell a missed "
                                             "rounding point")
    return errs


def phase_landscape_flow():
    """Both chains at the landscape flow shape (C=64, E=128, hidden 512, 20
    blocks): reverse at B=6 (the start frames), forward at B=6 and at B=1 (the
    transfer's one query), and the B=1 round trip, in both weight modes."""
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.models.stage2 import flow as tflow
    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk

    errs = {}
    flow, x, emb = flow_case(False, cond_z=128, seed=3)
    x1, emb1 = x[:1].contiguous(), emb[:1].contiguous()
    bd, sd = flow.blocks_dict(), flow.shuffle_dict()
    for mode, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        p = fk.PackedFlow(bd, flow.shuffle.fwd, flow.shuffle.inv, flow.mask, dtype)
        with torch.no_grad():
            y6, ld6 = fk.flow_forward_fused(p, x, emb)
            y1, ld1 = fk.flow_forward_fused(p, x1, emb1)
            cases = {
                "reverse B=6": (fk.flow_reverse_fused(p, x, emb),
                                fk.flow_reverse_fused_ref(p, x, emb)),
                "forward B=6": (y6, fk.flow_forward_fused_ref(p, x, emb)[0]),
                "logdet B=6": (ld6, fk.flow_forward_fused_ref(p, x, emb)[1]),
                "forward B=1": (y1, fk.flow_forward_fused_ref(p, x1, emb1)[0]),
                "logdet B=1": (ld1, fk.flow_forward_fused_ref(p, x1, emb1)[1]),
                "roundtrip B=1": (fk.flow_reverse_fused(p, y1, emb1), x1),
            }
            if mode == "fp32":  # the fp32 mode is the plain exact flow
                cases["reverse_vs_flow_reverse B=6"] = (
                    cases["reverse B=6"][0], tflow.flow_reverse(bd, sd, x, emb, flow.mask))
                cases["forward_vs_flow_forward B=1"] = (
                    y1, tflow.flow_forward(bd, sd, x1, emb1, flow.mask)[0])
            torch.cuda.synchronize()
            for name, (a, b) in cases.items():
                key = f"landscape E=128 {mode} {name}"
                errs[key] = check(key, a, b, TOL[mode])
    return errs


def zero_counts() -> None:
    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk

    for counts in (fk.launches, fk.device_launches):
        for k in counts:
            counts[k] = 0


def check_video(key: str, vid, shape) -> None:
    import torch

    ok = (tuple(vid.shape) == shape and bool(torch.isfinite(vid).all())
          and float(vid.abs().max()) <= 1.0)
    log(f"  {key}: shape={tuple(vid.shape)} finite_in_range={ok}")
    if not ok:
        raise AssertionError(f"bad video: {key}")


def phase_main_path():
    import numpy as np
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk
    from image2video_synthesis_using_cinns_tpu_torch.testing import PRESETS, build_model

    p = PRESETS[PRESET]
    models = {dt: build_model(PRESET, vid_length=16, seed=0, compute_dtype=dt, device=DEVICE)
              for dt in ("float32", "bfloat16")}
    img = p["img_size"]
    rng = np.random.default_rng(1234)
    x0 = torch.from_numpy(rng.uniform(-1, 1, (BATCH, 3, img, img)).astype(np.float32)).to(DEVICE)
    residual = torch.from_numpy(
        rng.standard_normal((BATCH, p["z_dim"])).astype(np.float32)).to(DEVICE)

    outs = {}
    torch.cuda.synchronize()
    zero_counts()
    with torch.no_grad():
        for dt, model in models.items():
            for t in (16, 24):
                model.vid_length = t
                outs[(dt, t)] = model.sample(x0, residual=residual)
        models["float32"].vid_length = 16
        drawn = models["float32"].forward(x0)  # nu drawn from the model's generator
    torch.cuda.synchronize()
    launches, device_launches = dict(fk.launches), dict(fk.device_launches)
    log(f"  main-path chain launches: {launches}; device kernels they launched: "
        f"{device_launches}")
    # sampling runs the flow in reverse only; the forward chain is off this path
    if launches["flow_reverse_fused"] < 1:
        raise AssertionError("flow_reverse_fused was not launched on the main path")
    if device_launches != launches:
        raise AssertionError("a chain launched other than one device kernel")

    with torch.no_grad():
        flow = models["float32"].flow
        z = outs[("float32", 16)][1]
        nu_back, logdet = flow(z, [x0])

    outs[("float32 drawn nu", 16)] = (drawn, None)
    for (dt, t), (vid, _) in outs.items():
        check_video(f"sample {dt} T={t}", vid, (BATCH, t, 3, img, img))
    with torch.no_grad():
        emb = flow.embed([x0])
        z = outs[("float32", 16)][1]
        z_ref = fk.flow_reverse_fused_ref(flow.flow.packed, residual, emb)
    if not bool(torch.isfinite(logdet).all()):
        raise AssertionError("non-finite logdet")
    check("z_vs_plain", z, z_ref, TOL["bf16"])
    check("z_same_across_dtypes", outs[("bfloat16", 24)][1], z, 0.0)
    check("z_repeatable", outs[("float32", 24)][1], z, 0.0)
    check("base_clip_kept_by_extension", outs[("float32", 24)][0][:, :16],
          outs[("float32", 16)][0], 1e-5)
    check("nu_roundtrip", nu_back, residual, 1e-2)
    return models, x0, residual, launches, device_launches


def phase_transfer():
    """The transfer path at the full landscape preset, in its own counted
    window, with a landscape ``Model.sample`` beside it; then its checks."""
    import numpy as np
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk
    from image2video_synthesis_using_cinns_tpu_torch.testing import PRESETS, build_model

    p = PRESETS[TRANSFER_PRESET]
    models = {dt: build_model(TRANSFER_PRESET, vid_length=16, seed=0, compute_dtype=dt,
                              transfer=True, device=DEVICE)
              for dt in ("float32", "bfloat16")}
    img = p["img_size"]
    rng = np.random.default_rng(4321)
    q = torch.from_numpy(
        rng.uniform(-1, 1, (1, QUERY_FRAMES, 3, img, img)).astype(np.float32)).to(DEVICE)
    x0 = torch.from_numpy(rng.uniform(-1, 1, (BATCH, 3, img, img)).astype(np.float32)).to(DEVICE)
    residual = torch.from_numpy(
        rng.standard_normal((BATCH, p["z_dim"])).astype(np.float32)).to(DEVICE)

    torch.cuda.synchronize()
    zero_counts()
    with torch.no_grad():
        outs = {dt: model.transfer_sample(q, x0) for dt, model in models.items()}
        sampled = models["float32"].sample(x0, residual=residual)
    torch.cuda.synchronize()
    launches, device_launches = dict(fk.launches), dict(fk.device_launches)
    log(f"  transfer-path chain launches: {launches}; device kernels they launched: "
        f"{device_launches}")
    for name in ("flow_forward_fused", "flow_reverse_fused"):
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched on the transfer path")
    if device_launches != launches:
        raise AssertionError("a chain launched other than one device kernel")

    for dt, (vid, _) in outs.items():
        check_video(f"transfer {dt}", vid, (BATCH, 16, 3, img, img))
    check_video("landscape sample float32", sampled[0], (BATCH, 16, 3, img, img))
    model = models["float32"]
    flow, packed = model.flow, model.flow.flow.packed
    with torch.no_grad():
        _, mu, _ = model.encoder(q[:, 1:].permute(0, 2, 1, 3, 4))
        nu_plain, _ = fk.flow_forward_fused_ref(packed, mu, flow.embed([q[:, 0]]))
        emb = flow.embed([x0])
        z_plain = fk.flow_reverse_fused_ref(packed, nu_plain.repeat(BATCH, 1), emb)
        z_sample_plain = fk.flow_reverse_fused_ref(packed, residual, emb)
        z_back = model.transfer_sample(q, q[:, 0])[1]
    check("transfer z_ref_vs_plain", outs["float32"][1], z_plain, TOL["bf16"])
    check("transfer z_ref_same_across_dtypes", outs["bfloat16"][1], outs["float32"][1], 0.0)
    check("transfer query_motion_roundtrip", z_back, mu, 1e-2)
    check("landscape sample z_vs_plain", sampled[1], z_sample_plain, TOL["bf16"])
    return models, q, x0, launches, device_launches


def seeded_imread(path: str):
    """A BAIR-like 64x64 frame drawn from a seed: a noise background fixed per
    clip and an 8x8 square that moves one step per frame, both from the crc32
    of the clip's ``traj_<k>/<n>`` (not of the temporary root, so every run
    sees the same data); the frame number is the file's stem. No image codec
    is needed."""
    import zlib

    import numpy as np

    *_, traj, clip, name = path.split("/")
    rng = np.random.default_rng(zlib.crc32(f"{traj}/{clip}".encode()))
    frame = rng.integers(0, 60, (BAIR_PX, BAIR_PX, 3), dtype=np.uint8)
    y0, x0 = rng.integers(0, BAIR_PX - 8, 2)
    dy, dx = rng.integers(-1, 2, 2)
    k = int(name.split(".")[0])
    y = int(np.clip(y0 + k * dy, 0, BAIR_PX - 8))
    x = int(np.clip(x0 + k * dx, 0, BAIR_PX - 8))
    frame[y:y + 8, x:x + 8] = rng.integers(120, 256, 3, dtype=np.uint8)
    return frame


def bair_split(root: Path, n_clips: int) -> str:
    """``<root>/test/traj_<k>/<n>/``: the clip directories of a BAIR test split
    (the frames come from ``seeded_imread``, packed into a FrameStore)."""
    for i in range(n_clips):
        (root / "test" / f"traj_{i // 10}" / str(i % 10)).mkdir(parents=True)
    return str(root) + "/"


def random_backbone(module, seed: int):
    """Full-size backbone weights from a seed: each conv kernel N(0, 2/fan_in)
    (activations stay of order one through the depth; the modules' own init
    shrinks them about 6x a layer), biases zero, frozen BN the identity;
    LPIPS's 1x1 heads non-negative, as trained ones are."""
    import math

    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.dim() < 3:
                p.zero_()
                continue
            w = torch.randn(p.shape, generator=g) * math.sqrt(2.0 / p[0].numel())
            p.copy_(w.abs() if name.startswith("lin") else w)
    return module


def write_backbones(models_dir: Path) -> None:
    """Random full-size I3D (kinetics, DT-16), Inception and LPIPS weights,
    written with the port's ``save`` where ``load_model``, ``load_inception``
    and ``load_lpips`` look for them."""
    from image2video_synthesis_using_cinns_tpu_torch.metrics import fid, fvd, lpips_eval
    from image2video_synthesis_using_cinns_tpu_torch.metrics.inception import InceptionV3FID
    from image2video_synthesis_using_cinns_tpu_torch.models.backbones.lpips import LPIPS
    from image2video_synthesis_using_cinns_tpu_torch.utils import checkpoint, convert

    for rel, module, seed in ((fvd.WEIGHT_FILES["kinetics"], fvd.build("kinetics"), 11),
                              (fvd.WEIGHT_FILES["dt16"], fvd.build("dt16"), 12),
                              (fid.WEIGHT_FILE, InceptionV3FID(), 13),
                              (lpips_eval.WEIGHT_FILE, LPIPS(), 14)):
        path = models_dir / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        variables = convert.to_variables(random_backbone(module, seed).state_dict())
        checkpoint.save(str(path), {"state_dict": variables})


def check_rel(key: str, a, b, tol: float) -> float:
    """max |a - b| over max |b|, held to ``tol``."""
    import torch

    a, b = a.double().cpu(), b.double().cpu()
    scale = float(b.abs().max())
    rel = float((a - b).abs().max()) / scale
    ok = rel <= tol and bool(torch.isfinite(a).all()) and scale > 0
    log(f"  {key}: max|b|={scale:.4g} rel_err={rel:.3e} (bound {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{key}: disagrees beyond tolerance")
    return rel


def self_distance(key: str, acts) -> float:
    """The Fréchet distance of a set of activation rows to itself, held to
    |d| <= 2e-6 D + 1e-6 tr(Sigma): the 1e-6 offset on both covariances alone
    gives -2e-6 D, and float64 eigendecompositions of a covariance of rank
    below D leave about 1e-7 tr(Sigma)."""
    import numpy as np

    from image2video_synthesis_using_cinns_tpu_torch.metrics.frechet import (
        frechet_from_activations,
    )

    d = frechet_from_activations(acts, acts)
    tr = float(np.trace(np.cov(np.asarray(acts, np.float64), rowvar=False)))
    bound = 2e-6 * acts.shape[1] + 1e-6 * tr
    ok = abs(d) <= bound
    log(f"  {key}(x, x) over {acts.shape[0]} rows of {acts.shape[1]}: {d:.6g} "
        f"(bound {bound:.4g}, tr Sigma {tr:.6g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{key}(x, x) is not ~0")
    return d


def eval_window(label: str, run, expected_chains: int):
    """Run ``run()`` with the launch counts zeroed just before and read just
    after: one reverse chain per ``Model.forward``, one device kernel per
    chain, no forward chain."""
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    results = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, device_launches = dict(fk.launches), dict(fk.device_launches)
    log(f"  {label} chain launches: {launches}; device kernels they launched: {device_launches}")
    want = {"flow_reverse_fused": expected_chains, "flow_forward_fused": 0}
    if launches != want:
        raise AssertionError(f"{label}: chain launches {launches}, expected {want}")
    if device_launches != launches:
        raise AssertionError(f"{label}: a chain launched other than one device kernel")
    return results, wall, launches, device_launches


def phase_eval(card: str, models, tmp: Path):
    """Offline evaluation at the full BAIR preset: both eval CLI bodies with
    the port's loader, augment, FrameStore and full-size random backbones,
    each in its own counted window; then the checks and the stage times."""
    import numpy as np
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.cli import eval_diversity, eval_synthesis_quality
    from image2video_synthesis_using_cinns_tpu_torch.data import get_eval_loader
    from image2video_synthesis_using_cinns_tpu_torch.data.augment import build_augment
    from image2video_synthesis_using_cinns_tpu_torch.data.framestore import FrameStore
    from image2video_synthesis_using_cinns_tpu_torch.data.loader import Loader
    from image2video_synthesis_using_cinns_tpu_torch.metrics import fid, fvd, lpips_eval
    from image2video_synthesis_using_cinns_tpu_torch.metrics import streaming_eval as se
    from image2video_synthesis_using_cinns_tpu_torch.metrics.frechet import (
        frechet_from_activations,
    )

    t0 = time.perf_counter()
    models_dir = tmp / "models"
    write_backbones(models_dir)
    loaders = {}
    for name, n_clips, frames, model in (("synthesis", EVAL_CLIPS, EVAL_SEQ + 1, models["float32"]),
                                          ("diversity", DIVERSITY_CLIPS, EVAL_SEQ,
                                           models["bfloat16"])):
        model.vid_length = EVAL_SEQ
        dataset = get_eval_loader("bair", frames, bair_split(tmp / name, n_clips), model.config)
        store = FrameStore.build(dataset, str(tmp / f"{name}.fst"), imread=seeded_imread)
        loaders[name] = Loader(dataset, BATCH, shuffle=False, drop_last=False, workers=8,
                               framestore=store)
    log(f"  set-up {time.perf_counter() - t0:.2f} s: backbone weights written to {models_dir}, "
        f"two BAIR test splits packed ({EVAL_CLIPS} and {DIVERSITY_CLIPS} clips of "
        f"{BAIR_FRAMES} {BAIR_PX}x{BAIR_PX} frames); framestore backend: "
        f"{loaders['synthesis'].framestore.backend}")
    root = str(models_dir)

    # -- synthesis quality: fp32 decoder (the CLI's default) ----------------
    stream = se.SynthesisQualityStream(want_fid=True, want_lpips=True, want_fvd=True,
                                       want_dtfvd=True, seq_length=EVAL_SEQ, weights_root=root,
                                       device=DEVICE)
    clips = []
    add_batch = stream.add_batch

    def keep(fake, real):  # the clips, for the batching check after the window
        clips.append((fake.clone(), real.clone()))
        add_batch(fake, real)

    stream.add_batch = keep
    model = models["float32"]
    synth, s_wall, s_launches, s_dev = eval_window(
        "synthesis", lambda: eval_synthesis_quality.evaluate(model, loaders["synthesis"], stream,
                                                             "bair"),
        -(-EVAL_CLIPS // BATCH))
    log(f"  [{card}] eval_synthesis_quality body, bair bs={BATCH} seq_length={EVAL_SEQ} fp32 "
        f"decoder, FID+LPIPS+FVD+DTFVD over {EVAL_CLIPS} clips: {s_wall:.3f} s, "
        f"{EVAL_CLIPS / s_wall:.2f} clips/s; {synth}")

    # -- diversity: bf16 decoder ---------------------------------------------
    dstream = se.DiversityStream(N_REALIZ, want_vgg=True, want_i3d=True, want_dti3d=True,
                                 seq_length=EVAL_SEQ, weights_root=root, device=DEVICE)
    div, d_wall, d_launches, d_dev = eval_window(
        "diversity", lambda: eval_diversity.evaluate(models["bfloat16"], loaders["diversity"],
                                                     dstream, N_REALIZ),
        -(-DIVERSITY_CLIPS // BATCH) * N_REALIZ)
    log(f"  [{card}] eval_diversity body, bair bs={BATCH} n_realiz={N_REALIZ} "
        f"seq_length={EVAL_SEQ} bf16 decoder, VGG+I3D+DTI3D over {DIVERSITY_CLIPS} clips: "
        f"{d_wall:.3f} s, {DIVERSITY_CLIPS / d_wall:.2f} clips/s; {div}")

    # -- checks ----------------------------------------------------------------
    for name, v in {**synth, **div}.items():
        if not np.isfinite(v):
            raise AssertionError(f"{name} is not finite: {v}")
    log(f"  every metric finite: {sorted({**synth, **div})}")
    for name in ("FID", "FVD", "DTFVD"):
        real = stream.activations(name)[1]
        n = real.shape[0]  # the stream's populations
        keep_n = {"FID": se._tail_drop(n, 50), "FVD": n // 16 * 16,
                  "DTFVD": se._tail_drop(n, 40)}[name]
        self_distance(name, real[:keep_n])
    fake_all = torch.cat([f for f, _ in clips])
    real_all = torch.cat([r for _, r in clips])
    with torch.inference_mode():
        same = stream.lpips(real_all[0], real_all[0])
    log(f"  LPIPS(x, x) over {same.numel()} frames: max {float(same.abs().max())}")
    if float(same.abs().max()) != 0.0:
        raise AssertionError("LPIPS(x, x) is not 0")

    # the same backbones on the card and on the CPU
    i3d = {k: (fvd.load_model(k, root, DEVICE), fvd.load_model(k, root, "cpu"))
           for k in ("kinetics", "dt16")}
    clip = real_all[:1]
    for kind, (card_m, cpu_m) in i3d.items():
        x = clip if kind == "kinetics" else fvd.prep_dt_time(clip, 16)
        check_rel(f"I3D {kind} card vs CPU, 1 clip", fvd.activation_fn(card_m)(x),
                  fvd.activation_fn(cpu_m)(x.cpu()), BACKBONE_TOL)
    frames, other = real_all[0, :4], fake_all[0, :4]
    inc_cpu = fid.load_inception(root, "cpu")
    lp_cpu = lpips_eval.load_lpips(root, "cpu")
    vgg_cpu = se.vgg_features("cpu")
    x224 = torch.nn.functional.interpolate(frames, size=(224, 224), mode="bilinear",
                                           antialias=True)
    with torch.inference_mode():
        check_rel("Inception card vs CPU, 4 frames", stream.inception(frames),
                  inc_cpu(frames.cpu()), BACKBONE_TOL)
        check_rel("LPIPS card vs CPU, 4 frame pairs", stream.lpips(other, frames),
                  lp_cpu(other.cpu(), frames.cpu()), BACKBONE_TOL)
        for lvl, (a, b) in enumerate(zip(dstream.vgg(x224), vgg_cpu(x224.cpu()))):
            check_rel(f"VGG relu{lvl + 1} tap card vs CPU, 4 frames", a, b, BACKBONE_TOL)

    # batching: the stream's values against activations taken at another batch
    # size, 10 clips (so every clip is scored: EVAL_CLIPS is a multiple of 10)
    kin, n = i3d["kinetics"][0], fake_all.shape[0]
    if n % 10:
        raise ValueError(f"the batching check needs a multiple of 10 clips, not {n}")
    acts = {
        "FVD": [fvd.get_activations(kin, v, 10)[:n // 16 * 16] for v in (fake_all, real_all)],
        "DTFVD": [fvd.get_activations(i3d["dt16"][0], fvd.prep_dt_time(v, 16), 10)
                  [:se._tail_drop(n, 40)] for v in (fake_all, real_all)],
        "FID": [fid.get_activations(stream.inception, v.flatten(0, 1), 50)
                for v in (fake_all, real_all)],
    }
    for name, (a1, a2) in acts.items():
        redo = frechet_from_activations(a1, a2)
        rel = abs(redo - synth[name]) / abs(synth[name])
        log(f"  {name} from the stream (batches of {BATCH} clips) {synth[name]:.10g}, from "
            f"activations at batch size {50 if name == 'FID' else 10} {redo:.10g}: rel "
            f"{rel:.3e} (bound {BATCHING_TOL:g}) {'ok' if rel <= BATCHING_TOL else 'FAIL'}")
        if rel > BATCHING_TOL:
            raise AssertionError(f"{name} depends on the batch size")

    # -- stage times, each alone ---------------------------------------------
    augment = build_augment(BAIR_PX, None, False, False)
    t0 = time.perf_counter()
    n_batches = 0
    for batch in loaders["synthesis"].epoch_iter(0):
        augment(torch.from_numpy(batch["seq_raw"]).to(DEVICE))
        n_batches += 1
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3 / n_batches
    x0 = real_all[:BATCH, 0].contiguous()
    fake6, real6 = fake_all[:BATCH].contiguous(), real_all[:BATCH].contiguous()
    ff, rf = fake6.flatten(0, 1), real6.flatten(0, 1)
    video = torch.stack([fake6[0]] * N_REALIZ) * 0.5 + 0.5
    with torch.inference_mode():
        fwd = {dt: cuda_ms(lambda m=m: m.forward(x0), iters=3, reps=3)
               for dt, m in models.items()}
        i3d_ms = {k: cuda_ms(lambda f=fvd.activation_fn(m[0]), k=k: f(
            fake6 if k == "kinetics" else fvd.prep_dt_time(fake6, 16)), iters=2, reps=3) / BATCH
            for k, m in i3d.items()}
        inc_ms = cuda_ms(lambda: stream.inception(ff), iters=2, reps=3) / ff.shape[0]
        lp_ms = cuda_ms(lambda: stream.lpips(ff, rf), iters=2, reps=3) / ff.shape[0]
        vgg_ms = cuda_ms(lambda: dstream._vgg_pairs(video), iters=2, reps=3) / (N_REALIZ * EVAL_SEQ)
    log(f"  [{card}] eval stages, each alone: loader + augment {load_ms:.3f} ms per batch of "
        f"{BATCH} ({EVAL_SEQ + 1} frames, {loaders['synthesis'].framestore.backend} framestore); "
        f"Model.forward bs={BATCH} T={EVAL_SEQ} fp32 {fwd['float32']:.3f} ms, bf16 "
        f"{fwd['bfloat16']:.3f} ms; I3D kinetics {i3d_ms['kinetics']:.3f} ms per clip, DT-16 "
        f"{i3d_ms['dt16']:.3f} ms per clip (16 frames at 224, batches of {BATCH}); Inception "
        f"{inc_ms:.3f} ms per frame (299 px, batches of {ff.shape[0]}); LPIPS {lp_ms:.3f} ms per "
        f"frame pair (64 px); VGG diversity {vgg_ms:.3f} ms per frame (224 px, with its pairs, "
        f"{N_REALIZ * EVAL_SEQ} frames a video)")
    for loader in loaders.values():
        loader.framestore.close()
    t0 = time.perf_counter()
    stream.results()
    s_res = time.perf_counter() - t0
    t0 = time.perf_counter()
    dstream.results()
    log(f"  [{card}] results() on the host, each alone: synthesis (float64 Fréchet: FID 2048-d, "
        f"DTFVD 1024-d, FVD 400-d) {s_res * 1e3:.1f} ms, diversity "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

    stream.add_batch = add_batch

    def synthesis_step():
        """One batch of the synthesis body after loading: sample, the BAIR
        frame protocol, all four backbones (its rows join the spent stream)."""
        gen = model(x0)
        stream.add_batch(torch.cat((real6[:, :1], gen[:, :-1]), dim=1), real6)

    launches = {"flow_reverse_fused": s_launches["flow_reverse_fused"]
                + d_launches["flow_reverse_fused"], "flow_forward_fused": 0}
    device_launches = {"flow_reverse_fused": s_dev["flow_reverse_fused"]
                       + d_dev["flow_reverse_fused"], "flow_forward_fused": 0}
    return launches, device_launches, synthesis_step


def _timeline_library(lib):
    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk

    fk._type_library(lib)
    lib.flow_chain_timeline.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.flow_chain_barrier_probe.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.flow_chain_timeline, lib.flow_chain_barrier_probe):
        fn.restype = ctypes.c_int
    return lib


def chain_breakdown(card: str, p, x, emb):
    """Where one reverse chain's time goes, from the timeline build: per CTA
    and layer, clock64() at the layer's start, input staged (the wait for the
    net's count, then the load; none in layer 0), weights ready, tile done,
    the layer's count released (layers 0-2), and at a pass's end (s, t)
    arrived and glue done. Medians per layer of the MLP over the CTAs that had
    a tile in it; the wait for (s, t) (from the CTA's last tile of the pass,
    or the last layer's start where it had none) and the glue over all CTAs;
    and the span of a pass, from one glue's end to the next, over all CTAs
    and passes; and a CTA's time from the kernel's entry to its exit, before
    the first layer, and in the first pass. SM clocks are not synchronised,
    so only differences within one CTA are taken, and cycles become time at
    the clock measured by each CTA's entry and exit against the global
    timer, on which the kernel's span, from its first CTA's entry to its
    last one's exit, is read too. Then a probe times grid barriers alone."""
    import numpy as np
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import build
    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk

    lib = build.load("flow_chain_timeline", _timeline_library)
    fk.LIBRARY = "flow_chain_timeline"
    try:
        with torch.no_grad():
            fk.flow_reverse_fused(p, x, emb)
            torch.cuda.synchronize()
            tl_ms = cuda_ms(lambda: fk.flow_reverse_fused(p, x, emb))
            fk.flow_reverse_fused(p, x, emb)
            torch.cuda.synchronize()
    finally:
        fk.LIBRARY = "flow_chain"
    dims = (ctypes.c_int * 3)()
    lib.flow_chain_timeline(None, dims)  # the sizes only
    tl = np.zeros(tuple(dims), dtype=np.int64)
    err = lib.flow_chain_timeline(tl.ctypes.data, dims)
    if err != 0:
        raise RuntimeError(f"timeline read failed: CUDA error {err}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_passes = 2 * p.n_flows
    edges = tl[:sms, -1, :4].astype(np.float64)  # entry, exit: SM cycles, then global ns
    mhz = float(np.median((edges[:, 1] - edges[:, 0]) / (edges[:, 3] - edges[:, 2]))) * 1e3
    t = tl[:sms, :4 * n_passes].astype(np.float64) / mhz  # microseconds
    t = t.reshape(sms, n_passes, 4, t.shape[-1])  # (CTA, pass, layer of the MLP, point)
    had_tile = t[..., 3] > 0
    layers = []
    for lyr in range(4):
        h = had_tile[:, :, lyr]
        parts = [np.median((t[:, :, lyr, k + 1] - t[:, :, lyr, k])[h])
                 for k in range(3 if lyr == 3 else 4)]
        layers.append(f"layer {lyr} ({int(h.sum())} tiles) input {parts[0]:.3f}, weights "
                      f"{parts[1]:.3f}, math {parts[2]:.3f}"
                      + ("" if lyr == 3 else f", release {parts[3]:.3f}"))
    end = t[:, :, 3]
    own_end = np.where(had_tile[:, :, 3], end[..., 3], end[..., 0])
    span = np.diff(end[..., 5], axis=1)
    entry, leave = edges[:, 0] / mhz, edges[:, 1] / mhz
    log(f"  [{card}] chain breakdown, reverse bf16-weights B={x.shape[0]} (timeline build "
        f"{tl_ms:.4f} ms a call; SM clock {mhz:.0f} MHz, measured against the global timer), "
        "median us: "
        + "; ".join(layers)
        + f"; per pass: wait for (s, t) {np.median(end[..., 4] - own_end):.3f}, glue "
        f"{np.median(end[..., 5] - end[..., 4]):.3f}, span {np.median(span):.3f} "
        f"(x {n_passes} passes = {np.median(span) * n_passes / 1e3:.4f} ms); a CTA from entry "
        f"to exit {np.median(leave - entry):.3f}, of which before the first layer "
        f"{np.median(t[:, 0, 0, 0] - entry):.3f} and the first pass "
        f"{np.median(end[:, 0, 5] - t[:, 0, 0, 0]):.3f}; the kernel, first entry to last exit "
        f"{(edges[:, 3].max() - edges[:, 2].min()) / 1e3:.3f}, entries spread "
        f"{np.ptp(edges[:, 2]) / 1e3:.3f}, exits {np.ptp(edges[:, 3]) / 1e3:.3f}")
    stream = torch.cuda.current_stream().cuda_stream
    for barrier in ("cooperative groups' grid sync", "a grid barrier written by hand"):
        for n in (100, 1000):
            def probe():
                counter = (None if barrier.startswith("cooperative")
                           else torch.zeros(1, dtype=torch.int32, device=DEVICE))
                err = lib.flow_chain_barrier_probe(
                    None if counter is None else counter.data_ptr(), n, stream)
                if err != 0:
                    raise RuntimeError(f"barrier probe: CUDA error {err}")
            ms = cuda_ms(probe, iters=5, reps=5)
            log(f"  [{card}] barrier probe, {barrier} ({sms} CTAs x 256 threads): {n} barriers "
                f"{ms:.4f} ms, {ms * 1e3 / n:.3f} us each")


def kernel_row(card: str, label: str, name: str, p, x, emb) -> dict:
    """One chain's median ms on these inputs, beside its plain version and its
    bound: the larger of the bytes it must move (the unpadded weights, x and
    emb read once, the outputs written once) over the HBM rate and its flops
    (2 per weight and row) over the peak rate of its weight type."""
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk

    kern, ref = getattr(fk, name), getattr(fk, name + "_ref")
    mode = "bf16" if p.bf16 else "fp32"
    b = x.shape[0]
    wbytes = p.weight_bytes()
    out_bytes = 4 * (x.numel() + (b if name == "flow_forward_fused" else 0))  # (+ logdet)
    flops = 2 * b * (wbytes // (2 if p.bf16 else 4))
    bound_bytes = (wbytes + 4 * (x.numel() + emb.numel()) + out_bytes) / HBM_BYTES_PER_S * 1e3
    bound_ops = flops / PEAK_FLOPS[mode] * 1e3
    with torch.no_grad():
        ms = cuda_ms(lambda: kern(p, x, emb))
        plain_ms = cuda_ms(lambda: ref(p, x, emb), iters=5, reps=5)
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bound_bytes, bound_ops),
               bound_by="bytes" if bound_bytes >= bound_ops else "operations")
    log(f"  [{card}] {name} {mode}-weights {label} B={b} E={p.E}: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}: {wbytes} "
        f"weight bytes, {flops} flops)")
    return row


def phase_timings(card: str, models, x0, residual):
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk

    flow = models["float32"].flow
    with torch.no_grad():
        emb = flow.embed([x0])
    flow_mod = flow.flow
    rows = {}
    for mode, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        p = fk.PackedFlow(flow_mod.blocks_dict(), flow_mod.shuffle.fwd, flow_mod.shuffle.inv,
                          flow_mod.mask, dtype)
        for name in ("flow_reverse_fused", "flow_forward_fused"):
            rows[(name, mode)] = kernel_row(card, "BAIR", name, p, residual, emb)
        if mode != "bf16":
            continue
        with torch.no_grad():  # the main path's chain: batch sweep and breakdown
            gen = torch.Generator(device="cpu").manual_seed(5)
            for b in SWEEP:
                xb = torch.randn(b, residual.shape[1], generator=gen).to(DEVICE)
                eb = torch.randn(b, emb.shape[1], generator=gen).to(DEVICE)
                ms = cuda_ms(lambda: fk.flow_reverse_fused(p, xb, eb))
                log(f"  [{card}] flow_reverse_fused bf16-weights batch sweep B={b}: {ms:.4f} ms")
            chain_breakdown(card, p, residual, emb)
    for dt, model in models.items():
        model.vid_length = 16
        with torch.no_grad():
            for _ in range(2):
                model.forward(x0, residual=residual)
            torch.cuda.synchronize()
            lat = []
            for _ in range(7):
                t0 = time.perf_counter()
                model.forward(x0, residual=residual)
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t0)
        med = statistics.median(lat)
        log(f"  [{card}] Model.forward bs=6 T=16 64x64 {dt}: latency {med * 1e3:.3f} ms, "
            f"{6 * 16 / med:.1f} frames/s (median of 7)")
        with torch.no_grad():  # the stages of one forward, each timed alone
            z = model.sample(x0, residual=residual)[1]
            xd, zd = x0.to(model.compute_dtype), z.to(model.compute_dtype)
            emb_ms = cuda_ms(lambda: model.flow.embed([x0]), iters=5, reps=5)
            dec_ms = cuda_ms(lambda: model.decoder(xd, zd), iters=3, reps=5)
        log(f"  [{card}] stages of Model.forward bs=6 {dt} decoder: embedder {emb_ms:.3f} ms, "
            f"flow_reverse_fused {rows[('flow_reverse_fused', 'bf16')]['ms']:.3f} ms, "
            f"decoder (16 frames) {dec_ms:.3f} ms")
    return rows


def phase_transfer_timings(card: str, models, q, x0):
    """``Model.transfer`` latency and frames/s, its stages each timed alone, and
    both chains at the shapes the transfer gives them."""
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import flow_kernel as fk

    img = q.shape[-1]
    for dt, model in models.items():
        with torch.no_grad():
            for _ in range(2):
                model.transfer(q, x0)
            torch.cuda.synchronize()
            lat = []
            for _ in range(7):
                t0 = time.perf_counter()
                model.transfer(q, x0)
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t0)
        med = statistics.median(lat)
        log(f"  [{card}] Model.transfer landscape, one {q.shape[1]}-frame query onto bs={BATCH}, "
            f"T=16 {img}x{img} {dt}: latency {med * 1e3:.3f} ms, {BATCH * 16 / med:.1f} "
            "frames/s (median of 7)")
    model = models["float32"]
    flow, packed = model.flow, model.flow.flow.packed
    clip = q[:, 1:].permute(0, 2, 1, 3, 4)
    with torch.no_grad():  # the stages of one transfer, each timed alone
        _, mu, _ = model.encoder(clip)
        emb_q, emb_x = flow.embed([q[:, 0]]), flow.embed([x0])
        nu = fk.flow_forward_fused(packed, mu, emb_q)[0].repeat(BATCH, 1)
        z = fk.flow_reverse_fused(packed, nu, emb_x)
        enc_ms = cuda_ms(lambda: model.encoder(clip), iters=5, reps=5)
        emb_q_ms = cuda_ms(lambda: flow.embed([q[:, 0]]), iters=5, reps=5)
        emb_ms = cuda_ms(lambda: flow.embed([x0]), iters=5, reps=5)
        fwd_ms = cuda_ms(lambda: fk.flow_forward_fused(packed, mu, emb_q))
        rev_ms = cuda_ms(lambda: fk.flow_reverse_fused(packed, nu, emb_x))
        dec_ms = {dt: cuda_ms(lambda: m.decoder(x0.to(m.compute_dtype), z.to(m.compute_dtype)),
                              iters=3, reps=5)
                  for dt, m in models.items()}
    log(f"  [{card}] stages of Model.transfer landscape: encoder (resnet18 3-D, fp32, "
        f"{clip.shape[2]} frames) {enc_ms:.3f} ms, embedder (ResNet-50 bn, fp32) query "
        f"{emb_q_ms:.3f} ms and bs={BATCH} {emb_ms:.3f} ms, flow_forward_fused B=1 {fwd_ms:.4f} ms, "
        f"flow_reverse_fused B={BATCH} {rev_ms:.4f} ms, decoder (16 frames) fp32 "
        f"{dec_ms['float32']:.3f} ms, bf16 {dec_ms['bfloat16']:.3f} ms")
    rows = {}
    flow_mod = flow.flow
    for mode, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        p = fk.PackedFlow(flow_mod.blocks_dict(), flow_mod.shuffle.fwd, flow_mod.shuffle.inv,
                          flow_mod.mask, dtype)
        rows[("flow_forward_fused", mode)] = kernel_row(card, "landscape", "flow_forward_fused",
                                                        p, mu, emb_q)
        rows[("flow_reverse_fused", mode)] = kernel_row(card, "landscape", "flow_reverse_fused",
                                                        p, nu, emb_x)
    return rows


def _union_us(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def phase_trace(card: str, label: str, call, filename: str, before_chain: str):
    """One torch.profiler window over two calls of ``call`` after two warm-up
    calls: the top device kernels, the flow chain's share, the device's idle
    share over the window's device span, and for each call the host time
    from its start to the first flow chain's launch against the device time
    of the kernels launched before it (``before_chain`` names them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with torch.no_grad():
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(2):
                with record_function(f"{label} #{i}"):
                    call()
            torch.cuda.synchronize()
    OUT_DIR.mkdir(exist_ok=True)
    path = OUT_DIR / filename
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        log(f"  [{card}] trace: the profiler recorded no device activity; not measured")
        return
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in device]
    span = max(b for _, b in spans) - min(a for a, _ in spans)
    busy = _union_us(spans)
    by_name: dict[str, list[float]] = {}
    for e in device:
        by_name.setdefault(e["name"], []).append(e["dur"])
    total = sum(sum(v) for v in by_name.values())
    chain = sum(sum(v) for k, v in by_name.items() if "chain_kernel" in k)
    log(f"  [{card}] trace of 2 x {label} ({path.name}): device span "
        f"{span / 1e3:.3f} ms, busy {busy / 1e3:.3f} ms, idle share {1 - busy / span:.3f}; "
        f"{len(device)} device activities, {total / 1e3:.3f} ms in all; flow chain "
        f"{chain / 1e3:.4f} ms = {chain / total:.4f} of device time")
    for name, durs in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:10]:
        log(f"    {sum(durs) / 1e3:9.4f} ms  {sum(durs) / total:.3f}  x{len(durs):<4d} {name[:110]}")
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    for i in range(2):
        window = [e for e in events if e.get("cat") == "user_annotation"
                  and e.get("name") == f"{label} #{i}"]
        if not window:
            continue
        start, end = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
        launched = sorted(((launch_ts[e["args"]["correlation"]], e) for e in device
                           if launch_ts.get(e.get("args", {}).get("correlation"), -1.0) >= start
                           and launch_ts[e["args"]["correlation"]] <= end),
                          key=lambda te: te[0])
        chain_at = next((ts for ts, e in launched if "chain_kernel" in e["name"]), None)
        if chain_at is None:
            continue
        before = [e for ts, e in launched if ts < chain_at]
        dev_busy = _union_us([(e["ts"], e["ts"] + e["dur"]) for e in before])
        log(f"  [{card}] {label} #{i}: host {(chain_at - start) / 1e3:.3f} ms from its "
            f"start to the flow chain's launch; the {len(before)} device activities launched "
            f"before it ({before_chain}) are busy {dev_busy / 1e3:.3f} ms; host wall "
            f"{(end - start) / 1e3:.3f} ms under the profiler")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from image2video_synthesis_using_cinns_tpu_torch.ops.cuda import build

    log("== 1. environment")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}")
    log(f"  card: {card}")
    log(f"  matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    log("== 2. build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:  # one nvcc per source, all at once
        built = dict(zip(LIBRARIES, pool.map(build.build, LIBRARIES)))
    log(f"  built in {time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{name} ({b['seconds']:.2f} s)" for name, b in built.items()))
    for line in built["flow_chain"]["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  " + line.strip())

    log("== 3. kernel vs plain (BAIR flow shape)")
    errs = phase_kernel_vs_plain()
    log("== 3b. kernel vs plain (landscape flow shape)")
    errs.update(phase_landscape_flow())

    log("== 4. sampling path (BAIR preset, random weights)")
    models, x0, residual, launches, device_launches = phase_main_path()
    log("== 4b. transfer path (landscape preset, random weights)")
    t_models, q, t_x0, t_launches, t_device_launches = phase_transfer()
    log("== 4c. offline evaluation (BAIR preset, random weights and backbones)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        e_launches, e_device_launches, synthesis_step = phase_eval(card, models, Path(tmp))
    log(f"  phase 4c took {time.perf_counter() - t0:.2f} s")

    log("== 5. timings")
    rows = phase_timings(card, models, x0, residual)
    log("== 5b. transfer timings (landscape preset)")
    t_rows = phase_transfer_timings(card, t_models, q, t_x0)

    log("== 6. traces")
    sampler, transfer = models["bfloat16"], t_models["bfloat16"]
    sampler.vid_length = 16
    phase_trace(card, "Model.forward bs=6 T=16 bf16",
                lambda: sampler.forward(x0, residual=residual),
                "trace_model_forward_bf16.json", "embedder, input")
    phase_trace(card, "Model.transfer landscape bs=6 T=16 bf16",
                lambda: transfer.transfer(q, t_x0),
                "trace_model_transfer_bf16.json", "encoder, query embedder, input")
    phase_trace(card, "eval synthesis step bs=6 fp32", synthesis_step,
                "trace_eval_synthesis_step.json", "embedder, input")

    # each kernel at the shape its path gives it, in that path's mode (bf16
    # weights): the reverse at the BAIR sampling path's B=6, E=64, the forward
    # at the transfer's one query, B=1, E=128; launches over all four windows
    kernels = []
    for name, line, r, shape, err_key in (
        ("flow_reverse_fused", 221, rows[("flow_reverse_fused", "bf16")], "B=6 C=64 E=64",
         "blocks=20 control=0 bf16 reverse"),
        ("flow_forward_fused", 215, t_rows[("flow_forward_fused", "bf16")], "B=1 C=64 E=128",
         "landscape E=128 bf16 forward B=1"),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": f"{PALLAS_KERNEL}:{line}",
            "launches": launches[name] + t_launches[name] + e_launches[name],
            "device_launches": (device_launches[name] + t_device_launches[name]
                                + e_device_launches[name]),
            "shape": f"{shape} hidden 512 20 blocks, bf16 weights",
            "max_abs_err": errs[err_key],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        })
    print(card)  # as nvidia-smi --query-gpu=name,power.limit gives it
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
