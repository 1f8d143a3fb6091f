#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Environment: versions, the card's name and power limit; TF32 off for
   matmuls and convolutions, so fp32 means fp32.
2. Build every CUDA kernel of the sampling path from ``csrc/`` (nvcc, all
   sources at once) and print the build time and ptxas report.
3. Kernel against its plain PyTorch version on the card at the BAIR flow
   shape (B=6, C=64, E=64 or 94 with control, hidden 512, 20 blocks), with
   seeded random weights and a non-trivial ActNorm (and one block alone, at
   a tighter tolerance): reverse, forward with logdet, a forward -> reverse
   round trip, in fp32- and bf16-weight mode.
4. The main path at the full BAIR preset with random weights: ``Model.sample``
   (bs=6, 64x64 x0) at 16 and 24 frames (the autoregressive extension), fp32
   and bf16 decoder, and ``Model.forward``. Launch counters are zeroed just
   before these calls and read just after. Then, outside that window, the
   flow forward (``SupervisedTransformer``) maps the sampled z back to nu.
5. Timings: each kernel's median ms beside its plain version and its bound,
   and ``Model.forward`` latency and frames/s, each with the card's name.
6. A ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is visible, and when the
port's package is not beside it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

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
DEVICE = "cuda"
PRESET = "bair"  # the main path's model: full width, random weights
BATCH = 6


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


def flow_case(control: bool, n_flows: int = 20, seed: int = 0):
    """A BAIR-shaped ConditionalFlow on the card with seeded random weights."""
    import torch

    from image2video_synthesis_using_cinns_tpu_torch.models.stage2.flow import ConditionalFlow

    e = 64 + (30 if control else 0)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        flow = ConditionalFlow(64, e, 512, 2, n_flows, control=control)
        flow.blocks.actnorm.loc.data.normal_(0.0, 0.2)
        flow.blocks.actnorm.scale.data.uniform_(0.8, 1.25)
        x = torch.randn(6, 64)
        emb = torch.randn(6, e)
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
    for counts in (fk.launches, fk.device_launches):
        for k in counts:
            counts[k] = 0
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

    with torch.no_grad():
        flow = models["float32"].flow
        z = outs[("float32", 16)][1]
        nu_back, logdet = flow(z, [x0])

    outs[("float32 drawn nu", 16)] = (drawn, None)
    for (dt, t), (vid, _) in outs.items():
        ok = (tuple(vid.shape) == (BATCH, t, 3, img, img) and bool(torch.isfinite(vid).all())
              and float(vid.abs().max()) <= 1.0)
        log(f"  sample {dt} T={t}: shape={tuple(vid.shape)} finite_in_range={ok}")
        if not ok:
            raise AssertionError(f"bad video for {dt} T={t}")
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
        wbytes = p.weight_bytes()
        nparams = wbytes // (2 if mode == "bf16" else 4)
        io_bytes = 4 * (residual.numel() * 2 + emb.numel())
        flops = 2 * residual.shape[0] * nparams
        bound_bytes = (wbytes + io_bytes) / HBM_BYTES_PER_S * 1e3
        bound_ops = flops / PEAK_FLOPS[mode] * 1e3
        with torch.no_grad():
            for name, kern, ref in (
                ("flow_reverse_fused", fk.flow_reverse_fused, fk.flow_reverse_fused_ref),
                ("flow_forward_fused", fk.flow_forward_fused, fk.flow_forward_fused_ref),
            ):
                ms = cuda_ms(lambda: kern(p, residual, emb))
                plain_ms = cuda_ms(lambda: ref(p, residual, emb), iters=5, reps=5)
                rows[(name, mode)] = dict(ms=ms, plain_ms=plain_ms,
                                          bound_ms=max(bound_bytes, bound_ops),
                                          bound_by="bytes" if bound_bytes >= bound_ops
                                          else "operations")
                log(f"  [{card}] {name} {mode}-weights B=6: kernel {ms:.4f} ms, plain "
                    f"{plain_ms:.4f} ms, bound {rows[(name, mode)]['bound_ms']:.4f} ms "
                    f"({rows[(name, mode)]['bound_by']}: {wbytes} weight bytes, {flops} flops)")
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
    built = build.build("flow_chain")
    log(f"  built in {time.perf_counter() - t0:.2f} s: flow_chain ({built['seconds']:.2f} s)")
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  " + line.strip())

    log("== 3. kernel vs plain (BAIR flow shape)")
    errs = phase_kernel_vs_plain()

    log("== 4. main path (BAIR preset, random weights)")
    models, x0, residual, launches, device_launches = phase_main_path()

    log("== 5. timings")
    rows = phase_timings(card, models, x0, residual)

    kernels = []
    for name, line in (("flow_reverse_fused", 221), ("flow_forward_fused", 215)):
        r = rows[(name, "bf16")]  # the main path's mode: bf16 weights, no control
        direction = "reverse" if name == "flow_reverse_fused" else "forward"
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": f"{PALLAS_KERNEL}:{line}",
            "launches": launches[name], "device_launches": device_launches[name],
            "max_abs_err": errs[f"blocks=20 control=0 bf16 {direction}"],
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
