"""The benchmark of the PyTorch and CUDA port, one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card. The run
makes its weights and inputs from ``--seed``, warms up the cell's shapes
(set-up), measures for ``--seconds`` (``--trace 0``: the cell's end-to-end
metrics) or profiles a fixed number of calls (``--trace 1``: its per-layer
metrics), compares what the timed path produced with the plain reference,
and prints one JSON line last on standard output. Without a card, or with
fewer than the cell asks for, it prints no result and exits 2. It exits 3,
printing no result, when the JAX package or JAX itself was loaded into the
process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".portbench_cache"
OUT = ROOT / "portbench_out"
FORBIDDEN = ("jax", "jaxlib", "flax", "image2video_synthesis_using_cinns_tpu")


def loaded_forbidden() -> list[str]:
    """Modules in ``sys.modules`` whose top-level name is one of ``FORBIDDEN``."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))

    import torch

    from portbench import harness

    bench = harness.load_benchmark(ROOT)
    cell = harness.find_cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")

    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                           device, T_START, OUT)
    found = loaded_forbidden()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    out.device["power_limit_w"] = power_limit()
    line = {"correct": out.correct, "attempted": out.attempted, "failed": 0,
            "metrics": out.metrics, "device": out.device}
    if out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in out.checks}
    for name, v, lim in out.checks:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def power_limit() -> float | None:
    """The card's power limit in W, as ``nvidia-smi`` reads it."""
    import subprocess

    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                               "--format=csv,noheader,nounits"],
                              capture_output=True, text=True, timeout=30)
        return float(proc.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


if __name__ == "__main__":
    sys.exit(main())
