"""The general part of a benchmark run: find a cell's files by name, run its
runner's set-up, the measured window and, with ``trace``, the profiled
window, read the metrics, decide ``correct`` and build the result line.

What belongs to one configuration, one traffic mix or one per-layer metric
lives in files of its own, found by name from ``BENCHMARK.json``:

* ``portbench/configs/<config>.json`` (the ``file`` of its ``configs`` entry);
* ``portbench/traffic/<traffic>.json``: the mix's parameters, among them
  ``runner``, the module ``portbench/runners/<runner>.py`` that runs the
  program's entry point for it;
* ``portbench/metrics/<metric>.py``: ``read(ctx)`` of one per-layer metric,
  returning its value or None when the run has nothing to read.

A runner is a class ``Runner(cfg, traffic, seed, device)`` with
``setup(phases)`` (weights, program, warm-up; ``phases(name)`` marks the end
of each part), ``loop`` (``"closed"``: ``call(i)`` returns the
units of one call, the harness synchronizes after each; ``"steps"``:
``call(i)`` enqueues a step, ``fetch()`` waits for the pending ones every
``fetch_every`` calls), ``unit_metric`` (the end-to-end rate it reports),
``spans()`` (a context manager opening the benchmark's own spans),
``counts()`` (operations and bytes a call needs, for the readers), and
``check()``, which frees the program's state, runs the reference and
returns the compared numbers as ``(name, value, limit)``, each passing when
``value <= limit``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import random
import statistics
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from . import tracing

ROOT = Path(__file__).resolve().parents[1]
HOST_CALLS = 10  # untraced calls whose host enqueue time a traced run reads


# -- finding a cell's files ------------------------------------------------------

def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_of(bench: dict, root: Path, name: str) -> dict:
    entry = next(c for c in bench["configs"] if c["name"] == name)
    return json.loads((root / entry["file"]).read_text())


def traffic_of(root: Path, name: str) -> dict:
    return json.loads((root / "portbench" / "traffic" / f"{name}.json").read_text())


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def runner_of(root: Path, name: str):
    return _load(root / "portbench" / "runners" / f"{name}.py", f"portbench_runner_{name}")


def reader_of(root: Path, metric: str):
    path = root / "portbench" / "metrics" / f"{metric}.py"
    return _load(path, "portbench_metric_" + metric.replace(".", "_").replace("-", "_"))


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metric entries a cell reports: its end-to-end ones without trace,
    its per-layer ones with it (an entry without ``workloads`` is every
    cell's)."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if workload in m.get("workloads", [workload])]


# -- what the readers see ---------------------------------------------------------

@dataclass
class Context:
    """What one traced run gives the per-layer readers."""

    trace: tracing.Trace | None
    calls: int  # calls (or steps) inside the profiled window
    host_call_s: list[float]  # host seconds from a call's start to its return
    counts: dict  # the runner's operations and bytes of one call
    peak_bytes: int  # max_memory_allocated over the profiled window

    def per_call_ms(self, *spans: str) -> float | None:
        if self.trace is None:
            return None
        s = self.trace.span_device_s(*spans)
        return None if s is None else 1e3 * s / self.calls


# -- the run ---------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


class Phases:
    """Seconds of each named part of a set-up, printed to standard error."""

    def __init__(self, t0: float):
        self.t = t0
        self.parts: list[tuple[str, float]] = []

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.parts.append((name, now - self.t))
        self.t = now

    def report(self) -> None:
        print("setup: " + ", ".join(f"{n} {s:.2f} s" for n, s in self.parts), file=sys.stderr)


def p95(values: list[float]) -> float:
    """The 95th percentile (Python's ``statistics.quantiles``, exclusive)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=20)[-1]


@dataclass
class Outcome:
    correct: bool
    attempted: int
    metrics: dict
    device: dict
    checks: list
    breakdown: dict | None = None


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float, out_dir: Path) -> Outcome:
    """One run of ``workload``: set-up, the window (or, with ``trace``, the
    profiled window), the reference check. ``t_start`` is the process's
    start on the ``time.perf_counter`` clock."""
    bench = load_benchmark(root)
    cell = find_cell(bench, workload)
    cfg = config_of(bench, root, cell["config"])
    traffic = traffic_of(root, cell["traffic"])
    drv = runner_of(root, traffic["runner"]).Runner(cfg, traffic, seed, device)
    phases = Phases(t_start)
    phases("imports")
    torch.zeros(1, device=device)
    _sync(device)
    phases("cuda init")
    drv.setup(phases)
    _sync(device)
    phases("warm-up")
    phases.report()
    peak_setup = _peak(device)
    setup_s = time.perf_counter() - t_start
    _reset_peak(device)

    metrics: dict = {}
    breakdown = None
    extra_device: dict = {}
    if not trace:
        attempted, units, window_s, call_s = _window(drv, seconds, device)
        values = {"setup_s": setup_s, drv.unit_metric: units / window_s}
        if call_s is not None:
            values["call_ms_p95"] = 1e3 * p95(call_s)
        entries = cell_metrics(bench, workload, trace=False)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in entries}
    else:
        host_s = _host_calls(drv, device) if drv.loop == "closed" else []
        _reset_peak(device)
        path = out_dir / f"{workload}.trace.json"
        n = int(drv.traffic["trace_calls"])
        with drv.spans(), tracing.profiled(path, device):
            for i in range(n):
                with torch.profiler.record_function("bench/call"):
                    drv.call(10_000 + i)
            if drv.loop == "steps":
                drv.fetch()
        attempted = n
        tr = tracing.Trace(path) if device.type == "cuda" else None
        ctx = Context(tr, n, host_s, drv.counts(), _peak(device))
        for m in cell_metrics(bench, workload, trace=True):
            value = reader_of(root, m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if tr is not None:
            extra_device = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
            breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    peak = max(peak_setup, _peak(device))
    checks = drv.check()
    correct = all(v <= lim for _, v, lim in checks)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": peak, **extra_device}
    return Outcome(correct, attempted, metrics, dev, checks, breakdown)


def _window(drv, seconds: float, device: torch.device):
    """The measured window: calls until ``seconds`` have passed, the last
    one completed. Returns (calls, units, window seconds, per-call seconds
    or None). The rate of each third of the window goes to standard error,
    to tell noise within a run from noise between runs."""
    units, i = 0, 0
    call_s: list[float] | None = [] if drv.loop == "closed" else None
    every = int(drv.traffic.get("fetch_every", 1))
    marks: list[tuple[float, int]] = []
    _sync(device)
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        units += drv.call(i)
        i += 1
        if drv.loop == "closed":
            _sync(device)
            te = time.perf_counter()
            call_s.append(te - ts)
        elif i % every == 0:
            drv.fetch()
            te = time.perf_counter()
        else:
            continue
        if te - t0 >= seconds * (len(marks) + 1) / 3:
            marks.append((te, units))
        if te - t0 >= seconds:
            rates = [(u1 - u0) / (b - a) for (a, u0), (b, u1)
                     in zip([(t0, 0)] + marks[:-1], marks)]
            print("window thirds: " + ", ".join(f"{r:.2f}" for r in rates), file=sys.stderr)
            return i, units, te - t0, call_s


def _host_calls(drv, device: torch.device) -> list[float]:
    """Host seconds from the start of a call to its return, before the
    synchronize, over ``HOST_CALLS`` untraced calls."""
    out = []
    for i in range(HOST_CALLS):
        _sync(device)
        ts = time.perf_counter()
        drv.call(20_000 + i)
        out.append(time.perf_counter() - ts)
        _sync(device)
    return out


def free(device: torch.device) -> None:
    """Release what the program held, before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class Reservoir:
    """``k`` calls kept uniformly at random over all calls of a window, the
    choice drawn from the run's seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def rel_gap_rows(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest, over rows, of ||got - want|| / ||want||."""
    g = got.detach().double().reshape(got.shape[0], -1)
    w = want.detach().double().reshape(want.shape[0], -1).to(g.device)
    return float(((g - w).norm(dim=1) / w.norm(dim=1).clamp(min=1e-30)).max())
