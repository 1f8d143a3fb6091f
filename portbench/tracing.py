"""Spans from outside the program, the profiler window, and the reduction of
its trace to the numbers the per-layer readers take.

* ``module_span`` opens a ``record_function`` span around every call of a
  module (forward pre- and post-hooks); ``method_span`` wraps a bound
  method of one instance. Both are installed only in a traced run.
* ``profiled`` runs a block under ``torch.profiler`` (CPU and CUDA
  activities) inside one ``bench/window`` span and writes one chrome trace.
* ``Trace`` reads that trace: device activities (kernels, memcpys,
  memsets), the host time at which each was launched (by correlation id),
  and the spans. Device time belongs to a span when its launch lies inside
  one of the span's intervals, on any thread (autograd's backward launches
  from its own). The window is the ``bench/window`` span's wall time, so a
  host stall before the first kernel or after the last counts as idle.
"""

from __future__ import annotations

import bisect
import contextlib
import json
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "bench/window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def module_span(module: torch.nn.Module, name: str):
    """A ``name`` span around every forward of ``module``."""
    open_spans = []

    def pre(_mod, _args):
        rf = record_function(name)
        rf.__enter__()
        open_spans.append(rf)

    def post(_mod, _args, _out):
        open_spans.pop().__exit__(None, None, None)

    handles = [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def method_span(obj, attr: str, name: str):
    """A ``name`` span around every call of ``obj.attr`` (this instance only)."""
    bound = getattr(obj, attr)

    def wrapped(*args, **kwargs):
        with record_function(name):
            return bound(*args, **kwargs)

    object.__setattr__(obj, attr, wrapped)
    try:
        yield
    finally:
        object.__delattr__(obj, attr)


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


@contextlib.contextmanager
def profiled(path: Path, device: torch.device):
    """Profile the block inside a ``bench/window`` span that ends after a
    synchronize, and write the chrome trace to ``path``."""
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            yield
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))


class Trace:
    """The reduced chrome trace of one profiled window."""

    def __init__(self, path: Path):
        events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
                  if e.get("ph") == "X"]
        win = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
        if not win:
            raise ValueError(f"{path}: no {WINDOW} span")
        self.w0, self.w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
        self.device = [e for e in events if e.get("cat") in DEVICE_CATS]
        self.launch = {e["args"]["correlation"]: e["ts"] for e in events
                       if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and "correlation" in e.get("args", {})}
        self.spans: dict[str, list[tuple[float, float]]] = {}
        for e in events:
            if e.get("cat") == "user_annotation" and e["name"] != WINDOW:
                self.spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
        for v in self.spans.values():
            v.sort()

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e6

    def busy_s(self) -> float:
        """Seconds of the window in which some device activity ran."""
        return union_us([(max(e["ts"], self.w0), min(e["ts"] + e["dur"], self.w1))
                         for e in self.device if e["ts"] < self.w1
                         and e["ts"] + e["dur"] > self.w0]) / 1e6

    def span_device_s(self, *names: str) -> float | None:
        """Device seconds launched inside any of the spans ``names``; None
        when none of them was recorded."""
        merged: list[list[float]] = []
        for a, b in sorted(iv for n in names for iv in self.spans.get(n, [])):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        if not merged:
            return None
        starts = [a for a, _ in merged]
        total = 0.0
        for e in self.device:
            ts = self.launch.get(e.get("args", {}).get("correlation"))
            k = bisect.bisect_right(starts, ts) - 1 if ts is not None else -1
            if k >= 0 and ts <= merged[k][1]:
                total += e["dur"]
        return total / 1e6

    def kernel_s(self, fragment: str) -> float | None:
        """Device seconds of the kernels whose name holds ``fragment``; None
        when there is none."""
        durs = [e["dur"] for e in self.device if fragment in e["name"]]
        return sum(durs) / 1e6 if durs else None

    def top_ops(self, n: int = 10) -> list[list]:
        """The ``n`` device operations that took most time: [name, seconds]."""
        by_name: dict[str, float] = {}
        for e in self.device:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
        return [[k[:200], v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The ``n`` longest stretches of the window with no device activity,
        each named by the innermost span the host was in at its start
        ("host" outside every span): [name, seconds]."""
        busy = sorted((max(e["ts"], self.w0), min(e["ts"] + e["dur"], self.w1))
                      for e in self.device if e["ts"] < self.w1 and e["ts"] + e["dur"] > self.w0)
        gaps, reach = [], self.w0
        for a, b in busy:
            if a > reach:
                gaps.append((reach, a))
            reach = max(reach, b)
        if self.w1 > reach:
            gaps.append((reach, self.w1))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            inner = [(iv[1] - iv[0], name) for name, ivs in self.spans.items()
                     for iv in ivs if iv[0] <= a < iv[1]]
            out.append([min(inner)[1] if inner else "host", (b - a) / 1e6])
        return out
