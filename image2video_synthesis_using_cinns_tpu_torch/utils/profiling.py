"""Spans and timing (port of ``utils/profiling.py``) on ``torch.profiler``.

- ``annotate(name)``: a ``record_function`` span while a torch profiler
  records, so the program's phases (a call's embed, chains and decode
  chunks, a training step's parts) show in the same trace as the kernels
  they launch, on its clock; otherwise one shared ``nullcontext``, so a span
  costs one attribute read when nothing records. Spans nest on the thread
  that enters them: a request's spans lie inside its root (``model/sample``,
  ``model/transfer``, ``stage1/step``).
- ``StepTimer``: wall-clock step times with an EMA, for the trainers' logs;
  ``stop(result)`` first waits for the card when ``result`` holds CUDA
  tensors, where the JAX package blocks until the result is ready.

A trace is taken by the caller, with ``torch.profiler.profile`` around the
calls it wants to see.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A ``record_function(name)`` span when a profiler records, else the
    shared null context."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF


def _synchronize(result) -> None:
    """Wait for the cards that hold a tensor of ``result`` (nested lists,
    tuples and dicts)."""
    stack, devices = [result], set()
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    for d in devices:
        torch.cuda.synchronize(d)


class StepTimer:
    def __init__(self, ema: float = 0.9):
        self._ema_coef = ema
        self.ema_ms: float | None = None
        self.last_ms: float = 0.0
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        if result is not None:
            _synchronize(result)
        dt = (time.perf_counter() - self._t0) * 1000.0
        self.last_ms = dt
        self.ema_ms = dt if self.ema_ms is None else (
            self._ema_coef * self.ema_ms + (1 - self._ema_coef) * dt)
        return dt

    @contextlib.contextmanager
    def measure(self):
        self.start()
        try:
            yield self
        finally:
            self.stop()
