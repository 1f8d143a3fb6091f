"""Preemption handling and the debug-NaN switch (port of ``utils/preemption.py``).

``PreemptionGuard`` turns SIGTERM into a flag that the trainers poll once
per step: on it they write the latest checkpoint (atomically) and stop, so
that the next run resumes from it. ``I2V_DEBUG_NANS=1`` turns on autograd's
anomaly detection, which raises at the backward op that first produces a
NaN: the port's counterpart of ``jax_debug_nans``.
"""

from __future__ import annotations

import os
import signal


def maybe_enable_debug_nans() -> bool:
    if os.environ.get("I2V_DEBUG_NANS", "") not in ("", "0"):
        import torch

        torch.autograd.set_detect_anomaly(True)
        return True
    return False


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM,)):
        self._stop = False
        self._prev = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):  # not the main thread, or unsupported
                pass

    def _handler(self, signum, frame):
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop

    def restore(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
