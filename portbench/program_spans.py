"""What the readers of the program's own spans share.

The port opens its spans through ``utils/profiling.annotate`` (``model/...``
in serving, ``stage1/...`` in the stage-1 step, ``data/augment``); they lie
in the same trace as the kernels, on its clock. Each helper takes a
``tracing.Trace`` and returns None where the trace holds none of the spans
it reads, so that a reader reports nothing on a program without them.

* ``host_s``: the union of a span set's host intervals, in seconds.
* ``launched``: the device operations (kernels, memcpys, memsets) whose
  launch, found by correlation, lies inside a span set.
* ``program_idle_s``: the device-idle stretches of the window that start
  while the host is inside a span of the program (any span whose name does
  not start with ``bench/``), in seconds; the rest of the idle time starts
  in the caller.
"""

from __future__ import annotations

import bisect

from . import tracing

BENCH = "bench/"


def merged(intervals) -> list[list[float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _inside(union: list[list[float]], starts: list[float], t: float) -> bool:
    """Whether ``t`` lies in one of the ``merged`` intervals ``union``,
    whose starts are ``starts``."""
    k = bisect.bisect_right(starts, t) - 1
    return k >= 0 and t <= union[k][1]


def _union(tr, names) -> list[list[float]]:
    return merged(iv for n in names for iv in tr.spans.get(n, []))


def host_s(tr, *names: str) -> float | None:
    """Host seconds inside any of the spans ``names``."""
    ivs = [iv for n in names for iv in tr.spans.get(n, [])]
    return tracing.union_us(ivs) / 1e6 if ivs else None


def launched(tr, *names: str) -> list[dict] | None:
    """The device operations launched inside any of the spans ``names``."""
    union = _union(tr, names)
    if not union:
        return None
    starts = [a for a, _ in union]
    out = []
    for e in tr.device:
        ts = tr.launch.get(e.get("args", {}).get("correlation"))
        if ts is not None and _inside(union, starts, ts):
            out.append(e)
    return out


def idle_stretches(tr) -> list[tuple[float, float]]:
    """The stretches of the window with no device activity."""
    busy = sorted((max(e["ts"], tr.w0), min(e["ts"] + e["dur"], tr.w1))
                  for e in tr.device if e["ts"] < tr.w1 and e["ts"] + e["dur"] > tr.w0)
    gaps, reach = [], tr.w0
    for a, b in busy:
        if a > reach:
            gaps.append((reach, a))
        reach = max(reach, b)
    if tr.w1 > reach:
        gaps.append((reach, tr.w1))
    return gaps


def program_idle_s(tr) -> float | None:
    """Idle seconds of the stretches that start inside a program span."""
    union = merged(iv for n, ivs in tr.spans.items() if not n.startswith(BENCH) for iv in ivs)
    if not union:
        return None
    starts = [a for a, _ in union]
    return sum(b - a for a, b in idle_stretches(tr) if _inside(union, starts, a)) / 1e6
