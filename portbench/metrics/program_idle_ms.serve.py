"""program_idle_ms.serve: device-idle ms a call in stretches that start
while the host is inside a program span (``model/...``); the rest of
``idle_share.serve`` starts in the caller."""

from portbench import program_spans


def read(ctx):
    s = None if ctx.trace is None else program_spans.program_idle_s(ctx.trace)
    return None if s is None else 1e3 * s / ctx.calls
