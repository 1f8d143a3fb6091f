"""program_idle_ms.train: device-idle ms a step in stretches that start
while the host is inside a program span (``stage1/...``, ``data/augment``);
the rest of ``idle_share.train`` starts in the caller (the fetch every
``fetch_every`` steps, the draws)."""

from portbench import program_spans


def read(ctx):
    s = None if ctx.trace is None else program_spans.program_idle_s(ctx.trace)
    return None if s is None else 1e3 * s / ctx.calls
