"""step_host_ms: host ms a step inside the program's span ``stage1/step``
(``Stage1Step.__call__``, the enqueue of the whole step)."""

from portbench import program_spans


def read(ctx):
    s = None if ctx.trace is None else program_spans.host_s(ctx.trace, "stage1/step")
    return None if s is None else 1e3 * s / ctx.calls
