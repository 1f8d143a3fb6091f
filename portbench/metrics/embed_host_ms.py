"""embed_host_ms: host ms a call inside the program's span ``model/embed``
(every embed of the call: the start frames', and in transfer the query's
first frame)."""

from portbench import program_spans


def read(ctx):
    s = None if ctx.trace is None else program_spans.host_s(ctx.trace, "model/embed")
    return None if s is None else 1e3 * s / ctx.calls
