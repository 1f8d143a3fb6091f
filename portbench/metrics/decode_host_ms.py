"""decode_host_ms: host ms a call inside the program's span ``model/decode``
(the enqueue of every decode chunk)."""

from portbench import program_spans


def read(ctx):
    s = None if ctx.trace is None else program_spans.host_s(ctx.trace, "model/decode")
    return None if s is None else 1e3 * s / ctx.calls
