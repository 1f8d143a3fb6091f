"""decode_launches: device operations (kernels, memcpys, memsets) a call
launched inside the program's span ``model/decode``."""

from portbench import program_spans


def read(ctx):
    ops = None if ctx.trace is None else program_spans.launched(ctx.trace, "model/decode")
    return None if ops is None else len(ops) / ctx.calls
