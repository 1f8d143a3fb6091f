"""flow_train_launches: device operations (kernels, memcpys, memsets) a step
launched inside the program's span ``stage2/flow``, autograd's thread
included."""

from portbench import program_spans


def read(ctx):
    ops = None if ctx.trace is None else program_spans.launched(ctx.trace, "stage2/flow")
    return None if ops is None else len(ops) / ctx.calls
