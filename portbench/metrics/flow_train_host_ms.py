"""flow_train_host_ms: host ms a step inside the program's span
``stage2/flow`` (the enqueue of the flow's forward, loss and backward)."""

from portbench import program_spans


def read(ctx):
    s = None if ctx.trace is None else program_spans.host_s(ctx.trace, "stage2/flow")
    return None if s is None else 1e3 * s / ctx.calls
