"""posterior_ms: device ms a step launched inside the program's span
``stage2/posterior`` (``train/stage2.py::train_step``: the frozen 3-D
encoder's posterior sample of frames 1:)."""


def read(ctx):
    return ctx.per_call_ms("stage2/posterior")
