"""flow_train_ms: device ms a step launched inside the program's span
``stage2/flow`` (``train/stage2.py::_flow_step``: the plain flow's forward,
``flow_loss`` and the backward), autograd's thread included."""


def read(ctx):
    return ctx.per_call_ms("stage2/flow")
