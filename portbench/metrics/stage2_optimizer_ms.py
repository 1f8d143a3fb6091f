"""stage2_optimizer_ms: device ms a step launched inside the program's span
``stage2/optimizer`` (the AMSGrad ``Adam`` on the flow's parameters)."""


def read(ctx):
    return ctx.per_call_ms("stage2/optimizer")
