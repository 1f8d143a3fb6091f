"""encoder_ms: device ms a call under the ``bench/encoder`` span, the hooks
on the dynamics encoder (models/stage1/resnet3d.py)."""


def read(ctx):
    return ctx.per_call_ms("bench/encoder")
