"""vae_backward_ms: device ms a step under the program's span
``stage1/vae_backward`` (train/stage1_step.py), autograd's thread included."""


def read(ctx):
    return ctx.per_call_ms("stage1/vae_backward")
