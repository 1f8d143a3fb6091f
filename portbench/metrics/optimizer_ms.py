"""optimizer_ms: device ms a step under the program's span
``stage1/optimizer`` (the autoencoder's Adam; the discriminators' Adams run
inside their own spans)."""


def read(ctx):
    return ctx.per_call_ms("stage1/optimizer")
