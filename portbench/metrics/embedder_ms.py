"""embedder_ms: device ms a call under the ``bench/embedder`` span, the
wrapper around the embedder's ``encode`` (models/stage2/resnet2d.py)."""


def read(ctx):
    return ctx.per_call_ms("bench/embedder")
