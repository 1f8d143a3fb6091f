"""augment_ms: device ms a step under the ``bench/augment`` span, the
benchmark's span around the train augment (data/augment.py)."""


def read(ctx):
    return ctx.per_call_ms("bench/augment")
