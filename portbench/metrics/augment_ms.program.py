"""augment_ms.program: device ms a step launched inside the program's span
``data/augment`` (``data/augment.py::apply_augment``); ``augment_ms`` reads
the benchmark's own span around the transform."""


def read(ctx):
    return ctx.per_call_ms("data/augment")
