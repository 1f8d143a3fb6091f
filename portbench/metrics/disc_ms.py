"""disc_ms: device ms a step under the program's spans ``stage1/disc_t`` and
``stage1/disc_s`` (both discriminators, the gradient penalty and their two
Adam updates)."""


def read(ctx):
    return ctx.per_call_ms("stage1/disc_t", "stage1/disc_s")
