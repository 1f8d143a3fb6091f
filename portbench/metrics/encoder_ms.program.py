"""encoder_ms.program: device ms a call launched inside the program's span
``model/encode`` (the dynamics encoder's pass over the query in
``Model.transfer_sample``); ``encoder_ms`` reads the benchmark's hooks."""


def read(ctx):
    return ctx.per_call_ms("model/encode")
