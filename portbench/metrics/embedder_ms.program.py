"""embedder_ms.program: device ms a call launched inside the program's span
``model/embed`` (``SupervisedTransformer.embed``: the embedder's encode,
``.mode()``, the reshape and the control concat); ``embedder_ms`` reads the
benchmark's own span around the encode."""


def read(ctx):
    return ctx.per_call_ms("model/embed")
