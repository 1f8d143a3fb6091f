"""stage2_embed_ms: device ms a step launched inside the program's span
``stage2/embedder`` (``train/stage2.py::_flow_step``: the frozen embedder on
the start frame)."""


def read(ctx):
    return ctx.per_call_ms("stage2/embedder")
