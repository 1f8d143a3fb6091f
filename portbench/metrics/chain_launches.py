"""chain_launches: the program's ``model/chain`` spans a call, one a kernel
launch of at most ``MAX_BATCH`` rows (one a call on the plain flow)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.spans.get("model/chain"):
        return None
    return len(ctx.trace.spans["model/chain"]) / ctx.calls
