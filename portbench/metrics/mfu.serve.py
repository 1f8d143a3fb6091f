"""mfu.serve: the model FLOPs of the profiled calls, each part (decoder,
embedder, chains, encoder) over its precision's peak, summed, over the
traced window's wall time, in %."""

from portbench import count


def read(ctx):
    if ctx.trace is None:
        return None
    ideal = sum(p["flops"] / count.PEAK_FLOPS[p["precision"]] for p in ctx.counts.values())
    return 100.0 * ideal * ctx.calls / ctx.trace.window_s
