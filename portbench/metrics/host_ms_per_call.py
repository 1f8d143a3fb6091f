"""host_ms_per_call: the median host time from a call's start to its
return, before the benchmark's synchronize (the facade's enqueue cost), over
the traced run's untraced host-timing calls."""

import statistics


def read(ctx):
    return 1e3 * statistics.median(ctx.host_call_s) if ctx.host_call_s else None
