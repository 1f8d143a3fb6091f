"""idle_share.train: the share of the traced window's wall time in which no
kernel, memcpy or memset ran on the device, in %."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
