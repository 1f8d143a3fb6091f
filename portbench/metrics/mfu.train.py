"""mfu.train: the model FLOPs of the profiled steps (``count.stage1_step_flops``:
forward, backward, the gradient penalty's double backward, LPIPS) over
fp32's peak, over the traced window's wall time, in %."""

from portbench import count


def read(ctx):
    if ctx.trace is None:
        return None
    step = ctx.counts["step"]
    ideal = step["flops"] / count.PEAK_FLOPS[step["precision"]]
    return 100.0 * ideal * ctx.calls / ctx.trace.window_s
