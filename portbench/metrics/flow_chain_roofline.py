"""flow_chain_roofline: the chain's least time over its kernel time, in %.

The least time is the larger of its FLOPs over the peak of its weights'
precision (the bf16 tensor cores) and its bytes over the HBM bandwidth
(``count.chain_bytes``: the weights once per chain, the biases, x in and
out, the embedding). The kernel time is every kernel whose name holds
``chain_kernel`` in the profiled window."""

from portbench import count


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.kernel_s("chain_kernel")
    if t is None:
        return None
    c = ctx.counts["chain"]
    least = count.roofline_s(c["flops"], c["bytes"], c["precision"]) * ctx.calls
    return 100.0 * least / t
