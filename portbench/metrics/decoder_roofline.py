"""decoder_roofline: the decoder's least time over its device time under the
``bench/decoder`` span, in %. The least time is the larger of its FLOPs
(``count.decoder_flops``, every decode of a call) over the peak of its
precision and its weights and frames over the HBM bandwidth."""

from portbench import count


def read(ctx):
    ms = ctx.per_call_ms("bench/decoder")
    if not ms:
        return None
    d = ctx.counts["decoder"]
    return 100.0 * count.roofline_s(d["flops"], d["bytes"], d["precision"]) / (ms / 1e3)
