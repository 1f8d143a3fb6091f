"""decoder_roofline.program: ``decoder_roofline``'s least time over the
device time launched inside the program's span ``model/decode`` (one a
16-frame chunk: the casts, the decoder, the gather, ``.float()``), in %."""

from portbench import count


def read(ctx):
    ms = ctx.per_call_ms("model/decode")
    if not ms:
        return None
    d = ctx.counts["decoder"]
    return 100.0 * count.roofline_s(d["flops"], d["bytes"], d["precision"]) / (ms / 1e3)
