"""Operations and bytes from shapes, and the peaks of the card.

Every count here is a function of a configuration's sizes and a batch; none
reads the program. FLOPs count the multiply-adds of convolutions and dense
layers as 2 each, as ``torch.utils.flop_counter`` does (biases, norms,
activations and resampling are left out). The tests hold each forward count
to ``FlopCounterMode`` on the module it names, at the tiny preset.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit: 989
TFLOP/s bf16 dense on the tensor cores, 67 TFLOP/s fp32 outside them, 3.35
TB/s of HBM.
"""

from __future__ import annotations

import math

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
ITEM_BYTES = {"bfloat16": 2, "float32": 4}


def _out(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - k) // s + 1


def conv_flops(c_in: int, c_out: int, kernel: tuple, out_shape: tuple, batch: int) -> int:
    """One convolution: 2 * c_in * c_out * prod(kernel) per output position."""
    return 2 * c_in * c_out * math.prod(kernel) * math.prod(out_shape) * batch


# -- the decoder (models/stage1/decoder.py) -------------------------------------------

def decoder_flops(dec: dict, batch: int) -> int:
    """One decode of ``Generator`` (the ``Decoder`` section: channel_factor nf,
    z_dim, upsample_s, upsample_t) for ``batch`` videos: ``fc`` (z -> 256 nf),
    six ``GeneratorBlock``s (``conv_0``, ``conv_1`` 3x3x3, ``conv_s`` 1x1x1
    where the width changes; ``Spade``'s three 3x3 2-D convs at the block's
    input size; ``ADAIN``'s dense z -> 2 n_middle) at (1, 4, 4), then x2 in
    T, H, W three times and (upsample_t[i], upsample_s[i]) twice, and
    ``conv_img`` (nf -> 3, 3x3x3)."""
    nf, z = dec["channel_factor"], dec["z_dim"]
    widths = [(16 * nf, 16 * nf), (16 * nf, 16 * nf), (16 * nf, 8 * nf), (8 * nf, 4 * nf),
              (4 * nf, 2 * nf), (2 * nf, nf)]
    ups = [(1, 1), (2, 2), (2, 2), (2, 2), (dec["upsample_t"][0], dec["upsample_s"][0]),
           (dec["upsample_t"][1], dec["upsample_s"][1])]
    t, hw = 1, 4
    total = 2 * z * 256 * nf * batch  # fc
    for (n_in, n_out), (ft, fs) in zip(widths, ups):
        t, hw = t * ft, hw * fs
        mid = min(n_in, n_out)
        vol = (t, hw, hw)
        total += conv_flops(n_in, mid, (3, 3, 3), vol, batch)
        total += conv_flops(mid, n_out, (3, 3, 3), vol, batch)
        if n_in != n_out:
            total += conv_flops(n_in, n_out, (1, 1, 1), vol, batch)
        total += conv_flops(3, 128, (3, 3), (hw, hw), batch)  # Spade
        total += 2 * conv_flops(128, n_in, (3, 3), (hw, hw), batch)
        total += 2 * z * 2 * mid * batch  # ADAIN
    total += conv_flops(nf, 3, (3, 3, 3), (t, hw, hw), batch)
    return total


def decoder_frames(dec: dict) -> int:
    """Frames one decode gives: 8 * prod(upsample_t)."""
    return 8 * math.prod(dec["upsample_t"])


def decoder_weight_count(dec: dict) -> int:
    """Weights of the serving ``Generator`` (bytes bound of a decode)."""
    nf, z = dec["channel_factor"], dec["z_dim"]
    widths = [(16 * nf, 16 * nf), (16 * nf, 16 * nf), (16 * nf, 8 * nf), (8 * nf, 4 * nf),
              (4 * nf, 2 * nf), (2 * nf, nf)]
    n = z * 256 * nf + 256 * nf
    for n_in, n_out in widths:
        mid = min(n_in, n_out)
        n += n_in * mid * 27 + mid + mid * n_out * 27 + n_out
        n += (n_in * n_out + 2 * n_in) if n_in != n_out else 0
        n += 3 * 128 * 9 + 128 + 2 * (128 * n_in * 9 + n_in) + z * 2 * mid + 2 * mid
    return n + nf * 3 * 27 + 3


# -- the 2-D embedder (models/stage2/resnet2d.py) ---------------------------------------

RESNET2D = {"resnet18": ("basic", (2, 2, 2, 2)), "resnet34": ("basic", (3, 4, 6, 3)),
            "resnet50": ("bottleneck", (3, 4, 6, 3)), "resnet101": ("bottleneck", (3, 4, 23, 3))}


def embedder_flops(ae: dict, img: int, batch: int) -> int:
    """``ResnetEncoder`` (the ``AE`` section's encoder_type and z_dim) on
    ``batch`` images of img x img: the torchvision trunk (7x7/2 stem, max
    pool /2, four stages at strides 1, 2, 2, 2) and the 1x1 head to 2 z."""
    kind, layers = RESNET2D[ae["encoder_type"]]
    exp = 1 if kind == "basic" else 4
    h = _out(img, 7, 2, 3)
    total = conv_flops(3, 64, (7, 7), (h, h), batch)
    h = _out(h, 3, 2, 1)
    inplanes = 64
    for stage, planes in enumerate((64, 128, 256, 512)):
        for b in range(layers[stage]):
            s = 2 if stage and b == 0 else 1
            ho = _out(h, 3, s, 1)
            if kind == "basic":
                total += conv_flops(inplanes, planes, (3, 3), (ho, ho), batch)
                total += conv_flops(planes, planes, (3, 3), (ho, ho), batch)
            else:
                total += conv_flops(inplanes, planes, (1, 1), (h, h), batch)
                total += conv_flops(planes, planes, (3, 3), (ho, ho), batch)
                total += conv_flops(planes, planes * 4, (1, 1), (ho, ho), batch)
            if b == 0 and (s != 1 or inplanes != planes * exp):
                total += conv_flops(inplanes, planes * exp, (1, 1), (ho, ho), batch)
            inplanes, h = planes * exp, ho
    return total + conv_flops(inplanes, 2 * ae["z_dim"], (1, 1), (1, 1), batch)


# -- the 3-D backbones (models/stage1/resnet3d.py) ---------------------------------------

RESNET3D_BLOCKS = {"resnet10": (1, 1, 1, 1), "resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}


def backbone3d_flops(dic: dict, frames: int, img: int, batch: int, stem_stride_t: int,
                     downsample_on_stride_t: bool) -> tuple[int, tuple]:
    """``ResNet3DBackbone`` of basic blocks (channels, stride_s, stride_t,
    use_max_pool) on ``batch`` clips of frames x img x img: (FLOPs, the last
    stage's (C, T, H, W))."""
    ch = dic["channels"]
    t, h = _out(frames, 3, stem_stride_t, 1), _out(img, 7, 2, 3)
    total = conv_flops(3, ch[0], (3, 7, 7), (t, h, h), batch)
    if dic["use_max_pool"]:
        t, h = _out(t, 3, 1, 1), _out(h, 3, 2, 1)
    inplanes = ch[0]
    for stage, planes in enumerate(ch[1:]):
        for b in range(RESNET3D_BLOCKS[dic["res_type_encoder"]][stage]):
            s, st = (dic["stride_s"][stage], dic["stride_t"][stage]) if b == 0 else (1, 1)
            to, ho = _out(t, 3, st, 1), _out(h, 3, s, 1)
            total += conv_flops(inplanes, planes, (3, 3, 3), (to, ho, ho), batch)
            total += conv_flops(planes, planes, (3, 3, 3), (to, ho, ho), batch)
            if b == 0 and (s != 1 or inplanes != planes or (downsample_on_stride_t and st != 1)):
                total += conv_flops(inplanes, planes, (3, 3, 3), (to, ho, ho), batch)
            inplanes, t, h = planes, to, ho
    return total, (inplanes, t, h, h)


def encoder_flops(enc: dict, frames: int, img: int, batch: int) -> int:
    """The dynamics ``Encoder`` on ``batch`` clips: the backbone (temporal
    stem stride 2) and the two 4x4 heads to z_dim."""
    total, (c, _, _, _) = backbone3d_flops(enc, frames, img, batch, 2, False)
    return total + 2 * conv_flops(c, enc["z_dim"], (4, 4), (1, 1), batch)


def disc_t_flops(dic: dict, frames: int, img: int, batch: int) -> int:
    """The temporal ``Discriminator`` on ``batch`` clips: the backbone (stem
    stride 1 in time, max pool, downsample where a block strides in time)
    and the dense head on the pooled (1, 4, 4) map."""
    total, (c, t, h, w) = backbone3d_flops(dic, frames, img, batch, 1, True)
    return total + 2 * c * t * (h - 3) * (w - 3) * batch


def patch_disc_flops(dic: dict, img: int, batch: int) -> int:
    """``NLayerDiscriminator`` (ndf, n_layers) on ``batch`` images: 4x4 convs,
    stride 2 then stride 1 twice, padding 1."""
    ndf, n_layers = dic["ndf"], dic["n_layers"]
    h = _out(img, 4, 2, 1)
    total = conv_flops(dic["in_channels"], ndf, (4, 4), (h, h), batch)
    n_in = ndf
    for n in range(1, n_layers + 1):
        n_out = ndf * min(2 ** n, 8)
        h = _out(h, 4, 2 if n < n_layers else 1, 1)
        total += conv_flops(n_in, n_out, (4, 4), (h, h), batch)
        n_in = n_out
    h = _out(h, 4, 1, 1)
    return total + conv_flops(n_in, 1, (4, 4), (h, h), batch)


VGG_STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


def lpips_flops(img: int, pairs: int) -> int:
    """``LPIPS`` on ``pairs`` image pairs: VGG16's 13 3x3 convs on both
    images, and the five 1x1 heads on the differences."""
    total, c, h = 0, 3, img
    for stage, (n_convs, ch) in enumerate(VGG_STAGES):
        if stage:
            h //= 2
        for _ in range(n_convs):
            total += conv_flops(c, ch, (3, 3), (h, h), 2 * pairs)
            c = ch
        total += conv_flops(ch, 1, (1, 1), (h, h), pairs)
    return total


# -- the flow chain (models/stage2/flow.py -> csrc/flow_chain.cu) --------------------------

def chain_weight_count(c: int, e: int, hidden: int, depth: int, n_flows: int) -> int:
    """The coupling MLPs' weights: per block two passes of an s and a t net
    of layers (c/2 + e -> hidden), depth x (hidden -> hidden), (hidden -> c/2)."""
    dims = [(c // 2 + e, hidden)] + [(hidden, hidden)] * depth + [(hidden, c // 2)]
    return n_flows * 4 * sum(di * do for di, do in dims)


def chain_flops(c: int, e: int, hidden: int, depth: int, n_flows: int, batch: int) -> int:
    """One chain (forward or reverse) over ``batch`` rows: 2 FLOPs a weight a row."""
    return 2 * batch * chain_weight_count(c, e, hidden, depth, n_flows)


def chain_bytes(c: int, e: int, hidden: int, depth: int, n_flows: int, batch: int,
                weight_dtype: str) -> int:
    """Bytes one chain over ``batch`` rows must move: its weights once in
    their dtype, the fp32 biases, ActNorm loc and scale, x in and out, the
    embedding in."""
    dims = [(c // 2 + e, hidden)] + [(hidden, hidden)] * depth + [(hidden, c // 2)]
    biases = n_flows * 4 * sum(do for _, do in dims)
    return (chain_weight_count(c, e, hidden, depth, n_flows) * ITEM_BYTES[weight_dtype]
            + 4 * (biases + 2 * n_flows * c) + 4 * batch * (2 * c + e))


def roofline_s(flops: float, nbytes: float, precision: str) -> float:
    """The least time: the larger of FLOPs over the precision's peak and
    bytes over the HBM bandwidth."""
    return max(flops / PEAK_FLOPS[precision], nbytes / PEAK_BYTES_PER_S)


# -- whole calls and steps --------------------------------------------------------------

def chain_shape(cfg: dict) -> tuple[int, int, int, int, int]:
    """(c, e, hidden, depth, n_flows) of a configuration's flow."""
    z = cfg["Decoder"]["z_dim"]
    fl = cfg["Flow"]
    return (z, cfg["AE"]["z_dim"], z * fl["flow_mid_channels_factor"], fl["flow_hidden_depth"],
            fl["n_flows"])


def decodes(cfg: dict, vid_length: int) -> int:
    """Decodes a served video takes: the first and the extensions."""
    return -(-vid_length // decoder_frames(cfg["Decoder"]))


def stage1_step_flops(cfg: dict, batch: int) -> int:
    """One ``Stage1Step`` with the gates open on ``batch`` clips of
    ``sequence_length`` frames: the VAE forward (encoder on frames 1:, one
    decode), its backward (2x each forward); the temporal discriminator on the
    subsample, fake and real (2 forwards), the gradient penalty's input
    gradient (1 forward) and the update's backward through both forwards and
    the penalty's graph (2 forwards each: 6); the patch discriminator on the
    20 frames, fake and real, forward and backward (6); the VAE loss's
    discriminator forwards (patch 1, temporal 2) and LPIPS on every frame
    pair, and the VAE backward's input gradients through them (patch 1,
    temporal 1, LPIPS's generated half 1). Gradients through a network cost
    twice its forward (input and weight), input gradients alone once."""
    tr, img = cfg["Training"], cfg["Data"]["img_size"]
    frames = cfg["Data"]["sequence_length"] - 1
    sub = int(tr["subsample_length"]) if frames >= 16 else frames
    f_enc = encoder_flops(cfg["Encoder"], frames, img, batch)
    f_dec = decoder_flops(cfg["Decoder"], batch)
    f_dt = disc_t_flops(cfg["Discriminator_Temporal"], sub, img, batch)
    f_ds = patch_disc_flops(cfg["Discriminator_Patch"], img, 20)
    f_lp = lpips_flops(img, batch * frames) // 2  # one image of each pair
    return 3 * (f_enc + f_dec) + 12 * f_dt + 8 * f_ds + 3 * f_lp
