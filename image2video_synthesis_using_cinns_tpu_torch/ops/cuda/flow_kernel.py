"""The conditional-flow chain as a hand-written CUDA kernel for Hopper.

Replaces the Pallas TPU kernel ``_flow_fused`` in
``image2video_synthesis_using_cinns_tpu/ops/pallas/flow_kernel.py``
(pallas_call at :191; ``flow_reverse_fused`` :221 on the sampling path and
``flow_forward_fused`` :215). Source: ``csrc/flow_chain.cu``.

What it computes: the 20-block flow chain, reverse (shuffle^-1, coupling
pass 1, swap, pass 0, InvLeakyReLU^-1, ActNorm^-1 per block, blocks n-1..0)
or forward (ActNorm with logdet, InvLeakyReLU, pass 0, swap, pass 1 with
logdet, shuffle). Each coupling pass runs two 4-layer MLPs (s and t) on
``concat(x_half * mask, emb)``.

What bounds it on the H100. At the BAIR shape (B=6, C=64, E=64, hidden
512, 20 blocks) one chain reads 47.2 M weights, 94.4 MB in bf16 (28 us at
3.35 TB/s) or 189 MB in fp32, and does about 2 * B flops per weight. But its
160 MLP layers depend on each other in a row, and each needs every output of
its net in the layer before, so the chain is bound by 160 hand-offs between
CTAs (stores to L2, a signal, and the loads by the CTAs that need them), not
by bytes.

What the design does about it: one persistent, cooperative launch per chain
(one CTA per SM). Each layer's output columns, s and t together, are cut into
tiles of ``TILE_N`` columns owned by fixed CTAs, so each CTA streams its
weight slabs (stored contiguously by ``PackedFlow``) through a 128 KB ring in
shared memory with ``cp.async.bulk``, many layers ahead of the math, while it
waits for its input. There is no grid barrier: a net's count of finished
tiles (release/acquire) hands a hidden layer to the next, and the last
layer's (s, t) travel as 8-byte units that carry a flag naming the call and
the pass. After a coupling pass every CTA applies the glue (coupling update,
swap, InvLeakyReLU, ActNorm, logdet, shuffle, the next coupling input) to its
own copy of x in shared memory. ``csrc/flow_chain.cu`` says how this answers
each of the five causes that held the first design (201 launches per chain)
back, and why its buffers may be reused with no further wait.

Numerics match the Pallas kernel: in bf16-weight mode every product's
activation input (the coupling input included) is rounded to bf16, products
accumulate in fp32, biases are fp32. The fp32-weight mode rounds nowhere.
The shuffle is an exact gather (the Pallas one-hot matmul is exact too).

On a CPU tensor the wrappers run the plain PyTorch version below
(``*_ref``); on a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn as nn

from . import build

LRELU_SLOPE = 0.01  # LeakyReLU inside the coupling MLPs
INV_LRELU_ALPHA = 0.9
HIDDEN_DEPTH = 2  # the only specialised depth: 4 linear layers per MLP
N_LAYERS = HIDDEN_DEPTH + 2
MAX_BATCH = 16  # kMaxB in csrc/flow_chain.cu
TILE_N = 8  # kTileN in csrc/flow_chain.cu: the columns of a tile; packed widths are padded to it
BARRIER_WORDS = 3 * 32  # kBarrierWords in csrc/flow_chain.cu: the counts of the hand-offs
# the library the wrappers launch: csrc/flow_chain.cu, or its timeline build
# csrc/flow_chain_timeline.cu, which also records where a chain's time goes
LIBRARY = "flow_chain"

# launches of the chain, per wrapper: each adds one where it launches it
launches = {"flow_reverse_fused": 0, "flow_forward_fused": 0}
# the device kernels those chains launched (1 per chain), as the C function
# reports them
device_launches = {"flow_reverse_fused": 0, "flow_forward_fused": 0}


class PackedFlow(nn.Module):
    """The flow's weights in the kernel's layout, built once at load.

    Layer ``l`` is ``w{l}``: (n_flows, 2 passes, tiles, d_in, TILE_N) in the
    weight dtype, where the output width is zero-padded to ``d_pad``, a
    multiple of ``TILE_N``, and ``tiles = 2 * d_pad / TILE_N`` counts the s
    net's tiles, then the t net's. So the slab of one tile, the weights that
    one CTA streams for it, is contiguous. ``b{l}`` is (n_flows, 2, 2, d_pad)
    in fp32. Buffers are non-persistent: they are derived from the module's
    parameters and never saved.
    """

    def __init__(self, blocks: dict, shuffle_fwd: torch.Tensor, shuffle_inv: torch.Tensor,
                 mask: torch.Tensor, weight_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if weight_dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"weight dtype must be bfloat16 or float32, got {weight_dtype}")
        coupling = blocks["coupling"]
        if any(len(coupling[net]) != N_LAYERS for net in ("s0", "t0", "s1", "t1")):
            raise ValueError(f"the kernel takes {N_LAYERS}-layer coupling MLPs only")
        self.n_flows, self.C = blocks["loc"].shape
        if self.C % 2:
            raise ValueError("the flow's channel count must be even")
        self.H = coupling["s0"][0][0].shape[1]
        self.E = coupling["s0"][0][0].shape[2] - self.C // 2
        self.bf16 = weight_dtype == torch.bfloat16
        self.d_out = []
        for li in range(N_LAYERS):
            d_out, d_in = coupling["s0"][li][0].shape[1:]
            d_pad = -(-d_out // TILE_N) * TILE_N
            dev = blocks["loc"].device
            w = torch.zeros(self.n_flows, 2, 2, d_in, d_pad, dtype=weight_dtype, device=dev)
            b = torch.zeros(self.n_flows, 2, 2, d_pad, dtype=torch.float32, device=dev)
            for p in (0, 1):
                for k, net in enumerate((f"s{p}", f"t{p}")):
                    wt, bt = coupling[net][li]
                    w[:, p, k, :, :d_out] = wt.detach().transpose(1, 2).to(weight_dtype)
                    b[:, p, k, :d_out] = bt.detach().float()
            w = w.reshape(self.n_flows, 2, 2, d_in, d_pad // TILE_N, TILE_N)
            w = w.permute(0, 1, 2, 4, 3, 5).reshape(self.n_flows, 2, -1, d_in, TILE_N)
            self.register_buffer(f"w{li}", w.contiguous(), persistent=False)
            self.register_buffer(f"b{li}", b, persistent=False)
            self.d_out.append(d_out)
        self.register_buffer("loc", blocks["loc"].detach().float().contiguous(), persistent=False)
        self.register_buffer("scale", blocks["scale"].detach().float().contiguous(), persistent=False)
        self.register_buffer("fwd", shuffle_fwd.to(torch.int32).contiguous(), persistent=False)
        self.register_buffer("inv", shuffle_inv.to(torch.int32).contiguous(), persistent=False)
        self.register_buffer("mask", mask.detach().float().contiguous(), persistent=False)

    def weights(self) -> list[torch.Tensor]:
        return [getattr(self, f"w{li}") for li in range(N_LAYERS)]

    def biases(self) -> list[torch.Tensor]:
        return [getattr(self, f"b{li}") for li in range(N_LAYERS)]

    def dense(self, li: int, blk: int, pass_: int, net: int) -> torch.Tensor:
        """Layer ``li``'s (d_in, d_out) weight of one net, from its tiles."""
        w = getattr(self, f"w{li}")[blk, pass_]  # (tiles, d_in, TILE_N)
        per_net = w.shape[0] // 2
        w = w[net * per_net:(net + 1) * per_net].transpose(0, 1).reshape(w.shape[1], -1)
        return w[:, :self.d_out[li]]

    def weight_bytes(self) -> int:
        """Bytes of the unpadded weights one chain must read (bound accounting)."""
        item = 2 if self.bf16 else 4
        d_in = [self.C // 2 + self.E] + [self.H] * (N_LAYERS - 1)
        return sum(self.n_flows * 4 * di * do * item for di, do in zip(d_in, self.d_out))


# --------------------------------------------------------------------------
# plain PyTorch version: the same function, rounded at the same places
# --------------------------------------------------------------------------

def _mlp_ref(p: PackedFlow, blk: int, pass_: int, net: int, h: torch.Tensor) -> torch.Tensor:
    for li, b in enumerate(p.biases()):
        if p.bf16:
            h = h.to(torch.bfloat16).float()
        h = h @ p.dense(li, blk, pass_, net).float() + b[blk, pass_, net, :p.d_out[li]]
        if li < N_LAYERS - 1:
            h = torch.where(h >= 0, h, LRELU_SLOPE * h)
    return h


def _pass_ref(p: PackedFlow, blk: int, pass_: int, x, emb, reverse: bool):
    half = p.C // 2
    xa, xk = x[:, :half], x[:, half:]
    cin = torch.cat([xa * p.mask[blk], emb], dim=1)
    s = _mlp_ref(p, blk, pass_, 0, cin)
    t = _mlp_ref(p, blk, pass_, 1, cin)
    if reverse:
        xk = (xk - t) * torch.exp(-s)
    else:
        xk = xk * torch.exp(s) + t
    return torch.cat([xa, xk], dim=1), s.sum(dim=1)


def _swap(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[1] // 2
    return torch.cat([x[:, half:], x[:, :half]], dim=1)


def flow_reverse_fused_ref(p: PackedFlow, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    x, emb = x.float(), emb.float()
    for i in reversed(range(p.n_flows)):
        x = x[:, p.inv[i].long()]
        x, _ = _pass_ref(p, i, 1, x, emb, True)
        x = _swap(x)
        x, _ = _pass_ref(p, i, 0, x, emb, True)
        x = torch.where(x >= 0, x, x / INV_LRELU_ALPHA)
        x = x / p.scale[i] - p.loc[i]
    return x


def flow_forward_fused_ref(p: PackedFlow, x: torch.Tensor, emb: torch.Tensor):
    x, emb = x.float(), emb.float()
    logdet = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for i in range(p.n_flows):
        x = (x + p.loc[i]) * p.scale[i]
        logdet = logdet + torch.log(torch.abs(p.scale[i])).sum()
        x = torch.where(x >= 0, x, INV_LRELU_ALPHA * x)
        x, ld0 = _pass_ref(p, i, 0, x, emb, False)
        x = _swap(x)
        x, ld1 = _pass_ref(p, i, 1, x, emb, False)
        logdet = logdet + ld0 + ld1
        x = x[:, p.fwd[i].long()]
    return x, logdet


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------

def _type_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.flow_chain.argtypes = ([vp] * 17 + [ctypes.c_longlong, ctypes.c_uint] + [ci] * 7
                               + [vp, ctypes.POINTER(ci)])
    lib.flow_chain.restype = ci
    lib.flow_chain_error_string.argtypes = [ci]
    lib.flow_chain_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    return build.load(LIBRARY, _type_library)


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def workspace_bytes(C: int, H: int) -> int:
    """The kernel's workspace for a flow of C channels and hidden width H: the
    hand-offs' counts, two buffers of the last layer's (s, t) as 8-byte units,
    and two of the hidden layers' outputs, all sized for MAX_BATCH rows."""
    return (_round128(BARRIER_WORDS * 4) + 2 * _round128(2 * MAX_BATCH * (C // 2) * 8)
            + 2 * _round128(2 * MAX_BATCH * H * 4))


SEQ_LIMIT = 1 << 23  # 2^(32 - kFlagShift): calls on a workspace before its flags would repeat
_workspaces: dict[tuple[torch.device, int], list] = {}
_workspaces_lock = threading.Lock()  # two calls on a stream must not draw one number


def _workspace(device: torch.device, stream: int, nbytes: int) -> tuple[torch.Tensor, int]:
    """The workspace of chains on one stream and the number of this call on
    it. Chains on one stream run one after another, so they share it; another
    stream gets its own. It is zeroed when made, and again before the call
    number would repeat, since the kernel's flags name the call."""
    key = (device, stream)
    with _workspaces_lock:
        ws = _workspaces.get(key)
        if ws is None or ws[0].numel() < nbytes:
            ws = _workspaces[key] = [torch.zeros(nbytes, dtype=torch.uint8, device=device), 0]
        ws[1] += 1
        if ws[1] == SEQ_LIMIT:
            ws[0].zero_()
            ws[1] = 1
        return ws[0], ws[1]


def _check(p: PackedFlow, x: torch.Tensor, emb: torch.Tensor) -> None:
    b = x.shape[0]
    if x.dim() != 2 or emb.dim() != 2 or x.shape[1] != p.C or emb.shape != (b, p.E):
        raise ValueError(f"expected x (B, {p.C}) and emb (B, {p.E}), got "
                         f"{tuple(x.shape)} and {tuple(emb.shape)}")
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"the flow kernel takes 1..{MAX_BATCH} rows, got {b}")
    for name, t in (("x", x), ("emb", emb)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if t.device != p.loc.device:
            raise ValueError(f"{name} is on {t.device}, the packed weights on {p.loc.device}")


def _chain(name: str, p: PackedFlow, x: torch.Tensor, emb: torch.Tensor, reverse: bool):
    _check(p, x, emb)
    lib = _lib()
    b = x.shape[0]
    out = torch.empty_like(x)
    logdet = torch.empty(b, dtype=torch.float32, device=x.device)
    perm = p.inv if reverse else p.fwd
    n_launched = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        work, seq = _workspace(x.device, stream, workspace_bytes(p.C, p.H))
        err = lib.flow_chain(
            x.data_ptr(), emb.data_ptr(), out.data_ptr(), logdet.data_ptr(),
            *[w.data_ptr() for w in p.weights()], *[bb.data_ptr() for bb in p.biases()],
            p.loc.data_ptr(), p.scale.data_ptr(), perm.data_ptr(), p.mask.data_ptr(),
            work.data_ptr(), work.numel(), seq,
            b, p.C, p.E, p.H, p.n_flows, int(reverse), int(p.bf16), stream,
            ctypes.byref(n_launched),
        )
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: {lib.flow_chain_error_string(err).decode()}")
    launches[name] += 1
    device_launches[name] += n_launched.value
    return out, logdet


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"the flow kernel runs on cuda (or its plain version on cpu), not {x.device}")
    return False


def flow_reverse_fused(p: PackedFlow, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Flow inverse: x (B, C) -> z (B, C) under embedding emb (B, E)."""
    if _on_cpu(x):
        return flow_reverse_fused_ref(p, x, emb)
    return _chain("flow_reverse_fused", p, x, emb, reverse=True)[0]


def flow_forward_fused(p: PackedFlow, x: torch.Tensor, emb: torch.Tensor):
    """Flow forward: x (B, C) -> (out (B, C), logdet (B,))."""
    if _on_cpu(x):
        return flow_forward_fused_ref(p, x, emb)
    return _chain("flow_forward_fused", p, x, emb, reverse=False)
