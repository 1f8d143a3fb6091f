"""Conditional normalizing flow, the cINN core (port of ``models/stage2/flow.py``).

A stack of ``n_flows`` blocks, each ActNorm -> InvLeakyReLU(0.9) -> double
affine coupling -> fixed channel shuffle, conditioned on an embedding fed
to every block. ``flow_forward`` returns the exact log-determinant and
``flow_reverse`` is the exact inverse; both are the plain float32 path.
Given blocks sharded over a mesh (``parallel/tp.py``), both run the
tensor-parallel coupling MLPs.

Block parameters are stacked on a leading block axis, as in the JAX package.
A coupling MLP layer keeps torch's (out, in) weight layout: its weight is
(n_flows, out, in) and its bias (n_flows, out). The endpoint-control variant
multiplies the x-half of the coupling input by a per-block mask (0 on
'cond' blocks), so every block has the same shape.

``ConditionalFlow(use_kernel=True)`` runs the chain through the hand-written
CUDA kernel (``ops/cuda/flow_kernel.py``) in bf16-weight mode, as the JAX
package runs its Pallas kernel; only ``hidden_depth=2`` is specialised, and
other depths take the plain path, as in the JAX package. The trainer packs
fp32 weights and runs the kernel where it needs no gradient (validation,
sampling); ``actnorm_init`` is the data-dependent ActNorm initialisation.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.cuda import flow_kernel
from ...parallel import distributed, tp
from ...utils.profiling import annotate

LRELU_SLOPE = flow_kernel.LRELU_SLOPE
INV_LRELU_ALPHA = flow_kernel.INV_LRELU_ALPHA


def control_mask(n_flows: int, control: bool) -> torch.Tensor:
    """1.0 where the coupling conditions on (x_half, embedding); 0.0 where on
    the embedding alone (blocks with ``fl % 4 != 0`` under control)."""
    if not control:
        return torch.ones(n_flows, dtype=torch.float32)
    return torch.tensor([0.0 if fl % 4 != 0 else 1.0 for fl in range(n_flows)],
                        dtype=torch.float32)


# --------------------------------------------------------------------------
# functional forward / reverse. ``blocks`` is the dict of ConditionalFlow.blocks_dict()
# --------------------------------------------------------------------------

def _leaky(h: torch.Tensor) -> torch.Tensor:
    return torch.where(h >= 0, h, LRELU_SLOPE * h)


def _mlp(layers, i: int, h: torch.Tensor) -> torch.Tensor:
    if isinstance(layers[0][0], tp.Split):  # blocks sharded over a mesh (parallel/tp.py)
        return tp.mlp(layers, i, h, _leaky)
    for li, (w, b) in enumerate(layers):
        h = F.linear(h, w[i], b[i])
        if li < len(layers) - 1:
            h = _leaky(h)
    return h


def _swap(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[1] // 2
    return torch.cat([x[:, half:], x[:, :half]], dim=1)


def _coupling(coupling, i: int, p: int, x, emb, m, reverse: bool):
    half = x.shape[1] // 2
    x_apply, x_keep = x[:, :half], x[:, half:]
    cin = torch.cat([x_apply * m, emb], dim=1)
    s = _mlp(coupling[f"s{p}"], i, cin)
    t = _mlp(coupling[f"t{p}"], i, cin)
    if reverse:
        x_keep = (x_keep - t) * torch.exp(-s)
    else:
        x_keep = x_keep * torch.exp(s) + t
    return torch.cat([x_apply, x_keep], dim=1), s.sum(dim=1)


def flow_forward(blocks, shuffle, x, embedding, xmask):
    """x: (B, C) -> (out (B, C), logdet (B,)). ``xmask``: (n_flows,) control mask."""
    logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for i in range(blocks["loc"].shape[0]):
        scale = blocks["scale"][i]
        x = (x + blocks["loc"][i]) * scale
        logdet = logdet + torch.log(torch.abs(scale)).sum()
        x = torch.where(x >= 0, x, INV_LRELU_ALPHA * x)
        x, ld0 = _coupling(blocks["coupling"], i, 0, x, embedding, xmask[i], False)
        x = _swap(x)
        x, ld1 = _coupling(blocks["coupling"], i, 1, x, embedding, xmask[i], False)
        logdet = logdet + ld0 + ld1
        x = x[:, shuffle["fwd"][i]]
    return x, logdet


def flow_reverse(blocks, shuffle, x, embedding, xmask):
    """Exact inverse of ``flow_forward``: blocks n-1 ... 0."""
    for i in reversed(range(blocks["loc"].shape[0])):
        x = x[:, shuffle["inv"][i]]
        x, _ = _coupling(blocks["coupling"], i, 1, x, embedding, xmask[i], True)
        x = _swap(x)
        x, _ = _coupling(blocks["coupling"], i, 0, x, embedding, xmask[i], True)
        x = torch.where(x >= 0, x, x / INV_LRELU_ALPHA)
        x = x / blocks["scale"][i] - blocks["loc"][i]
    return x


@torch.no_grad()
def actnorm_init(blocks, shuffle, x, embedding, xmask):
    """Data-dependent ActNorm init (the JAX package's ``actnorm_init``): for
    each block in turn, ``loc = -mean`` and ``scale = 1 / (std + 1e-6)`` with
    the unbiased std over the batch of that block's input, which is computed
    through the chain with the new values. Returns (locs, scales), each
    (n_flows, C). In a multi-process run the mean and the std are the global
    batch's (``distributed.batch_moments``: two passes, N - 1 of the global N)."""
    locs, scales = [], []
    for i in range(blocks["loc"].shape[0]):
        mean, var, _ = distributed.batch_moments(x, [0], correction=1)
        loc, scale = -mean, 1.0 / (var.sqrt() + 1e-6)
        x = (x + loc) * scale
        x = torch.where(x >= 0, x, INV_LRELU_ALPHA * x)
        x, _ = _coupling(blocks["coupling"], i, 0, x, embedding, xmask[i], False)
        x = _swap(x)
        x, _ = _coupling(blocks["coupling"], i, 1, x, embedding, xmask[i], False)
        x = x[:, shuffle["fwd"][i]]
        locs.append(loc)
        scales.append(scale)
    return torch.stack(locs), torch.stack(scales)


# --------------------------------------------------------------------------
# module
# --------------------------------------------------------------------------

class _StackedDense(nn.Module):
    """One MLP layer for every block: weight (n, out, in), bias (n, out)."""

    def __init__(self, n: int, d_in: int, d_out: int):
        super().__init__()
        bound = 1.0 / math.sqrt(d_in)
        self.weight = nn.Parameter(torch.empty(n, d_out, d_in).uniform_(-bound, bound))
        self.bias = nn.Parameter(torch.empty(n, d_out).uniform_(-bound, bound))


class _ActNorm(nn.Module):
    def __init__(self, n: int, c: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(n, c))
        self.scale = nn.Parameter(torch.ones(n, c))


class _Blocks(nn.Module):
    def __init__(self, n: int, c: int, e: int, hidden: int, depth: int):
        super().__init__()
        half = c // 2
        dims = [(half + e, hidden)] + [(hidden, hidden)] * depth + [(hidden, half)]
        self.actnorm = _ActNorm(n, c)
        self.coupling = nn.ModuleDict({
            net: nn.ModuleDict({f"l{i}": _StackedDense(n, di, do)
                                for i, (di, do) in enumerate(dims)})
            for net in ("s0", "t0", "s1", "t1")
        })


class _Shuffle(nn.Module):
    """Fixed channel permutations and their inverses (always loaded from a
    checkpoint when there is one: torch cannot redraw JAX's permutations)."""

    def __init__(self, n: int, c: int):
        super().__init__()
        fwd = torch.stack([torch.randperm(c) for _ in range(n)])
        self.register_buffer("fwd", fwd)
        self.register_buffer("inv", torch.argsort(fwd, dim=1))


class ConditionalFlow(nn.Module):
    """Owns the stacked block parameters and the shuffle buffers.

    Call ``pack_kernel_weights()`` after loading weights and after every
    change to them: it builds the kernel's packed weights, a copy held as
    non-persistent buffers. ``use_kernel=True`` makes ``forward`` run the
    kernel; ``fused`` runs it whatever ``use_kernel`` says (the trainer takes
    gradients through the plain flow and runs the kernel where it needs none).
    """

    def __init__(self, in_channels: int, embedding_dim: int, hidden_dim: int,
                 hidden_depth: int, n_flows: int, control: bool = False,
                 use_kernel: bool = False):
        super().__init__()
        self.n_flows = n_flows
        self.blocks = _Blocks(n_flows, in_channels, embedding_dim, hidden_dim, hidden_depth)
        self.shuffle = _Shuffle(n_flows, in_channels)
        self.register_buffer("mask", control_mask(n_flows, control), persistent=False)
        self.kernel_depth = hidden_depth == flow_kernel.HIDDEN_DEPTH
        self.use_kernel = use_kernel and self.kernel_depth
        self.packed: flow_kernel.PackedFlow | None = None

    def blocks_dict(self) -> dict:
        return {
            "loc": self.blocks.actnorm.loc,
            "scale": self.blocks.actnorm.scale,
            "coupling": {
                net: [(lay.weight, lay.bias) for lay in layers.values()]
                for net, layers in self.blocks.coupling.items()
            },
        }

    def shuffle_dict(self) -> dict:
        return {"fwd": self.shuffle.fwd, "inv": self.shuffle.inv}

    @torch.no_grad()
    def pack_kernel_weights(self, weight_dtype: torch.dtype = torch.bfloat16) -> None:
        """Pack the weights in ``weight_dtype``: bf16, as the JAX package's
        Pallas kernel streams them, or fp32, which rounds nowhere. A depth
        the kernel does not take packs nothing."""
        if self.kernel_depth:
            self.packed = flow_kernel.PackedFlow(
                self.blocks_dict(), self.shuffle.fwd, self.shuffle.inv, self.mask, weight_dtype
            )

    def fused(self, x: torch.Tensor, embedding: torch.Tensor, reverse: bool = False):
        """The chain through the kernel from the packed weights, at most
        ``MAX_BATCH`` rows a launch; the plain flow at a depth the kernel
        does not take, as the JAX package falls back to its scan."""
        if not self.kernel_depth:
            with annotate("model/chain"):
                return self.plain(x, embedding, reverse)
        if self.packed is None:
            raise RuntimeError("call pack_kernel_weights() after loading the flow's weights")
        fused = flow_kernel.flow_reverse_fused if reverse else flow_kernel.flow_forward_fused
        x, embedding = x.contiguous(), embedding.contiguous()
        m = flow_kernel.MAX_BATCH  # the kernel takes at most m rows a call
        outs = []
        for i in range(0, x.shape[0], m):
            with annotate("model/chain"):
                outs.append(fused(self.packed, x[i:i + m], embedding[i:i + m]))
        if reverse:
            return torch.cat(outs)
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    def plain(self, x: torch.Tensor, embedding: torch.Tensor, reverse: bool = False):
        """The plain float32 flow, which autograd differentiates."""
        if reverse:
            return flow_reverse(self.blocks_dict(), self.shuffle_dict(), x, embedding, self.mask)
        return flow_forward(self.blocks_dict(), self.shuffle_dict(), x, embedding, self.mask)

    def forward(self, x: torch.Tensor, embedding: torch.Tensor, reverse: bool = False):
        if self.use_kernel:
            return self.fused(x, embedding, reverse)
        with annotate("model/chain"):
            return self.plain(x, embedding, reverse)

    def reverse(self, out: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
        return self(out, embedding, reverse=True)

    @torch.no_grad()
    def init_actnorm(self, x: torch.Tensor, embedding: torch.Tensor) -> None:
        """Write the data-dependent ActNorm init (``actnorm_init``) on the
        batch ``x`` into the parameters. The pack is not refreshed here."""
        loc, scale = actnorm_init(self.blocks_dict(), self.shuffle_dict(), x, embedding,
                                  self.mask)
        self.blocks.actnorm.loc.copy_(loc)
        self.blocks.actnorm.scale.copy_(scale)
