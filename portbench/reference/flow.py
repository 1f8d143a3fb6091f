"""The conditional INN in plain float32 PyTorch: the 2-D embedder and the
20-block flow, forward and reverse (the port's ``models/stage2/flow.py``
plain path and ``inn.py``, frozen; no kernel, no tensor-parallel blocks).

``SupervisedTransformer`` carries the port's parameter names
(``flow.blocks...``, ``flow.shuffle.{fwd,inv}``, ``embedder...``), so the
serving state dict loads into it. ``weight_rounding`` rounds the coupling
MLPs' weights and inputs for the control (``nn.round_to``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from .nn import round_to
from .resnet import ResnetEncoder

LRELU_SLOPE = 0.01
INV_LRELU_ALPHA = 0.9


class _StackedDense(nn.Module):
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
        dims = [(c // 2 + e, hidden)] + [(hidden, hidden)] * depth + [(hidden, c // 2)]
        self.actnorm = _ActNorm(n, c)
        self.coupling = nn.ModuleDict({
            net: nn.ModuleDict({f"l{i}": _StackedDense(n, di, do) for i, (di, do) in enumerate(dims)})
            for net in ("s0", "t0", "s1", "t1")})


class _Shuffle(nn.Module):
    """Each block's channel permutation and its inverse, as the state dict
    loaded into the module gives them (zeros until then)."""

    def __init__(self, n: int, c: int):
        super().__init__()
        self.register_buffer("fwd", torch.zeros(n, c, dtype=torch.long))
        self.register_buffer("inv", torch.zeros(n, c, dtype=torch.long))


class ConditionalFlow(nn.Module):
    def __init__(self, in_channels: int, embedding_dim: int, hidden_dim: int,
                 hidden_depth: int, n_flows: int):
        super().__init__()
        self.blocks = _Blocks(n_flows, in_channels, embedding_dim, hidden_dim, hidden_depth)
        self.shuffle = _Shuffle(n_flows, in_channels)
        self.weight_rounding = "fp32"

    def _mlp(self, net: str, i: int, h: torch.Tensor) -> torch.Tensor:
        layers = list(self.blocks.coupling[net].values())
        kind = self.weight_rounding
        for li, lay in enumerate(layers):
            h = F.linear(round_to(h, kind), round_to(lay.weight[i], kind), lay.bias[i])
            if li < len(layers) - 1:
                h = torch.where(h >= 0, h, LRELU_SLOPE * h)
        return h

    def _coupling(self, i: int, p: int, x, emb, reverse: bool):
        half = x.shape[1] // 2
        x_apply, x_keep = x[:, :half], x[:, half:]
        cin = torch.cat([x_apply, emb], dim=1)
        s = self._mlp(f"s{p}", i, cin)
        t = self._mlp(f"t{p}", i, cin)
        x_keep = (x_keep - t) * torch.exp(-s) if reverse else x_keep * torch.exp(s) + t
        return torch.cat([x_apply, x_keep], dim=1), s.sum(dim=1)

    @staticmethod
    def _swap(x):
        half = x.shape[1] // 2
        return torch.cat([x[:, half:], x[:, :half]], dim=1)

    def forward(self, x: torch.Tensor, emb: torch.Tensor):
        """x (B, C) -> (out (B, C), logdet (B,))."""
        a = self.blocks.actnorm
        logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
        for i in range(a.loc.shape[0]):
            x = (x + a.loc[i]) * a.scale[i]
            logdet = logdet + torch.log(torch.abs(a.scale[i])).sum()
            x = torch.where(x >= 0, x, INV_LRELU_ALPHA * x)
            x, ld0 = self._coupling(i, 0, x, emb, False)
            x = self._swap(x)
            x, ld1 = self._coupling(i, 1, x, emb, False)
            logdet = logdet + ld0 + ld1
            x = x[:, self.shuffle.fwd[i]]
        return x, logdet

    def reverse(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        a = self.blocks.actnorm
        for i in reversed(range(a.loc.shape[0])):
            x = x[:, self.shuffle.inv[i]]
            x, _ = self._coupling(i, 1, x, emb, True)
            x = self._swap(x)
            x, _ = self._coupling(i, 0, x, emb, True)
            x = torch.where(x >= 0, x, x / INV_LRELU_ALPHA)
            x = x / a.scale[i] - a.loc[i]
        return x


class SupervisedTransformer(nn.Module):
    """The frozen embedder and the flow, without endpoint control."""

    def __init__(self, z_dim: int, cond_z: int, hidden: int, hidden_depth: int, n_flows: int,
                 encoder_type: str, norm: str):
        super().__init__()
        self.flow = ConditionalFlow(z_dim, cond_z, hidden, hidden_depth, n_flows)
        self.embedder = ResnetEncoder(cond_z, encoder_type, norm)

    @classmethod
    def from_config(cls, cfg: dict) -> "SupervisedTransformer":
        z = cfg["Decoder"]["z_dim"]
        fl = cfg["Flow"]
        ae = cfg["AE"]
        return cls(z, ae["z_dim"], z * fl["flow_mid_channels_factor"], fl["flow_hidden_depth"],
                   fl["n_flows"], ae["encoder_type"], ae["norm"])

    def embed(self, x0: torch.Tensor) -> torch.Tensor:
        return self.embedder.mode(x0).reshape(x0.shape[0], -1)
