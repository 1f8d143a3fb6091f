"""Inflated-3D Inception (I3D) feature extractor for FVD / DTFVD / diversity
(port of ``models/backbones/i3d.py``), channels-first.

One module covers both metric backbones: the kinetics-400 I3D (400-d
*logits*, averaged over time) and the DTDB-trained I3D (18 classes; its
1024-d pre-logits representation is the DTFVD feature; the 32-frame variant
only widens the final temporal average pool from 2 to 4).

What follows the JAX module exactly:

* TF-SAME padding is asymmetric and depends on the input's size along each
  axis (``tf_same_pads``): the input is padded with zeros by ``F.pad`` and
  the convolution runs with ``padding=0``.
* ``max_pool_same`` pads with ZEROS (``jnp.pad``) and then takes the max, so
  a padded tap wins over negative inputs; ``F.max_pool3d(padding=...)``
  would pad with -inf.
* BatchNorm is frozen: ``(x - bn_mean) * rsqrt(bn_var + eps) * bn_scale +
  bn_bias`` with eps 1e-3 for the kinetics net and 1e-5 for the DT nets.
* The final ``(avg_pool_t, 7, 7)`` average pool is VALID, stride 1.
* The representation is flattened time-major, as the JAX (B, T', 1, 1, 1024)
  reshape; the logits head averages over time.

Input: (B, 3, T, 224, 224) in the range the weights expect ([0, 1] after
``metrics/fvd.py``'s denormalisation).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import SNConv


def tf_same_pads(in_size: int, kernel: int, stride: int) -> tuple[int, int]:
    if in_size % stride == 0:
        pad = max(kernel - stride, 0)
    else:
        pad = max(kernel - in_size % stride, 0)
    return pad // 2, pad - pad // 2


def tf_same_pad(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int]) -> torch.Tensor:
    """Zero-pad (B, C, T, H, W) by the TF-SAME amounts of a 3-D window."""
    pads: list[int] = []
    for ax in (2, 1, 0):  # F.pad takes the last axis first
        pads.extend(tf_same_pads(x.shape[2 + ax], kernel[ax], stride[ax]))
    return F.pad(x, pads)


def max_pool_same(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int]) -> torch.Tensor:
    return F.max_pool3d(tf_same_pad(x, kernel, stride), tuple(kernel), tuple(stride))


class Unit3D(nn.Module):
    """conv3d (TF-SAME) -> frozen BN -> relu."""

    def __init__(self, in_features: int, features: int, kernel: Sequence[int] = (1, 1, 1),
                 stride: Sequence[int] = (1, 1, 1), use_bn: bool = True,
                 use_bias: bool = False, activation: bool = True, bn_eps: float = 1e-3):
        super().__init__()
        self.kernel, self.stride = tuple(kernel), tuple(stride)
        self.activation = activation
        self.bn_eps = bn_eps
        self.conv3d = SNConv(in_features, features, self.kernel, self.stride, 0, bias=use_bias)
        self.use_bn = use_bn
        if use_bn:
            self.register_buffer("bn_mean", torch.zeros(features))
            self.register_buffer("bn_var", torch.ones(features))
            self.register_buffer("bn_scale", torch.ones(features))
            self.register_buffer("bn_bias", torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv3d(tf_same_pad(x, self.kernel, self.stride))
        if self.use_bn:
            c = (1, -1, 1, 1, 1)
            x = ((x - self.bn_mean.view(c)) * torch.rsqrt(self.bn_var + self.bn_eps).view(c)
                 * self.bn_scale.view(c) + self.bn_bias.view(c))
        return F.relu(x) if self.activation else x


class Mixed(nn.Module):
    def __init__(self, in_features: int, out_channels: Sequence[int], bn_eps: float = 1e-3):
        super().__init__()
        c, e = out_channels, bn_eps  # [b0, b1a, b1b, b2a, b2b, b3]
        self.branch_0 = Unit3D(in_features, c[0], bn_eps=e)
        self.branch_1a = Unit3D(in_features, c[1], bn_eps=e)
        self.branch_1b = Unit3D(c[1], c[2], kernel=(3, 3, 3), bn_eps=e)
        self.branch_2a = Unit3D(in_features, c[3], bn_eps=e)
        self.branch_2b = Unit3D(c[3], c[4], kernel=(3, 3, 3), bn_eps=e)
        self.branch_3 = Unit3D(in_features, c[5], bn_eps=e)
        self.out_features = c[0] + c[2] + c[4] + c[5]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b0 = self.branch_0(x)
        b1 = self.branch_1b(self.branch_1a(x))
        b2 = self.branch_2b(self.branch_2a(x))
        b3 = self.branch_3(max_pool_same(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([b0, b1, b2, b3], dim=1)


MIXED_CFG = {
    "mixed_3b": [64, 96, 128, 16, 32, 32],
    "mixed_3c": [128, 128, 192, 32, 96, 64],
    "mixed_4b": [192, 96, 208, 16, 48, 64],
    "mixed_4c": [160, 112, 224, 24, 64, 64],
    "mixed_4d": [128, 128, 256, 24, 64, 64],
    "mixed_4e": [112, 144, 288, 32, 64, 64],
    "mixed_4f": [256, 160, 320, 32, 128, 128],
    "mixed_5b": [256, 160, 320, 32, 128, 128],
    "mixed_5c": [384, 192, 384, 48, 128, 128],
}


class I3D(nn.Module):
    """Returns (softmax, logits), or the 1024-d pre-logits representation when
    ``head='representation'``. ``avg_pool_t``: temporal extent of the final
    average pool, 2 for the kinetics and 16-frame DT variants, 4 for the
    32-frame DT variant."""

    def __init__(self, num_classes: int = 400, head: str = "logits", avg_pool_t: int = 2,
                 bn_eps: float = 1e-3):
        super().__init__()
        self.head, self.avg_pool_t = head, avg_pool_t
        e = bn_eps
        self.conv3d_1a_7x7 = Unit3D(3, 64, kernel=(7, 7, 7), stride=(2, 2, 2), bn_eps=e)
        self.conv3d_2b_1x1 = Unit3D(64, 64, bn_eps=e)
        self.conv3d_2c_3x3 = Unit3D(64, 192, kernel=(3, 3, 3), bn_eps=e)
        c = 192
        for name in MIXED_CFG:
            mixed = Mixed(c, MIXED_CFG[name], bn_eps=e)
            self.add_module(name, mixed)
            c = mixed.out_features
        if head != "representation":
            self.conv3d_0c_1x1 = Unit3D(c, num_classes, use_bn=False, use_bias=True,
                                        activation=False)

    def forward(self, x: torch.Tensor):
        x = self.conv3d_1a_7x7(x)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.conv3d_2b_1x1(x)
        x = self.conv3d_2c_3x3(x)
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2))
        x = self.mixed_3c(self.mixed_3b(x))
        x = max_pool_same(x, (3, 3, 3), (2, 2, 2))
        for name in ("mixed_4b", "mixed_4c", "mixed_4d", "mixed_4e", "mixed_4f"):
            x = getattr(self, name)(x)
        x = max_pool_same(x, (2, 2, 2), (2, 2, 2))
        x = self.mixed_5c(self.mixed_5b(x))
        x = F.avg_pool3d(x, (self.avg_pool_t, 7, 7), stride=1)  # VALID

        if self.head == "representation":
            # (B, 1024, T', 1, 1) -> (B, T' * 1024), time-major like the JAX reshape
            return x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)
        x = self.conv3d_0c_1x1(x)  # (B, classes, T', 1, 1)
        logits = x.reshape(x.shape[0], x.shape[1], -1).mean(dim=2)  # mean over time
        return torch.softmax(logits, dim=-1), logits
