"""Shared layers (port of ``models/layers.py``): convolution and dense layers
whose spectral norm is folded into the weight at load, GroupNorm, BatchNorm
and ActNorm at inference, pooling.

Weights use torch's layout: a conv weight is (out, in, *k), a dense weight
is (out, in). Random initialisation follows torch's defaults (uniform in
+-1/sqrt(fan_in)), the same distribution the JAX package draws from.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def _uniform_(t: torch.Tensor, fan_in: int) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    nn.init.uniform_(t, -bound, bound)


class SNConv(nn.Module):
    """2-D or 3-D convolution, channels-first; the spectral-norm scale of a
    ``use_spectral`` layer is folded into ``weight`` by the weight bridge."""

    def __init__(self, in_features: int, features: int, kernel_size: Sequence[int],
                 stride: int | Sequence[int] = 1, padding: int | Sequence[int] = 0,
                 bias: bool = True):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        if len(self.kernel_size) not in (2, 3):
            raise ValueError(f"unsupported conv rank {len(self.kernel_size)}")
        self.stride = stride
        self.padding = padding
        fan_in = in_features * math.prod(self.kernel_size)
        self.weight = nn.Parameter(torch.empty(features, in_features, *self.kernel_size))
        _uniform_(self.weight, fan_in)
        if bias:
            self.bias = nn.Parameter(torch.empty(features))
            _uniform_(self.bias, fan_in)
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = F.conv2d if len(self.kernel_size) == 2 else F.conv3d
        return conv(x, self.weight, self.bias, self.stride, self.padding)


class SNDense(nn.Module):
    """Linear layer; (out, in) weight with any spectral scale folded in."""

    def __init__(self, in_features: int, features: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        _uniform_(self.weight, in_features)
        if bias:
            self.bias = nn.Parameter(torch.empty(features))
            _uniform_(self.bias, in_features)
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class GroupNorm(nn.Module):
    """GroupNorm with torch's eps (1e-5) over (B, C, *spatial).

    Statistics and the affine step are taken in float32 (float64 input stays
    float64), and the result is cast back to the input's dtype, as the JAX
    layer does.
    """

    def __init__(self, num_features: int, num_groups: int = 16, affine: bool = True,
                 eps: float = 1e-5):
        super().__init__()
        if num_features % num_groups:
            raise ValueError(f"channels {num_features} not divisible by groups {num_groups}")
        self.num_groups = num_groups
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _stats_dtype(x)
        w = None if self.weight is None else self.weight.to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        return F.group_norm(x.to(dt), self.num_groups, w, b, self.eps).to(x.dtype)


def _stats_dtype(x: torch.Tensor) -> torch.dtype:
    """float32, or the input's dtype where it is wider."""
    return torch.promote_types(x.dtype, torch.float32)


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (C,) vector shaped to broadcast over (B, C, *spatial)."""
    return v.reshape((1, -1) + (1,) * (x.ndim - 2))


class BatchNorm(nn.Module):
    """BatchNorm in eval mode: ``(x - mean) * rsqrt(var + eps) * weight + bias``
    from the running statistics (the JAX layer's ``batch_stats`` collection,
    carried to the ``mean``/``var`` buffers by the weight bridge). Computed in
    float32 (float64 input stays float64) and cast back to the input's dtype."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(_stats_dtype(x))
        y = (x32 - _per_channel(self.mean, x)) * _per_channel(torch.rsqrt(self.var + self.eps), x)
        return (y * _per_channel(self.weight, x) + _per_channel(self.bias, x)).to(x.dtype)


class ActNormImage(nn.Module):
    """Per-channel affine ``scale * (x + loc)`` at inference; the data-dependent
    initialisation of ``loc``/``scale`` belongs to training."""

    def __init__(self, num_features: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(num_features))
        self.scale = nn.Parameter(torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _per_channel(self.scale, x) * (x + _per_channel(self.loc, x))


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def max_pool(x: torch.Tensor, window, stride, padding) -> torch.Tensor:
    """2-D (B, C, H, W) or 3-D (B, C, T, H, W) max pool with symmetric padding
    that never wins (-inf); window, stride and padding are ints or per-axis."""
    pool = F.max_pool2d if x.ndim == 4 else F.max_pool3d
    return pool(x, window, stride, padding)
