"""Plain layers of the reference: float32 PyTorch, no kernel, no sharding.

A frozen copy of the port's eager layers (``models/layers.py``,
``ops/norms.py``, ``ops/resize.py``, ``ops/spectral.py``) with the
multi-device branches left out. Parameter and buffer names are the port's,
so one state dict loads into both.

Every convolution and dense layer rounds its operands with ``rounding``
(``set_precision``): ``fp32`` leaves them as they are (the reference);
``tf32`` and ``fp8`` give the control, the reference computed one
precision below what the configuration states. The rounding is the forward
operands' (inputs and weights), with the gradient passed straight through.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0  # largest float8_e4m3fn value


def round_to(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``x`` rounded to ``kind`` and returned in float32: ``tf32`` keeps 10
    mantissa bits (round to nearest even), ``fp8`` is e4m3 with one scale
    for the tensor (its largest magnitude maps to 448)."""
    if kind == "fp32":
        return x
    x = x.float()
    if kind == "tf32":
        bits = x.view(torch.int32).to(torch.int64)
        bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
        bits = torch.where(bits > 0x7FFFFFFF, bits - (1 << 32), bits)
        return bits.to(torch.int32).view(torch.float32)
    if kind == "fp8":
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"unknown precision {kind!r}")


def rounded(x: torch.Tensor, kind: str) -> torch.Tensor:
    """``round_to`` in the forward pass, the identity in the backward."""
    if kind == "fp32":
        return x
    return x + (round_to(x, kind) - x).detach()


def set_precision(module: nn.Module, kind: str) -> nn.Module:
    """Make every convolution and dense layer of ``module`` round its
    operands to ``kind``."""
    for m in module.modules():
        if isinstance(m, (SNConv, SNDense)):
            m.rounding = kind
    return module


# -- spectral norm (ops/spectral.py) --------------------------------------------

def kernel_to_matrix(weight: torch.Tensor) -> torch.Tensor:
    return weight.reshape(weight.shape[0], -1)


def _l2normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + eps)


class _Spectral(nn.Module):
    """Trainable spectral norm: the weight divided by u^T W v from the stored
    vectors on every forward; ``power_iteration_`` refreshes them."""

    rounding = "fp32"

    def _init_spectral(self, spectral: bool) -> None:
        self.spectral = spectral
        if spectral:  # unit vectors, until a state dict brings the stored ones
            n_out, n_in = kernel_to_matrix(self.weight).shape
            self.register_buffer("u", torch.full((n_out,), n_out ** -0.5))
            self.register_buffer("v", torch.full((n_in,), n_in ** -0.5))

    def effective_weight(self) -> torch.Tensor:
        if not self.spectral:
            return self.weight
        return self.weight / (self.u @ kernel_to_matrix(self.weight) @ self.v)

    @torch.no_grad()
    def power_iteration_(self) -> None:
        w = kernel_to_matrix(self.weight)
        v = _l2normalize(w.t() @ self.u)
        self.u.copy_(_l2normalize(w @ v))
        self.v.copy_(v)


def _uniform_(t: torch.Tensor, fan_in: int) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    nn.init.uniform_(t, -bound, bound)


class SNConv(_Spectral):
    """2-D or 3-D convolution, channels-first (``models/layers.py::SNConv``)."""

    def __init__(self, in_features: int, features: int, kernel_size: Sequence[int],
                 stride=1, padding=0, bias: bool = True, spectral: bool = False):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
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
        self._init_spectral(spectral)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = F.conv2d if len(self.kernel_size) == 2 else F.conv3d
        w = rounded(self.effective_weight(), self.rounding)
        return conv(rounded(x, self.rounding), w, self.bias, self.stride, self.padding)


class SNDense(_Spectral):
    """Linear layer with an (out, in) weight (``models/layers.py::SNDense``)."""

    def __init__(self, in_features: int, features: int, bias: bool = True,
                 spectral: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        _uniform_(self.weight, in_features)
        if bias:
            self.bias = nn.Parameter(torch.empty(features))
            _uniform_(self.bias, in_features)
        else:
            self.register_parameter("bias", None)
        self._init_spectral(spectral)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = rounded(self.effective_weight(), self.rounding)
        return F.linear(rounded(x, self.rounding), w, self.bias)


def power_iteration_(module: nn.Module) -> None:
    """Refresh the stored vectors of every spectral layer of ``module``."""
    for m in module.modules():
        if isinstance(m, _Spectral) and m.spectral:
            m.power_iteration_()


# -- norms ----------------------------------------------------------------------

def group_norm_groups(num_features: int, num_groups: int = 16) -> int:
    while num_features % num_groups != 0:
        num_groups -= 1
    return num_groups


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per sample and channel over every spatial axis, biased variance."""
    dims = tuple(range(2, x.ndim))
    var, mean = torch.var_mean(x, dim=dims, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


class GroupNorm(nn.Module):
    def __init__(self, num_features: int, num_groups: int = 16, affine: bool = True,
                 eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.num_groups, self.weight, self.bias, self.eps)


def _per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.reshape((1, -1) + (1,) * (x.ndim - 2))


class BatchNorm(nn.Module):
    """BatchNorm from its running statistics (the serving embedder's)."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = (x - _per_channel(self.mean, x)) * _per_channel(torch.rsqrt(self.var + self.eps), x)
        return y * _per_channel(self.weight, x) + _per_channel(self.bias, x)


class ActNormImage(nn.Module):
    """``scale * (x + loc)``; while ``initializing``, first ``loc = -mean`` and
    ``scale = 1 / (std + 1e-6)`` over (B, *spatial), std with ddof 1."""

    def __init__(self, num_features: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(num_features))
        self.scale = nn.Parameter(torch.ones(num_features))
        self.initializing = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.initializing:
            with torch.no_grad():
                dims = [0] + list(range(2, x.ndim))
                var, mean = torch.var_mean(x, dim=dims, correction=1)
                self.loc.copy_(-mean)
                self.scale.copy_(1.0 / (var.sqrt() + 1e-6))
        return _per_channel(self.scale, x) * (x + _per_channel(self.loc, x))


@torch.no_grad()
def init_actnorm(module: nn.Module, *inputs) -> None:
    """One forward in which every ``ActNormImage`` initialises from its input."""
    norms = [m for m in module.modules() if isinstance(m, ActNormImage)]
    for m in norms:
        m.initializing = True
    try:
        module(*inputs)
    finally:
        for m in norms:
            m.initializing = False


# -- resampling and pooling -----------------------------------------------------

def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def max_pool(x: torch.Tensor, window, stride, padding) -> torch.Tensor:
    pool = F.max_pool2d if x.ndim == 4 else F.max_pool3d
    return pool(x, window, stride, padding)


def upsample_nearest(x: torch.Tensor, factors: Sequence[int]) -> torch.Tensor:
    if all(f == 1 for f in factors):
        return x
    return F.interpolate(x, scale_factor=tuple(float(f) for f in factors), mode="nearest")


def resize_bilinear_align_corners(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Half-pixel bilinear resize of (..., C, H, W), antialiased downwards."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    lead = x.shape[:-3]
    y = F.interpolate(x.reshape((-1,) + tuple(x.shape[-3:])), size=tuple(size),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.reshape(lead + y.shape[1:])
