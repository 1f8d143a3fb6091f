"""Shared layers (port of ``models/layers.py``): convolution and dense layers
with spectral norm, GroupNorm, BatchNorm and ActNorm at inference, ActNorm's
data-dependent initialisation, pooling.

Spectral norm has two forms. The serving modules fold sigma into the weight
at load (``utils/convert.py``) and carry no flag. A layer built with
``spectral=True`` (the trainers') keeps the raw ``weight`` and the stored
vectors in the buffers ``u`` (out,) and ``v`` (in * prod(k),), and divides
the weight by sigma = u^T W_mat v from those vectors on every forward, so
the gradient flows through W alone (the JAX layer with the ``spectral``
collection immutable, ``models/layers.py:113-124``). ``power_iteration_``
refreshes the vectors once, with no gradient, as the JAX trainer's
``mutable=["spectral"]`` pass does after each update. This is not
``torch.nn.utils.spectral_norm``, which iterates on every training forward
and divides by the refreshed vectors' sigma. ``sn_mode="biggan"`` (the
stage-2 AE's generator, ``models/layers.py:106-112``) iterates once from the
stored ``u`` on every forward, with eps 1e-4, divides by that sigma and
writes nothing back (``ops/spectral.py::biggan_sigma``); ``power_iteration_``
skips these layers.

``BatchNorm`` normalises with its running statistics unless its forward is
called with ``train=True``: then with the batch's, taken in float32 with the
biased variance, and the running statistics move (momentum 0.1, the
unbiased variance) only inside ``updating_batch_stats``, the port of the JAX
trainers' pass with ``batch_stats`` mutable. ``nn.BatchNorm2d`` in train
mode would move them on every forward.

While a process group of more than one rank is live
(``parallel/distributed.py``), batch statistics are the global batch's: the
train-mode ``BatchNorm`` (its gradient flows through the all-reduce, as in
``SyncBatchNorm``, and its running statistics move by the global ones) and
the ActNorm init, as the JAX package's ``jnp.mean`` over a sharded batch
axis is global.

Weights use torch's layout: a conv weight is (out, in, *k), a dense weight
is (out, in). Random initialisation follows torch's defaults (uniform in
+-1/sqrt(fan_in)), the same distribution the JAX package draws from;
``orthogonal_`` and ``normal_002_`` are the temporal and patch
discriminators' inits (``models/layers.py:41-68``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import spectral as sn
from ..parallel import distributed


def _uniform_(t: torch.Tensor, fan_in: int) -> None:
    bound = 1.0 / math.sqrt(fan_in)
    nn.init.uniform_(t, -bound, bound)


def orthogonal_(weight: torch.Tensor) -> torch.Tensor:
    """torch's ``orthogonal_`` on the (out, -1) matrix of a weight."""
    with torch.no_grad():
        return nn.init.orthogonal_(weight.view(weight.shape[0], -1)).view_as(weight)


def normal_002_(weight: torch.Tensor) -> torch.Tensor:
    """N(0, 0.02), the patch discriminator's conv init."""
    with torch.no_grad():
        return weight.normal_(0.0, 0.02)


BIGGAN_SN_EPS = 1e-4


class _Spectral(nn.Module):
    """The trainable spectral norm of ``SNConv``/``SNDense`` (see the module
    docstring); ``spectral=False`` leaves ``weight`` as it is."""

    def _init_spectral(self, spectral: bool, sn_mode: str) -> None:
        if sn_mode not in ("torch", "biggan"):
            raise ValueError(f"unknown spectral-norm mode {sn_mode!r}")
        self.spectral = spectral
        self.sn_mode = sn_mode
        if spectral:
            n_out, n_in = sn.kernel_to_matrix(self.weight).shape
            self.register_buffer("u", F.normalize(torch.randn(n_out), dim=0, eps=1e-12))
            self.register_buffer("v", F.normalize(torch.randn(n_in), dim=0, eps=1e-12))

    def effective_weight(self) -> torch.Tensor:
        if not self.spectral:
            return self.weight
        if self.sn_mode == "biggan":
            return self.weight / sn.biggan_sigma(self.weight, self.u, BIGGAN_SN_EPS)
        return self.weight / sn.sigma(self.weight, self.u, self.v)

    @torch.no_grad()
    def power_iteration_(self) -> None:
        """One power iteration of the raw weight from the stored ``u``."""
        u, v = sn.spectral_normalize(self.weight, self.u)
        self.u.copy_(u)
        self.v.copy_(v)


class SNConv(_Spectral):
    """2-D or 3-D convolution, channels-first. Without ``spectral`` the
    weight is used as it is (a serving module's, with sigma folded in at
    load); with it, divided by sigma from the stored vectors."""

    def __init__(self, in_features: int, features: int, kernel_size: Sequence[int],
                 stride: int | Sequence[int] = 1, padding: int | Sequence[int] = 0,
                 bias: bool = True, spectral: bool = False, sn_mode: str = "torch"):
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
        self._init_spectral(spectral, sn_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = F.conv2d if len(self.kernel_size) == 2 else F.conv3d
        return conv(x, self.effective_weight(), self.bias, self.stride, self.padding)


class SNDense(_Spectral):
    """Linear layer with an (out, in) weight, spectral as ``SNConv``."""

    def __init__(self, in_features: int, features: int, bias: bool = True,
                 spectral: bool = False, sn_mode: str = "torch"):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        _uniform_(self.weight, in_features)
        if bias:
            self.bias = nn.Parameter(torch.empty(features))
            _uniform_(self.bias, in_features)
        else:
            self.register_parameter("bias", None)
        self._init_spectral(spectral, sn_mode)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.effective_weight(), self.bias)


def power_iteration_(module: nn.Module) -> None:
    """Refresh the stored vectors of every spectral layer in ``module``: the
    port of the JAX trainer's ``mutable=["spectral"]`` pass, whose output is
    discarded and whose new (u, v) depend only on W and the old u. BigGAN
    layers keep theirs."""
    for m in module.modules():
        if isinstance(m, _Spectral) and m.spectral and m.sn_mode == "torch":
            m.power_iteration_()


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
    """BatchNorm: ``(x - mean) * rsqrt(var + eps) * weight + bias``, the
    affine step left out with ``affine=False``. By default from the running
    statistics (the JAX layer's ``batch_stats`` collection, carried to the
    ``mean``/``var`` buffers by the weight bridge); with ``train=True`` from
    the batch's (see the module docstring). Computed in float32 (float64
    input stays float64) and cast back to the input's dtype."""

    momentum = 0.1  # torch's convention: new = (1 - m) * old + m * batch

    def __init__(self, num_features: int, eps: float = 1e-5, affine: bool = True):
        super().__init__()
        self.eps = eps
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))
        self.update_stats = False

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x32 = x.to(_stats_dtype(x))
        if train:
            dims = [0] + list(range(2, x.ndim))
            mean, var, n = distributed.batch_moments(x32, dims)
            if self.update_stats:
                m = self.momentum
                with torch.no_grad():
                    self.mean.copy_((1 - m) * self.mean + m * mean)
                    self.var.copy_((1 - m) * self.var + m * (var * n / max(n - 1, 1)))
            y = (x32 - _per_channel(mean, x)) * _per_channel(torch.rsqrt(var + self.eps), x)
        else:
            y = (x32 - _per_channel(self.mean, x)) * _per_channel(
                torch.rsqrt(self.var + self.eps), x)
        if self.weight is None:
            return y.to(x.dtype)
        return (y * _per_channel(self.weight, x) + _per_channel(self.bias, x)).to(x.dtype)


@contextlib.contextmanager
def updating_batch_stats(module: nn.Module) -> Iterator[None]:
    """Within: every ``BatchNorm`` of ``module`` called with ``train=True``
    moves its running statistics once per call."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.update_stats = True
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = False


class ActNormImage(nn.Module):
    """Per-channel affine ``scale * (x + loc)``. While ``initializing`` is set
    (``init_actnorm``), a forward first sets ``loc = -mean`` and
    ``scale = 1 / (std + 1e-6)`` from its input's per-channel statistics
    over (B, *spatial), std with ddof 1 (``models/layers.py:436-470``), over
    the global batch in a multi-process run."""

    def __init__(self, num_features: int):
        super().__init__()
        self.loc = nn.Parameter(torch.zeros(num_features))
        self.scale = nn.Parameter(torch.ones(num_features))
        self.initializing = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.initializing:
            with torch.no_grad():
                x32 = x.to(_stats_dtype(x))
                dims = [0] + list(range(2, x.ndim))
                mean, var, _ = distributed.batch_moments(x32, dims, correction=1)
                self.loc.copy_(-mean)
                self.scale.copy_(1.0 / (var.sqrt() + 1e-6))
        return _per_channel(self.scale, x) * (x + _per_channel(self.loc, x))


@torch.no_grad()
def init_actnorm(module: nn.Module, *inputs) -> None:
    """The data-dependent init of every ``ActNormImage`` in ``module``: one
    forward of ``inputs`` in which each ActNorm initialises from what reaches
    it, so each later one sees the output the earlier ones normalised (the
    JAX package's train pass with ``actnorm_stats`` mutable, then
    ``merge_actnorm_init``)."""
    norms = [m for m in module.modules() if isinstance(m, ActNormImage)]
    for m in norms:
        m.initializing = True
    try:
        module(*inputs)
    finally:
        for m in norms:
            m.initializing = False


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def max_pool(x: torch.Tensor, window, stride, padding) -> torch.Tensor:
    """2-D (B, C, H, W) or 3-D (B, C, T, H, W) max pool with symmetric padding
    that never wins (-inf); window, stride and padding are ints or per-axis."""
    pool = F.max_pool2d if x.ndim == 4 else F.max_pool3d
    return pool(x, window, stride, padding)
