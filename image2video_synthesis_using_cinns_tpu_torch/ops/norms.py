"""Normalisation helpers with the reference's torch semantics (port of
``ops/norms.py``), in channels-first layout."""

from __future__ import annotations

import torch


def group_norm_groups(num_features: int, num_groups: int = 16) -> int:
    """SPADE-style adaptation: decrement groups until they divide channels."""
    while num_features % num_groups != 0:
        num_groups -= 1
    return num_groups


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm over all spatial axes, per sample and channel, no affine.

    ``x``: (B, C, *spatial). Biased variance, as torch's InstanceNorm without
    running stats. Statistics are taken in float32 (float64 input stays
    float64) and the result is cast back to ``x``'s dtype.
    """
    dims = tuple(range(2, x.ndim))
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    var, mean = torch.var_mean(x32, dim=dims, unbiased=False, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
