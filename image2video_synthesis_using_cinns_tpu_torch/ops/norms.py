"""Normalisation helpers with the reference's torch semantics (port of
``ops/norms.py``), in channels-first layout."""

from __future__ import annotations

import torch

from ..parallel import spatial


def group_norm_groups(num_features: int, num_groups: int = 16) -> int:
    """SPADE-style adaptation: decrement groups until they divide channels."""
    while num_features % num_groups != 0:
        num_groups -= 1
    return num_groups


def instance_norm(x, eps: float = 1e-5):
    """InstanceNorm over all spatial axes, per sample and channel, no affine.

    ``x``: (B, C, *spatial). Biased variance, as torch's InstanceNorm without
    running stats. Statistics are taken in float32 (float64 input stays
    float64) and the result is cast back to ``x``'s dtype. A width-sharded
    ``x`` (``parallel/spatial.py``) takes its statistics over every shard.
    """
    if isinstance(x, spatial.WidthShards):
        return spatial.group_norm(x, x.shape[1], eps=eps)
    dims = tuple(range(2, x.ndim))
    x32 = x.to(torch.promote_types(x.dtype, torch.float32))
    var, mean = torch.var_mean(x32, dim=dims, unbiased=False, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)
