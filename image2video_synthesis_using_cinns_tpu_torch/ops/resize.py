"""Resampling primitives (port of ``ops/resize.py``), channels-first.

* ``upsample_nearest``: integer nearest-neighbour upsampling, an exact
  repeat along each axis, as the decoder's ``F.interpolate(scale_factor=..)``.
* ``resize_bilinear_align_corners``: SPADE's conditioning resize,
  ``F.interpolate(mode='bilinear', align_corners=True)``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def upsample_nearest(x: torch.Tensor, factors: Sequence[int]) -> torch.Tensor:
    """Repeat each trailing spatial axis of (B, C, *spatial) by its factor."""
    if all(f == 1 for f in factors):
        return x
    return F.interpolate(x, scale_factor=tuple(float(f) for f in factors), mode="nearest")


def resize_bilinear_align_corners(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) with ``align_corners=True`` sampling."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=True)
