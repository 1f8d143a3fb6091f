"""Resampling primitives (port of ``ops/resize.py``), channels-first.

* ``upsample_nearest``: integer nearest-neighbour upsampling, an exact
  repeat along each axis, as the decoder's ``F.interpolate(scale_factor=..)``.
* ``resize_bilinear_align_corners``: SPADE's conditioning resize and the FVD
  preprocess to 224, ``F.interpolate(mode='bilinear', align_corners=True)``.
* ``resize_bilinear``: the data pipeline's and the metrics' half-pixel
  resize, ``jax.image.resize(..., 'bilinear')``, which antialiases when it
  downsamples (a triangle filter widened by the scale) and returns its input
  when the size already matches: ``F.interpolate(mode='bilinear',
  align_corners=False, antialias=True)`` computes the same filter.
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


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Half-pixel bilinear resize of (..., C, H, W), antialiased when it
    downsamples, as ``jax.image.resize(..., 'bilinear')``."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    lead = x.shape[:-3]
    y = F.interpolate(x.reshape((-1,) + tuple(x.shape[-3:])), size=tuple(size),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.reshape(lead + y.shape[1:])
