"""Clip augmentation on the batch's device (port of ``data/augment.py``, its
eval branch).

``build_augment(img_size, params, random_crop, train=False)`` returns the eval
transform of the JAX package, ``uint8 / 255 -> resize_bilinear -> (x - 0.5) /
0.5``, as torch ops on the device the batch lies on. The resize is the JAX
package's ``jax.image.resize(..., 'bilinear')``: half-pixel centres,
antialiased when it downsamples (a 128 px dataset evaluated at 64 px), the
input unchanged when the size matches (``ops/resize.py``). The layout is the
JAX package's: (B, T, H, W, 3) in, float32 (B, T, H, W, 3) in [-1, 1] out.

The train branch (horizontal flip, random crop, colour jitter in a random
order per clip) is not ported yet: ``train=True`` raises.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.resize import resize_bilinear


def build_augment(img_size: int, params: dict | None, random_crop: bool,
                  train: bool) -> Callable[[torch.Tensor], torch.Tensor]:
    """The eval transform: uint8 batch (B, T, H, W, 3), a tensor on any device
    or a numpy array (taken on the CPU), -> float32 (B, T, H, W, 3) in [-1, 1]
    on the same device. ``params`` and ``random_crop`` only shape the train
    branch."""
    if train:
        raise NotImplementedError(
            "the train augmentation (flip, crop, colour jitter) is not ported yet "
            "(ROADMAP slice 5, stage-2 cINN training)")

    def augment(batch_u8) -> torch.Tensor:
        x = torch.as_tensor(batch_u8).to(torch.float32) / 255.0
        x = resize_bilinear(x.permute(0, 1, 4, 2, 3), (img_size, img_size))
        return ((x - 0.5) / 0.5).permute(0, 1, 3, 4, 2).contiguous()

    return augment
