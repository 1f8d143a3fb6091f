"""LPIPS perceptual metric, VGG flavour, frozen (port of
``models/backbones/lpips.py``), channels-first.

Scaling layer (shift/scale constants), the 5 VGG16 feature slices, the
channel-unit-normalised squared differences, the 1x1 ``lin{k}`` heads
(dropout is the identity at eval, the only mode LPIPS runs in), the spatial
mean, summed over slices: one scalar per image pair.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..layers import SNConv
from .vgg16 import VGG16Features, normalize_tensor, spatial_average

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_CHNS = (64, 128, 256, 512, 512)


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)
        self.net = VGG16Features()
        for k, ch in enumerate(_CHNS):
            self.add_module(f"lin{k}", SNConv(ch, 1, (1, 1), bias=False))

    def forward(self, input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """input/target: (B, 3, H, W) in [-1, 1] -> (B,) LPIPS distances."""
        outs0 = self.net((input - self.shift) / self.scale)
        outs1 = self.net((target - self.shift) / self.scale)
        val = 0.0
        for k in range(len(_CHNS)):
            diff = torch.square(normalize_tensor(outs0[k]) - normalize_tensor(outs1[k]))
            val = val + spatial_average(getattr(self, f"lin{k}")(diff), keepdim=False)
        return val[:, 0]
