"""VGG16 feature slices relu1_2 ... relu5_3 for LPIPS and the diversity metric
(port of ``models/backbones/vgg16.py``), channels-first.

The torchvision VGG16 ``features`` trunk split into 5 slices, each ending at
its stage's last relu; the convolutions are named ``conv0`` ... ``conv12`` as
in the JAX module. The network is always frozen.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import SNConv, max_pool

# (convs per stage, channels): torchvision vgg16 cfg 'D'
_STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


class VGG16Features(nn.Module):
    def __init__(self):
        super().__init__()
        c, idx = 3, 0
        for n_convs, ch in _STAGES:
            for _ in range(n_convs):
                self.add_module(f"conv{idx}", SNConv(c, ch, (3, 3), padding=1))
                c, idx = ch, idx + 1

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: (B, 3, H, W) -> [relu1_2, relu2_2, relu3_3, relu4_3, relu5_3]."""
        outs, idx = [], 0
        for stage, (n_convs, _) in enumerate(_STAGES):
            if stage > 0:
                x = max_pool(x, 2, 2, 0)
            for _ in range(n_convs):
                x = F.relu(getattr(self, f"conv{idx}")(x))
                idx += 1
            outs.append(x)
        return outs


def normalize_tensor(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Unit-normalise over the channel axis of (B, C, H, W)."""
    norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    return x / (norm + eps)


def spatial_average(x: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    return x.mean(dim=(2, 3), keepdim=keepdim)
