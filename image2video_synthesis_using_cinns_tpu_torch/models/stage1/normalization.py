"""Conditional normalisation layers of the video decoder (port of
``models/stage1/normalization.py``), on (B, C, T, H, W) features.

* ``Spade``: GroupNorm (no affine, groups adapted to divide C), modulated by
  gamma and beta predicted from the start frame, which is resized (bilinear,
  align_corners=True) to the features' spatial size; broadcast over T:
  ``normalized * (1 + gamma) + beta``.
* ``ADAIN``: InstanceNorm3d (no affine), modulated per channel from the
  motion latent through a linear layer: ``gamma * IN(x) + beta``.
* ``Norm3D``: affine GroupNorm(16).

Each takes a width-sharded activation (``parallel/spatial.py``): the norms'
statistics span every shard, ``Spade`` computes its modulation at full width
on the start frame's device and sends each shard its columns, and ``ADAIN``'s
per-channel modulation needs no columns.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ...ops.norms import group_norm_groups, instance_norm
from ...ops.resize import resize_bilinear_align_corners
from ...parallel import spatial
from ..layers import GroupNorm, SNConv, SNDense, leaky_relu


class Spade(nn.Module):
    def __init__(self, num_features: int, num_groups: int = 16, hidden: int = 128):
        super().__init__()
        self.norm = GroupNorm(num_features, group_norm_groups(num_features, num_groups),
                              affine=False)
        self.conv = SNConv(3, hidden, (3, 3), padding=1)  # from the RGB start frame
        self.conv_gamma = SNConv(hidden, num_features, (3, 3), padding=1)
        self.conv_beta = SNConv(hidden, num_features, (3, 3), padding=1)

    def forward(self, x, img: torch.Tensor):
        normalized = self.norm(x)
        # the image path at the features' full size on img's device, also for
        # a width-sharded x: resizing a shard's own width would give other pixels
        y = resize_bilinear_align_corners(img, (x.shape[3], x.shape[4]))
        y = leaky_relu(self.conv(y), 0.2)
        gamma = self.conv_gamma(y).unsqueeze(2)  # broadcast over time
        beta = self.conv_beta(y).unsqueeze(2)
        if isinstance(x, spatial.WidthShards):
            gamma, beta = spatial.columns(gamma, x), spatial.columns(beta, x)
        return spatial.each(lambda n, g, b: n * (1.0 + g) + b, normalized, gamma, beta)


class ADAIN(nn.Module):
    def __init__(self, num_features: int, z_dim: int):
        super().__init__()
        self.linear = SNDense(z_dim, num_features * 2)

    def forward(self, x, z: torch.Tensor):
        gamma, beta = torch.chunk(self.linear(z), 2, dim=-1)
        return spatial.each(lambda n, g, b: g * n + b, instance_norm(x),
                            gamma[:, :, None, None, None], beta[:, :, None, None, None])


class Norm3D(nn.Module):
    def __init__(self, num_features: int, num_groups: int = 16):
        super().__init__()
        self.bn = GroupNorm(num_features, num_groups, affine=True)

    def forward(self, x):
        return self.bn(x)
