"""SPADE/ADAIN-conditioned 3D-conv video decoder (port of
``models/stage1/decoder.py``).

Six residual ``GeneratorBlock``s (Spade -> conv3d -> ADAIN -> conv3d plus a
learned shortcut), nearest x2 upsampling between the first four, then
per-axis (upsample_t, upsample_s, upsample_s) factors for the last two,
LeakyReLU(0.2), spectral norm on the blocks' convs where configured, tanh
output. Channels-first: the decoder maps (start image (B, 3, H, W), motion z
(B, z)) to a video (B, 3, T, H, W). A serving decoder has that spectral norm
folded into its weights at load; a trainable one (``from_config(...,
trainable=True)``, stage-1 training) keeps it on ``conv_0``, ``conv_1`` and
``conv_s`` as trainable spectral layers. The Spade and ADAIN layers have
none, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ...ops.resize import upsample_nearest
from ..layers import SNConv, SNDense, leaky_relu
from .normalization import ADAIN, Norm3D, Spade


class GeneratorBlock(nn.Module):
    """Residual block: Spade(img) -> conv3d -> ADAIN(z) -> conv3d (+ shortcut).

    ``spectral`` makes conv_0/conv_1/conv_s trainable spectral layers; a
    serving block has their sigma folded in by the weight bridge."""

    def __init__(self, n_in: int, n_out: int, z_dim: int, spectral: bool = False):
        super().__init__()
        n_middle = min(n_in, n_out)
        self.learned_shortcut = n_in != n_out
        if self.learned_shortcut:
            self.norm_s = Norm3D(n_in)
            self.conv_s = SNConv(n_in, n_out, (1, 1, 1), bias=False, spectral=spectral)
        self.norm_0 = Spade(n_in)
        self.conv_0 = SNConv(n_in, n_middle, (3, 3, 3), padding=1, spectral=spectral)
        self.norm_1 = ADAIN(n_middle, z_dim)
        self.conv_1 = SNConv(n_middle, n_out, (3, 3, 3), padding=1, spectral=spectral)

    def forward(self, x: torch.Tensor, motion: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        x_s = self.conv_s(self.norm_s(x)) if self.learned_shortcut else x
        dx = self.conv_0(leaky_relu(self.norm_0(x, img), 0.2))
        dx = self.conv_1(leaky_relu(self.norm_1(dx, motion), 0.2))
        return x_s + dx


class Generator(nn.Module):
    """Video decoder; config keys follow the ``Decoder`` section:
    channel_factor, z_dim, upsample_s, upsample_t, spectral_norm. The
    constructor's ``spectral_norm`` builds trainable spectral layers;
    ``from_config`` sets it only for a ``trainable`` decoder."""

    def __init__(self, channel_factor: int, z_dim: int, upsample_s: Sequence[int],
                 upsample_t: Sequence[int], spectral_norm: bool = False):
        super().__init__()
        sn = spectral_norm
        nf = self.nf = channel_factor
        self.upsample_s = tuple(upsample_s)
        self.upsample_t = tuple(upsample_t)
        self.fc = SNDense(z_dim, 4 * 4 * 16 * nf)
        self.head_0 = GeneratorBlock(16 * nf, 16 * nf, z_dim, sn)
        self.g_0 = GeneratorBlock(16 * nf, 16 * nf, z_dim, sn)
        self.g_1 = GeneratorBlock(16 * nf, 8 * nf, z_dim, sn)
        self.g_2 = GeneratorBlock(8 * nf, 4 * nf, z_dim, sn)
        self.g_3 = GeneratorBlock(4 * nf, 2 * nf, z_dim, sn)
        self.g_4 = GeneratorBlock(2 * nf, 1 * nf, z_dim, sn)
        self.conv_img = SNConv(nf, 3, (3, 3, 3), padding=1)

    @classmethod
    def from_config(cls, dic, trainable: bool = False) -> "Generator":
        return cls(channel_factor=dic["channel_factor"], z_dim=dic["z_dim"],
                   upsample_s=tuple(dic["upsample_s"]), upsample_t=tuple(dic["upsample_t"]),
                   spectral_norm=trainable and bool(dic.get("spectral_norm", True)))

    @property
    def base_frames(self) -> int:
        """Frames per application: 8 * prod(upsample_t)."""
        t = 8
        for f in self.upsample_t:
            t *= f
        return t

    def forward(self, img: torch.Tensor, motion: torch.Tensor) -> torch.Tensor:
        """img: (B, 3, H, W) in [-1, 1]; motion: (B, z) -> video (B, 3, T, H, W)."""
        x = self.fc(motion).reshape(img.shape[0], 16 * self.nf, 1, 4, 4)
        x = self.head_0(x, motion, img)
        x = self.g_0(upsample_nearest(x, (2, 2, 2)), motion, img)
        x = self.g_1(upsample_nearest(x, (2, 2, 2)), motion, img)
        x = self.g_2(upsample_nearest(x, (2, 2, 2)), motion, img)
        ft, fs = self.upsample_t[0], self.upsample_s[0]
        x = self.g_3(upsample_nearest(x, (ft, fs, fs)), motion, img)
        ft, fs = self.upsample_t[1], self.upsample_s[1]
        x = self.g_4(upsample_nearest(x, (ft, fs, fs)), motion, img)
        return torch.tanh(self.conv_img(leaky_relu(x, 0.2)))
