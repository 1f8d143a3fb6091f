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

Given ``peers`` (its copies on a data row's model devices), the decoder runs
width-sharded from the JAX package's anchors on (``parallel/spatial.py``):
each block's 3x3x3 convolutions take a one-column halo, its norms reduce
their statistics over every shard.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ...ops.resize import upsample_nearest
from ...parallel import spatial
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

    def forward(self, x, motion: torch.Tensor, img: torch.Tensor,
                peers: list[GeneratorBlock] | None = None):
        """``x`` whole, or width-sharded with ``peers`` this block's copies on
        the shards' devices, in column order (``parallel/spatial.py``)."""
        def conv(name: str, t):
            if isinstance(t, spatial.WidthShards):
                return spatial.conv(t, [getattr(p, name) for p in peers])
            return getattr(self, name)(t)

        def act(t):
            return spatial.each(leaky_relu, t, 0.2)

        x_s = conv("conv_s", self.norm_s(x)) if self.learned_shortcut else x
        dx = conv("conv_0", act(self.norm_0(x, img)))
        dx = conv("conv_1", act(self.norm_1(dx, motion)))
        return spatial.each(torch.add, x_s, dx)


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

    def forward(self, img: torch.Tensor, motion: torch.Tensor,
                peers: list[Generator] | None = None):
        """img: (B, 3, H, W) in [-1, 1]; motion: (B, z) -> video (B, 3, T, H, W).

        ``peers``: this decoder's copies on a data row's model devices, in
        column order, the first on img's device (``Model(spatial_shard=)``).
        From the first anchor whose width divides their count the width is
        split over them (``spatial.constrain_spatial``), and the video comes
        back width-sharded (``spatial.gather`` joins it)."""
        if peers is None:
            anchor, row = (lambda t: t), (lambda name: None)
        else:
            devices = [p.fc.weight.device for p in peers]
            anchor = lambda t: spatial.constrain_spatial(t, devices)  # noqa: E731
            row = lambda name: [getattr(p, name) for p in peers]  # noqa: E731

        def up(t, factors):
            return spatial.each(upsample_nearest, t, factors)

        x = self.fc(motion).reshape(img.shape[0], 16 * self.nf, 1, 4, 4)
        x = self.head_0(x, motion, img)  # width 4: whole, as in JAX
        x = self.g_0(anchor(up(x, (2, 2, 2))), motion, img, row("g_0"))
        x = self.g_1(anchor(up(x, (2, 2, 2))), motion, img, row("g_1"))
        x = self.g_2(anchor(up(x, (2, 2, 2))), motion, img, row("g_2"))
        ft, fs = self.upsample_t[0], self.upsample_s[0]
        x = self.g_3(anchor(up(x, (ft, fs, fs))), motion, img, row("g_3"))
        ft, fs = self.upsample_t[1], self.upsample_s[1]
        x = self.g_4(anchor(up(x, (ft, fs, fs))), motion, img, row("g_4"))
        x = spatial.each(leaky_relu, anchor(x), 0.2)
        x = spatial.conv(x, row("conv_img")) if isinstance(x, spatial.WidthShards) else \
            self.conv_img(x)
        return spatial.each(torch.tanh, x)
