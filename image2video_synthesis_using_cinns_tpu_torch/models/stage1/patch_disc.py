"""PatchGAN image discriminator (port of ``models/stage1/patch_disc.py``),
channels-first, for stage-1 training.

A conv (k4, s2) + LeakyReLU(0.2) stem, ``n_layers - 1`` strided conv + norm +
LeakyReLU stages with channels doubling up to 8x, one stride-1 stage, then a
one-channel prediction map. The norm is ``ActNormImage`` (data-dependent
init, ``layers.init_actnorm``) or an eval-mode ``BatchNorm``, as configured;
the convs carry trainable spectral norm where configured; conv weights are
drawn from N(0, 0.02).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..layers import ActNormImage, BatchNorm, SNConv, leaky_relu, normal_002_


class NLayerDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 3, ndf: int = 64, n_layers: int = 3,
                 use_actnorm: bool = True, spectral_norm: bool = True):
        super().__init__()
        self.n_layers = n_layers
        sn = spectral_norm
        use_bias = use_actnorm  # BatchNorm has its own affine bias
        norm = ActNormImage if use_actnorm else BatchNorm
        self.conv0 = SNConv(in_channels, ndf, (4, 4), 2, 1, spectral=sn)
        n_in = ndf
        for n in range(1, n_layers):
            n_out = ndf * min(2 ** n, 8)
            self.add_module(f"conv{n}", SNConv(n_in, n_out, (4, 4), 2, 1, bias=use_bias,
                                               spectral=sn))
            self.add_module(f"norm{n}", norm(n_out))
            n_in = n_out
        n_out = ndf * min(2 ** n_layers, 8)
        self.add_module(f"conv{n_layers}", SNConv(n_in, n_out, (4, 4), 1, 1, bias=use_bias,
                                                  spectral=sn))
        self.add_module(f"norm{n_layers}", norm(n_out))
        self.conv_out = SNConv(n_out, 1, (4, 4), 1, 1, spectral=sn)
        for m in self.modules():
            if isinstance(m, SNConv):
                normal_002_(m.weight)

    @classmethod
    def from_config(cls, dic) -> "NLayerDiscriminator":
        return cls(in_channels=dic["in_channels"], ndf=dic["ndf"], n_layers=dic["n_layers"],
                   use_actnorm=bool(dic["use_actnorm"]), spectral_norm=bool(dic["spectral_norm"]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) -> patch logits (B, 1, H', W')."""
        h = leaky_relu(self.conv0(x), 0.2)
        for n in range(1, self.n_layers + 1):
            h = leaky_relu(getattr(self, f"norm{n}")(getattr(self, f"conv{n}")(h)), 0.2)
        return self.conv_out(h)
