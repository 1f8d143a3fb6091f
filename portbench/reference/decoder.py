"""The video decoder in plain float32 PyTorch (``models/stage1/decoder.py``
and ``normalization.py`` of the port, frozen, without the width-sharded
branches): (start frame (B, 3, H, W), motion z (B, z)) -> video (B, 3, T, H, W).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .nn import (GroupNorm, SNConv, SNDense, group_norm_groups, instance_norm, leaky_relu,
                 resize_bilinear_align_corners, upsample_nearest)


class Spade(nn.Module):
    def __init__(self, num_features: int, num_groups: int = 16, hidden: int = 128):
        super().__init__()
        self.norm = GroupNorm(num_features, group_norm_groups(num_features, num_groups),
                              affine=False)
        self.conv = SNConv(3, hidden, (3, 3), padding=1)
        self.conv_gamma = SNConv(hidden, num_features, (3, 3), padding=1)
        self.conv_beta = SNConv(hidden, num_features, (3, 3), padding=1)

    def forward(self, x: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        normalized = self.norm(x)
        y = resize_bilinear_align_corners(img, (x.shape[3], x.shape[4]))
        y = leaky_relu(self.conv(y), 0.2)
        gamma = self.conv_gamma(y).unsqueeze(2)
        beta = self.conv_beta(y).unsqueeze(2)
        return normalized * (1.0 + gamma) + beta


class ADAIN(nn.Module):
    def __init__(self, num_features: int, z_dim: int):
        super().__init__()
        self.linear = SNDense(z_dim, num_features * 2)

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        gamma, beta = torch.chunk(self.linear(z), 2, dim=-1)
        return gamma[:, :, None, None, None] * instance_norm(x) + beta[:, :, None, None, None]


class Norm3D(nn.Module):
    def __init__(self, num_features: int, num_groups: int = 16):
        super().__init__()
        self.bn = GroupNorm(num_features, num_groups, affine=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x)


class GeneratorBlock(nn.Module):
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
    """The decoder; ``spectral_norm`` keeps trainable spectral layers (stage-1
    training), a serving decoder has sigma folded into its weights."""

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
    def from_config(cls, dic: dict, trainable: bool = False) -> "Generator":
        return cls(dic["channel_factor"], dic["z_dim"], dic["upsample_s"], dic["upsample_t"],
                   spectral_norm=trainable and bool(dic.get("spectral_norm", True)))

    @property
    def base_frames(self) -> int:
        t = 8
        for f in self.upsample_t:
            t *= f
        return t

    def forward(self, img: torch.Tensor, motion: torch.Tensor) -> torch.Tensor:
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


def render(decoder: Generator, x0: torch.Tensor, z: torch.Tensor, vid_length: int,
           rows: int | None = None) -> torch.Tensor:
    """The serving facade's video (``Model._render``): decode z from x0, then
    from each chunk's last frame until ``vid_length`` frames, truncated:
    (B, T, 3, H, W). ``rows`` decodes that many rows at a time."""
    rows = rows or x0.shape[0]
    out = []
    for i in range(0, x0.shape[0], rows):
        img, zz = x0[i:i + rows], z[i:i + rows]
        chunks = [decoder(img, zz)]
        n_repeats = max(0, -(-vid_length // decoder.base_frames) - 1)
        for _ in range(n_repeats):
            chunks.append(decoder(chunks[-1][:, :, -1], zz))
        out.append(torch.cat(chunks, dim=2)[:, :, :vid_length].permute(0, 2, 1, 3, 4))
    return torch.cat(out)
