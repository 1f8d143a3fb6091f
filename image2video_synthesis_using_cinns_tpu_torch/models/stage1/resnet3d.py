"""3-D ResNet dynamics encoder (port of ``models/stage1/resnet3d.py``).

``Encoder``: a conv3d stem (3, 7, 7) with stride (2, 2, 2) and GroupNorm(16),
an optional (3, 3, 3) max pool with stride (1, 2, 2), four stages of
``BasicBlock3D`` (resnet10/18/34) or ``Bottleneck3D`` (resnet50/101) with the
config's per-stage channels and spatial/temporal strides, then two 4x4 valid
2-D conv heads on the final feature map with its time axis squeezed, giving
mu and logvar, and the sample ``eps * exp(0.5 * logvar) + mu``.

Channels-first inside: a video is (B, C, T, H, W); the facade swaps the
layout at its boundary. Spectral norm (the reference quirk: blocks after a
stage's first fall back to the block class's default flag, True for the
bottleneck) is folded into the weights by the weight bridge, so the modules
carry no spectral flag. The temporal discriminator, which shares the
backbone with a stride-1 stem (and adds downsample paths where a block
strides in time only), belongs to the stage-1 training slice.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import GroupNorm, SNConv, max_pool

RESNET_LAYERS = {
    "resnet10": ("basic", (1, 1, 1, 1)),
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
}


class BasicBlock3D(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, stride_t: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        s = (stride_t, stride, stride)
        self.conv1 = SNConv(inplanes, planes, (3, 3, 3), s, 1, bias=False)
        self.bn1 = GroupNorm(planes, 16)
        self.conv2 = SNConv(planes, planes, (3, 3, 3), 1, 1, bias=False)
        self.bn2 = GroupNorm(planes, 16)
        self.downsample_conv = self.downsample_norm = None
        if has_downsample:
            self.downsample_conv = SNConv(inplanes, planes, (3, 3, 3), s, 1, bias=False)
            self.downsample_norm = GroupNorm(planes, 16)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample_conv is not None:
            x = self.downsample_norm(self.downsample_conv(x))
        return F.relu(out + x)


class Bottleneck3D(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, stride_t: int = 1,
                 has_downsample: bool = False):
        super().__init__()
        s = (stride_t, stride, stride)
        self.conv1 = SNConv(inplanes, planes, (1, 1, 1), bias=False)
        self.bn1 = GroupNorm(planes, 16)
        self.conv2 = SNConv(planes, planes, (3, 3, 3), s, 1, bias=False)
        self.bn2 = GroupNorm(planes, 16)
        self.conv3 = SNConv(planes, planes * 4, (1, 1, 1), bias=False)
        self.bn3 = GroupNorm(planes * 4, 16)
        self.downsample_conv = self.downsample_norm = None
        if has_downsample:
            self.downsample_conv = SNConv(inplanes, planes * 4, (3, 3, 3), s, 1, bias=False)
            self.downsample_norm = GroupNorm(planes * 4, 16)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample_conv is not None:
            x = self.downsample_norm(self.downsample_conv(x))
        return F.relu(out + x)


class ResNet3DBackbone(nn.Module):
    """Stem and four stages of blocks; ``forward`` returns each stage's output.
    ``stem_stride_t`` is the stem's temporal stride (2 in the encoder)."""

    def __init__(self, res_type: str, channels: Sequence[int], stride_s: Sequence[int],
                 stride_t: Sequence[int], use_max_pool: bool, stem_stride_t: int):
        super().__init__()
        kind, layers = RESNET_LAYERS[res_type]
        block = BasicBlock3D if kind == "basic" else Bottleneck3D
        if not len(channels) - 1 == len(stride_s) == len(stride_t):
            raise ValueError("channels must have one entry more than stride_s and stride_t")
        self.use_max_pool = use_max_pool
        self.conv1 = SNConv(3, channels[0], (3, 7, 7), (stem_stride_t, 2, 2), (1, 3, 3),
                            bias=False)
        self.norm1 = GroupNorm(channels[0], 16)
        self.stages = []
        inplanes = channels[0]
        for stage, planes in enumerate(channels[1:]):
            stride, st = stride_s[stage], stride_t[stage]
            needs_ds = stride != 1 or inplanes != planes * block.expansion
            names = [f"layer{stage}_block{b}" for b in range(layers[stage])]
            self.add_module(names[0], block(inplanes, planes, stride, st, needs_ds))
            inplanes = planes * block.expansion
            for name in names[1:]:
                self.add_module(name, block(inplanes, planes))
            self.stages.append(names)
        self.out_features = inplanes

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = F.relu(self.norm1(self.conv1(x)))
        if self.use_max_pool:
            x = max_pool(x, (3, 3, 3), (1, 2, 2), (1, 1, 1))
        features = []
        for names in self.stages:
            for name in names:
                x = getattr(self, name)(x)
            features.append(x)
        return features


class Encoder(nn.Module):
    """Dynamics encoder: video (B, 3, T, H, W) -> (sample, mu, logvar), each (B, z_dim).

    The backbone must reduce the time axis to 1 and the spatial axes to 4x4.
    Backbone convs are drawn from kaiming-normal (fan_out), as the JAX
    package initialises them."""

    def __init__(self, res_type_encoder: str, z_dim: int, channels: Sequence[int],
                 stride_s: Sequence[int], stride_t: Sequence[int], use_max_pool: bool = False):
        super().__init__()
        self.backbone = ResNet3DBackbone(res_type_encoder, channels, stride_s, stride_t,
                                         use_max_pool, stem_stride_t=2)
        for m in self.backbone.modules():
            if isinstance(m, SNConv):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")
        self.conv_mu = SNConv(self.backbone.out_features, z_dim, (4, 4))
        self.conv_var = SNConv(self.backbone.out_features, z_dim, (4, 4))

    @classmethod
    def from_config(cls, dic) -> "Encoder":
        return cls(res_type_encoder=dic["res_type_encoder"], z_dim=dic["z_dim"],
                   channels=tuple(dic["channels"]), stride_s=tuple(dic["stride_s"]),
                   stride_t=tuple(dic["stride_t"]), use_max_pool=bool(dic["use_max_pool"]))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                noise: torch.Tensor | None = None):
        """``noise`` injects eps (parity tests); otherwise eps ~ N(0, I) is drawn
        in float32 from ``generator``."""
        emb = self.backbone(x)[-1]
        if emb.shape[2] != 1:
            raise ValueError(f"the backbone left {emb.shape[2]} time steps, not 1: the clip "
                             "length does not match the encoder's temporal strides")
        emb = emb.squeeze(2)  # (B, C, 4, 4)
        mu = self.conv_mu(emb).reshape(emb.shape[0], -1)
        logvar = self.conv_var(emb).reshape(emb.shape[0], -1)
        if noise is None:
            noise = torch.randn(logvar.shape, generator=generator, dtype=torch.float32,
                                device=logvar.device)
        eps = noise.to(device=logvar.device, dtype=logvar.dtype)
        return eps * torch.exp(0.5 * logvar) + mu, mu, logvar
