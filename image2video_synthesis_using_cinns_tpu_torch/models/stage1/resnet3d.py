"""3-D ResNet dynamics encoder and temporal discriminator (port of
``models/stage1/resnet3d.py``).

``Encoder``: a conv3d stem (3, 7, 7) with stride (2, 2, 2) and GroupNorm(16),
an optional (3, 3, 3) max pool with stride (1, 2, 2), four stages of
``BasicBlock3D`` (resnet10/18/34) or ``Bottleneck3D`` (resnet50/101) with the
config's per-stage channels and spatial/temporal strides, then two 4x4 valid
2-D conv heads on the final feature map with its time axis squeezed, giving
mu and logvar, and the sample ``eps * exp(0.5 * logvar) + mu``.

``Discriminator`` (stage-1 training): the same backbone with a stride-1
stem in time, spectral norm where the config asks for it, spectral
downsample paths (also where a block strides in time only), orthogonal conv
init, then an average pool (1, 4, 4) and a bias-free linear head: (logit
(B, 1), the four stages' features).

Channels-first inside: a video is (B, C, T, H, W); the facade swaps the
layout at its boundary. The reference quirk: blocks after a stage's first
are built without the spectral flag and take the block class's default,
True for the bottleneck, False for the basic block. A serving encoder
(``trainable=False``) has that norm folded into its weights by the weight
bridge and carries no spectral layer; a trainable one (``trainable=True``)
and the discriminator keep it as trainable spectral layers.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import GroupNorm, SNConv, SNDense, max_pool, orthogonal_

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
                 has_downsample: bool = False, spectral: bool = False,
                 downsample_spectral: bool = False):
        super().__init__()
        s = (stride_t, stride, stride)
        self.conv1 = SNConv(inplanes, planes, (3, 3, 3), s, 1, bias=False, spectral=spectral)
        self.bn1 = GroupNorm(planes, 16)
        self.conv2 = SNConv(planes, planes, (3, 3, 3), 1, 1, bias=False, spectral=spectral)
        self.bn2 = GroupNorm(planes, 16)
        self.downsample_conv = self.downsample_norm = None
        if has_downsample:
            self.downsample_conv = SNConv(inplanes, planes, (3, 3, 3), s, 1, bias=False,
                                          spectral=downsample_spectral)
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
                 has_downsample: bool = False, spectral: bool = False,
                 downsample_spectral: bool = False):
        super().__init__()
        s = (stride_t, stride, stride)
        self.conv1 = SNConv(inplanes, planes, (1, 1, 1), bias=False, spectral=spectral)
        self.bn1 = GroupNorm(planes, 16)
        self.conv2 = SNConv(planes, planes, (3, 3, 3), s, 1, bias=False, spectral=spectral)
        self.bn2 = GroupNorm(planes, 16)
        self.conv3 = SNConv(planes, planes * 4, (1, 1, 1), bias=False, spectral=spectral)
        self.bn3 = GroupNorm(planes * 4, 16)
        self.downsample_conv = self.downsample_norm = None
        if has_downsample:
            self.downsample_conv = SNConv(inplanes, planes * 4, (3, 3, 3), s, 1, bias=False,
                                          spectral=downsample_spectral)
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
    ``stem_stride_t`` is the stem's temporal stride (2 in the encoder, 1 in
    the discriminator). With ``trainable``, the blocks carry trainable
    spectral layers: a stage's first block where ``use_spectral_norm`` (its
    downsample path where ``downsample_always_spectral``), the later blocks
    where their class defaults to it. ``downsample_on_stride_t`` adds a
    downsample path where a block strides in time only (``:167-169``)."""

    def __init__(self, res_type: str, channels: Sequence[int], stride_s: Sequence[int],
                 stride_t: Sequence[int], use_max_pool: bool, stem_stride_t: int,
                 trainable: bool = False, use_spectral_norm: bool = False,
                 downsample_always_spectral: bool = False, downsample_on_stride_t: bool = False):
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
            needs_ds = (stride != 1 or inplanes != planes * block.expansion
                        or (downsample_on_stride_t and st != 1))
            names = [f"layer{stage}_block{b}" for b in range(layers[stage])]
            self.add_module(names[0], block(
                inplanes, planes, stride, st, needs_ds, spectral=trainable and use_spectral_norm,
                downsample_spectral=trainable and downsample_always_spectral))
            inplanes = planes * block.expansion
            rest_spectral = trainable and kind == "bottleneck"
            for name in names[1:]:
                self.add_module(name, block(inplanes, planes, spectral=rest_spectral))
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
    package initialises them. ``trainable`` keeps the spectral layers of a
    bottleneck backbone's later blocks (see the module docstring)."""

    def __init__(self, res_type_encoder: str, z_dim: int, channels: Sequence[int],
                 stride_s: Sequence[int], stride_t: Sequence[int], use_max_pool: bool = False,
                 trainable: bool = False):
        super().__init__()
        self.z_dim = z_dim
        self.backbone = ResNet3DBackbone(res_type_encoder, channels, stride_s, stride_t,
                                         use_max_pool, stem_stride_t=2, trainable=trainable)
        for m in self.backbone.modules():
            if isinstance(m, SNConv):
                nn.init.kaiming_normal_(m.weight, mode="fan_out", nonlinearity="relu")
        self.conv_mu = SNConv(self.backbone.out_features, z_dim, (4, 4))
        self.conv_var = SNConv(self.backbone.out_features, z_dim, (4, 4))

    @classmethod
    def from_config(cls, dic, trainable: bool = False) -> "Encoder":
        return cls(res_type_encoder=dic["res_type_encoder"], z_dim=dic["z_dim"],
                   channels=tuple(dic["channels"]), stride_s=tuple(dic["stride_s"]),
                   stride_t=tuple(dic["stride_t"]), use_max_pool=bool(dic["use_max_pool"]),
                   trainable=trainable)

    def moments(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(mu, logvar), each (B, z_dim), of video ``x`` (B, 3, T, H, W)."""
        emb = self.backbone(x)[-1]
        if emb.shape[2] != 1:
            raise ValueError(f"the backbone left {emb.shape[2]} time steps, not 1: the clip "
                             "length does not match the encoder's temporal strides")
        emb = emb.squeeze(2)  # (B, C, 4, 4)
        return (self.conv_mu(emb).reshape(emb.shape[0], -1),
                self.conv_var(emb).reshape(emb.shape[0], -1))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None,
                noise: torch.Tensor | None = None):
        """``noise`` injects eps (parity tests); otherwise eps ~ N(0, I) is drawn
        in float32 from ``generator``."""
        mu, logvar = self.moments(x)
        if noise is None:
            noise = torch.randn(logvar.shape, generator=generator, dtype=torch.float32,
                                device=logvar.device)
        eps = noise.to(device=logvar.device, dtype=logvar.dtype)
        return eps * torch.exp(0.5 * logvar) + mu, mu, logvar


class Discriminator(nn.Module):
    """Temporal discriminator: video (B, 3, T, H, W) -> (logit (B, 1), the
    four stages' features), trainable spectral norm as configured."""

    def __init__(self, res_type_encoder: str, channels: Sequence[int], stride_s: Sequence[int],
                 stride_t: Sequence[int], use_max_pool: bool = True, spectral_norm: bool = True):
        super().__init__()
        self.backbone = ResNet3DBackbone(
            res_type_encoder, channels, stride_s, stride_t, use_max_pool, stem_stride_t=1,
            trainable=True, use_spectral_norm=spectral_norm, downsample_always_spectral=True,
            downsample_on_stride_t=True)
        for m in self.backbone.modules():
            if isinstance(m, SNConv):
                orthogonal_(m.weight)
        self.fc = SNDense(self.backbone.out_features, 1, bias=False)

    @classmethod
    def from_config(cls, dic) -> "Discriminator":
        return cls(res_type_encoder=dic["res_type_encoder"], channels=tuple(dic["channels"]),
                   stride_s=tuple(dic["stride_s"]), stride_t=tuple(dic["stride_t"]),
                   use_max_pool=bool(dic["use_max_pool"]),
                   spectral_norm=bool(dic["spectral_norm"]))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        feats = self.backbone(x)
        h = feats[-1].unfold(3, 4, 1).unfold(4, 4, 1).mean((-2, -1))  # avg pool (1, 4, 4)
        # the JAX head flattens a channels-last (B, T, H, W, C) map
        h = h.permute(0, 2, 3, 4, 1).reshape(h.shape[0], -1)
        return self.fc(h), feats
