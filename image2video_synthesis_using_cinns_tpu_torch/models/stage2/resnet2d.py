"""2-D ResNet conditioning encoder (port of ``models/stage2/resnet2d.py``).

A torchvision-style resnet18/34/50/101 trunk whose norm is InstanceNorm
('in'), BatchNorm from running statistics ('bn') or ActNorm ('an'), as the
config says, and a 1x1 conv head producing 2 * z_dim posterior parameters;
``encode`` wraps them in a ``DiagonalGaussianDistribution`` (the serving paths
use its mode; the AE trainer also its KL, which ``deterministic`` sets to 0).
Inputs are (B, 3, H, W) in [-1, 1], fed to the trunk as they are. Each norm
keeps the JAX module's name (``bn1``, ``downsample_norm``, ...) and holds its
layer as ``bn`` or ``an``, so the weight bridge maps paths to keys one to one.

``train=True`` (the AE trainer's forward) normalises the ``bn`` layers with
the batch's statistics (``layers.BatchNorm``); InstanceNorm and ActNorm
compute the same in both modes. The default, ``train=False``, is the serving
embedder's forward.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.norms import instance_norm
from ..layers import ActNormImage, BatchNorm, SNConv, max_pool
from .distributions import DiagonalGaussianDistribution

TV_LAYERS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
}


class _Norm2D(nn.Module):
    """InstanceNorm without affine ('in'), BatchNorm ('bn') or ActNorm ('an')."""

    def __init__(self, kind: str, features: int):
        super().__init__()
        if kind not in ("in", "bn", "an"):
            raise ValueError(f"unknown embedder norm {kind!r}")
        self.kind = kind
        if kind == "bn":
            self.bn = BatchNorm(features)
        elif kind == "an":
            self.an = ActNormImage(features)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.kind == "in":
            return instance_norm(x)
        return self.bn(x, train) if self.kind == "bn" else self.an(x)


class _BasicBlock2D(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int, norm: str, has_downsample: bool):
        super().__init__()
        self.conv1 = SNConv(inplanes, planes, (3, 3), stride, 1, bias=False)
        self.bn1 = _Norm2D(norm, planes)
        self.conv2 = SNConv(planes, planes, (3, 3), 1, 1, bias=False)
        self.bn2 = _Norm2D(norm, planes)
        self.downsample_conv = self.downsample_norm = None
        if has_downsample:
            self.downsample_conv = SNConv(inplanes, planes, (1, 1), stride, bias=False)
            self.downsample_norm = _Norm2D(norm, planes)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), train))
        out = self.bn2(self.conv2(out), train)
        if self.downsample_conv is not None:
            x = self.downsample_norm(self.downsample_conv(x), train)
        return F.relu(out + x)


class _Bottleneck2D(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int, norm: str, has_downsample: bool):
        super().__init__()
        self.conv1 = SNConv(inplanes, planes, (1, 1), bias=False)
        self.bn1 = _Norm2D(norm, planes)
        self.conv2 = SNConv(planes, planes, (3, 3), stride, 1, bias=False)
        self.bn2 = _Norm2D(norm, planes)
        self.conv3 = SNConv(planes, planes * 4, (1, 1), bias=False)
        self.bn3 = _Norm2D(norm, planes * 4)
        self.downsample_conv = self.downsample_norm = None
        if has_downsample:
            self.downsample_conv = SNConv(inplanes, planes * 4, (1, 1), stride, bias=False)
            self.downsample_norm = _Norm2D(norm, planes * 4)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), train))
        out = F.relu(self.bn2(self.conv2(out), train))
        out = self.bn3(self.conv3(out), train)
        if self.downsample_conv is not None:
            x = self.downsample_norm(self.downsample_conv(x), train)
        return F.relu(out + x)


class ResNet2D(nn.Module):
    """torchvision-equivalent trunk returning (B, C, 1, 1) pooled features."""

    def __init__(self, encoder_type: str = "resnet50", norm: str = "in"):
        super().__init__()
        kind, layers = TV_LAYERS[encoder_type]
        block = _BasicBlock2D if kind == "basic" else _Bottleneck2D
        self.conv1 = SNConv(3, 64, (7, 7), 2, 3, bias=False)
        self.bn1 = _Norm2D(norm, 64)
        inplanes = 64
        for stage, planes in enumerate((64, 128, 256, 512)):
            stride = 1 if stage == 0 else 2
            needs_ds = stride != 1 or inplanes != planes * block.expansion
            self.add_module(f"layer{stage + 1}_block0",
                            block(inplanes, planes, stride, norm, needs_ds))
            inplanes = planes * block.expansion
            for b in range(1, layers[stage]):
                self.add_module(f"layer{stage + 1}_block{b}",
                                block(inplanes, planes, 1, norm, False))
        self.out_features = inplanes

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x), train))
        x = max_pool(x, 3, 2, 1)
        for name, mod in self.named_children():
            if name.startswith("layer"):
                x = mod(x, train)
        return x.mean(dim=(2, 3), keepdim=True)


class ResnetEncoder(nn.Module):
    """Conditioning encoder: image (B, 3, H, W) -> 2 * z_dim posterior params."""

    def __init__(self, z_dim: int, encoder_type: str = "resnet50", norm: str = "in",
                 deterministic: bool = False):
        super().__init__()
        self.deterministic = deterministic
        self.model = ResNet2D(encoder_type, norm)
        self.fc = SNConv(self.model.out_features, 2 * z_dim, (1, 1))

    @classmethod
    def from_config(cls, cfg) -> "ResnetEncoder":
        return cls(z_dim=cfg["z_dim"], encoder_type=cfg["encoder_type"], norm=cfg["norm"],
                   deterministic=bool(cfg["deterministic"]))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        enc = self.fc(self.model(x, train))
        return enc.reshape(enc.shape[0], -1)

    def encode(self, x: torch.Tensor, train: bool = False) -> DiagonalGaussianDistribution:
        return DiagonalGaussianDistribution.from_params(self(x, train), self.deterministic)
