"""2-D ResNet conditioning encoder (port of ``models/stage2/resnet2d.py``).

A torchvision-style resnet18/34/50/101 trunk with InstanceNorm ('in') as
its norm, and a 1x1 conv head producing 2 * z_dim posterior parameters;
``encode`` wraps them in a ``DiagonalGaussianDistribution`` (sampling uses its
mode, so the config's ``deterministic`` flag does not matter here). Inputs are
(B, 3, H, W) in [-1, 1], fed to the trunk as they are.

The 'bn' (BatchNorm) and 'an' (ActNorm) norms are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.norms import instance_norm
from ..layers import SNConv, max_pool
from .distributions import DiagonalGaussianDistribution

TV_LAYERS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
}


def _check_norm(norm: str) -> None:
    if norm in ("bn", "an"):
        raise NotImplementedError(f"embedder norm {norm!r} is not ported yet (only 'in')")
    if norm != "in":
        raise ValueError(norm)


class _BasicBlock2D(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int, has_downsample: bool):
        super().__init__()
        self.conv1 = SNConv(inplanes, planes, (3, 3), stride, 1, bias=False)
        self.conv2 = SNConv(planes, planes, (3, 3), 1, 1, bias=False)
        self.downsample_conv = (SNConv(inplanes, planes, (1, 1), stride, bias=False)
                                if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(instance_norm(self.conv1(x)))
        out = instance_norm(self.conv2(out))
        if self.downsample_conv is not None:
            x = instance_norm(self.downsample_conv(x))
        return F.relu(out + x)


class _Bottleneck2D(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int, has_downsample: bool):
        super().__init__()
        self.conv1 = SNConv(inplanes, planes, (1, 1), bias=False)
        self.conv2 = SNConv(planes, planes, (3, 3), stride, 1, bias=False)
        self.conv3 = SNConv(planes, planes * 4, (1, 1), bias=False)
        self.downsample_conv = (SNConv(inplanes, planes * 4, (1, 1), stride, bias=False)
                                if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(instance_norm(self.conv1(x)))
        out = F.relu(instance_norm(self.conv2(out)))
        out = instance_norm(self.conv3(out))
        if self.downsample_conv is not None:
            x = instance_norm(self.downsample_conv(x))
        return F.relu(out + x)


class ResNet2D(nn.Module):
    """torchvision-equivalent trunk returning (B, C, 1, 1) pooled features."""

    def __init__(self, encoder_type: str = "resnet50", norm: str = "in"):
        super().__init__()
        _check_norm(norm)
        kind, layers = TV_LAYERS[encoder_type]
        block = _BasicBlock2D if kind == "basic" else _Bottleneck2D
        self.conv1 = SNConv(3, 64, (7, 7), 2, 3, bias=False)
        inplanes = 64
        for stage, planes in enumerate((64, 128, 256, 512)):
            stride = 1 if stage == 0 else 2
            needs_ds = stride != 1 or inplanes != planes * block.expansion
            self.add_module(f"layer{stage + 1}_block0", block(inplanes, planes, stride, needs_ds))
            inplanes = planes * block.expansion
            for b in range(1, layers[stage]):
                self.add_module(f"layer{stage + 1}_block{b}", block(inplanes, planes, 1, False))
        self.out_features = inplanes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(instance_norm(self.conv1(x)))
        x = max_pool(x, 3, 2, 1)
        for name, mod in self.named_children():
            if name.startswith("layer"):
                x = mod(x)
        return x.mean(dim=(2, 3), keepdim=True)


class ResnetEncoder(nn.Module):
    """Conditioning encoder: image (B, 3, H, W) -> 2 * z_dim posterior params."""

    def __init__(self, z_dim: int, encoder_type: str = "resnet50", norm: str = "in"):
        super().__init__()
        self.model = ResNet2D(encoder_type, norm)
        self.fc = SNConv(self.model.out_features, 2 * z_dim, (1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        enc = self.fc(self.model(x))
        return enc.reshape(enc.shape[0], -1)

    def encode(self, x: torch.Tensor) -> DiagonalGaussianDistribution:
        return DiagonalGaussianDistribution.from_params(self(x))
