"""The 2-D conditioning embedder and the 3-D dynamics encoder and temporal
discriminator in plain float32 PyTorch (the port's
``models/stage2/resnet2d.py`` and ``models/stage1/resnet3d.py``, frozen;
the embedder in its serving mode, BatchNorm from running statistics)."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .nn import BatchNorm, GroupNorm, SNConv, SNDense, instance_norm, max_pool

TV_LAYERS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
}
RESNET3D_LAYERS = {"resnet10": ("basic", (1, 1, 1, 1)), **TV_LAYERS}


# -- the 2-D embedder -------------------------------------------------------------

class _Norm2D(nn.Module):
    """InstanceNorm without affine ('in') or BatchNorm from running
    statistics ('bn'), the two norms the configurations' embedders use."""

    def __init__(self, kind: str, features: int):
        super().__init__()
        if kind not in ("in", "bn"):
            raise ValueError(f"the reference's embedder takes 'in' or 'bn' norms, not {kind!r}")
        self.kind = kind
        if kind == "bn":
            self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x) if self.kind == "in" else self.bn(x)


class _BasicBlock2D(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride, norm, has_downsample):
        super().__init__()
        self.conv1 = SNConv(inplanes, planes, (3, 3), stride, 1, bias=False)
        self.bn1 = _Norm2D(norm, planes)
        self.conv2 = SNConv(planes, planes, (3, 3), 1, 1, bias=False)
        self.bn2 = _Norm2D(norm, planes)
        self.downsample_conv = self.downsample_norm = None
        if has_downsample:
            self.downsample_conv = SNConv(inplanes, planes, (1, 1), stride, bias=False)
            self.downsample_norm = _Norm2D(norm, planes)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample_conv is not None:
            x = self.downsample_norm(self.downsample_conv(x))
        return F.relu(out + x)


class _Bottleneck2D(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride, norm, has_downsample):
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

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample_conv is not None:
            x = self.downsample_norm(self.downsample_conv(x))
        return F.relu(out + x)


class ResNet2D(nn.Module):
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

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool(x, 3, 2, 1)
        for name, mod in self.named_children():
            if name.startswith("layer"):
                x = mod(x)
        return x.mean(dim=(2, 3), keepdim=True)


class ResnetEncoder(nn.Module):
    """Image (B, 3, H, W) -> 2 * z_dim posterior parameters."""

    def __init__(self, z_dim: int, encoder_type: str = "resnet50", norm: str = "in"):
        super().__init__()
        self.model = ResNet2D(encoder_type, norm)
        self.fc = SNConv(self.model.out_features, 2 * z_dim, (1, 1))

    def forward(self, x):
        enc = self.fc(self.model(x))
        return enc.reshape(enc.shape[0], -1)

    def mode(self, x):
        """The posterior mean (the first half of the parameters)."""
        return torch.chunk(self(x), 2, dim=1)[0]


# -- the 3-D encoder and temporal discriminator ---------------------------------------

class BasicBlock3D(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, stride_t=1, has_downsample=False,
                 spectral=False, downsample_spectral=False):
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

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample_conv is not None:
            x = self.downsample_norm(self.downsample_conv(x))
        return F.relu(out + x)


class ResNet3DBackbone(nn.Module):
    """Stem and four stages of basic blocks (resnet10/18/34)."""

    def __init__(self, res_type: str, channels: Sequence[int], stride_s: Sequence[int],
                 stride_t: Sequence[int], use_max_pool: bool, stem_stride_t: int,
                 use_spectral_norm: bool = False, downsample_always_spectral: bool = False,
                 downsample_on_stride_t: bool = False):
        super().__init__()
        kind, layers = RESNET3D_LAYERS[res_type]
        if kind != "basic":
            raise ValueError("the reference's 3-D backbones are resnet10/18/34")
        self.use_max_pool = use_max_pool
        self.conv1 = SNConv(3, channels[0], (3, 7, 7), (stem_stride_t, 2, 2), (1, 3, 3),
                            bias=False)
        self.norm1 = GroupNorm(channels[0], 16)
        self.stages = []
        inplanes = channels[0]
        for stage, planes in enumerate(channels[1:]):
            stride, st = stride_s[stage], stride_t[stage]
            needs_ds = (stride != 1 or inplanes != planes
                        or (downsample_on_stride_t and st != 1))
            names = [f"layer{stage}_block{b}" for b in range(layers[stage])]
            self.add_module(names[0], BasicBlock3D(
                inplanes, planes, stride, st, needs_ds, spectral=use_spectral_norm,
                downsample_spectral=downsample_always_spectral))
            inplanes = planes
            for name in names[1:]:
                self.add_module(name, BasicBlock3D(inplanes, planes))
            self.stages.append(names)
        self.out_features = inplanes

    def forward(self, x):
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
    """Video (B, 3, T, H, W) -> (sample, mu, logvar), each (B, z_dim)."""

    def __init__(self, dic: dict):
        super().__init__()
        self.backbone = ResNet3DBackbone(dic["res_type_encoder"], dic["channels"],
                                         dic["stride_s"], dic["stride_t"],
                                         bool(dic["use_max_pool"]), stem_stride_t=2)
        self.conv_mu = SNConv(self.backbone.out_features, dic["z_dim"], (4, 4))
        self.conv_var = SNConv(self.backbone.out_features, dic["z_dim"], (4, 4))

    def moments(self, x):
        emb = self.backbone(x)[-1].squeeze(2)
        return (self.conv_mu(emb).reshape(emb.shape[0], -1),
                self.conv_var(emb).reshape(emb.shape[0], -1))

    def forward(self, x, noise: torch.Tensor):
        mu, logvar = self.moments(x)
        return noise * torch.exp(0.5 * logvar) + mu, mu, logvar


class Discriminator(nn.Module):
    """Temporal discriminator: video -> (logit (B, 1), the stages' features)."""

    def __init__(self, dic: dict):
        super().__init__()
        self.backbone = ResNet3DBackbone(
            dic["res_type_encoder"], dic["channels"], dic["stride_s"], dic["stride_t"],
            bool(dic["use_max_pool"]), stem_stride_t=1,
            use_spectral_norm=bool(dic["spectral_norm"]), downsample_always_spectral=True,
            downsample_on_stride_t=True)
        self.fc = SNDense(self.backbone.out_features, 1, bias=False)

    def forward(self, x):
        feats = self.backbone(x)
        h = feats[-1].unfold(3, 4, 1).unfold(4, 4, 1).mean((-2, -1))
        h = h.permute(0, 2, 3, 4, 1).reshape(h.shape[0], -1)
        return self.fc(h), feats
