"""The patch discriminator and LPIPS in plain float32 PyTorch (the port's
``models/stage1/patch_disc.py``, ``models/backbones/{lpips,vgg16}.py``,
frozen)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .nn import ActNormImage, BatchNorm, SNConv, leaky_relu, max_pool


class NLayerDiscriminator(nn.Module):
    def __init__(self, dic: dict):
        super().__init__()
        ndf, n_layers, sn = dic["ndf"], dic["n_layers"], bool(dic["spectral_norm"])
        use_actnorm = bool(dic["use_actnorm"])
        norm = ActNormImage if use_actnorm else BatchNorm
        self.n_layers = n_layers
        self.conv0 = SNConv(dic["in_channels"], ndf, (4, 4), 2, 1, spectral=sn)
        n_in = ndf
        for n in range(1, n_layers):
            n_out = ndf * min(2 ** n, 8)
            self.add_module(f"conv{n}", SNConv(n_in, n_out, (4, 4), 2, 1, bias=use_actnorm,
                                               spectral=sn))
            self.add_module(f"norm{n}", norm(n_out))
            n_in = n_out
        n_out = ndf * min(2 ** n_layers, 8)
        self.add_module(f"conv{n_layers}", SNConv(n_in, n_out, (4, 4), 1, 1, bias=use_actnorm,
                                                  spectral=sn))
        self.add_module(f"norm{n_layers}", norm(n_out))
        self.conv_out = SNConv(n_out, 1, (4, 4), 1, 1, spectral=sn)

    def forward(self, x):
        h = leaky_relu(self.conv0(x), 0.2)
        for n in range(1, self.n_layers + 1):
            h = leaky_relu(getattr(self, f"norm{n}")(getattr(self, f"conv{n}")(h)), 0.2)
        return self.conv_out(h)


VGG_STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    def __init__(self):
        super().__init__()
        c, idx = 3, 0
        for n_convs, ch in VGG_STAGES:
            for _ in range(n_convs):
                self.add_module(f"conv{idx}", SNConv(c, ch, (3, 3), padding=1))
                c, idx = ch, idx + 1

    def forward(self, x):
        outs, idx = [], 0
        for stage, (n_convs, _) in enumerate(VGG_STAGES):
            if stage > 0:
                x = max_pool(x, 2, 2, 0)
            for _ in range(n_convs):
                x = F.relu(getattr(self, f"conv{idx}")(x))
                idx += 1
            outs.append(x)
        return outs


class LPIPS(nn.Module):
    """(B, 3, H, W) pairs in [-1, 1] -> (B,) distances."""

    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(LPIPS_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(LPIPS_SCALE).view(1, 3, 1, 1),
                             persistent=False)
        self.net = VGG16Features()
        for k, (_, ch) in enumerate(VGG_STAGES):
            self.add_module(f"lin{k}", SNConv(ch, 1, (1, 1), bias=False))

    def forward(self, input, target):
        outs0 = self.net((input - self.shift) / self.scale)
        outs1 = self.net((target - self.shift) / self.scale)
        val = 0.0
        for k in range(len(VGG_STAGES)):
            a = outs0[k] / (outs0[k].square().sum(1, keepdim=True).sqrt() + 1e-10)
            b = outs1[k] / (outs1[k].square().sum(1, keepdim=True).sqrt() + 1e-10)
            val = val + getattr(self, f"lin{k}")((a - b).square()).mean(dim=(2, 3))
        return val[:, 0]
