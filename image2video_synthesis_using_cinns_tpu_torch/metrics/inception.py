"""FID InceptionV3 (pool3, 2048-d) (port of ``metrics/inception.py``),
channels-first.

The pytorch-fid trunk: InceptionA/C and the first InceptionE pool with an
average that divides by the taps inside the image (``count_include_pad=
False``); the second InceptionE max-pools in its pool branch; max pools pad
with -inf. ``BasicConv2d`` = conv without bias, frozen BN (eps 1e-3), relu.
Input: frames (B, 3, H, W) in [-1, 1], resized to 299 by the half-pixel
bilinear resize of ``ops/resize.py`` (at 64 and 128 px an upsample, so its
antialiasing plays no part). Output: the final average pool, (B, 2048).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.layers import SNConv
from ..ops.resize import resize_bilinear


def _avg_pool_excl_pad(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def _max_pool(x: torch.Tensor, window: int = 3, stride: int = 2, pad: int = 0) -> torch.Tensor:
    return F.max_pool2d(x, window, stride, pad)


class BasicConv2d(nn.Module):
    def __init__(self, in_features: int, features: int, kernel=(3, 3), stride=(1, 1),
                 padding=(0, 0)):
        super().__init__()
        self.conv = SNConv(in_features, features, kernel, stride, padding, bias=False)
        self.register_buffer("bn_mean", torch.zeros(features))
        self.register_buffer("bn_var", torch.ones(features))
        self.register_buffer("bn_scale", torch.ones(features))
        self.register_buffer("bn_bias", torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        c = (1, -1, 1, 1)
        x = ((x - self.bn_mean.view(c)) * torch.rsqrt(self.bn_var + 1e-3).view(c)
             * self.bn_scale.view(c) + self.bn_bias.view(c))
        return F.relu(x)


class InceptionA(nn.Module):
    def __init__(self, c_in: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 64, (1, 1))
        self.branch5x5_1 = BasicConv2d(c_in, 48, (1, 1))
        self.branch5x5_2 = BasicConv2d(48, 64, (5, 5), padding=(2, 2))
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), padding=(1, 1))
        self.branch_pool = BasicConv2d(c_in, pool_features, (1, 1))
        self.out_features = 64 + 64 + 96 + pool_features

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_excl_pad(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(c_in, 384, (3, 3), stride=(2, 2))
        self.branch3x3dbl_1 = BasicConv2d(c_in, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), stride=(2, 2))
        self.out_features = 384 + 96 + c_in

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, c_in: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(c_in, 192, (1, 1))
        self.branch7x7_1 = BasicConv2d(c_in, c7, (1, 1))
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(c_in, c7, (1, 1))
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(c_in, 192, (1, 1))
        self.out_features = 4 * 192

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for k in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{k}")(bd)
        bp = self.branch_pool(_avg_pool_excl_pad(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, c_in: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(c_in, 192, (1, 1))
        self.branch3x3_2 = BasicConv2d(192, 320, (3, 3), stride=(2, 2))
        self.branch7x7x3_1 = BasicConv2d(c_in, 192, (1, 1))
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, (3, 3), stride=(2, 2))
        self.out_features = 320 + 192 + c_in

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_1(x)
        for k in range(2, 5):
            b7 = getattr(self, f"branch7x7x3_{k}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], dim=1)


class InceptionE(nn.Module):
    def __init__(self, c_in: int, pool_kind: str):  # 'avg_excl' (FID E1) | 'max' (FID E2)
        super().__init__()
        self.pool_kind = pool_kind
        self.branch1x1 = BasicConv2d(c_in, 320, (1, 1))
        self.branch3x3_1 = BasicConv2d(c_in, 384, (1, 1))
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(c_in, 448, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(448, 384, (3, 3), padding=(1, 1))
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(c_in, 192, (1, 1))
        self.out_features = 320 + 768 + 768 + 192

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        bp = _max_pool(x, 3, 1, 1) if self.pool_kind == "max" else _avg_pool_excl_pad(x)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], dim=1)


class InceptionV3FID(nn.Module):
    def __init__(self, resize_input: bool = True):
        super().__init__()
        self.resize_input = resize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), stride=(2, 2))
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), padding=(1, 1))
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3))
        blocks = [("Mixed_5b", lambda c: InceptionA(c, 32)), ("Mixed_5c", lambda c: InceptionA(c, 64)),
                  ("Mixed_5d", lambda c: InceptionA(c, 64)), ("Mixed_6a", InceptionB),
                  ("Mixed_6b", lambda c: InceptionC(c, 128)),
                  ("Mixed_6c", lambda c: InceptionC(c, 160)),
                  ("Mixed_6d", lambda c: InceptionC(c, 160)),
                  ("Mixed_6e", lambda c: InceptionC(c, 192)), ("Mixed_7a", InceptionD),
                  ("Mixed_7b", lambda c: InceptionE(c, "avg_excl")),
                  ("Mixed_7c", lambda c: InceptionE(c, "max"))]
        c = 192
        self._mixed = []
        for name, make in blocks:
            block = make(c)
            self.add_module(name, block)
            self._mixed.append(name)
            c = block.out_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, H, W) in [-1, 1] -> 2048-d pool3 activations."""
        if self.resize_input:
            x = resize_bilinear(x, (299, 299))
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = _max_pool(x)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = _max_pool(x)
        for name in self._mixed:
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # adaptive average pool -> (B, 2048)
