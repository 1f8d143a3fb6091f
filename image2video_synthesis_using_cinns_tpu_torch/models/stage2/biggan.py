"""BigGAN-style conditional image decoder of the stage-2 conditioning AE (port
of ``models/stage2/biggan.py``), channels-first.

* ``ClassUp``: z -> softmax class embedding through three plain dense layers
  with LeakyReLU(0.01) and a fourth to 1000 classes.
* ``ConditionalNorm2d``: BatchNorm without affine (eps 1e-4) or ActNorm, then
  ``(gamma + 1) * x + beta`` from two BigGAN-mode spectral dense embeddings
  of the condition.
* ``SelfAttention``: 1x1 BigGAN-mode convs, phi and g max-pooled 2x2, a
  learned ``gamma`` that starts at 0. It runs before block ``sa_id = 4``, so
  only the 128 px generator (5 blocks) builds and runs it.
* ``GBlock``: residual block with nearest x2 upsampling, conditioned through
  two ``ConditionalNorm2d``.
* ``VariableDimGenerator``: z split into (z - 40, 10 x 4) at 64 px or (z -
  100, 20 x 5) at 128 px; each block sees its chunk beside the 128-wide
  class embedding (138 or 148 wide: the reference's ``code_dim`` quirk,
  ``models/stage2/biggan.py:176-180``). ``G_linear``'s output is viewed as
  (B, 4, 4, 16 chn), then made channels-first, as the reference's torch
  generator does. ``features`` ends at the final norm and ReLU; ``to_rgb``
  is the JAX module's ``colorize`` method (tanh of the ``colorize`` conv,
  which keeps the JAX name so the weight bridge maps it one to one).
* ``BigGANDecoderWrapper`` and ``BigAE`` (the ResNet encoder and this
  decoder), with ``encode``/``decode``/``decode_features``/``colorize``.

Every BigGAN spectral layer recomputes sigma from its stored vectors on each
forward (``sn_mode="biggan"``, ``models/layers.py``). ``train=True`` takes
the BatchNorm statistics from the batch; the running ones move only inside
``layers.updating_batch_stats``. ``chn`` comes from the AE config (96 by
default; 8 is the reference's debug width).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import ActNormImage, BatchNorm, SNConv, SNDense
from .distributions import DiagonalGaussianDistribution
from .resnet2d import ResnetEncoder

_BIGGAN = dict(spectral=True, sn_mode="biggan")
CLASS_EMB = 128


class ClassUp(nn.Module):
    def __init__(self, dim: int, depth: int = 2, hidden_dim: int = 2000, out_dim: int = 1000):
        super().__init__()
        self.depth = depth
        widths = [dim] + [hidden_dim] * (depth + 1) + [out_dim]
        for i in range(depth + 2):
            self.add_module(f"l{i}", SNDense(widths[i], widths[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.depth + 1):
            h = F.leaky_relu(getattr(self, f"l{i}")(h), 0.01)
        return torch.softmax(getattr(self, f"l{self.depth + 1}")(h), dim=1)


class ConditionalNorm2d(nn.Module):
    def __init__(self, num_features: int, cond_dim: int, use_actnorm: bool = False):
        super().__init__()
        self.use_actnorm = use_actnorm
        self.bn = (ActNormImage(num_features) if use_actnorm
                   else BatchNorm(num_features, eps=1e-4, affine=False))
        self.gamma_embed = SNDense(cond_dim, num_features, bias=False, **_BIGGAN)
        self.beta_embed = SNDense(cond_dim, num_features, bias=False, **_BIGGAN)

    def forward(self, x: torch.Tensor, cond: torch.Tensor, train: bool = False) -> torch.Tensor:
        out = self.bn(x) if self.use_actnorm else self.bn(x, train)
        gamma = self.gamma_embed(cond) + 1.0
        beta = self.beta_embed(cond)
        return gamma[:, :, None, None] * out + beta[:, :, None, None]


class SelfAttention(nn.Module):
    def __init__(self, in_dim: int):
        super().__init__()
        c = in_dim
        self.theta = SNConv(c, c // 8, (1, 1), bias=False, **_BIGGAN)
        self.phi = SNConv(c, c // 8, (1, 1), bias=False, **_BIGGAN)
        self.g = SNConv(c, c // 2, (1, 1), bias=False, **_BIGGAN)
        self.o_conv = SNConv(c // 2, c, (1, 1), bias=False, **_BIGGAN)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        theta = self.theta(x).flatten(2).transpose(1, 2)  # (b, n, c/8), n row-major
        phi = F.max_pool2d(self.phi(x), 2, 2).flatten(2)  # (b, c/8, n/4)
        g = F.max_pool2d(self.g(x), 2, 2).flatten(2).transpose(1, 2)  # (b, n/4, c/2)
        attn = torch.softmax(theta @ phi, dim=-1)  # (b, n, n/4)
        attn_g = (attn @ g).transpose(1, 2).reshape(b, c // 2, h, w)
        return self.gamma * self.o_conv(attn_g) + x


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 upsampling of (B, C, H, W) (``jnp.repeat`` on both axes)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class GBlock(nn.Module):
    def __init__(self, in_channel: int, out_channel: int, cond_dim: int, upsample: bool = True,
                 use_actnorm: bool = False):
        super().__init__()
        self.upsample = upsample
        self.HyperBN = ConditionalNorm2d(in_channel, cond_dim, use_actnorm)
        self.conv0 = SNConv(in_channel, out_channel, (3, 3), padding=1, **_BIGGAN)
        self.HyperBN_1 = ConditionalNorm2d(out_channel, cond_dim, use_actnorm)
        self.conv1 = SNConv(out_channel, out_channel, (3, 3), padding=1, **_BIGGAN)
        self.conv_sc = SNConv(in_channel, out_channel, (1, 1), **_BIGGAN)

    def forward(self, x: torch.Tensor, condition: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        out = F.relu(self.HyperBN(x, condition, train))
        if self.upsample:
            out = _up2(out)
        out = self.conv0(out)
        out = F.relu(self.HyperBN_1(out, condition, train))
        out = self.conv1(out)
        skip = _up2(x) if self.upsample else x
        return out + self.conv_sc(skip)


class VariableDimGenerator(nn.Module):
    """BigGAN generator with the variable-width latent split (64 or 128 px)."""

    sa_id = 4

    def __init__(self, size: int, z_dim: int, chn: int = 96, n_class: int = 1000,
                 use_actnorm: bool = False):
        super().__init__()
        if size not in (64, 128):
            raise ValueError(f"the BigGAN decoder is built for 64 or 128 px, not {size}")
        self.size, self.chn, self.use_actnorm = size, chn, use_actnorm
        c = chn
        mults = [(16, 16), (16, 8), (8, 4), (4, 1)] if size == 64 else \
            [(16, 16), (16, 8), (8, 4), (4, 2), (2, 1)]
        self.block_channels = [(a * c, b * c) for a, b in mults]
        per = 10 if size == 64 else 20
        first = z_dim - len(mults) * per
        if first <= 0:
            raise ValueError(f"z_dim {z_dim} too small for size {size}")
        self.split = [first] + [per] * len(mults)
        cond_dim = per + CLASS_EMB
        self.linear = SNDense(n_class, CLASS_EMB, bias=False)
        self.G_linear = SNDense(first, 4 * 4 * 16 * c, **_BIGGAN)
        for i, (cin, cout) in enumerate(self.block_channels):
            self.add_module(f"GBlock_{i}", GBlock(cin, cout, cond_dim, use_actnorm=use_actnorm))
        if self.sa_id < len(self.block_channels):
            self.attention = SelfAttention(self.block_channels[self.sa_id][0])
        self.ScaledCrossReplicaBN = (ActNormImage(c) if use_actnorm
                                     else BatchNorm(c, eps=1e-4))
        self.colorize = SNConv(c, 3, (3, 3), padding=1, **_BIGGAN)

    def features(self, z: torch.Tensor, class_emb_input: torch.Tensor,
                 train: bool = False) -> torch.Tensor:
        codes = torch.split(z, self.split, dim=1)
        class_emb = self.linear(class_emb_input)
        out = self.G_linear(codes[0]).view(-1, 4, 4, 16 * self.chn).permute(0, 3, 1, 2)
        for i in range(len(self.block_channels)):
            if i == self.sa_id:
                out = self.attention(out)
            condition = torch.cat([codes[i + 1], class_emb], dim=1)
            out = getattr(self, f"GBlock_{i}")(out, condition, train)
        norm = self.ScaledCrossReplicaBN
        return F.relu(norm(out) if self.use_actnorm else norm(out, train))

    def to_rgb(self, h: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.colorize(h))

    def forward(self, z: torch.Tensor, class_emb_input: torch.Tensor,
                train: bool = False) -> torch.Tensor:
        return self.to_rgb(self.features(z, class_emb_input, train))


class BigGANDecoderWrapper(nn.Module):
    """ClassUp(z) -> softmax class embedding -> BigGAN generator."""

    def __init__(self, z_dim: int, image_size: int = 64, use_actnorm: bool = False,
                 chn: int = 96):
        super().__init__()
        self.map_to_class_embedding = ClassUp(z_dim, depth=2, hidden_dim=2000)
        self.decoder = VariableDimGenerator(image_size, z_dim, chn=chn, use_actnorm=use_actnorm)

    def forward(self, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.decoder(z, self.map_to_class_embedding(z), train)

    def features(self, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.decoder.features(z, self.map_to_class_embedding(z), train)

    def colorize(self, h: torch.Tensor) -> torch.Tensor:
        return self.decoder.to_rgb(h)


class BigAE(nn.Module):
    """ResNet encoder + BigGAN decoder VAE. Images are (B, 3, H, W) in [-1, 1]."""

    def __init__(self, config):
        super().__init__()
        self.encoder = ResnetEncoder.from_config(config)
        self.decoder_wrap = BigGANDecoderWrapper(
            z_dim=config["z_dim"], image_size=config["in_size"],
            use_actnorm=bool(config.get("use_actnorm_in_dec", False)),
            chn=int(config.get("chn", 96)))

    @property
    def colorize_weight(self) -> nn.Parameter:
        """The raw weight of the decoder's last conv (the adaptive weight's leaf)."""
        return self.decoder_wrap.decoder.colorize.weight

    def encode(self, x: torch.Tensor, train: bool = False) -> DiagonalGaussianDistribution:
        return self.encoder.encode(x, train)

    def decode(self, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.decoder_wrap(z, train)

    def decode_features(self, z: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.decoder_wrap.features(z, train)

    def colorize(self, h: torch.Tensor) -> torch.Tensor:
        return self.decoder_wrap.colorize(h)

    def forward(self, x: torch.Tensor, train: bool = False):
        p = self.encode(x, train)
        mode = p.mode()
        return self.decode(mode, train), mode, p
