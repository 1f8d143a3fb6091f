"""The stage-1 VAE-GAN training step in plain float32 PyTorch: the train
augment, the VAE forward, both discriminators with the gradient penalty,
LPIPS, the backward, three Adam updates and the spectral refreshes (the
port's ``data/augment.py``, ``train/stage1_step.py``, ``losses/common.py``
and ``train/optim.py``, frozen, one process, fp32).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .decoder import Generator
from .discriminators import LPIPS, NLayerDiscriminator
from .nn import power_iteration_, resize_bilinear
from .resnet import Discriminator, Encoder

N_PATCH = 20
COLOUR_OPS = ("brightness", "contrast", "saturation", "hue")


# -- the train augment (no random crop) -------------------------------------------

def _grayscale(x):
    return 0.299 * x[..., 0:1] + 0.587 * x[..., 1:2] + 0.114 * x[..., 2:3]


def _frame_mean(g: torch.Tensor) -> torch.Tensor:
    """Each frame's mean, summed exactly in 40-bit fixed point."""
    scale = 2.0 ** 40
    total = torch.round(g.double() * scale).long().sum(dim=(-3, -2, -1), keepdim=True)
    n = g.shape[-3] * g.shape[-2] * g.shape[-1]
    return (total.double() / (n * scale)).to(g.dtype)


_ADJUST = {
    "brightness": lambda x, f: torch.clamp(x * f, 0.0, 1.0),
    "contrast": lambda x, f: torch.clamp(f * x + (1 - f) * _frame_mean(_grayscale(x)), 0.0, 1.0),
    "saturation": lambda x, f: torch.clamp(f * x + (1 - f) * _grayscale(x), 0.0, 1.0),
}


def augment(batch_u8: torch.Tensor, img_size: int, params: dict, draws: dict) -> torch.Tensor:
    """uint8 (B, T, H, W, 3) -> float32 in [-1, 1]: resize, flip per clip,
    the enabled colour ops in each clip's drawn order. Hue is not taken (the
    configurations set it to 0)."""
    ops = tuple(o for o in COLOUR_OPS if params.get(o, 0.0))
    if "hue" in ops:
        raise ValueError("the reference augment takes no hue shift")
    x = batch_u8.float() / 255.0
    if x.shape[2] != img_size:
        x = resize_bilinear(x.permute(0, 1, 4, 2, 3), (img_size, img_size)).permute(0, 1, 3, 4, 2)
    flip = draws["flip"].to(x.device).view(-1, 1, 1, 1, 1)
    x = torch.where(flip, x.flip(3), x)
    factors = draws["factors"].to(x.device, torch.float32).view(x.shape[0], len(ops), 1, 1, 1, 1)
    order = draws["order"].to(x.device).view(x.shape[0], len(ops), 1, 1, 1, 1)
    for k in range(len(ops)):
        out = x
        for j, name in enumerate(ops):
            out = torch.where(order[:, k] == j, _ADJUST[name](x, factors[:, j]), out)
        x = out
    return (x - 0.5) / 0.5


# -- losses ---------------------------------------------------------------------------

def hinge_disc(fake, real):
    return (torch.mean(F.relu(1.0 - real)) + torch.mean(F.relu(1.0 + fake))) / 2.0


def KL(mu, logvar):
    return -0.5 * torch.mean(torch.sum(1.0 + logvar - mu.square() - logvar.exp(), dim=1))


def flat_frames(video):
    b, c, t, h, w = video.shape
    return video.transpose(1, 2).reshape(b * t, c, h, w)


# -- Adam (optax's adam_torch: coupled L2, bias-corrected, float32) ----------------

class Adam:
    def __init__(self, params, lr: float, betas=(0.5, 0.9), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps, self.wd = lr, betas[0], betas[1], eps, weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads):
        self.count += 1
        c = np.float32(self.count)
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** c)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** c)
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = g + self.wd * p if self.wd else g
            mu.mul_(self.b1).add_(g * (1.0 - self.b1))
            nu.mul_(self.b2).add_(g * g * (1.0 - self.b2))
            p.add_(-self.lr * (mu / bc1) / ((nu / bc2).sqrt() + self.eps))


def grads_of(loss, params):
    gs = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, gs)]


# -- the step -----------------------------------------------------------------------

@dataclass
class Models:
    decoder: Generator
    encoder: Encoder
    disc_t: Discriminator
    disc_s: NLayerDiscriminator
    lpips: LPIPS

    @classmethod
    def from_config(cls, cfg: dict) -> "Models":
        return cls(Generator.from_config(cfg["Decoder"], trainable=True),
                   Encoder(cfg["Encoder"]), Discriminator(cfg["Discriminator_Temporal"]),
                   NLayerDiscriminator(cfg["Discriminator_Patch"]), LPIPS())

    def named(self) -> dict[str, nn.Module]:
        return {"decoder": self.decoder, "encoder": self.encoder, "disc_t": self.disc_t,
                "disc_s": self.disc_s, "lpips": self.lpips}


class Step:
    """The port's ``Stage1Step`` in fp32 with the gates open or closed by
    ``epoch >= pretrain``; ``__call__`` returns the step's losses."""

    def __init__(self, models: Models, tr: dict):
        self.m = models
        self.tr = tr
        lr, wd = float(tr["lr"]), float(tr["weight_decay"])
        self.ae_params = [*models.decoder.parameters(), *models.encoder.parameters()]
        self.opt_ae = Adam(self.ae_params, lr, weight_decay=wd)
        self.opt_dt = Adam(models.disc_t.parameters(), lr, weight_decay=wd)
        self.opt_ds = Adam(models.disc_s.parameters(), lr, weight_decay=wd)

    def optimizers(self) -> dict[str, Adam]:
        return {"ae": self.opt_ae, "disc_t": self.opt_dt, "disc_s": self.opt_ds}

    def __call__(self, seq: torch.Tensor, epoch: int, eps: torch.Tensor, start: int,
                 patches: torch.Tensor) -> dict[str, float]:
        m, tr = self.m, self.tr
        gate = epoch >= int(tr["pretrain"])
        sub = int(tr["subsample_length"])
        w_gp = float(tr["w_GP"])
        video = seq.permute(0, 4, 1, 2, 3)
        orig = video[:, :, 1:]
        motion, mu, logvar = m.encoder(orig, eps.to(seq.device))
        gen = m.decoder(video[:, :, 0], motion)
        gen_d = gen.detach()

        def subsample(g, o):
            return (g[:, :, start:start + sub], o[:, :, start:start + sub]) if g.shape[2] >= 16 \
                else (g, o)

        idx = patches.to(seq.device)
        fake_t, real_t = subsample(gen_d, orig)
        fake_s, real_s = flat_frames(gen_d)[idx], flat_frames(orig)[idx]

        real = real_t.detach().requires_grad_(bool(w_gp))
        pred_fake, _ = m.disc_t(fake_t)
        pred_real, _ = m.disc_t(real)
        l_dt = hinge_disc(pred_fake, pred_real)
        if w_gp:
            (gx,) = torch.autograd.grad(pred_real.mean(), real, create_graph=gate)
            gp = gx.square().reshape(real.shape[0], -1).sum(1).mean()
        else:
            gp = torch.zeros((), device=seq.device)
        if gate:
            self.opt_dt.step(grads_of(l_dt + w_gp * gp, self.opt_dt.params))
        l_ds = hinge_disc(m.disc_s(fake_s), m.disc_s(real_s))
        if gate:
            self.opt_ds.step(grads_of(l_ds, self.opt_ds.params))
        power_iteration_(m.disc_t)
        power_iteration_(m.disc_s)

        fake_t, real_t = subsample(gen, orig)
        loss_gen_s = -torch.mean(m.disc_s(flat_frames(gen)[idx]))
        pred_fake_t, fmap_f = m.disc_t(fake_t)
        with torch.no_grad():
            _, fmap_r = m.disc_t(real_t)
        coup_t = -torch.mean(pred_fake_t)
        l_fmap = sum(torch.mean(torch.abs(a - b)) for a, b in zip(fmap_f, fmap_r)) / len(fmap_f)
        lp = m.lpips(flat_frames(orig), flat_frames(gen)).mean()
        l_recon = torch.mean(torch.abs(gen - orig))
        l_kl = KL(mu, logvar)
        total = (float(gate) * (loss_gen_s + float(tr["w_coup_t"]) * coup_t
                                + float(tr["w_fmap_t"]) * l_fmap)
                 + float(tr["w_percep"]) * lp + float(tr["w_kl"]) * l_kl
                 + float(tr["w_recon"]) * l_recon)
        self.opt_ae.step(grads_of(total, self.ae_params))
        power_iteration_(m.decoder)
        out = {"Loss_VAE": total, "Loss_Disc_T": l_dt, "L_GP": gp, "Loss_Disc_S": l_ds,
               "LPIPS": lp, "Loss_L1": l_recon}
        return {k: float(v.detach()) for k, v in out.items()}
