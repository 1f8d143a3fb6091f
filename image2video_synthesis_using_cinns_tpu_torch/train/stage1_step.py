"""The stage-1 VAE-GAN training step and its eval step (port of
``train/stage1_step.py``: ``_build_phases`` and ``make_stage1_eval_step``).

One step, in this order:

1. The VAE forward, once, with gradient: the encoder's posterior sample of
   frames 1: with the given eps (drawn in fp32), then the decoder from frame
   0 and that motion. The discriminators see it detached. They update first,
   so the decoder's parameters are the same in both phases, and this one
   forward equals the JAX package's two forwards with one ``k_sample``.
   PSNR and SSIM are taken on the detached frames.
2. With 16 frames or more, a subsample of ``subsample_length`` from one start
   (the same for fake and real); 20 frame indices, drawn with replacement
   over the B * (T - 1) flattened frames, for the patch discriminator. The
   VAE phase reuses both draws.
3. The temporal discriminator: the hinge loss plus ``w_GP`` times the
   gradient penalty, the batch mean of sum((d mean(logit(real)) / d real)^2),
   a second-order term (``autograd.grad(..., create_graph=True)``); one
   forward of the real clips serves both.
4. The patch discriminator: the hinge loss on the 20 frames.
5. The gate ``epoch >= pretrain``. While it is closed the discriminators'
   parameters and their optimizer state stay as they were (no ``Adam``
   step, so its count does not move); their losses are still computed.
6. One power iteration of both discriminators' spectral norm, gated or not.
7. The VAE loss against the updated discriminators: gate * (gen_S +
   w_coup_t * gen_T + w_fmap_t * L1 feature matching, the real features a
   constant) + w_percep * LPIPS(orig, gen) over all B * (T - 1) frames +
   w_kl * KL + w_recon * L1; one ``Adam`` over the decoder's and the
   encoder's parameters together.
8. One power iteration of the decoder's spectral norm.

``Training.compute_dtype: bfloat16`` runs the forwards of the encoder, the
decoder, both discriminators and LPIPS on bf16 casts of their fp32
parameters, buffers and inputs (``torch.func.functional_call``), with the
outputs cast back to fp32, as ``_mixed_precision_apply`` does; losses,
gradients, the refreshes and the optimizer state stay fp32. The eval step
runs in fp32. Videos are (B, T, H, W, 3) at the boundary, as the augment
gives them, and (B, 3, T, H, W) inside. The spans (``stage1/...``) name the
phases for a profiler's trace.

In a multi-process run (``parallel/distributed.py``) a rank holds its rows of
the global batch and the step computes what the JAX package's global step
does: the patch indices are into the global batch's frames, and each rank
gathers the 20 frames (``distributed.gather_rows``), so the patch
discriminator's loss is the same on every rank and its gradient reaches the
frames' owners; the gradient penalty differentiates the global batch's mean
logit (this rank's sum over the global count), so the per-clip gradients
keep their scale; PSNR and SSIM take the global data range (and PSNR the
global MSE); ``Adam`` averages the gradients.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
from torch.func import functional_call
from torch.profiler import record_function

from ..losses.common import KL, fmap_loss, hinge_loss, psnr, ssim
from ..models.layers import power_iteration_
from ..parallel import distributed
from .optim import Adam

N_PATCH = 20


@dataclass
class Stage1Models:
    """The four trained networks and the frozen LPIPS."""

    decoder: nn.Module
    encoder: nn.Module
    disc_t: nn.Module
    disc_s: nn.Module
    lpips: nn.Module

    def to(self, device) -> "Stage1Models":
        for m in (self.decoder, self.encoder, self.disc_t, self.disc_s, self.lpips):
            m.to(device)
        return self


@dataclass
class StepDraws:
    """The random draws of one step: the encoder's eps (B, z), fp32; the
    subsample's start (used at 16 frames or more); the patch frames' indices
    (20,) into the flattened frames."""

    eps: torch.Tensor
    start: int
    patches: torch.Tensor


def flat_frames(video: torch.Tensor) -> torch.Tensor:
    """(B, C, T, H, W) -> (B * T, C, H, W), clip-major as the JAX package's."""
    b, c, t, h, w = video.shape
    return video.transpose(1, 2).reshape(b * t, c, h, w)


def quality(gen: torch.Tensor, orig: torch.Tensor) -> dict:
    """PSNR and SSIM of the generated frames against the real ones,
    (B, C, T, H, W) each, over the global batch."""
    fg, fo = flat_frames(gen), flat_frames(orig)
    if distributed.world() == 1:
        return {"PSNR": psnr(fg, fo), "SSIM": ssim(fg, fo)}
    data_range = distributed.all_reduce_max(fo.max()) + distributed.all_reduce_max(-fo.min())
    mse = distributed.all_reduce_sum(torch.mean(torch.square(fg - fo))) / distributed.world()
    return {"PSNR": 10.0 * torch.log10(data_range ** 2 / mse),
            "SSIM": ssim(fg, fo, data_range=data_range)}


def _cast(x, dtype):
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.to(dtype)
    if isinstance(x, (list, tuple)):
        return type(x)(_cast(v, dtype) for v in x)
    return x


def _back(x, dtype):
    if isinstance(x, torch.Tensor) and x.dtype == dtype:
        return x.float()
    if isinstance(x, (list, tuple)):
        return type(x)(_back(v, dtype) for v in x)
    return x


def apply(module: nn.Module, dtype: torch.dtype | None, *args, **kwargs):
    """``module(*args, **kwargs)``, or with ``dtype`` on casts of its fp32
    parameters, buffers and positional inputs, the outputs cast back to
    fp32; gradients reach the fp32 parameters through the casts."""
    if dtype is None:
        return module(*args, **kwargs)
    state = {n: _cast(t, dtype) for n, t in (*module.named_parameters(),
                                             *module.named_buffers())}
    return _back(functional_call(module, state, _cast(args, dtype), kwargs), dtype)


def _ae_params(models: Stage1Models) -> list[nn.Parameter]:
    return [*models.decoder.parameters(), *models.encoder.parameters()]


def ae_names(models: Stage1Models) -> list[str]:
    """Names of the autoencoder optimizer's parameters in its order: the
    decoder's under ``0.`` and the encoder's under ``1.`` (optax's tuple
    ``(dec_params, enc_params)``)."""
    return ([f"0.{n}" for n, _ in models.decoder.named_parameters()]
            + [f"1.{n}" for n, _ in models.encoder.named_parameters()])


def make_optimizers(models: Stage1Models, lr: float, weight_decay: float,
                    eps: float = 1e-8) -> tuple[Adam, ...]:
    """The JAX trainer's three ``adam_torch(lr, betas=(0.5, 0.9), weight_decay)``:
    the decoder and the encoder together, the temporal and the patch
    discriminator."""
    def mk(params):
        return Adam(params, lr, betas=(0.5, 0.9), eps=eps, weight_decay=weight_decay)

    return (mk(_ae_params(models)), mk(list(models.disc_t.parameters())),
            mk(list(models.disc_s.parameters())))


def backward_into(loss: torch.Tensor, params: list[nn.Parameter]) -> None:
    """Set each parameter's ``.grad`` to d loss / d p (zeros where it does not
    reach, as the JAX gradient gives)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g


class Stage1Step:
    """The step over ``models`` with ``optimizers`` (``make_optimizers``) and
    the ``Training`` section's weights; ``step(seq, epoch, draws)`` returns
    the ``TRAIN_KEYS`` metrics (0-d tensors) and the generated clips,
    detached, (B, T - 1, 3, H, W)."""

    def __init__(self, models: Stage1Models, optimizers: tuple[Adam, Adam, Adam], opt_cfg):
        self.models = models
        self.opt_ae, self.opt_dt, self.opt_ds = optimizers
        self.w_kl = float(opt_cfg["w_kl"])
        self.w_coup_t = float(opt_cfg["w_coup_t"])
        self.w_fmap_t = float(opt_cfg["w_fmap_t"])
        self.w_recon = float(opt_cfg["w_recon"])
        self.w_GP = float(opt_cfg["w_GP"])
        self.w_percep = float(opt_cfg["w_percep"])
        self.pretrain = int(opt_cfg["pretrain"])
        self.sub_len = int(opt_cfg["subsample_length"])
        bf16 = str(opt_cfg.get("compute_dtype", "float32")) in ("bfloat16", "bf16")
        self.dtype = torch.bfloat16 if bf16 else None

    # -- the phases, each usable alone -----------------------------------------
    def forward_vae(self, seq: torch.Tensor, eps: torch.Tensor) -> dict:
        """seq (B, T, H, W, 3) -> the clips channels-first, frames 1:, the
        generated frames (with gradient), mu and logvar."""
        m, dt = self.models, self.dtype
        video = seq.permute(0, 4, 1, 2, 3)
        orig = video[:, :, 1:]
        motion, mu, logvar = apply(m.encoder, dt, orig, noise=eps.to(seq.device))
        gen = apply(m.decoder, dt, video[:, :, 0], motion)
        return {"orig": orig, "gen": gen, "mu": mu, "logvar": logvar}

    def subsample(self, gen: torch.Tensor, orig: torch.Tensor, start: int):
        if gen.shape[2] >= 16:
            return (gen[:, :, start:start + self.sub_len], orig[:, :, start:start + self.sub_len])
        return gen, orig

    @staticmethod
    def patch_frames(gen: torch.Tensor, orig: torch.Tensor, idx: torch.Tensor):
        """The frames ``idx`` of the global batch's flattened frames, whole on
        every rank (``distributed.gather_rows``)."""
        fg, fo = flat_frames(gen), flat_frames(orig)
        offset = distributed.rank() * fg.shape[0]  # every rank holds as many frames
        return (distributed.gather_rows(fg, idx, offset),
                distributed.gather_rows(fo, idx, offset))

    def disc_t_loss(self, fake: torch.Tensor, real: torch.Tensor, create_graph: bool):
        """The temporal discriminator's hinge loss plus w_GP times the
        gradient penalty: (total, metrics)."""
        real = real.detach().requires_grad_(bool(self.w_GP))
        pred_fake, _ = apply(self.models.disc_t, self.dtype, fake)
        pred_real, _ = apply(self.models.disc_t, self.dtype, real)
        l_d = hinge_loss(pred_fake, pred_real, "disc")
        if self.w_GP:
            # d mean(logits) / d real over the global batch: the rank's sum over the global count
            mean_logit = pred_real.sum() / (pred_real.numel() * distributed.world())
            (grad_x,) = torch.autograd.grad(mean_logit, real, create_graph=create_graph)
            gp = grad_x.square().reshape(real.shape[0], -1).sum(1).mean()
        else:
            gp = torch.zeros((), device=real.device)
        metrics = {"Loss_Disc_T": l_d, "L_GP": gp, "Logits_Real_T": pred_real.mean(),
                   "Logits_Fake_T": pred_fake.mean()}
        return l_d + self.w_GP * gp, metrics

    def disc_s_loss(self, fake: torch.Tensor, real: torch.Tensor):
        pred_fake = apply(self.models.disc_s, self.dtype, fake)
        pred_real = apply(self.models.disc_s, self.dtype, real)
        l_d = hinge_loss(pred_fake, pred_real, "disc")
        return l_d, {"Loss_Disc_S": l_d, "Logits_Real_S": pred_real.mean(),
                     "Logits_Fake_S": pred_fake.mean()}

    def vae_loss(self, fwd: dict, draws: StepDraws, gate: float):
        m, dt = self.models, self.dtype
        gen, orig = fwd["gen"], fwd["orig"]
        fake_t, real_t = self.subsample(gen, orig, draws.start)
        fake_s, _ = self.patch_frames(gen, orig, draws.patches)
        loss_gen_s = hinge_loss(apply(m.disc_s, dt, fake_s), None, "gen")
        pred_fake_t, fmap_f = apply(m.disc_t, dt, fake_t)
        with torch.no_grad():
            _, fmap_r = apply(m.disc_t, dt, real_t)
        coup_t = hinge_loss(pred_fake_t, None, "gen")
        l_fmap = fmap_loss(fmap_f, fmap_r, "L1")
        lp = apply(m.lpips, dt, flat_frames(orig), flat_frames(gen)).mean()
        l_recon = torch.mean(torch.abs(gen - orig))
        l_kl = KL(fwd["mu"], fwd["logvar"])
        total = (gate * (loss_gen_s + self.w_coup_t * coup_t + self.w_fmap_t * l_fmap)
                 + self.w_percep * lp + self.w_kl * l_kl + self.w_recon * l_recon)
        return total, {"Loss_VAE": total, "Loss_L1": l_recon, "LPIPS": lp, "Loss_KL": l_kl,
                       "Loss_GEN_S": loss_gen_s, "Loss_GEN_T": coup_t, "Loss_Fmap_T": l_fmap}

    # -- the whole step ------------------------------------------------------------
    def __call__(self, seq: torch.Tensor, epoch: int, draws: StepDraws):
        m = self.models
        gate_open = epoch >= self.pretrain
        with record_function("stage1/vae_forward"):
            fwd = self.forward_vae(seq, draws.eps)
        gen_d, orig = fwd["gen"].detach(), fwd["orig"]
        with torch.no_grad():
            metrics = quality(gen_d, orig)
        fake_t, real_t = self.subsample(gen_d, orig, draws.start)
        fake_s, real_s = self.patch_frames(gen_d, orig, draws.patches)

        with record_function("stage1/disc_t"):
            total, mt = self.disc_t_loss(fake_t, real_t, create_graph=gate_open)
            if gate_open:
                self.opt_dt.zero_grad(set_to_none=True)
                backward_into(total, list(m.disc_t.parameters()))
                self.opt_dt.step()
        with record_function("stage1/disc_s"):
            total, ms = self.disc_s_loss(fake_s, real_s)
            if gate_open:
                backward_into(total, list(m.disc_s.parameters()))
                self.opt_ds.step()
        metrics.update({k: v.detach() for k, v in {**mt, **ms}.items()})
        del total, mt, ms
        with record_function("stage1/spectral"):
            power_iteration_(m.disc_t)
            power_iteration_(m.disc_s)

        with record_function("stage1/vae_loss"):
            total, mv = self.vae_loss(fwd, draws, float(gate_open))
        with record_function("stage1/vae_backward"):
            backward_into(total, _ae_params(m))
        with record_function("stage1/optimizer"):
            self.opt_ae.step()
        with record_function("stage1/spectral"):
            power_iteration_(m.decoder)
        metrics.update({k: v.detach() for k, v in mv.items()})
        return metrics, gen_d.permute(0, 2, 1, 3, 4)


@torch.no_grad()
def eval_step(models: Stage1Models, seq: torch.Tensor, eps: torch.Tensor):
    """Reconstruction metrics of a batch (B, T, H, W, 3) with eps (B, z), in
    fp32: (``Loss_L1``, ``LPIPS``, ``L_KL``, ``PSNR``, ``SSIM`` as 0-d
    tensors; the reconstruction (B, T - 1, 3, H, W))."""
    video = seq.permute(0, 4, 1, 2, 3)
    orig = video[:, :, 1:]
    motion, mu, logvar = models.encoder(orig, noise=eps.to(seq.device))
    gen = models.decoder(video[:, :, 0], motion)
    fg, fo = flat_frames(gen), flat_frames(orig)
    metrics = {"Loss_L1": torch.mean(torch.abs(gen - orig)), "LPIPS": models.lpips(fo, fg).mean(),
               "L_KL": KL(mu, logvar), **quality(gen, orig)}
    return metrics, gen.permute(0, 2, 1, 3, 4)
