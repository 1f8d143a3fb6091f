"""Stage-2 conditioning-AE training (port of ``train/stage2_ae.py``): the BigAE
(ResNet encoder, BigGAN decoder) as a VAE-GAN against the patch
discriminator. It writes ``Encoder_stage2``, the frozen start-frame embedder
of stage-2 training and of every ``Model``.

One step (``AEStep``, the counterpart of ``_build_step``):

1. One forward with gradient, BatchNorm on batch statistics: the posterior's
   mode, the decoder's features and ``colorize``, rec = |img - recon| +
   LPIPS(img, recon); nll = rec / exp(logvar) + logvar with a learned scalar
   ``logvar``, summed and divided by the batch; the KL; g_loss = -mean of
   the discriminator's logits on the recon. The JAX step forwards twice for
   its two gradients; both are of this one graph at the same parameters.
2. The adaptive weight d_weight = |d(nll + w_kl KL)/dW| / (|d g_loss/dW| +
   1e-4), W the raw weight of the decoder's ``colorize`` conv, clamped to
   [0, 1e4] and detached; then one backward of nll + w_kl KL + d_weight *
   gate * g_loss into the generator and ``logvar`` (gate = epoch >=
   ``pretrain``) and one ``Adam`` step over both.
3. The recon recomputed with the updated generator, batch statistics again,
   under ``no_grad`` (``_build_step``'s code at ``:129-132``, whatever its
   comment says). The JAX step's refresh pass at ``:160-165`` is the same
   forward of the same parameters and input, so this one pass also moves
   the BatchNorm running averages, once. The logged ``Loss_recon`` is its
   mean reconstruction loss: after the update.
4. The discriminator on the image and on that recon, as the JAX step applies
   it (ActNorm as it is, sigma from the stored vectors): d_loss = gate * 0.5
   * (hinge_real + hinge_fake). Its ``Adam`` steps only where d_loss > 0;
   otherwise its parameters and state, the count included, stay as they
   were (every gated step). Then one power iteration of its spectral norm,
   gated or not; the generator's BigGAN layers keep their vectors.

The eval step is the same step with ``train=False``: running statistics,
nothing updated, the recon not recomputed (it would be the same). d_weight
still takes both colorize gradients, so it runs with autograd.

``main``/``train``: two ``Adam`` (generator with ``logvar``, discriminator),
two ``LRController('plateau')`` stepped on the epoch's last train
``Loss_recon``; the discriminator's ActNorm init on the first augmented
batch, then its optimizer reset at the controller's lr; per epoch the CSVs
``log_per_epoch_{train,test}.csv``, ``images/<epoch>_train_recon.jpg`` (best
effort, warned once; to wandb too where it logs) and ``Encoder_stage2.msgpack``
in the JAX layout whenever the eval ``Loss_recon`` beats the best (from 99.0), written on a
background thread that is flushed on every exit. Under ``max_steps`` the
validation is cut to 2 batches. LPIPS is the random one of a fixed torch
seed, as the JAX trainer's is random from ``PRNGKey(2)``; the networks are
random from ``seed`` and ``seed + 1``.

The augment's draws come from ``Draws`` (its ``augment`` purpose, keyed by
epoch and batch; tests inject the JAX trainer's ``fold_in(PRNGKey(42),
global_step)``); the eval transform draws nothing. ``AE.pretrained: true``
starts the decoder from the ImageNet BigGAN checkpoint (``build_models``;
not in the repository, docs/WEIGHTS.md), and a missing file raises.
``steps_per_dispatch``, a TPU dispatch mechanism whose steps equal single
steps, is ignored. fp32, with TF32 off on a CUDA device. The spans
(``stage2_ae/...``) name the phases for a profiler's trace.

``Training.distributed`` runs one process per card, as in ``stage2.py``:
each rank's loaders decode its rows and the augment's draws are made for the
global batch and sliced. BatchNorm and the discriminator's ActNorm init take
the global batch's statistics (``models/layers.py``); d_weight is taken from
the colorize gradients averaged over the ranks, the discriminator steps only
where the global d_loss > 0, every logged metric is the global mean (so the
plateau schedulers and the best ``Encoder_stage2`` agree), and rank 0 alone
writes.
"""

from __future__ import annotations

import os
import time
import warnings
from dataclasses import dataclass
from datetime import datetime

import numpy as np
import torch
import torch.nn as nn

from .. import config as cfg
from ..data import get_loader
from ..data.augment import build_augment
from ..data.framestore import open_or_build
from ..data.loader import Loader
from ..data.registry import augment_params
from ..losses.common import hinge_loss
from ..models.backbones.lpips import LPIPS
from ..models.facade import resolve_device
from ..models.layers import init_actnorm, power_iteration_, updating_batch_stats
from ..models.stage1.patch_disc import NLayerDiscriminator
from ..models.stage2.biggan import BigAE
from ..parallel import distributed
from ..utils import checkpoint as ckpt_io
from ..utils import convert
from ..utils.logging import CSVlogger, Logging, WandbSink
from ..utils.profiling import annotate
from ..utils.video import write_image
from . import stage1, stage2
from .optim import Adam, LRController, set_lr
from .stage1_step import backward_into

LOG_KEYS = [
    "Loss", "Loss_recon", "Loss_nll", "Logvar", "L_KL", "Loss_G", "L_disc",
    "Logits_real", "Logits_fake", "Disc_weight", "Disc_factor",
]
LPIPS_SEED = 2


@dataclass
class AEModels:
    """The trained BigAE, ``logvar`` and discriminator, and the frozen LPIPS."""

    network: BigAE
    disc: NLayerDiscriminator
    lpips: LPIPS
    logvar: nn.Parameter

    def to(self, device) -> "AEModels":
        for m in (self.network, self.disc, self.lpips):
            m.to(device)
        self.logvar.data = self.logvar.data.to(device)
        return self

    def gen_params(self) -> list[nn.Parameter]:
        """The generator optimizer's parameters: the BigAE's, then ``logvar``."""
        return [*self.network.parameters(), self.logvar]


class Draws(stage2.Draws):
    """The train augment's draws, each from a CPU generator keyed by (seed,
    epoch, batch index); ``global_step`` is passed for a subclass that keys
    on it, as the JAX trainer does."""

    PURPOSES = ("augment",)


def build_models(opt, seed: int = 0, weights_root: str = "models",
                 biggan_sd: dict | None = None) -> AEModels:
    """Random networks of the config's shapes, drawn from ``seed`` (BigAE)
    and ``seed + 1`` (discriminator), the LPIPS of ``LPIPS_SEED``, on the CPU.
    With ``AE.pretrained: true`` every decoder weight but ``G_linear`` comes
    from ``{weights_root}/biggan/biggan_{in_size}.pth`` (or the state dict
    ``biggan_sd``), as ``convert.pretrained_init_biggan`` maps it."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        network = BigAE(dict(opt.AE))
        if bool(opt.AE.get("pretrained", False)):
            tree = convert.pretrained_init_biggan(stage1.variables(network), dict(opt.AE),
                                                  weights_root, sd=biggan_sd)
            stage1.load_variables(network, tree)
        torch.manual_seed(seed + 1)
        disc = NLayerDiscriminator.from_config(opt.Discriminator_Patch)
        torch.manual_seed(LPIPS_SEED)
        lpips = LPIPS()
    return AEModels(network, disc, lpips.eval().requires_grad_(False),
                    nn.Parameter(torch.zeros(())))


def make_optimizers(models: AEModels, lr: float, weight_decay: float) -> tuple[Adam, Adam]:
    """The JAX trainer's two ``adam_torch(lr, weight_decay)``."""
    return (Adam(models.gen_params(), lr, weight_decay=weight_decay),
            Adam(list(models.disc.parameters()), lr, weight_decay=weight_decay))


class AEStep:
    """``step(img, epoch, train=True)``: img (B, 3, H, W) in [-1, 1] -> the
    ``LOG_KEYS`` metrics (0-d tensors) and the recon (detached)."""

    def __init__(self, models: AEModels, optimizers: tuple[Adam, Adam], opt_cfg):
        self.models = models
        self.opt_gen, self.opt_disc = optimizers
        self.w_kl = float(opt_cfg["w_kl"])
        self.pretrain = int(opt_cfg["pretrain"])

    def recon_losses(self, img: torch.Tensor, train: bool) -> dict:
        """recon, rec (B, 3, H, W), nll_loss and kl of one forward."""
        m = self.models
        p = m.network.encode(img, train)
        recon = m.network.colorize(m.network.decode_features(p.mode(), train))
        rec = torch.abs(img - recon) + m.lpips(img, recon)[:, None, None, None]
        nll = rec / torch.exp(m.logvar) + m.logvar
        return {"recon": recon, "rec": rec, "nll": torch.sum(nll) / nll.shape[0], "kl": p.kl()}

    def __call__(self, img: torch.Tensor, epoch: int, train: bool = True):
        m = self.models
        gate = float(epoch >= self.pretrain)
        with torch.enable_grad():
            with annotate("stage2_ae/forward"):
                f = self.recon_losses(img, train)
                loss_vae = f["nll"] + self.w_kl * f["kl"]
                g_loss = hinge_loss(m.disc(f["recon"]), None, "gen")
            with annotate("stage2_ae/colorize_grads"):
                w = m.network.colorize_weight
                (g1,) = torch.autograd.grad(loss_vae, w, retain_graph=True)
                (g2,) = torch.autograd.grad(g_loss, w, retain_graph=True)
                distributed.all_reduce_mean_([g1, g2])  # the global batch's gradients
                d_weight = torch.clamp(torch.linalg.vector_norm(g1)
                                       / (torch.linalg.vector_norm(g2) + 1e-4), 0.0, 1e4).detach()
            loss_total = loss_vae + d_weight * gate * g_loss
            if train:
                with annotate("stage2_ae/backward"):
                    backward_into(loss_total, m.gen_params())
        metrics = {k: v.detach() for k, v in (("Loss", loss_total), ("Loss_nll", f["nll"]),
                                               ("L_KL", f["kl"]), ("Loss_G", g_loss))}
        recon, rec = f["recon"].detach(), f["rec"].detach()
        del f, loss_vae, loss_total, g_loss
        if train:
            with annotate("stage2_ae/gen_optimizer"):
                self.opt_gen.step()
            with annotate("stage2_ae/recompute"), torch.no_grad(), \
                    updating_batch_stats(m.network):
                f = self.recon_losses(img, True)
                recon, rec = f["recon"], f["rec"]
        with annotate("stage2_ae/disc"), torch.set_grad_enabled(bool(train and gate)):
            logits_real, logits_fake = m.disc(img), m.disc(recon)
            d_loss = gate * hinge_loss(logits_fake, logits_real, "disc")
            # the global batch's d_loss decides, the same on every rank
            if train and gate and distributed.mean_scalars({"d": d_loss})["d"] > 0:
                backward_into(d_loss, list(m.disc.parameters()))
                with annotate("stage2_ae/disc_optimizer"):
                    self.opt_disc.step()
        if train:
            with annotate("stage2_ae/spectral"):
                power_iteration_(m.disc)
        metrics.update({
            "Loss_recon": torch.mean(rec), "Logvar": m.logvar.detach().clone(),
            "L_disc": d_loss.detach(), "Logits_real": logits_real.detach().mean(),
            "Logits_fake": logits_fake.detach().mean(), "Disc_weight": d_weight,
            "Disc_factor": torch.tensor(gate)})
        return {k: metrics[k] for k in LOG_KEYS}, recon


def encoder_variables(models: AEModels) -> dict:
    """The encoder's JAX variables tree, the standalone ``ResnetEncoder``
    layout that the cINN's embedder splice reads (``_extract_encoder``)."""
    return stage1.variables(models.network.encoder)


def recon_grid(img: torch.Tensor, recon: torch.Tensor) -> np.ndarray:
    """Inputs above their recons, side by side: (2H, B W, 3) uint8."""
    pair = torch.cat([img, recon], dim=2).permute(0, 2, 3, 1).cpu().numpy()
    grid = np.clip((np.concatenate(list(pair), axis=1) + 1) / 2, 0, 1)
    return (grid * 255).astype(np.uint8)


def train(opt, models: AEModels, train_loader, eval_loader, *, device=None,
          max_steps: int | None = None, draws: Draws | None = None) -> dict:
    """The training run over built modules and loaders; ``max_steps`` stops
    after that many steps in all and cuts the validation to 2 batches. In a
    live process group the loaders must give each rank its rows (``main``
    builds them)."""
    device = resolve_device(device)
    n_rank, primary = distributed.world(), distributed.is_primary()
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    draws = draws or Draws()
    tr = opt.Training
    models.to(device)
    opt_gen, opt_disc = make_optimizers(models, tr["lr"], tr["weight_decay"])
    step = AEStep(models, (opt_gen, opt_disc), tr)

    img_size = opt.Data["img_size"]
    params_aug, random_crop, aug_on = augment_params(opt, "train")
    aug_train = build_augment(img_size, params_aug, random_crop, aug_on)
    aug_eval = build_augment(img_size, params_aug, random_crop, False)

    def prep(augment, batch, d=None) -> torch.Tensor:
        seq = augment(torch.from_numpy(batch["seq_raw"]).to(device), draws=d)
        return seq[:, 0].permute(0, 3, 1, 2).contiguous()  # sequence_length 1: the frame

    # ---- logging -----------------------------------------------------------
    now = datetime.now()
    run_name = "Stage2_AE_{}_Date-{}-{}-{}-{}-{}-{}_{}".format(
        opt.Data["dataset"], now.year, now.month, now.day, now.hour, now.minute, now.second,
        tr["savename"])
    save_path = os.path.join(tr["save_path"] or ".", run_name)
    tr["save_path"] = save_path
    if primary:  # rank 0 alone touches the filesystem
        os.makedirs(os.path.join(save_path, "images"), exist_ok=True)
        cfg.save(opt, os.path.join(save_path, "config_stage2_AE.yaml"))
    wandb_sink = WandbSink()
    wandb_sink.init(opt.get("Logging"), opt, save_path, tr["savename"])
    logger_train, logger_eval = Logging(LOG_KEYS), Logging(LOG_KEYS)
    csv_train = CSVlogger(os.path.join(save_path, "log_per_epoch_train.csv"),
                          ["Epoch", "Time", "LR"] + LOG_KEYS)
    csv_eval = CSVlogger(os.path.join(save_path, "log_per_epoch_test.csv"),
                         ["Epoch", "Time", "LR"] + LOG_KEYS)

    scheds = [LRController(tr["lr"], "plateau", factor=0.5, patience=1) for _ in range(2)]
    best_val = 99.0
    actnorm_done = False
    global_step = 0
    dump_warned = []

    if n_rank > 1:
        distributed.require_mesh_divisible(n_rank, bs=tr["bs"])
    distributed.barrier("stage2-ae-build")

    def dump(pair, epoch: int) -> None:
        if not primary:
            return
        grid = recon_grid(*pair)
        wandb_sink.log_image("images_train", grid, caption="Reconstructions")
        try:
            write_image(os.path.join(save_path, "images", f"{epoch}_train_recon.jpg"), grid)
        except Exception as e:  # the recon grid is best effort, as in the JAX package
            if not dump_warned:
                warnings.warn(f"per-epoch recon grid failed (reported once a run): {e!r}")
                dump_warned.append(e)

    writer = ckpt_io.AsyncWriter()
    try:
        for epoch in range(tr["n_epochs"]):
            t0 = time.time()
            lr = scheds[0].lr
            logger_train.reset()
            loss_recon = float("nan")
            last = None
            for i, batch in enumerate(train_loader.epoch_iter(epoch)):
                n = batch["seq_raw"].shape[0] * n_rank  # the global batch's draws
                img = prep(aug_train, batch, distributed.local_rows(
                    draws.augment(epoch, i, global_step, n, params_aug, random_crop)))
                if not actnorm_done:
                    init_actnorm(models.disc, img)
                    opt_disc.reset()
                    set_lr(opt_disc, scheds[1].lr)
                    actnorm_done = True
                metrics, recon = step(img, epoch)
                metrics = distributed.mean_scalars(metrics)
                loss_recon = metrics["Loss_recon"]
                logger_train.append(metrics)
                wandb_sink.log({f"train_{k}": v for k, v in metrics.items()})
                last = (img, recon)
                global_step += 1
                if max_steps and global_step >= max_steps:
                    break

            # plateau schedulers stepped on the last train recon loss
            set_lr(opt_gen, scheds[0].step(loss_recon))
            set_lr(opt_disc, scheds[1].step(loss_recon))
            if last is not None:
                dump(last, epoch)

            logger_eval.reset()
            for i, batch in enumerate(eval_loader.epoch_iter(epoch)):
                metrics, _ = step(prep(aug_eval, batch), epoch, train=False)
                logger_eval.append(distributed.mean_scalars(metrics))
                if max_steps and i >= 1:
                    break
            val_recon = logger_eval.log()[LOG_KEYS.index("Loss_recon")]
            if val_recon < best_val:
                best_val = val_recon
                if primary:
                    writer.save_async(os.path.join(save_path, "Encoder_stage2.msgpack"),
                                      {"state_dict": encoder_variables(models)})

            dt = time.time() - t0
            csv_train.write([epoch, dt, lr, *logger_train.log()])
            csv_eval.write([epoch, dt, lr, *logger_eval.log()])
            if max_steps and global_step >= max_steps:
                break
    finally:
        writer.wait()
    return {"save_path": save_path, "best_val": best_val, "train_loss": logger_train.log(),
            "eval_loss": logger_eval.log(), "global_step": global_step}


def main(opt, max_steps: int | None = None, device=None, draws: Draws | None = None) -> dict:
    """Train from the config, on ``device`` (``cuda`` unless the caller
    passes another; in a multi-process run, each rank's card); ``draws``
    replaces the run's draws."""
    device = resolve_device(device)
    tr = opt.Training
    rank, n_rank = distributed.maybe_initialize(tr.get("distributed"), device)
    if n_rank > 1:
        device = distributed.rank_device(device)
    models = build_models(opt)
    dataset_cls = get_loader(opt.Data["dataset"])
    fs_spec = opt.Data.get("framestore", "off")
    loaders = {}
    for mode, seed, drop_last in (("train", 42, True), ("eval", 43, False)):
        ds = dataset_cls(opt, mode=mode)
        loaders[mode] = Loader(ds, tr["bs"], workers=tr["workers"], drop_last=drop_last,
                               seed=seed, framestore=open_or_build(ds, fs_spec, mode),
                               process_index=rank, process_count=n_rank,
                               tail_multiple=n_rank if n_rank > 1 else None)
    return train(opt, models, loaders["train"], loaders["eval"], device=device,
                 max_steps=max_steps, draws=draws)
