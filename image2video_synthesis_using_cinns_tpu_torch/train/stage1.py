"""Stage-1 video-VAE training (port of ``train/stage1.py``): the encoder and
decoder against the temporal and patch discriminators.

* ``build_models``: the trainable decoder (spectral norm kept as trainable
  layers), encoder, temporal ``Discriminator`` and ``NLayerDiscriminator``
  from the config's sections, random from a seed, and the frozen LPIPS from
  ``I2V_LPIPS_WEIGHTS``, else ``<weights_root>/lpips/vgg_lpips.msgpack``,
  else its fixed-seed random init.
* Three ``Adam(betas=(0.5, 0.9))`` (``stage1_step.make_optimizers``), each
  with an ``LRController('exponential')`` stepped per epoch; the
  discriminators' only once the pretrain gate has opened.
* On the first batch of a fresh run the patch discriminator's ActNorm init
  runs on the first 20 frames of the flattened augmented clips (start frames
  included), and its optimizer is reset.
* Each epoch: the steps (``stage1_step.Stage1Step``), the validation pass
  (cut to 2 batches under ``max_steps``), the posterior FVD
  (``fvd_eval.evaluate_FVD_posterior``; without I3D weights it is dropped
  with one warning and the best checkpoint follows the eval L1, its gate
  moving from 999 to inf), ``latest_checkpoint_{GEN,ENC,DISC_t,DISC_s}`` and
  ``best_PFVD_{GEN,ENC}`` in the JAX package's layout (variables, optax
  state, the AE scheduler's state), written on a background thread; the
  ``TRAIN_KEYS``/``TEST_KEYS`` CSVs.
* Resume from ``Training.reload_path``: the four networks, the three
  optimizer states, and the ``GEN`` checkpoint's scheduler state loaded into
  all three controllers, as the JAX trainer does.

Every random draw comes from ``Draws`` (CPU generators keyed by purpose,
epoch and batch); tests subclass it to inject the JAX trainer's draws.
``Training.distributed`` raises (ROADMAP slice 9); ``fused_step`` and
``steps_per_dispatch``, TPU dispatch fusion whose steps equal single steps,
are ignored. ``train`` runs built modules over given loaders;
``main`` builds them from the config. On a CUDA device TF32 is off.
"""

from __future__ import annotations

import os
import time
import warnings
from datetime import datetime

import numpy as np
import torch

from .. import config as cfg
from ..data import get_loader
from ..data.augment import build_augment
from ..data.framestore import open_or_build
from ..data.loader import Loader
from ..data.registry import augment_params
from ..metrics.lpips_eval import load_lpips
from ..models.facade import resolve_device
from ..models.layers import ActNormImage, init_actnorm
from ..models.stage1.decoder import Generator
from ..models.stage1.patch_disc import NLayerDiscriminator
from ..models.stage1.resnet3d import Discriminator, Encoder
from ..utils import checkpoint as ckpt_io
from ..utils import convert
from ..utils.logging import CSVlogger, Logging, WandbSink
from ..utils.preemption import PreemptionGuard, maybe_enable_debug_nans
from . import stage2
from .fvd_eval import evaluate_FVD_posterior
from .optim import LRController, load_optax_state, optax_state, set_lr
from .stage1_step import (N_PATCH, Stage1Models, Stage1Step, StepDraws, ae_names, eval_step,
                          make_optimizers)

TRAIN_KEYS = [
    "Loss_VAE", "Loss_L1", "LPIPS", "Loss_KL", "Loss_GEN_S", "Loss_GEN_T",
    "Loss_Disc_T", "Loss_Fmap_T", "L_GP", "Logits_Real_T", "Logits_Fake_T",
    "Loss_Disc_S", "Logits_Real_S", "Logits_Fake_S", "PSNR", "SSIM",
]
TEST_KEYS = ["Loss_L1", "LPIPS", "L_KL", "PSNR", "SSIM", "PFVD"]
NETWORKS = ("GEN", "ENC", "DISC_t", "DISC_s")


class Draws(stage2.Draws):
    """Every random draw of a stage-1 run, each from a CPU generator keyed by
    (seed, purpose, epoch, batch index); ``global_step`` is passed for a
    subclass that keys on it, as the JAX trainer does."""

    PURPOSES = ("augment", "posterior", "subsample", "patches", "eval_posterior")

    def step(self, epoch: int, index: int, global_step: int, n: int, z_dim: int,
             n_frames: int, sub_len: int) -> StepDraws:
        """A step's eps (n, z_dim), subsample start in [0, n_frames -
        sub_len] and 20 patch-frame indices in [0, n * n_frames)."""
        eps = self.normal("posterior", epoch, index, global_step, (n, z_dim))
        start = int(torch.randint(0, max(1, n_frames - sub_len + 1), (),
                                  generator=self.generator("subsample", epoch, index)))
        patches = torch.randint(0, n * n_frames, (N_PATCH,),
                                generator=self.generator("patches", epoch, index))
        return StepDraws(eps, start, patches)

    def fvd_posterior(self, shape: tuple) -> torch.Tensor:
        """The posterior FVD's eps: the same for every batch of one size, as
        the JAX trainer draws it from ``PRNGKey(1)``."""
        return torch.randn(shape, generator=torch.Generator().manual_seed(1))


def build_models(opt, seed: int = 0, weights_root: str = "models") -> Stage1Models:
    """Random trainable networks of the config's shapes drawn from ``seed``,
    and the frozen LPIPS, on the CPU."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        decoder = Generator.from_config(opt.Decoder, trainable=True)
        encoder = Encoder.from_config(opt.Encoder, trainable=True)
        disc_t = Discriminator.from_config(opt.Discriminator_Temporal)
        disc_s = NLayerDiscriminator.from_config(opt.Discriminator_Patch)
    env = os.environ.get("I2V_LPIPS_WEIGHTS")
    lpips = load_lpips(weights_root, "cpu", path=env if env and os.path.exists(env) else None)
    return Stage1Models(decoder, encoder, disc_t, disc_s, lpips.requires_grad_(False))


# -- the JAX package's checkpoint layout ----------------------------------------------

def variables(module: torch.nn.Module) -> dict:
    """The JAX variables tree of a trainable network (host copies):
    ``params``, ``spectral`` and, for ActNorm layers, ``actnorm_stats`` as
    the JAX trainer keeps it, at its init values (the data-dependent init
    goes into ``params``)."""
    tree = convert.to_variables(module.state_dict())
    for name, m in module.named_modules():
        if isinstance(m, ActNormImage):
            node = tree.setdefault("actnorm_stats", {})
            for part in name.split("."):
                node = node.setdefault(part, {})
            c = m.loc.shape[0]
            node.update(initialized=np.zeros((), np.uint8), loc_init=np.zeros(c, np.float32),
                        scale_init=np.ones(c, np.float32))
    return tree


def load_variables(module: torch.nn.Module, tree: dict) -> None:
    module.load_state_dict(convert.to_state_dict(tree, fold_spectral=False))


def _params_tree(named: dict) -> dict:
    return convert.to_variables(named)["params"]


def _params_named(tree: dict) -> dict:
    return convert.to_state_dict({"params": tree}, fold_spectral=False)


def _ae_tree(named: dict) -> dict:
    """{"0.<dec>": t, "1.<enc>": t} -> optax's ``{"0": dec tree, "1": enc tree}``."""
    return {part: _params_tree({k[2:]: v for k, v in named.items() if k[0] == part})
            for part in ("0", "1")}


def _ae_named(tree: dict) -> dict:
    return {f"{part}.{k}": v for part in ("0", "1") for k, v in _params_named(tree[part]).items()}


def optimizer_states(models: Stage1Models, optimizers) -> dict:
    """Each network's optimizer state in optax's layout (the AE's twice)."""
    opt_ae, opt_dt, opt_ds = optimizers
    ae = optax_state(opt_ae, ae_names(models), _ae_tree)
    return {"GEN": ae, "ENC": ae,
            "DISC_t": optax_state(opt_dt, [n for n, _ in models.disc_t.named_parameters()],
                                  _params_tree),
            "DISC_s": optax_state(opt_ds, [n for n, _ in models.disc_s.named_parameters()],
                                  _params_tree)}


def load_optimizer_states(models: Stage1Models, optimizers, payloads: dict) -> None:
    opt_ae, opt_dt, opt_ds = optimizers
    for name, opt, names, from_tree in (
            ("GEN", opt_ae, ae_names(models), _ae_named),
            ("DISC_t", opt_dt, [n for n, _ in models.disc_t.named_parameters()], _params_named),
            ("DISC_s", opt_ds, [n for n, _ in models.disc_s.named_parameters()], _params_named)):
        if name in payloads and "optim_state_dict" in payloads[name]:
            load_optax_state(opt, payloads[name]["optim_state_dict"], names, from_tree)


def networks(models: Stage1Models) -> dict:
    """The four trained networks by their checkpoint names."""
    return {"GEN": models.decoder, "ENC": models.encoder, "DISC_t": models.disc_t,
            "DISC_s": models.disc_s}


def _check_supported(opt) -> None:
    if opt.Training.get("distributed"):
        raise NotImplementedError("Training.distributed: multi-host and data-parallel training "
                                  "are not ported yet (ROADMAP slice 9)")


def train(opt, models: Stage1Models, train_loader, eval_loader, *, device=None,
          max_steps: int | None = None, eval_fvd: bool = True, draws: Draws | None = None,
          guard: PreemptionGuard | None = None, weights_root: str = "models") -> dict:
    """The training run over built modules and loaders. ``max_steps`` stops
    after that many steps in all and cuts the validation to 2 batches, as in
    the JAX package; ``guard`` is polled after every step; ``weights_root``
    holds the I3D weights of the posterior FVD."""
    _check_supported(opt)
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    draws = draws or Draws()
    tr = opt.Training
    z_dim = opt.Decoder["z_dim"]
    sub_len = int(tr["subsample_length"])
    models.to(device)
    models.lpips.eval().requires_grad_(False)
    optimizers = make_optimizers(models, tr["lr"], tr["weight_decay"])
    opt_ae, opt_dt, opt_ds = optimizers
    step = Stage1Step(models, optimizers, tr)

    params_aug, random_crop, aug_on = augment_params(opt, "train")
    aug_train = build_augment(opt.Data["img_size"], params_aug, random_crop, aug_on)
    aug_eval = build_augment(opt.Data["img_size"], params_aug, random_crop, False)

    # ---- logging ---------------------------------------------------------
    dt = datetime.now()
    run_name = "Stage1_{}_Date-{}-{}-{}-{}-{}-{}_{}".format(
        opt.Data["dataset"], dt.year, dt.month, dt.day, dt.hour, dt.minute, dt.second,
        tr["savename"])
    save_path = os.path.join(tr["save_path"] or ".", run_name)
    tr["save_path"] = save_path
    os.makedirs(os.path.join(save_path, "videos"), exist_ok=True)
    cfg.save(opt, os.path.join(save_path, "config_stage1.yaml"))
    wandb_sink = WandbSink()
    wandb_sink.init(opt.get("Logging"), opt, save_path, tr["savename"])
    log_train, log_test = Logging(TRAIN_KEYS), Logging(TEST_KEYS[:-1])
    full_log_train = CSVlogger(os.path.join(save_path, "log_per_epoch_train.csv"),
                               ["Epoch", "Time", "LR"] + TRAIN_KEYS)
    full_log_test = CSVlogger(os.path.join(save_path, "log_per_epoch_eval.csv"),
                              ["Epoch", "Time", "LR"] + TEST_KEYS)

    # ---- resume ------------------------------------------------------------
    scheds = [LRController(tr["lr"], "exponential", gamma=tr["lr_gamma"]) for _ in range(3)]
    start_epoch = 0
    if tr.get("reload_path"):
        payloads = {}
        for name in NETWORKS:
            p = ckpt_io.find(os.path.join(tr["reload_path"], f"latest_checkpoint_{name}"))
            if p:
                payloads[name] = ckpt_io.load(p)
        if "GEN" in payloads:
            for name, module in networks(models).items():
                load_variables(module, payloads[name]["state_dict"])
            start_epoch = int(payloads["GEN"]["epoch"])
            if start_epoch > 0:
                load_optimizer_states(models, optimizers, payloads)
            sched_state = payloads["GEN"].get("scheduler_state_dict")
            if sched_state is not None:
                for s in scheds:
                    s.load_state_dict({k: float(v) for k, v in sched_state.items()})

    actnorm_done = start_epoch > 0
    # 999 is the reference's FVD-scale gate; the eval-loss fallback compares
    # against inf, so that the first epoch always writes best_PFVD_*
    best_PFVD = 999.0 if eval_fvd else float("inf")
    global_step = 0
    dump_warned = []

    def dump(sequences, epoch: int, mode: str) -> None:
        try:
            from ..utils.video import plot_vid

            wandb_sink.log_video(f"{mode}_video", plot_vid(opt, sequences, epoch, mode=mode))
        except Exception as e:  # the GIF dump is best effort: imageio may be missing
            if not dump_warned:
                warnings.warn(f"per-epoch video dump failed (reported once a run): {e!r}")
                dump_warned.append(e)

    def clips(gen: torch.Tensor, seq: torch.Tensor) -> list[np.ndarray]:
        """The generated clips and frames 1: of ``seq``, (B, T, C, H, W) on the host."""
        return [gen.cpu().numpy(), seq[:, 1:].permute(0, 1, 4, 2, 3).cpu().numpy()]

    writer = ckpt_io.AsyncWriter()
    PFVD = float("nan")
    try:
        for epoch in range(start_epoch, tr["n_epochs"]):
            epoch_time = time.time()
            lr = scheds[0].lr

            # ---------------- train ----------------
            log_train.reset()
            sequences = None
            for i, batch in enumerate(train_loader.epoch_iter(epoch)):
                n = batch["seq_raw"].shape[0]
                seq = aug_train(torch.from_numpy(batch["seq_raw"]).to(device), draws=draws.augment(
                    epoch, i, global_step, n, params_aug, random_crop))
                if not actnorm_done:
                    frames = seq.reshape((-1,) + seq.shape[2:])[:N_PATCH].permute(0, 3, 1, 2)
                    init_actnorm(models.disc_s, frames)
                    opt_ds.reset()
                    actnorm_done = True
                metrics, seq_gen = step(seq, epoch, draws.step(
                    epoch, i, global_step, n, z_dim, seq.shape[1] - 1, sub_len))
                metrics = {k: float(v) for k, v in metrics.items()}
                log_train.append(metrics)
                wandb_sink.log(metrics)
                sequences = clips(seq_gen, seq)
                global_step += 1
                if max_steps and global_step >= max_steps:
                    break
                if guard is not None and guard.should_stop:
                    break
            if sequences is not None:
                dump(sequences, epoch, "train")

            # ---------------- validate ----------------
            log_test.reset()
            sequences = None
            for i, batch in enumerate(eval_loader.epoch_iter(epoch)):
                seq = aug_eval(torch.from_numpy(batch["seq_raw"]).to(device))
                metrics, seq_gen = eval_step(models, seq, draws.normal(
                    "eval_posterior", epoch, i, global_step, (seq.shape[0], z_dim)))
                log_test.append({k: float(v) for k, v in metrics.items()})
                sequences = clips(seq_gen, seq)
                if max_steps and i >= 1:
                    break
            if sequences is not None:
                dump(sequences, epoch, "eval")

            # ---------------- FVD(posterior) ----------------
            PFVD = float("nan")
            if eval_fvd:
                try:
                    PFVD = evaluate_FVD_posterior(eval_loader, aug_eval, models.decoder,
                                                  models.encoder, tr.get("FVD", "FVD"),
                                                  weights_root, noise=draws.fvd_posterior)
                    wandb_sink.log({"FVD": PFVD})
                except FileNotFoundError as e:
                    warnings.warn(
                        "posterior-FVD evaluation disabled for the rest of this run: I3D "
                        f"weights not found ({e}); best-checkpoint selection falls back to eval "
                        "loss and the PFVD CSV column stays NaN.")
                    eval_fvd = False
                    if best_PFVD == 999.0:
                        best_PFVD = float("inf")

            # ---------------- checkpoints ----------------
            sched_sd = scheds[0].state_dict()
            states = optimizer_states(models, optimizers)
            payloads = {name: {"epoch": epoch + 1, "state_dict": variables(module),
                               "optim_state_dict": states[name],
                               "scheduler_state_dict": sched_sd}
                        for name, module in networks(models).items()}
            for name, payload in payloads.items():
                writer.save_async(os.path.join(save_path, f"latest_checkpoint_{name}.msgpack"),
                                  payload)
            metric = PFVD if PFVD == PFVD else log_test.log()[0]
            if metric < best_PFVD:
                for name in ("GEN", "ENC"):
                    writer.save_async(os.path.join(save_path, f"best_PFVD_{name}.msgpack"),
                                      payloads[name])
                best_PFVD = metric

            # ---------------- schedulers ----------------
            set_lr(opt_ae, scheds[0].step())
            if epoch >= tr["pretrain"]:
                set_lr(opt_dt, scheds[1].step())
                set_lr(opt_ds, scheds[2].step())

            epoch_dt = time.time() - epoch_time
            full_log_train.write([epoch, epoch_dt, lr, *log_train.log()])
            full_log_test.write([epoch, epoch_dt, lr, *log_test.log(), PFVD])
            if max_steps and global_step >= max_steps:
                break
            if guard is not None and guard.should_stop:
                break
    finally:
        writer.wait()
    return {
        "save_path": save_path,
        "best_metric": best_PFVD,
        "train_metrics": dict(zip(TRAIN_KEYS, log_train.log())),
        "eval_metrics": dict(zip(TEST_KEYS[:-1], log_test.log())),
        "PFVD": PFVD,
        "global_step": global_step,
    }


def main(opt, max_steps: int | None = None, eval_fvd: bool = True, device=None,
         draws: Draws | None = None) -> dict:
    """Train from the config, on ``device`` (``cuda`` unless the caller
    passes another); ``draws`` replaces the run's draws."""
    device = resolve_device(device)
    guard = PreemptionGuard()
    try:
        maybe_enable_debug_nans()
        _check_supported(opt)
        models = build_models(opt)
        tr = opt.Training
        dataset_cls = get_loader(opt.Data["dataset"])
        fs_spec = opt.Data.get("framestore", "off")
        loaders = {}
        for mode, bs, seed in (("train", tr["bs"], 42), ("eval", tr["bs_eval"], 43)):
            ds = dataset_cls(opt, mode=mode)
            loaders[mode] = Loader(ds, bs, workers=tr["workers"], seed=seed,
                                   framestore=open_or_build(ds, fs_spec, mode))
        return train(opt, models, loaders["train"], loaders["eval"], device=device,
                     max_steps=max_steps, eval_fvd=eval_fvd, draws=draws, guard=guard)
    finally:
        guard.restore()
