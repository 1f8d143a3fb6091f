"""Stage-2 cINN training (port of ``train/stage2.py``): the flow learns the
exact NLL of the frozen stage-1 encoder's motion posterior under the frozen
embedder's start-frame embedding.

* ``build_models``: the frozen stage-1 decoder and encoder from the chained
  ``config_stage1.yaml``, and the cINN with the stage-2 AE's embedder
  checkpoint spliced in; the flow starts from a random init (seed 0).
* A step: the train augment of the batch; the encoder's posterior sample of
  frames 1: (``Training.compute_dtype: bfloat16`` runs a bf16 copy of the
  encoder, eps drawn in fp32, the posterior cast back to fp32); the
  start-frame embedding (no gradient); the flow forward by autograd through
  the plain float32 flow; ``flow_loss``; the JAX package's Adam chain
  (``optim.py``). The JAX package trains on its scan flow too: its Pallas
  kernel has no backward.
* The ActNorm data-dependent init on the first batch, with its own fp32
  encoder draw; the optimizer state is reset after it.
* Each epoch: the validation NLL through the flow's forward kernel, and the
  prior FVD through its reverse kernel (``fvd_eval.py``), both from an fp32
  pack of the weights, which is refreshed after every change to them. Without
  I3D weights the FVD is dropped with one warning and the best checkpoint
  follows the eval loss (its gate moves from 999 to inf).
* ``Training.cache_posteriors`` (needs ``Data.aug: false``): before the
  first epoch the encoder's moments of every window of the train split are
  encoded once (``posterior_cache.py``); a cached step gathers its batch's
  rows by window id and resamples them with the step's eps instead of
  running the encoder, so the train loader reads one frame a clip and the
  window's (index, start). The ActNorm init resamples the cached moments in
  fp32 (under bf16 they came from the bf16 encoder, as in the JAX package).
  Validation and the prior FVD read full windows, as without the cache.
* ``cINN.msgpack`` (best) and ``cINN_latest.msgpack`` (every epoch) in the
  JAX package's format, written on a background thread; resume from
  ``Training.reload_path`` (the LR schedule replayed, no ActNorm init);
  ``LRController('step')`` per epoch; a SIGTERM (``PreemptionGuard``) ends
  the run after the current step, with its checkpoints written.

Random draws (augment, eps, reference noise, the prior's nu) come from
``Draws``: a CPU ``torch.Generator`` per draw, seeded by its purpose, epoch
and batch, so a resumed run draws what an uninterrupted one would, and the
card and the CPU see the same numbers. Tests subclass it to inject the JAX
package's draws. ``Training.steps_per_dispatch`` (the JAX package's scan
chunks, a TPU dispatch mechanism whose steps equal single steps) is ignored:
the port runs single steps.

``Training.distributed`` (``parallel/distributed.py``) runs one process per
card: ``main`` joins the process group, each rank's loaders decode its rows
of every global batch and drop an indivisible tail, and the batch sizes must
divide the world. Every draw is made for the global batch and sliced to the
rank's rows, so a multi-process run takes the single-process run's steps:
the ActNorm init and ``Adam`` reduce over the ranks, every logged loss is the
global mean (the validation loss steers the best checkpoint), the prior FVD
pools the ranks' I3D activations, the posterior cache is built in shards and
summed, a SIGTERM on any rank stops every rank, and rank 0 alone writes.

``train`` runs a built set of modules over given loaders (``chip_smoke.py``
calls it with in-memory models; the cache reads the train loader's
``dataset`` and ``framestore``, and a cached run needs a loader
``with_meta``); ``main`` loads everything from disk and calls it. On a CUDA
device TF32 is turned off, so that fp32 means fp32.
"""

from __future__ import annotations

import copy
import os
import time
import warnings
from dataclasses import dataclass
from datetime import datetime

import numpy as np
import torch

from .. import config as cfg
from ..config import Config
from ..data import get_loader
from ..data.augment import build_augment, draw_augment
from ..data.framestore import open_or_build
from ..data.loader import Loader
from ..data.registry import augment_params
from ..losses.flow_loss import flow_loss
from ..models.facade import _variables, resolve_device
from ..models.stage1.decoder import Generator
from ..models.stage1.resnet3d import Encoder
from ..models.stage2.inn import SupervisedTransformer
from ..parallel import distributed
from ..utils import checkpoint as ckpt_io
from ..utils import convert
from ..utils.logging import CSVlogger, Logging, WandbSink
from ..utils.preemption import PreemptionGuard, maybe_enable_debug_nans
from ..utils.profiling import annotate
from .fvd_eval import evaluate_FVD_prior
from .optim import LRController, adam_torch, get_lr, load_optax_state, optax_state, set_lr
from .posterior_cache import (WindowIndex, assemble_cache_multiprocess, build_cache,
                              make_clip_reader, resample_posterior)

LOGGING_KEYS = ["Loss", "reference_nll_loss", "nlogdet_loss", "nll_loss", "PFVD"]


@dataclass
class Stage2Models:
    """The modules of a run, on the CPU until ``train`` moves them."""

    config1: Config  # the chained stage-1 config
    decoder: Generator  # frozen
    encoder: Encoder  # frozen
    network: SupervisedTransformer  # the frozen embedder and the trained flow
    embedder_tree: dict | None = None  # the embedder's JAX params, written back unchanged


def build_models_from_configs(opt, config1, ae_cfg, seed: int = 0) -> Stage2Models:
    """Random modules of the configs' shapes, drawn from ``seed``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        decoder = Generator.from_config(config1.Decoder)
        encoder = Encoder.from_config(config1.Encoder)
        network = SupervisedTransformer.from_configs(opt, config1.Decoder, ae_cfg)
    return Stage2Models(config1, decoder, encoder, network)


def build_models(opt) -> Stage2Models:
    """The frozen stage-1 models and the cINN with its frozen embedder, from
    the directories that ``opt`` chains to."""
    fs = opt.First_stage_model
    model_path = os.path.join(fs["model_path"], fs["model_name"])
    config1 = cfg.load(os.path.join(model_path, "config_stage1.yaml"))
    cond_dic = opt.Conditioning_Model
    ae_dir = os.path.join(cond_dic["model_path"], cond_dic["model_name"])
    ae_cfg = cfg.load(os.path.join(ae_dir, "config_stage2_AE.yaml")).AE
    models = build_models_from_configs(opt, config1, ae_cfg)
    for module, name in ((models.decoder, "checkpoint_decoder"),
                         (models.encoder, "checkpoint_encoder")):
        path = ckpt_io.find(os.path.join(model_path, fs[name]))
        if path is None:
            raise FileNotFoundError(f"no {name} checkpoint in {model_path}")
        module.load_state_dict(convert.to_state_dict(_variables(path)))
    emb_ckpt = ckpt_io.find(os.path.join(ae_dir, cond_dic["checkpoint_name"]))
    if emb_ckpt:  # the collections of the embedder, wrapped or bare
        emb_vars = {c: t.get("embedder", t) for c, t in _variables(emb_ckpt).items()
                    if isinstance(t, dict)}
        models.network.embedder.load_state_dict(convert.to_state_dict(emb_vars))
        models.embedder_tree = emb_vars["params"]
    return models


class Draws:
    """Every random draw of a run, each from its own CPU ``torch.Generator``
    seeded by (seed, purpose, epoch, batch index). ``global_step`` is passed
    to each for a subclass that injects the JAX package's draws, which it
    keys on the step."""

    PURPOSES = ("augment", "posterior", "reference", "actnorm", "eval_posterior",
                "eval_reference")

    def __init__(self, seed: int = 42):
        self.seed = seed

    def generator(self, purpose: str, epoch: int, index: int) -> torch.Generator:
        seq = np.random.SeedSequence([self.seed, self.PURPOSES.index(purpose), epoch, index])
        return torch.Generator().manual_seed(int(seq.generate_state(1, np.uint64)[0]))

    def augment(self, epoch: int, index: int, global_step: int, n: int, params: dict,
                random_crop: bool) -> dict:
        return draw_augment(n, params, random_crop, self.generator("augment", epoch, index))

    def normal(self, purpose: str, epoch: int, index: int, global_step: int,
               shape: tuple) -> torch.Tensor:
        return torch.randn(shape, generator=self.generator(purpose, epoch, index))

    def prior(self, epoch: int, index: int, shape: tuple) -> torch.Tensor:
        """The prior FVD's nu: seeded by the epoch alone, as the JAX package
        draws every batch's from ``PRNGKey(epoch)``."""
        return torch.randn(shape, generator=torch.Generator().manual_seed(epoch))


def posterior(encoder: Encoder, seq: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The frozen encoder's posterior sample of frames 1: of ``seq`` (B, T,
    H, W, 3) in [-1, 1], with eps ``noise`` (B, z) drawn in fp32: (B, z)
    fp32. A bf16 encoder gets a bf16 input and casts eps inside."""
    dt = next(encoder.parameters()).dtype
    with torch.no_grad():
        post, _, _ = encoder(seq[:, 1:].permute(0, 4, 1, 2, 3).to(dt), noise=noise.to(seq.device))
    return post.float().reshape(post.shape[0], -1)


def conditioning(seq: torch.Tensor, cond_pos: torch.Tensor | None) -> list[torch.Tensor]:
    """The cINN's conditions: the start frame (B, 3, H, W), and the endpoint
    position with control."""
    x0 = seq[:, 0].permute(0, 3, 1, 2)
    return [x0] if cond_pos is None else [x0, cond_pos]


def cached_posterior(moments: torch.Tensor, wids: torch.Tensor, eps: torch.Tensor,
                     dtype: torch.dtype | None = None) -> torch.Tensor:
    """The posterior sample of windows ``wids`` from the cache ``moments``
    (n_windows, 2, z), with eps ``eps`` (B, z) drawn in fp32, computed in
    ``dtype`` (the step encoder's) as ``posterior`` computes it: (B, z) fp32."""
    mom = moments.index_select(0, wids.to(moments.device))
    return resample_posterior(mom[:, 0], mom[:, 1], eps, dtype)


def train_step(network: SupervisedTransformer, optimizer, encoder: Encoder, seq, cond,
               eps: torch.Tensor, ref: torch.Tensor) -> dict:
    """One optimisation step of the flow; returns the loss terms (detached).
    The spans name the stages for a profiler's trace."""
    with annotate("stage2/posterior"):
        post = posterior(encoder, seq, eps)
    return _flow_step(network, optimizer, post, cond, ref)


def cached_train_step(network: SupervisedTransformer, optimizer, moments: torch.Tensor,
                      wids: torch.Tensor, cond, eps: torch.Tensor, ref: torch.Tensor,
                      dtype: torch.dtype | None = None) -> dict:
    """``train_step`` with the posterior resampled from the cache's rows
    ``wids`` in place of the encoder's forward."""
    with annotate("stage2/posterior_cache"):
        post = cached_posterior(moments, wids, eps, dtype)
    return _flow_step(network, optimizer, post, cond, ref)


def _flow_step(network: SupervisedTransformer, optimizer, post, cond, ref) -> dict:
    """The embedding, the flow by autograd, the loss and ``optimizer``'s step.
    ``network.flow`` may be a ``parallel.tp.TensorParallelFlow``: its master
    shards are then the optimizer's parameters."""
    with annotate("stage2/embedder"):
        emb = network.embed(cond)
    with annotate("stage2/flow"):
        gauss, logdet = network.flow.plain(post, emb)
        loss, aux = flow_loss(gauss, logdet, noise=ref)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
    with annotate("stage2/optimizer"):
        optimizer.step()
    return aux


@torch.no_grad()
def eval_step(network: SupervisedTransformer, encoder: Encoder, seq, cond,
              eps: torch.Tensor, ref: torch.Tensor) -> dict:
    """The loss terms of one batch through the flow's forward kernel (its
    packed weights must be current)."""
    post = posterior(encoder, seq, eps)
    gauss, logdet = network.flow.fused(post, network.embed(cond))
    return flow_loss(gauss, logdet, noise=ref)[1]


def _flow_tree(named: dict[str, torch.Tensor]) -> dict:
    return convert.to_variables(named)["params"]


def _flow_named(tree: dict) -> dict[str, torch.Tensor]:
    return convert.to_state_dict({"params": tree})


def network_variables(network: SupervisedTransformer, embedder_tree: dict | None) -> dict:
    """The JAX package's variables tree of the cINN (host copies):
    ``params/flow``, ``params/embedder`` (``embedder_tree`` as it was loaded,
    or the embedder's own weights) and ``buffers/flow/shuffle``."""
    flow = convert.to_variables(network.flow.state_dict())
    if embedder_tree is None:
        embedder_tree = convert.to_variables(network.embedder.state_dict())["params"]
    return {"params": {"flow": flow["params"], "embedder": embedder_tree},
            "buffers": {"flow": flow["buffers"]}}


def _check_supported(opt) -> None:
    tr = opt.Training
    if tr.get("cache_posteriors") and augment_params(opt, "train")[2]:
        raise ValueError(
            "Training.cache_posteriors requires Data.aug: false — cached (mu, logvar) are only "
            "valid when the training frames are deterministic across epochs (the reference "
            "re-augments every epoch; this opt-in lever trades augmentation for an encoder-free "
            "step, see train/posterior_cache.py).")


def train(opt, models: Stage2Models, train_loader, eval_loader, *, device=None,
          max_steps: int | None = None, eval_fvd: bool = True, draws: Draws | None = None,
          guard: PreemptionGuard | None = None, weights_root: str = "models") -> dict:
    """The training run over built modules and loaders. ``max_steps`` stops
    after that many steps in all (and cuts the validation to 3 batches), as
    in the JAX package; ``guard`` is polled after every step;
    ``weights_root`` holds the I3D weights of the prior FVD. In a live process
    group the loaders must give each rank its rows (``main`` builds them)."""
    _check_supported(opt)
    device = resolve_device(device)
    n_rank, primary = distributed.world(), distributed.is_primary()
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    draws = draws or Draws()
    tr = opt.Training
    control = bool(tr.get("control", False))
    z_dim = models.config1.Decoder["z_dim"]

    decoder = models.decoder.to(device).eval().requires_grad_(False)
    encoder = models.encoder.to(device).eval().requires_grad_(False)
    network = models.network.to(device).eval()
    network.embedder.requires_grad_(False)
    bf16 = str(tr.get("compute_dtype", "float32")) in ("bfloat16", "bf16")
    step_encoder = copy.deepcopy(encoder).to(torch.bfloat16) if bf16 else encoder
    cache_dtype = torch.bfloat16 if bf16 else None
    names = [n for n, _ in network.flow.named_parameters()]
    optimizer = adam_torch([p for _, p in network.flow.named_parameters()], tr["lr"],
                           betas=(tr["beta1"], tr["beta2"]), weight_decay=tr["weight_decay"],
                           amsgrad=bool(tr["amsgrad"]))

    img = opt.Data["img_size"]
    params_aug, random_crop, aug_on = augment_params(opt, "train")
    aug_train = build_augment(img, params_aug, random_crop, aug_on)
    aug_eval = build_augment(img, params_aug, random_crop, False)

    # ---- logging ---------------------------------------------------------
    dt = datetime.now()
    run_name = "Stage2_{}_Date-{}-{}-{}-{}-{}-{}_{}".format(
        opt.Data["dataset"], dt.year, dt.month, dt.day, dt.hour, dt.minute, dt.second,
        tr["savename"])
    save_path = os.path.join(tr["save_path"] or ".", run_name)
    tr["save_path"] = save_path
    if primary:  # rank 0 alone touches the filesystem
        os.makedirs(os.path.join(save_path, "videos"), exist_ok=True)
        cfg.save(opt, os.path.join(save_path, "config_stage2.yaml"))
    wandb_sink = WandbSink()
    wandb_sink.init(opt.get("Logging"), opt, save_path, tr["savename"])
    loss_track_train = Logging(LOGGING_KEYS[:-1])
    loss_track_test = Logging(LOGGING_KEYS[:-1])
    header = ["Epoch", "Time", "LR"] + LOGGING_KEYS
    full_log_train = CSVlogger(os.path.join(save_path, "log_per_epoch_train.csv"), header)
    full_log_eval = CSVlogger(os.path.join(save_path, "log_per_epoch_eval.csv"), header)

    lr_ctrl = LRController(tr["lr"], "step", gamma=tr["gamma"], step_size=tr["step_size"])
    actnorm_done = False
    # 999 is the reference's FVD-scale gate; the eval-NLL fallback compares
    # against inf, so that the first epoch always writes cINN.msgpack
    best_PFVD = 999.0 if eval_fvd else float("inf")
    global_step = 0
    start_epoch = 0
    if tr.get("reload_path"):
        latest = ckpt_io.find(os.path.join(tr["reload_path"], "cINN_latest"))
        if latest:
            payload = ckpt_io.load(latest)
            vars_in = ckpt_io.variables(payload, latest)
            network.load_state_dict(convert.to_state_dict(vars_in))
            models.embedder_tree = vars_in["params"]["embedder"]
            if "optim_state_dict" in payload:
                load_optax_state(optimizer, payload["optim_state_dict"], names, _flow_named)
            start_epoch = int(payload.get("epoch", 0))
            for _ in range(start_epoch):
                lr_ctrl.step()
            set_lr(optimizer, lr_ctrl.lr)
            actnorm_done = True
    network.flow.pack_kernel_weights(torch.float32)
    if n_rank > 1:
        distributed.require_mesh_divisible(n_rank, bs=tr["bs"], bs_eval=tr["bs_eval"])
    # the builds above differ in time between ranks: enter the collectives together
    distributed.barrier("stage2-build")

    moments = windex = None
    if tr.get("cache_posteriors"):
        train_ds, seq_length = train_loader.dataset, opt.Data["sequence_length"]
        windex = WindowIndex(train_ds, seq_length)
        # each rank encodes its share of the unique videos, when each has one
        shard = ((distributed.rank(), n_rank) if n_rank <= len(windex.rep_entries)
                 else (0, 1))
        t_cache = time.time()
        moments = build_cache(
            step_encoder, train_ds, seq_length, aug_train,
            make_clip_reader(train_ds, train_loader.framestore, tr["workers"]),
            videos_per_dispatch=int(tr.get("cache_videos_per_dispatch", 32)), shard=shard)
        if shard[1] > 1:
            distributed.barrier("stage2-cache-build")
            moments = assemble_cache_multiprocess(moments)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        n_w, _, z_c = moments.shape
        print(f"posterior cache: {n_w} windows x 2 x {z_c} fp32 ({n_w * 2 * z_c * 4 / 1e6:.1f} "
              f"MB on {device}; oversampling dedup {windex.duplication:.1f}x) built in "
              f"{time.time() - t_cache:.1f} s")

    dump_warned = []

    def warn_dump_once(e: Exception) -> None:
        if not dump_warned:
            warnings.warn(f"per-epoch sample-video dump failed (reported once a run): {e!r}")
            dump_warned.append(e)

    def rows(x):
        """This rank's rows of a draw made for the global batch."""
        return distributed.local_rows(x)

    def batch_on_device(batch, augment, aug_draws=None):
        seq = augment(torch.from_numpy(batch["seq_raw"]).to(device), draws=aug_draws)
        cond_pos = torch.as_tensor(batch["cond"]).to(device) if control else None
        return seq, conditioning(seq, cond_pos)

    writer = ckpt_io.AsyncWriter()
    PFVD = float("nan")
    try:
        for epoch in range(start_epoch, tr["n_epochs"]):
            epoch_time = time.time()
            lr = get_lr(optimizer)

            # ---------------- train ----------------
            loss_track_train.reset()
            for i, batch in enumerate(train_loader.epoch_iter(epoch)):
                n = batch["seq_raw"].shape[0] * n_rank  # the global batch's draws
                if moments is None:
                    seq, cond = batch_on_device(batch, aug_train, rows(draws.augment(
                        epoch, i, global_step, n, params_aug, random_crop)))
                else:  # the augment is deterministic: no draws
                    seq, cond = batch_on_device(batch, aug_train)
                    wids = _window_ids(windex, train_loader, batch, device)
                if not actnorm_done:
                    eps0 = rows(draws.normal("actnorm", epoch, i, global_step, (n, z_dim)))
                    post = (posterior(encoder, seq, eps0) if moments is None
                            else cached_posterior(moments, wids, eps0))
                    network.init_actnorm(post, cond)
                    optimizer.reset()
                    set_lr(optimizer, lr_ctrl.lr)
                    actnorm_done = True
                eps = rows(draws.normal("posterior", epoch, i, global_step, (n, z_dim)))
                ref = rows(draws.normal("reference", epoch, i, global_step, (n, z_dim)))
                if moments is None:
                    aux = train_step(network, optimizer, step_encoder, seq, cond, eps, ref)
                else:
                    aux = cached_train_step(network, optimizer, moments, wids, cond, eps, ref,
                                            cache_dtype)
                aux = distributed.mean_scalars(aux)  # the global batch's losses
                loss_track_train.append(aux)
                wandb_sink.log({f"train_{k}": v for k, v in aux.items()})
                global_step += 1
                if max_steps and global_step >= max_steps:
                    break
                if guard is not None and distributed.any_rank(guard.should_stop):
                    break
            network.flow.pack_kernel_weights(torch.float32)  # the kernels read the new flow

            # ---------------- eval ----------------
            loss_track_test.reset()
            eval_auxs = []
            for i, batch in enumerate(eval_loader.epoch_iter(epoch)):
                n = batch["seq_raw"].shape[0] * n_rank
                seq, cond = batch_on_device(batch, aug_eval)
                eval_auxs.append(eval_step(
                    network, step_encoder, seq, cond,
                    rows(draws.normal("eval_posterior", epoch, i, global_step, (n, z_dim))),
                    rows(draws.normal("eval_reference", epoch, i, global_step, (n, z_dim)))))
                if max_steps and i >= 2:
                    break
            for aux in eval_auxs:
                aux = distributed.mean_scalars(aux)
                loss_track_test.append(aux)
                wandb_sink.log({f"eval_{k}": v for k, v in aux.items()})

            # ---------------- FVD(prior) + checkpoints ----------------
            PFVD = float("nan")
            if eval_fvd:
                try:
                    PFVD = evaluate_FVD_prior(
                        eval_loader, aug_eval, network, decoder, z_dim, opt, epoch,
                        models.config1.get("Training", {}).get("FVD", "FVD"), control,
                        weights_root=weights_root,
                        residual=lambda i, shape: rows(draws.prior(
                            epoch, i, (shape[0] * n_rank,) + tuple(shape[1:]))),
                        on_dump_error=warn_dump_once, wandb_sink=wandb_sink)
                    wandb_sink.log({"FVD": PFVD})
                except FileNotFoundError as e:
                    warnings.warn(
                        "prior-FVD evaluation disabled for the rest of this run: I3D weights "
                        f"not found ({e}); best-checkpoint selection falls back to eval loss "
                        "and the PFVD CSV column stays NaN.")
                    eval_fvd = False
                    if best_PFVD == 999.0:
                        best_PFVD = float("inf")

            if primary:  # the ranks' weights are the same: rank 0's files describe the run
                net_vars_out = network_variables(network, models.embedder_tree)
                opt_host = optax_state(optimizer, names, _flow_tree)
            metric = PFVD if PFVD == PFVD else loss_track_test.log()[0]
            if metric < best_PFVD:
                if primary:
                    writer.save_async(os.path.join(save_path, "cINN.msgpack"),
                                      ckpt_io.get_save_dict(net_vars_out, opt_host, epoch))
                best_PFVD = metric
            if primary:
                writer.save_async(os.path.join(save_path, "cINN_latest.msgpack"),
                                  ckpt_io.get_save_dict(net_vars_out, opt_host, epoch))

            epoch_dt = time.time() - epoch_time
            full_log_train.write([epoch, epoch_dt, lr, *loss_track_train.log(), PFVD])
            full_log_eval.write([epoch, epoch_dt, lr, *loss_track_test.log(), PFVD])
            set_lr(optimizer, lr_ctrl.step())
            if max_steps and global_step >= max_steps:
                break
            if guard is not None and distributed.any_rank(guard.should_stop):
                break
    finally:
        writer.wait()
    return {
        "save_path": save_path,
        "best_metric": best_PFVD,
        "train_loss": loss_track_train.log(),
        "eval_loss": loss_track_test.log(),
        "PFVD": PFVD,
        "global_step": global_step,
    }


def _window_ids(windex: WindowIndex, loader, batch: dict, device) -> torch.Tensor:
    if "index" not in batch:
        raise ValueError("Training.cache_posteriors: the train loader must yield each window's "
                         "index and start (Loader(..., with_meta=True))")
    ids = windex.ids(loader.dataset, batch["index"], batch["start"])
    return torch.from_numpy(ids).to(device)


def main(opt, max_steps: int | None = None, eval_fvd: bool = True, device=None,
         draws: Draws | None = None) -> dict:
    """Train from the directories ``opt`` chains to, on ``device`` (``cuda``
    unless the caller passes another; in a multi-process run, each rank's
    card); ``draws`` replaces the run's draws."""
    device = resolve_device(device)
    _check_supported(opt)  # before any model is built
    tr = opt.Training
    rank, n_rank = distributed.maybe_initialize(tr.get("distributed"), device)
    if n_rank > 1:
        device = distributed.rank_device(device)
    guard = PreemptionGuard()
    try:
        maybe_enable_debug_nans()
        models = build_models(opt)
        cached = bool(tr.get("cache_posteriors", False))
        dataset_cls = get_loader(opt.Data["dataset"], control=bool(tr.get("control", False)))
        fs_spec = opt.Data.get("framestore", "off")
        loaders = {}
        for mode, bs, seed in (("train", tr["bs"], 42), ("eval", tr["bs_eval"], 43)):
            ds = dataset_cls(opt, mode=mode)
            lean = cached and mode == "train"  # one conditioning frame and the window's id
            loaders[mode] = Loader(ds, bs, workers=tr["workers"], drop_last=False, seed=seed,
                                   framestore=open_or_build(ds, fs_spec, mode),
                                   process_index=rank, process_count=n_rank,
                                   tail_multiple=n_rank if n_rank > 1 else None,
                                   frames_per_item=1 if lean else None, with_meta=lean)
        return train(opt, models, loaders["train"], loaders["eval"], device=device,
                     max_steps=max_steps, eval_fvd=eval_fvd, draws=draws, guard=guard)
    finally:
        guard.restore()

