"""Training-time FVD (port of ``train/fvd_eval.py``): of samples from the
prior for stage 2 (``evaluate_FVD_prior``), of reconstructions from the
posterior for stage 1 (``evaluate_FVD_posterior``).

Each eval batch is augmented (the eval transform), nu is drawn by the
caller (the trainer seeds it by the epoch, as the JAX package draws from
``PRNGKey(epoch)``: the same nu for every batch of one size), mapped to z
by the flow's reverse chain through the kernel from its packed weights, and
decoded from the batch's first frame. I3D activations of the generated clips
and of the real frames after the first are streamed on the device
(``metrics/fvd.py``); the score is their Fréchet distance. A missing I3D
file raises ``FileNotFoundError``. Ten sampled clips, picked among the first
40, are written beside the real ones as a GIF; that dump is best effort, as
in the JAX package (``imageio`` may be missing), and its failure goes to
``on_dump_error`` (a warning by default).

``evaluate_FVD_posterior`` reconstructs each augmented eval batch: the
encoder's posterior sample of frames 1: with one fixed eps (the caller's
``noise``: the JAX package draws it from ``PRNGKey(1)`` for every batch),
decoded from frame 0, scored against frames 1:.
"""

from __future__ import annotations

import warnings
from typing import Callable

import numpy as np
import torch

from ..metrics import fvd as fvd_mod
from ..metrics.frechet import frechet_from_activations


def _stream_fvd(run, loader, model: fvd_mod.I3DModel, keep_clips: int = 0):
    """Activations of ``run(i, batch) -> (generated, real)`` over the loader's
    batches, each (B, T, C, H, W) on the model's device; host copies of the
    first ``keep_clips`` clips of each for the video dump. Returns (act1,
    act2, host generated, host real), numpy."""
    act_fn = fvd_mod.activation_fn(model, (-1.0, 1.0))
    dt_len = {"dt16": 16, "dt32": 32}.get(model.kind)
    acts_g, acts_o, host_g, host_o, kept = [], [], [], [], 0
    for i, batch in enumerate(loader.epoch_iter(0)):
        g, o = run(i, batch)
        if kept < keep_clips:
            host_g.append(g.cpu())
            host_o.append(o.cpu())
            kept += int(g.shape[0])
        if dt_len is not None:
            g, o = fvd_mod.prep_dt_time(g, dt_len), fvd_mod.prep_dt_time(o, dt_len)
        acts_g.append(act_fn(g))
        acts_o.append(act_fn(o))
    act1 = torch.cat(acts_g).cpu().numpy()
    act2 = torch.cat(acts_o).cpu().numpy()
    host_g = torch.cat(host_g).numpy() if host_g else None
    host_o = torch.cat(host_o).numpy() if host_o else None
    return act1, act2, host_g, host_o


def _warn_dump(e: Exception) -> None:
    warnings.warn(f"per-epoch sample-video dump failed: {e!r}")


def evaluate_FVD_prior(loader, aug, network, decoder, z_dim: int, opt, epoch: int,
                       mode: str = "FVD", control: bool = False, weights_root: str = "models", *,
                       residual: Callable[[int, tuple], torch.Tensor],
                       on_dump_error: Callable[[Exception], None] = _warn_dump,
                       wandb_sink=None) -> float:
    """FVD (``mode`` 'FVD', kinetics I3D) or DTFVD ('DTFVD', DT-16) of
    samples from the prior against the eval split. ``network`` is the
    ``SupervisedTransformer`` with its flow's packed weights current;
    ``residual(i, shape)`` draws batch ``i``'s nu on the CPU (the trainer's
    ``Draws.prior``)."""
    device = next(decoder.parameters()).device
    model = fvd_mod.load_model("kinetics" if mode == "FVD" else "dt16", weights_root, device)

    @torch.no_grad()
    def run(i: int, batch: dict):
        seq = aug(torch.from_numpy(batch["seq_raw"]).to(device))  # (B, T, H, W, 3)
        b = seq.shape[0]
        x0 = seq[:, 0].permute(0, 3, 1, 2)
        cond = [x0] + ([torch.as_tensor(batch["cond"]).to(device)] if control else [])
        res = residual(i, (b, z_dim)).to(device, torch.float32)
        z = network.flow.fused(res, network.embed(cond), reverse=True).reshape(b, -1)
        return decoder(x0, z).permute(0, 2, 1, 3, 4), seq[:, 1:].permute(0, 1, 4, 2, 3)

    act1, act2, gen, orig = _stream_fvd(run, loader, model, keep_clips=40)
    try:
        from ..utils.video import plot_vid

        pick = torch.Generator().manual_seed(epoch)
        sel = torch.randint(0, gen.shape[0], (min(10, gen.shape[0]),), generator=pick).numpy()
        gif = plot_vid(opt, [gen[sel], orig[sel]], epoch, mode="eval")
        if wandb_sink is not None:
            wandb_sink.log_video("eval_video", gif)
    except Exception as e:  # the GIF dump is best effort, as in the JAX package
        on_dump_error(e)
    return float(frechet_from_activations(np.asarray(act1), np.asarray(act2)))


def evaluate_FVD_posterior(loader, aug, decoder, encoder, mode: str = "FVD",
                           weights_root: str = "models", *,
                           noise: Callable[[tuple], torch.Tensor]) -> float:
    """FVD (kinetics I3D) or DTFVD (DT-16) of stage-1 reconstructions against
    the eval split; ``noise(shape)`` gives the encoder's eps on the CPU."""
    device = next(decoder.parameters()).device
    model = fvd_mod.load_model("kinetics" if mode == "FVD" else "dt16", weights_root, device)

    @torch.no_grad()
    def run(i: int, batch: dict):
        seq = aug(torch.from_numpy(batch["seq_raw"]).to(device))  # (B, T, H, W, 3)
        video = seq.permute(0, 4, 1, 2, 3)
        motion = encoder(video[:, :, 1:], noise=noise((seq.shape[0], encoder.z_dim)))[0]
        return (decoder(video[:, :, 0], motion).permute(0, 2, 1, 3, 4),
                video[:, :, 1:].permute(0, 2, 1, 3, 4))

    act1, act2, _, _ = _stream_fvd(run, loader, model)
    return float(frechet_from_activations(np.asarray(act1), np.asarray(act2)))
