"""Diversity scores over whole sets of realisations (port of
``metrics/diversity.py``): the mean pairwise distance between the
realisations of each video, with the reference's protocol
(``metrics/Diversity/``):

* VGG: per-frame ImageNet-normalised VGG16 feature maps at 224 px, the mean
  squared difference at each of the 5 slices for every ordered pair of
  realisations (squared means, as in the reference), averaged over videos,
  slices and pairs.
* I3D: the videos regrouped x16 (``input_b`` floored to a multiple of 16),
  kinetics-I3D logits in batches of 16, pairwise over realisations.
* DT-I3D: the DTDB I3D's representation, the 16- or 32-frame net by the
  clip length (16 frames tiled 3x in time), in batches of 20; the score
  x1000.

Inputs are the eval CLI's layout, (B, n_realiz, T, C, H, W) in [-1, 1], a
tensor on any device or a numpy array, held in memory whole: these are the
library counterparts of ``streaming_eval.DiversityStream``, which the eval
CLI runs batch by batch. The work runs on ``device`` (``cuda`` unless the
caller passes another). Without ``vgg_variables`` the VGG is the stream's,
random from ``streaming_eval.VGG_INIT_SEED`` (ROADMAP §C); the I3D weights
are read from under ``weights_root``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.facade import resolve_device
from ..ops.resize import resize_bilinear
from ..utils import convert
from . import fvd as fvd_mod
from .streaming_eval import _IMAGENET_MEAN, _IMAGENET_STD, DiversityStream, vgg_features


def _check_signed(videos: torch.Tensor) -> None:
    if not float(videos.min()) < 0:
        raise ValueError("the I3D diversities take videos in [-1, 1]")


@torch.inference_mode()
def compute_vgg_diversity(videos, vgg_variables: dict | None = None, device=None) -> float:
    """``vgg_variables``: a variables tree of the JAX package's
    ``VGG16Features`` (carried over by the weight bridge), else the stream's
    seeded random VGG."""
    device = resolve_device(device)
    videos = torch.as_tensor(videos)
    if not (float(videos.min()) < 0 and float(videos.max()) <= 1.0):
        raise ValueError("the VGG diversity takes videos in [-1, 1]")
    if vgg_variables is None:
        vgg = vgg_features(device)
    else:
        from ..models.backbones.vgg16 import VGG16Features

        vgg = VGG16Features()
        vgg.load_state_dict(convert.to_state_dict(vgg_variables))
        vgg = vgg.to(device).eval()
    n_samples, t = videos.shape[1:3]
    mean = torch.tensor(_IMAGENET_MEAN, device=device).view(1, 3, 1, 1)
    std = torch.tensor(_IMAGENET_STD, device=device).view(1, 3, 1, 1)
    div = []
    for video in videos:  # (n_samples, T, C, H, W)
        frames = (video.to(device, torch.float32).flatten(0, 1) + 1.0) / 2.0
        fmaps = vgg(resize_bilinear((frames - mean) / std, (224, 224)))
        pairs = []
        for fmap in fmaps:
            f = fmap.reshape((n_samples, t) + fmap.shape[1:])
            pairs += [(f[i] - f[j]).square().mean()
                      for i in range(n_samples) for j in range(n_samples) if i != j]
        div += torch.stack(pairs).cpu().tolist()
    return float(np.mean(div))


def compute_I3D_diversity(seq1, n_samples: int, weights_root: str = "models",
                          device=None) -> float:
    seq1 = torch.as_tensor(seq1)
    _check_signed(seq1)
    input_b = seq1.shape[0] // 16 * 16
    flat = seq1[:input_b].flatten(0, 1)  # (input_b * n_samples, T, C, H, W), x16 groups
    model = fvd_mod.load_model("kinetics", weights_root, device)
    embed = fvd_mod.get_activations(model, flat, batch_size=16)
    return DiversityStream._pairwise(embed.reshape(input_b, n_samples, -1), n_samples)


def compute_DTI3D_diversity(seq1, weights_root: str = "models", device=None) -> float:
    seq1 = torch.as_tensor(seq1)
    _check_signed(seq1)
    length, n_samples = seq1.shape[2], seq1.shape[1]
    model = fvd_mod.load_model("dt32" if length > 16 else "dt16", weights_root, device)
    embeds = []
    for s in range(n_samples):
        vids = seq1[:, s]
        if length <= 16:
            vids = fvd_mod.prep_dt_time(vids, 16)
        embeds.append(fvd_mod.get_activations(model, vids, batch_size=20))
    return DiversityStream._pairwise(np.stack(embeds, axis=1), n_samples) * 1000
