"""Streaming accumulators for the offline eval CLIs (port of
``metrics/streaming_eval.py``).

Each batch of clips is reduced on the device to backbone activation rows,
which alone are kept on the host; ``results()`` applies the reference's
reductions, including its deliberate tail-dropping populations:

  * FID: InceptionV3 rows per frame; the first ``(N // bs) * bs`` frames with
    ``bs = min(50, N)``.
  * LPIPS: per-frame distances; the mean of the means of batches of exactly
    10, the tail dropped.
  * DTFVD: DT-I3D rows per clip (16 frames: tiled x3); the first
    ``(N // bs) * bs`` clips with ``bs = min(40, N)``.
  * FVD: kinetics-I3D logit rows per clip; the first ``(N // 16) * 16``
    clips (the x16 grouping).
  * Diversity: VGG pairwise means per video, level and ordered pair of
    realisations; I3D rows (x16 population); DT-I3D rows (the
    ``min(20, N)`` population, reported x1000).

The VGG diversity compares every pair of realisations' feature maps on the
device and brings back one scalar per (level, i, j); the JAX package copies
each feature map to the host, about 1 GB per video at 224 px for relu1_2 and
80 frames. Its VGG runs with random weights, as the JAX package's does; the
port draws them from a fixed torch seed (``VGG_INIT_SEED``), which cannot
reproduce JAX's ``PRNGKey(0)`` (ROADMAP §C).

Clips are the port's layout, (B, T, C, H, W) in [-1, 1], tensors on any
device or numpy arrays; the work runs on the stream's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.facade import resolve_device
from ..ops.resize import resize_bilinear
from . import fid as fid_mod
from . import fvd as fvd_mod
from . import lpips_eval as lpips_mod
from .frechet import frechet_from_activations

VGG_INIT_SEED = 0
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg_features(device) -> torch.nn.Module:
    """The diversity metric's VGG16 trunk, randomly initialised from
    ``VGG_INIT_SEED``, on ``device`` in eval mode."""
    from ..models.backbones.vgg16 import VGG16Features

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(VGG_INIT_SEED)
        vgg = VGG16Features()
    return vgg.to(device).eval()


class _Pairs:
    """Accumulated (fake, real) activation rows, on the host."""

    def __init__(self):
        self.fake: list[np.ndarray] = []
        self.real: list[np.ndarray] = []

    def add(self, f: torch.Tensor, r: torch.Tensor | None = None) -> None:
        self.fake.append(f.float().cpu().numpy())
        if r is not None:
            self.real.append(r.float().cpu().numpy())

    def cat(self):
        return np.concatenate(self.fake, 0), np.concatenate(self.real, 0)

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.fake) + sum(a.nbytes for a in self.real)


def _tail_drop(n: int, ref_bs: int) -> int:
    bs = min(ref_bs, n)
    return (n // bs) * bs if n else 0


class SynthesisQualityStream:
    """``add_batch(fake, real)`` takes the clips AFTER the dataset-specific
    frame concatenation and reduces them to activation rows at once;
    ``results()`` applies the reference reductions."""

    def __init__(self, want_fid=False, want_lpips=False, want_fvd=False,
                 want_dtfvd=False, seq_length: int = 16, weights_root: str = "models",
                 device=None):
        self.device = resolve_device(device)
        self._acc: dict[str, _Pairs] = {}
        self.inception = self.lpips = self.i3d = self.dt = None
        if want_fid:
            self.inception = fid_mod.load_inception(weights_root, self.device)
            self._acc["FID"] = _Pairs()
        if want_lpips:
            self.lpips = lpips_mod.load_lpips(weights_root, self.device)
            self._acc["LPIPS"] = _Pairs()  # fake column only: the distances
        if want_fvd:
            self.i3d = fvd_mod.activation_fn(fvd_mod.load_model("kinetics", weights_root,
                                                                self.device))
            self._acc["FVD"] = _Pairs()
        if want_dtfvd:
            self.dt_len = 32 if seq_length > 16 else 16
            self.dt = fvd_mod.activation_fn(
                fvd_mod.load_model(f"dt{self.dt_len}", weights_root, self.device))
            self._acc["DTFVD"] = _Pairs()

    @torch.inference_mode()
    def add_batch(self, fake, real) -> None:
        fake = torch.as_tensor(fake).to(self.device, torch.float32)
        real = torch.as_tensor(real).to(self.device, torch.float32)
        if fake.shape != real.shape:
            raise ValueError(f"fake {tuple(fake.shape)} and real {tuple(real.shape)} differ")
        ff, rf = fake.flatten(0, 1), real.flatten(0, 1)  # frames (B*T, C, H, W)
        if self.inception is not None:
            self._acc["FID"].add(self.inception(ff), self.inception(rf))
        if self.lpips is not None:
            self._acc["LPIPS"].add(self.lpips(ff, rf).reshape(-1))
        if self.i3d is not None:
            self._acc["FVD"].add(self.i3d(fake), self.i3d(real))
        if self.dt is not None:
            self._acc["DTFVD"].add(self.dt(fvd_mod.prep_dt_time(fake, self.dt_len)),
                                   self.dt(fvd_mod.prep_dt_time(real, self.dt_len)))

    def activations(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        """All (fake, real) rows accumulated for ``name`` ('FID', 'FVD', 'DTFVD')."""
        return self._acc[name].cat()

    def results(self) -> dict[str, float]:
        out: dict[str, float] = {}
        if "FID" in self._acc:
            a1, a2 = self._acc["FID"].cat()
            keep = _tail_drop(a1.shape[0], 50)
            out["FID"] = frechet_from_activations(a1[:keep], a2[:keep])
        if "LPIPS" in self._acc:
            d = np.concatenate(self._acc["LPIPS"].fake, 0)
            n_batches = d.shape[0] // 10
            if n_batches:
                # mean of per-batch-of-10 means (reference eval_synthesis_quality.py:80-92)
                out["LPIPS"] = float(d[: n_batches * 10].reshape(n_batches, 10).mean(axis=1).mean())
            else:
                out["LPIPS"] = float(d.mean()) if d.size else 0.0
        if "FVD" in self._acc:
            a1, a2 = self._acc["FVD"].cat()
            keep = a1.shape[0] // 16 * 16
            out["FVD"] = frechet_from_activations(a1[:keep], a2[:keep])
        if "DTFVD" in self._acc:
            a1, a2 = self._acc["DTFVD"].cat()
            keep = _tail_drop(a1.shape[0], 40)
            out["DTFVD"] = frechet_from_activations(a1[:keep], a2[:keep])
        return out

    @property
    def retained_bytes(self) -> int:
        """Host bytes held by the accumulators: the streaming guarantee."""
        return sum(p.nbytes for p in self._acc.values())


class DiversityStream:
    """``add_batch(stack)`` takes (B, n_realiz, T, C, H, W) in [-1, 1] for one
    eval batch. Retains the VGG pairwise scalars and the I3D/DT-I3D rows."""

    def __init__(self, n_realiz: int, want_vgg=False, want_i3d=False, want_dti3d=False,
                 seq_length: int = 16, weights_root: str = "models", device=None):
        self.device = resolve_device(device)
        self.n = n_realiz
        self._vgg_scores: list[float] | None = [] if want_vgg else None
        self._i3d_rows: list[np.ndarray] | None = [] if want_i3d else None
        self._dt_rows: list[np.ndarray] | None = [] if want_dti3d else None
        self.vgg = vgg_features(self.device) if want_vgg else None
        if want_i3d:
            self.i3d = fvd_mod.activation_fn(fvd_mod.load_model("kinetics", weights_root,
                                                                self.device))
        if want_dti3d:
            self.dt_len = 32 if seq_length > 16 else 16
            self.dt = fvd_mod.activation_fn(
                fvd_mod.load_model(f"dt{self.dt_len}", weights_root, self.device))

    def _vgg_pairs(self, video: torch.Tensor) -> torch.Tensor:
        """One video's realisations (n, T, C, H, W) in [0, 1] -> (5, n, n): the
        mean squared difference of realisations i and j at each VGG level."""
        n, t = video.shape[:2]
        mean = video.new_tensor(_IMAGENET_MEAN).view(1, 3, 1, 1)
        std = video.new_tensor(_IMAGENET_STD).view(1, 3, 1, 1)
        x = resize_bilinear((video.flatten(0, 1) - mean) / std, (224, 224))
        out = video.new_zeros(5, n, n)
        for level, fmap in enumerate(self.vgg(x)):
            f = fmap.reshape((n, t) + fmap.shape[1:])
            for i in range(n):
                out[level, i] = (f[i : i + 1] - f).square_().flatten(1).mean(dim=1)
        return out

    @torch.inference_mode()
    def add_batch(self, stack) -> None:
        stack = torch.as_tensor(stack).to(self.device, torch.float32)
        b, n = stack.shape[:2]
        if n != self.n:
            raise ValueError(f"expected {self.n} realisations, got {n}")
        if self._vgg_scores is not None:
            for video in (stack + 1.0) / 2.0:  # the per-video unit of the reference
                pairs = self._vgg_pairs(video).cpu().numpy()
                self._vgg_scores.extend(float(pairs[level, i, j]) for level in range(5)
                                        for i in range(n) for j in range(n) if i != j)
        flat = stack.flatten(0, 1)  # (B * n, T, C, H, W)
        if self._i3d_rows is not None:
            self._i3d_rows.append(self.i3d(flat).cpu().numpy().reshape(b, n, -1))
        if self._dt_rows is not None:
            rows = self.dt(fvd_mod.prep_dt_time(flat, self.dt_len))
            self._dt_rows.append(rows.cpu().numpy().reshape(b, n, -1))

    @staticmethod
    def _pairwise(embed: np.ndarray, n: int) -> float:
        return float(np.mean([
            np.mean((embed[:, i] - embed[:, j]) ** 2)
            for i in range(n) for j in range(n) if i != j
        ]))

    def results(self) -> dict[str, float]:
        out: dict[str, float] = {}
        if self._vgg_scores is not None:
            out["VGG"] = float(np.mean(self._vgg_scores))
        if self._i3d_rows is not None:
            embed = np.concatenate(self._i3d_rows, 0)  # (B, n, d)
            input_b = embed.shape[0] // 16 * 16  # the x16 grouping population
            out["I3D"] = self._pairwise(embed[:input_b], self.n)
        if self._dt_rows is not None:
            embed = np.concatenate(self._dt_rows, 0)
            keep = (embed.shape[0] // min(20, max(embed.shape[0], 1))) * min(
                20, max(embed.shape[0], 1))
            out["DTI3D"] = self._pairwise(embed[:keep], self.n) * 1000.0
        return out

    @property
    def retained_bytes(self) -> int:
        total = 8 * len(self._vgg_scores) if self._vgg_scores is not None else 0
        for rows in (self._i3d_rows, self._dt_rows):
            if rows is not None:
                total += sum(a.nbytes for a in rows)
        return total
