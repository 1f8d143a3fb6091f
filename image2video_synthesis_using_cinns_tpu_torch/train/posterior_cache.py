"""Posterior-moment cache for stage-2 training (port of
``train/posterior_cache.py``; ``Training.cache_posteriors``).

A stage-2 step runs the frozen 3-D encoder on every clip of its batch. With
``Data.aug: false`` the encoder's (mu, logvar) of a given (video, window
start) never change, so this module encodes every window of the dataset
once and keeps the moments on the trainer's device: a ``(n_windows, 2, z)``
fp32 tensor, 14 windows x 2 x 64 fp32 per 30-frame BAIR clip (0.7 MB for
100 clips, about 310 MB for the full split of about 43k). A cached step then
gathers its batch's rows by window id and draws the posterior sample
``eps * exp(0.5 * logvar) + mu`` with the step's own eps
(``resample_posterior``), exactly as the encoder draws it: the training
objective is unchanged, only the deterministic forward is amortised. The
step's input drops to one conditioning frame and a window id per clip.

The cache is valid only without train-time augmentation (the reference
re-augments every epoch); the trainer refuses the flag otherwise.

Datasets whose ``videos`` list repeats entries (the iPER, landscape and DTDB
oversampling) are deduplicated: ``WindowIndex`` keys unique videos by
``str(video)``, as the FrameStore's ``video_map`` does, and every repeat
maps onto the same rows, so the cache's size and build time do not depend
on the oversampling factor.

In a multi-process run each rank encodes its share of the unique videos
(``build_cache(shard=(rank, world))``) and ``assemble_cache_multiprocess``
sums the partial tables, zeros off each shard, into the whole one on every
rank: each row has one owner, so the sum is exact.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..data.loader import _imread_rgb
from ..parallel import distributed


class WindowIndex:
    """Window-id table over the unique videos of a dataset.

    Window (unique video u, start s) has the id ``offsets[u] + s``;
    ``n_windows == offsets[-1]``. Repeated entries in ``dataset.videos``
    share one unique video, so their windows share cache rows."""

    def __init__(self, dataset, seq_length: int):
        uniq: dict[str, int] = {}
        reps: list[int] = []  # the first entry of each unique video
        entry_to_uniq = np.empty(len(dataset.videos), np.int64)
        for v, vid in enumerate(dataset.videos):
            key = str(vid)
            if key not in uniq:
                uniq[key] = len(reps)
                reps.append(v)
            entry_to_uniq[v] = uniq[key]
        self.seq_length = seq_length
        self.rep_entries = np.asarray(reps, np.int64)
        self.entry_to_uniq = entry_to_uniq
        counts = np.maximum(
            0, np.asarray([dataset.num_frames[e] for e in reps]) - seq_length + 1)
        self.offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.n_windows = int(self.offsets[-1])
        self.duplication = len(dataset.videos) / max(1, len(reps))

    def ids(self, dataset, indices, starts) -> np.ndarray:
        """A batch's (dataset index, window start) meta -> window ids (int32).

        Checked on the host: a wrong (offsets, video_of) mapping that still
        lands inside the table would train on another window's posterior
        without any error, so every id must lie in ``[0, n_windows)``."""
        entries = np.asarray([dataset.video_of(int(i)) for i in np.asarray(indices)])
        wids = self.offsets[self.entry_to_uniq[entries]] + np.asarray(starts)
        if wids.size and (wids.min() < 0 or wids.max() >= self.n_windows):
            bad = wids[(wids < 0) | (wids >= self.n_windows)]
            raise IndexError(
                f"posterior cache: window ids {bad[:8].tolist()} out of range "
                f"[0, {self.n_windows}): the offsets/video_of mapping is inconsistent with "
                "the cache build (train/posterior_cache.py)")
        return wids.astype(np.int32)


def make_clip_reader(dataset, framestore=None, workers: int = 8):
    """``read(entries, n_frames) -> uint8 (V, n, H, W, 3)``: the first
    ``n_frames`` of each listed entry of ``dataset.videos``, from the packed
    ``framestore`` when given (through its ``video_map``), else decoded on
    ``workers`` threads."""
    if framestore is not None:
        vmap = framestore.index.get("video_map")

        def read(vids, n):
            fvids = [vmap[str(v)] for v in vids] if vmap else list(vids)
            return framestore.read_batch(fvids, [0] * len(fvids), n)

        return read

    def read(vids, n):
        def one(v):
            video = dataset.videos[v]
            return np.stack([_imread_rgb(dataset.frame_path(video, f)) for f in range(n)], 0)

        with ThreadPoolExecutor(max(1, workers)) as pool:
            return np.stack(list(pool.map(one, vids)), 0)

    return read


@torch.no_grad()
def build_cache(encoder, dataset, seq_length: int, augment, read_clips, *,
                videos_per_dispatch: int = 32, shard: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Encode every (video, start) window once: ``(n_windows, 2, z)`` fp32
    (mu, logvar) on the encoder's device, row ``i`` the window of id ``i``.

    ``augment`` is the trainer's train augmentation, which with ``Data.aug:
    false`` is the deterministic resize and normalisation: it runs once on
    each whole clip, whose window slices equal each window augmented alone.
    Window ``s`` is frames ``s + 1 : s + seq_length`` of the clip, as the
    step's encoder sees them. ``encoder`` runs in its own dtype (the step's
    bf16 copy under ``compute_dtype: bfloat16``); the moments are stored in
    fp32. Unique videos are read and encoded ``videos_per_dispatch`` at a
    time, grouped by clip length, one encoder call per window start.

    ``shard=(i, n)`` encodes only the unique videos ``u`` with ``u % n ==
    i`` and leaves the other rows zero, so that the ``n`` partial caches sum
    to the whole one."""
    T = seq_length
    windex = WindowIndex(dataset, T)
    if windex.n_windows == 0:
        raise ValueError("posterior cache: dataset has no full-length windows")
    param = next(encoder.parameters())
    shard_i, shard_n = shard
    by_len: dict[int, list[int]] = {}
    for u, rep in enumerate(windex.rep_entries):
        n = int(dataset.num_frames[rep])
        if n >= T and u % shard_n == shard_i:
            by_len.setdefault(n, []).append(u)
    if not by_len:
        raise ValueError(
            f"posterior cache shard {shard_i}/{shard_n} owns no videos (dataset has "
            f"{len(windex.rep_entries)} unique): build with shard=(0, 1) instead")

    out = None
    for n, uniqs in sorted(by_len.items()):
        n_w = n - T + 1
        for lo in range(0, len(uniqs), videos_per_dispatch):
            chunk = uniqs[lo : lo + videos_per_dispatch]
            raw = read_clips([int(windex.rep_entries[u]) for u in chunk], n)
            x = augment(torch.from_numpy(np.ascontiguousarray(raw)).to(param.device))
            x = x.permute(0, 4, 1, 2, 3).to(param.dtype)  # (V, 3, n, H, W)
            mom = torch.stack([torch.stack(encoder.moments(x[:, :, s + 1 : s + T]), 1)
                               for s in range(n_w)], 1)  # (V, n_w, 2, z)
            if out is None:
                out = torch.zeros((windex.n_windows, 2, mom.shape[-1]), dtype=torch.float32,
                                  device=param.device)
            ids = windex.offsets[chunk][:, None] + np.arange(n_w)[None, :]
            out[torch.from_numpy(ids.reshape(-1)).to(param.device)] = (
                mom.reshape(len(chunk) * n_w, 2, -1).float())
    return out


def assemble_cache_multiprocess(partial: torch.Tensor) -> torch.Tensor:
    """The whole moment table from the ranks' partial ones (zeros off each
    rank's shard), on every rank, on ``partial``'s device: every rank's table
    gathered through the host group (JAX's ``process_allgather``), then
    summed in fp32, where each row adds zeros to its one owner's values, so
    the sum is exact. Callers barrier first: the sharded builds are long and
    communication-free."""
    stacked = distributed.process_allgather(partial.cpu().numpy())
    return torch.from_numpy(stacked.sum(axis=0, dtype=np.float32)).to(partial.device)


def resample_posterior(mu: torch.Tensor, logvar: torch.Tensor, eps: torch.Tensor,
                       dtype: torch.dtype | None = None) -> torch.Tensor:
    """The posterior sample from cached moments, drawn as the encoder draws
    it: with ``dtype`` (the encoder's compute dtype) mu and logvar are cast
    to it, ``eps`` (drawn in fp32 by the caller) is cast to their dtype, and
    ``eps * exp(0.5 * logvar) + mu`` is computed there and returned in fp32."""
    if dtype is not None:
        mu, logvar = mu.to(dtype), logvar.to(dtype)
    eps = eps.to(device=logvar.device, dtype=logvar.dtype)
    return (eps * torch.exp(0.5 * logvar) + mu).float()
