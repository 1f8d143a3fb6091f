"""Host-side batch loader (port of ``data/loader.py``): threaded decode and
prefetch feeding the device.

A thread pool decodes PNG/JPG frames (or reads windows out of a
``FrameStore``) into uint8 batches, and a small prefetch queue overlaps that
IO with device work; augmentation runs on the batch's device
(``augment.py``). Shuffling and window sampling draw from the same numpy
streams as the JAX ``Loader``: the epoch's order from
``default_rng((seed, epoch))`` and each item's window from
``default_rng((seed, epoch, idx))``, so both loaders give the same batches
bitwise. The posterior-cache input mode (``frames_per_item``,
``with_meta``) reads only the first frames of each sampled window and ships
the window's identity with the batch (``train/posterior_cache.py``).
Multi-process runs (``parallel/distributed.py``): every rank computes the
same global batch order from the shared seed and decodes only its block of
rows of each batch (``process_index``/``process_count``); ``tail_multiple``
drops, with one warning, a last batch that does not divide it.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _imread_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB: cv2 where it is installed, else PIL."""
    try:
        import cv2

        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    except ImportError:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))


class _Failed:
    """A producer's exception, carried through the queue to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class Loader:
    """Iterate dicts: {'seq_raw': uint8 (B,T,H,W,3), 'cond': float32 (B,3)?},
    with ``with_meta`` also 'index' and 'start', int64 (B,).

    ``seed`` drives both shuffling and window sampling so epochs are
    reproducible; ``epoch_iter(epoch)`` reshuffles per epoch. A decode error
    in a worker is raised by the iterator.

    ``frames_per_item`` reads only the first that many frames of each
    sampled window (the posterior cache's conditioning frame): the window's
    start is still drawn from the full window range, so each item sees the
    same random stream as a full-window load of the same (seed, epoch,
    index). ``with_meta`` adds each item's dataset index and window start.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, workers: int = 8, seed: int = 0,
                 prefetch: int = 4, framestore=None, process_index: int = 0,
                 process_count: int = 1, tail_multiple: int | None = None,
                 frames_per_item: int | None = None, with_meta: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.workers = max(1, workers)
        self.seed = seed
        self.prefetch = prefetch
        self.framestore = framestore
        self.process_index = process_index
        self.process_count = process_count
        self.tail_multiple = tail_multiple
        self._warned_tail = False
        self.frames_per_item = frames_per_item
        self.with_meta = with_meta

    def __len__(self) -> int:
        n = len(self.dataset)
        full, rem = n // self.batch_size, n % self.batch_size
        if self.drop_last or not rem:
            return full
        if self.tail_multiple is not None and rem % self.tail_multiple:
            if not self._warned_tail:
                import warnings

                warnings.warn(
                    f"multi-host run: dropping the tail batch of {rem} clips "
                    f"(not divisible by the {self.tail_multiple}-device mesh; "
                    "pad rows cannot be assembled per-process — see "
                    "parallel/distributed.py)")
                self._warned_tail = True
            return full
        return full + 1

    def _load_item(self, idx: int, rng: np.random.Generator):
        item = self.dataset.sample(idx, rng)
        if self.frames_per_item is not None:  # the start was drawn from the full range
            item = dict(item, paths=item["paths"][: self.frames_per_item])
        if self.framestore is not None:
            frames = self.framestore.read_window(item)
        else:
            frames = np.stack([_imread_rgb(p) for p in item["paths"]], axis=0)
        return frames, item.get("cond"), item["index"], item["start"]

    def __iter__(self):
        return self.epoch_iter(0)

    def epoch_iter(self, epoch: int):
        rng = np.random.default_rng((self.seed, epoch))
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng.shuffle(order)
        batches_idx = [order[i * self.batch_size : (i + 1) * self.batch_size]
                       for i in range(len(self))]
        if self.process_count > 1:
            from ..parallel.distributed import host_batch_slice

            batches_idx = [idxs[host_batch_slice(len(idxs), self.process_index,
                                                 self.process_count)]
                           for idxs in batches_idx]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.workers) as pool:
                    for idxs in batches_idx:
                        item_rngs = [np.random.default_rng((self.seed, epoch, int(i)))
                                     for i in idxs]
                        results = list(pool.map(self._load_item, idxs, item_rngs))
                        batch = {"seq_raw": np.stack([r[0] for r in results], axis=0)}
                        if results[0][1] is not None:
                            batch["cond"] = np.stack([r[1] for r in results], axis=0)
                        if self.with_meta:
                            batch["index"] = np.asarray([r[2] for r in results], np.int64)
                            batch["start"] = np.asarray([r[3] for r in results], np.int64)
                        if not put(batch):
                            return
            except Exception as e:  # handed to the consumer, which raises it
                put(_Failed(e))
                return
            put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, _Failed):
                    raise batch.exc
                yield batch
        finally:
            stop.set()
            thread.join(timeout=10)
