"""Dataset indexers: directory walks + temporal window sampling (port of
``data/datasets.py``; numpy only, with the port's own copy of ``splits/``).

Semantics of the reference dataloaders (``data/dataloader_*.py``):

  * BAIR: tree ``<root>/<mode>/traj_*/<n>/<k>.png``, 30 frames per clip;
    random temporal start at train, start=0 at test.
  * BAIR endpoint: same, plus per-clip ``endeffector_positions.csv``
    normalised with the reference's hard-coded min/max constants; the cond is
    the position of the *last* frame of the sampled window.
  * iPER: video list from ``splits/iPER/{train,val}.txt`` with
    ``iter_mode x int(vid[-1])`` oversampling; frames named ``frame_<k>.png``;
    the evaluation split has fixed length 1000.
  * Landscape: split lists, ``sky_train``/``sky_test`` prefixes,
    ``frame<k>.jpg`` names, ``iter_<mode>`` repeats.
  * DTDB: per-texture subdir, configurable image format, eval start=0.

These are host-side index structures only; decoding and batching live in
``loader.py``, augmentation runs on the batch's device (``augment.py``).
"""

from __future__ import annotations

import glob
import os

import numpy as np

_SPLIT_DIR = os.path.join(os.path.dirname(__file__), "splits")

# reference dataloader_bair_endpoint.py:14
_BAIR_POS_MIN = np.asarray([0.42638585, -0.3080245, 0.19146784])
_BAIR_POS_MAX = np.asarray([0.42850533, 0.54029283, 0.12564658])


class VideoDataset:
    """Common interface: ``len()``, ``sample(idx, rng) -> dict`` with
    'paths' (list of frame file paths), 'start', 'index' and optional 'cond'."""

    videos: list
    num_frames: list
    seq_length: int
    deterministic_start: bool

    def __len__(self) -> int:
        return len(self.videos)

    def frame_path(self, video, frame: int) -> str:
        raise NotImplementedError

    def video_of(self, idx: int) -> int:
        """Position in ``self.videos`` backing dataset index ``idx`` (identity
        except for fixed-length eval wrappers); the framestore maps sampler
        indices onto packed videos with it."""
        return idx

    def _start(self, idx: int, rng: np.random.Generator) -> int:
        n = self.num_frames[idx]
        if self.deterministic_start:
            return 0
        return int(rng.integers(0, n - self.seq_length + 1))

    def sample(self, idx: int, rng: np.random.Generator) -> dict:
        video = self.videos[idx]
        start = self._start(idx, rng)
        paths = [self.frame_path(video, start + i) for i in range(self.seq_length)]
        return {"paths": paths, "start": start, "index": idx}


class BairDataset(VideoDataset):
    frames_per_clip = 30

    def __init__(self, opt, mode: str):
        self.data_path = opt.Data["data_path"]
        self.mode = mode
        self.seq_length = opt.Data["sequence_length"]
        self.deterministic_start = mode == "test"
        self.videos = []
        mode_dir = os.path.join(self.data_path, mode)
        for vid in sorted(os.listdir(mode_dir)):
            for svid in sorted(os.listdir(os.path.join(mode_dir, vid))):
                self.videos.append(os.path.join(mode, vid, svid))
        self.num_frames = [self.frames_per_clip] * len(self.videos)

    def frame_path(self, video, frame):
        return os.path.join(self.data_path, video, f"{frame}.png")


class BairEndpointDataset(BairDataset):
    def __init__(self, opt, mode: str):
        super().__init__(opt, mode)
        self.positions = []
        for video in self.videos:
            pos = np.loadtxt(
                os.path.join(self.data_path, video, "endeffector_positions.csv"),
                delimiter=",",
            )
            self.positions.append((pos - _BAIR_POS_MIN) / _BAIR_POS_MAX)
        self.positions = np.asarray(self.positions)

    def sample(self, idx, rng):
        out = super().sample(idx, rng)
        out["cond"] = self.positions[idx, out["start"] + self.seq_length - 1].astype(
            np.float32
        )
        return out


class IperDataset(VideoDataset):
    def __init__(self, opt, mode: str):
        self.data_path = opt.Data["data_path"]
        self.seq_length = opt.Data["sequence_length"]
        self.deterministic_start = False
        split_file = "train.txt" if mode == "train" else "val.txt"
        names = _read_split(os.path.join(_SPLIT_DIR, "iPER", split_file))
        self.videos, self.num_frames = [], []
        for vid in names:
            vid = vid.replace("/", "_")
            n = len(glob.glob(os.path.join(self.data_path, vid, "*.png")))
            if n < self.seq_length:
                continue
            # oversampling: iter_<mode> x int(vid[-1]) repeats
            for _ in range(opt.Data[f"iter_{mode}"]):
                for _ in range(int(vid[-1])):
                    self.videos.append(vid)
                    self.num_frames.append(n)

    def frame_path(self, video, frame):
        return os.path.join(self.data_path, video, f"frame_{frame}.png")


class IperEvaluation(VideoDataset):
    """Fixed-length (1000) random-window eval set over the test split."""

    def __init__(self, seq_length: int, img_size: int, path: str):
        self.data_path = path
        self.seq_length = seq_length
        self.deterministic_start = False
        names = _read_split(os.path.join(_SPLIT_DIR, "iPER", "test.txt"))
        self.videos, self.num_frames = [], []
        for vid in names:
            vid = vid.replace("/", "_")
            n = len(glob.glob(os.path.join(path, vid, "*.png")))
            if n < seq_length:
                continue
            self.videos.append(vid)
            self.num_frames.append(n)
        self.num_videos = len(self.videos)
        self.length = 1000

    def __len__(self):
        return self.length

    def frame_path(self, video, frame):
        return os.path.join(self.data_path, video, f"frame_{int(frame)}.png")

    def video_of(self, idx):
        return idx % self.num_videos

    def sample(self, idx, rng):
        true_idx = idx % self.num_videos
        video = self.videos[true_idx]
        n = self.num_frames[true_idx]
        start = int(rng.integers(0, n - self.seq_length + 1))
        paths = [self.frame_path(video, start + i) for i in range(self.seq_length)]
        return {"paths": paths, "start": start, "index": idx}


class LandscapeDataset(VideoDataset):
    def __init__(self, opt, mode: str):
        self.data_path = opt.Data["data_path"]
        self.prefix = "sky_train" if mode != "test" else "sky_test"
        self.seq_length = opt.Data["sequence_length"]
        self.deterministic_start = False
        names = _read_split(os.path.join(_SPLIT_DIR, "landscape", f"{mode}.txt"))
        self.videos, self.num_frames = [], []
        for vid in names:
            n = len(
                glob.glob(os.path.join(self.data_path, self.prefix, vid, "*.jpg"))
            )
            for _ in range(opt.Data[f"iter_{mode}"]):
                self.videos.append(os.path.join(self.prefix, vid))
                self.num_frames.append(n)

    def frame_path(self, video, frame):
        return os.path.join(self.data_path, video, f"frame{int(frame)}.jpg")


class DTDBDataset(VideoDataset):
    def __init__(self, opt, mode: str):
        self.mode = "train" if mode == "train" else "eval"
        self.seq_length = opt.Data["sequence_length"]
        self.deterministic_start = self.mode != "train"
        self.data_path = os.path.join(
            opt.Data["data_path"], opt.Data["texture"], self.mode
        )
        self.img_format = opt.Data["image_format"]
        self.videos, self.num_frames = [], []
        for vid in sorted(os.listdir(self.data_path)):
            n = len(
                glob.glob(os.path.join(self.data_path, vid, f"*.{self.img_format}"))
            )
            for _ in range(opt.Data[f"iter_{mode}"]):
                self.videos.append(vid)
                self.num_frames.append(n)

    def frame_path(self, video, frame):
        return os.path.join(self.data_path, video, f"frame{frame}.{self.img_format}")


def _read_split(path: str) -> list[str]:
    with open(path) as f:
        return f.read().split()
