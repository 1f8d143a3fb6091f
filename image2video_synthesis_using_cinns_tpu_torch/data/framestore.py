"""Packed-frame dataset cache (port of ``data/framestore.py``, the Python side
of ``native/framestore.cpp``).

``FrameStore.build`` decodes a video dataset ONCE into a single binary file
(uint8 RGB, video-major); ``FrameStore`` then serves clip windows out of it:
``native/libframestore.so`` (build with ``make -C native``) does a threaded
batch gather over ctypes, and a numpy mmap path beside it serves machines
without the library. The file format is the JAX package's: a 32-byte header
(``MAGIC``, the video count, height, width, channels), ``n_videos + 1``
int64 frame offsets, the frames; and a ``.json`` sidecar with the sizes, the
``video_map`` from sampler index to packed video and the
``dataset_fingerprint``. A store built by either package reads bitwise the
same in the other.

The library is looked up beside the repository (``native/`` next to this
package) when a store is first opened, not when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import struct
import warnings

import numpy as np

MAGIC = b"FSTORE01"
_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "libframestore.so"),
    "libframestore.so",
]


@functools.cache
def native_library():
    """``libframestore.so`` bound over ctypes, or None where it does not load."""
    for p in _LIB_PATHS:
        try:
            lib = ctypes.CDLL(p)
        except OSError:
            continue
        lib.fs_open.restype = ctypes.c_void_p
        lib.fs_open.argtypes = [ctypes.c_char_p]
        lib.fs_read_batch.restype = ctypes.c_int
        lib.fs_read_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.fs_close.restype = None
        lib.fs_close.argtypes = [ctypes.c_void_p]
        return lib
    return None


class FrameStore:
    def __init__(self, path: str, use_native: bool = True):
        self.path = path
        with open(path + ".json") as f:
            self.index = json.load(f)
        self._handle = None
        self._lib = native_library() if use_native else None
        if self._lib is not None:
            self._handle = self._lib.fs_open(path.encode())
            if not self._handle:
                self._lib = None

        with open(path, "rb") as f:
            header = f.read(32)
            if header[:8] != MAGIC:
                raise ValueError(f"bad framestore {path}")
            (self.n_videos,) = struct.unpack("<q", header[8:16])
            self.height, self.width, self.channels = struct.unpack("<iii", header[16:28])
            self.offsets = np.fromfile(f, dtype=np.int64, count=self.n_videos + 1)
        self._data_start = 32 + (self.n_videos + 1) * 8
        self._frame_bytes = self.height * self.width * self.channels
        if self._lib is None:
            self._mmap = np.memmap(path, dtype=np.uint8, mode="r")

    @property
    def backend(self) -> str:
        return "native" if self._lib is not None else "numpy"

    def num_frames(self, vid: int) -> int:
        return int(self.offsets[vid + 1] - self.offsets[vid])

    def read_batch(self, vids, starts, length: int) -> np.ndarray:
        vids = np.ascontiguousarray(vids, dtype=np.int64)
        starts = np.ascontiguousarray(starts, dtype=np.int64)
        b = len(vids)
        if len(starts) != b:
            raise ValueError("vids and starts differ in length")
        out = np.empty((b, length, self.height, self.width, self.channels), np.uint8)
        if self._lib is not None:
            rc = self._lib.fs_read_batch(
                self._handle,
                vids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                b, length,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            )
            if rc != 0:
                raise IndexError(f"fs_read_batch failed with {rc}")
            return out
        for i, (v, s) in enumerate(zip(vids, starts)):
            if not (0 <= v < self.n_videos and 0 <= s and s + length <= self.num_frames(v)):
                raise IndexError(f"window ({v}, {s}, {length}) out of range")
            off = self._data_start + (self.offsets[v] + s) * self._frame_bytes
            flat = self._mmap[off : off + length * self._frame_bytes]
            out[i] = flat.reshape(length, self.height, self.width, self.channels)
        return out

    def read_window(self, item: dict) -> np.ndarray:
        """Loader hook: ``item`` carries 'index' (the sampler index) and 'start'."""
        vid = (self.index["video_map"][str(item["index"])] if "video_map" in self.index
               else item["index"])
        return self.read_batch([vid], [item["start"]], len(item["paths"]))[0]

    def close(self) -> None:
        if self._lib is not None and self._handle:
            self._lib.fs_close(self._handle)
            self._handle = None

    # ------------------------------------------------------------------
    @classmethod
    def build(cls, dataset, path: str, imread=None) -> "FrameStore":
        """Decode every frame of ``dataset`` (a ``datasets.VideoDataset``) once
        into a packed file. Repeated entries in ``dataset.videos`` (the
        iPER/landscape/DTDB oversampling repeats) are packed once; the
        sidecar's ``video_map`` maps every sampler index to its packed video.
        ``imread(path) -> (H, W, 3) uint8`` defaults to the loader's decoder."""
        from .loader import _imread_rgb

        imread = imread or _imread_rgb
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

        uniq: dict = {}
        packed = []  # (video, n_frames), each packed exactly once
        for v, n in zip(dataset.videos, dataset.num_frames):
            key = str(v)
            if key not in uniq:
                uniq[key] = len(packed)
                packed.append((v, int(n)))
        video_map = {
            str(i): uniq[str(dataset.videos[dataset.video_of(i)])]
            for i in range(len(dataset))
        }

        first = imread(dataset.frame_path(packed[0][0], 0))
        h, w, c = first.shape
        counts = []
        with open(path, "wb") as f:
            f.write(MAGIC)
            f.write(struct.pack("<q", len(packed)))
            f.write(struct.pack("<iii", h, w, c))
            f.write(b"\x00" * 4)
            # placeholder offsets, rewritten at the end
            f.write(np.zeros(len(packed) + 1, np.int64).tobytes())
            for video, nf in packed:
                counts.append(nf)
                for k in range(nf):
                    frame = imread(dataset.frame_path(video, k))
                    if frame.shape != (h, w, c):
                        raise ValueError(f"frame {k} of {video}: shape {frame.shape}, "
                                         f"expected {(h, w, c)}")
                    f.write(np.ascontiguousarray(frame, np.uint8).tobytes())
            offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
            f.seek(32)
            f.write(offsets.tobytes())
        with open(path + ".json", "w") as f:
            json.dump(
                {
                    "n_videos": len(counts),
                    "height": h,
                    "width": w,
                    "video_map": video_map,
                    "fingerprint": dataset_fingerprint(dataset),
                },
                f,
            )
        return cls(path)


def dataset_fingerprint(dataset) -> str:
    """Identity of the packed content: the (video, frame-count) sequence. A
    cached store is reused only when this matches, so dataset edits or a
    different mode/split trigger a rebuild."""
    h = hashlib.sha1()
    for v, n in zip(dataset.videos, dataset.num_frames):
        h.update(str(v).encode())
        h.update(struct.pack("<q", int(n)))
    h.update(struct.pack("<q", len(dataset)))
    return h.hexdigest()[:16]


def open_or_build(dataset, spec, mode: str = "train", imread=None):
    """Resolve a ``Data.framestore`` config value into a FrameStore (or None).

    ``spec``: falsy / ``off`` -> None (decode images per epoch, the reference
    behaviour); ``auto`` -> packed cache under ``<data_path>/.framestore/``
    (override the directory with ``$I2V_FRAMESTORE_DIR``), built on first
    use; any other string -> explicit store file path.

    A cached file is reused only if its fingerprint matches the dataset. In
    ``auto`` mode a failed build (a read-only data dir) degrades to None with
    a warning instead of aborting the run.
    """
    if spec is None or str(spec).strip().lower() in ("", "off", "false", "none", "0"):
        return None
    s = str(spec).strip()
    auto = s.lower() == "auto"
    if auto:
        base = os.environ.get("I2V_FRAMESTORE_DIR") or os.path.join(
            str(getattr(dataset, "data_path", ".")), ".framestore"
        )
        path = os.path.join(base, f"{type(dataset).__name__}_{mode}.fst")
    else:
        path = s
    fp = dataset_fingerprint(dataset)
    if os.path.exists(path) and os.path.exists(path + ".json"):
        try:
            with open(path + ".json") as f:
                meta = json.load(f)
            if meta.get("fingerprint") == fp:
                return FrameStore(path)
        except (OSError, ValueError):
            pass  # corrupt sidecar -> rebuild
    try:
        return FrameStore.build(dataset, path, imread)
    except OSError as e:
        if auto:
            warnings.warn(f"framestore build failed ({e}); decoding per epoch")
            return None
        raise
