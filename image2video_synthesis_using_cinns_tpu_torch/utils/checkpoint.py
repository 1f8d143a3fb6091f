"""Checkpoint lookup and a reader for the flax msgpack checkpoint format.

Port of ``utils/checkpoint.py`` (``load``/``find``) for ``.msgpack`` files,
without ``msgpack`` or ``flax``: a small pure-Python decoder for the subset
of MessagePack that ``flax.serialization.msgpack_serialize`` writes for a
checkpoint -- maps, arrays, str, bin, ints, floats, nil and bools, plus the
ndarray extension (ext code 1), whose payload is itself a msgpack array
``(shape, dtype name, raw C-order bytes)``. Arrays that flax
split into chunks (``__msgpack_chunked_array__``) are joined again.

Reading a torch ``.pth`` checkpoint is not ported yet.
"""

from __future__ import annotations

import os
import struct
from typing import Any

import numpy as np

_EXT_NDARRAY = 1


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            n = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self.take(n))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xD3:
            return self.unpack(
                {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}[b]
            )
        if 0xD4 <= b <= 0xD8:
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(1 << (b - 0xD4))))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _dtype(name: str) -> np.dtype:
    # numpy has no bfloat16: read the raw 16-bit words, widened in _ndarray
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _ndarray(payload: bytes) -> np.ndarray:
    shape, name, raw = unpackb(payload)
    arr = np.frombuffer(raw, dtype=_dtype(name)).reshape(shape, order="C")
    if name == "bfloat16":
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr.copy()  # writable, owns its memory


def _ext(code: int, payload: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    raise ValueError(f"unsupported msgpack extension code {code}")


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object (with flax's ndarray extension)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after msgpack object")
    return out


def load(path: str) -> dict:
    """Read a flax ``.msgpack`` checkpoint into a tree of dicts and numpy arrays."""
    if not path.endswith(".msgpack"):
        raise NotImplementedError(
            f"{path}: only .msgpack checkpoints are readable by the torch port; "
            "reading torch .pth files is not ported yet"
        )
    with open(path, "rb") as f:
        return _unchunk(unpackb(f.read()))


def find(path_no_ext: str) -> str | None:
    """Return the ``.msgpack`` checkpoint for a stem, or None if there is none.

    A ``.pth`` checkpoint with the same stem raises: the port cannot read it yet.
    """
    p = path_no_ext + ".msgpack"
    if os.path.exists(p):
        return p
    for suffix in (".pth", ".pth.tar"):
        if os.path.exists(path_no_ext + suffix):
            raise NotImplementedError(
                f"{path_no_ext + suffix}: reading torch .pth checkpoints is not "
                "ported yet; convert it to .msgpack with the JAX package"
            )
    return None
