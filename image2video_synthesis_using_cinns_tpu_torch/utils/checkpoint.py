"""Checkpoint lookup, reader and writer for the flax msgpack checkpoint format.

Port of ``utils/checkpoint.py`` (``load``/``find``/``save``) for ``.msgpack``
files, without ``msgpack`` or ``flax``: a small pure-Python codec for the
subset of MessagePack that ``flax.serialization.msgpack_serialize`` writes for
a checkpoint -- maps, arrays, str, bin, ints, floats, nil and bools, plus the
ndarray extension (ext code 1), whose payload is itself a msgpack array
``(shape, dtype name, raw C-order bytes)``. Arrays that flax
split into chunks (``__msgpack_chunked_array__``) are joined again on read and
split the same way on write.

``save`` writes the bytes the JAX package's ``save`` writes for the same tree
(``flax.serialization.to_state_dict`` turns lists and tuples into maps keyed
``"0"``, ``"1"``, ...; every leaf with a shape, torch tensors included, is an
ndarray; bf16 tensors keep the ``bfloat16`` dtype name). ``AsyncWriter``
writes on a background thread, as the JAX package's ``save_async``/``wait``
do. ``find`` also finds the reference framework's torch checkpoints
(``.pth``, ``.pth.tar``), and ``load`` of a missing ``.msgpack`` falls back
to the ``.pth`` beside it, returning its raw payload, as the JAX package's
do; ``utils/convert.py`` maps such a payload, and the CLI
``cli/convert_weights.py`` writes the ``.msgpack`` files that the loaders
read (``variables`` refuses a reference payload and names that CLI).
"""

from __future__ import annotations

import os
import queue
import struct
import threading
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
            return _ext(code, self.take(n))
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
            return _ext(code, self.take(1 << (b - 0xD4)))
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


def _ndarray(payload) -> np.ndarray:
    # [shape, dtype name, bin]: the bin read in place, its bytes copied once below
    r = _Reader(payload)
    if r.take(1)[0] != 0x93:
        raise ValueError("an ndarray payload is [shape, dtype name, data]")
    shape, name = r.value(), r.value()
    fmt = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}.get(r.take(1)[0])
    if fmt is None:
        raise ValueError("an ndarray payload's data is not bin")
    raw = r.take(r.unpack(fmt))
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after an ndarray payload")
    arr = np.frombuffer(raw, dtype=_dtype(name)).reshape(shape, order="C")
    if name == "bfloat16":
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr.copy()  # writable, owns its memory


def _ext(code: int, payload) -> Any:
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


_MAX_CHUNK_BYTES = 2**30  # flax.serialization.MAX_CHUNK_SIZE


def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int, codes: tuple) -> None:
    """A length header: ``fix | n`` up to ``fix_max``, then 8-, 16-, 32-bit forms."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                out += struct.pack(">B", code) + struct.pack(fmt, v)
                return
        raise OverflowError(v)
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if v >= low:
                out += struct.pack(">B", code) + struct.pack(fmt, v)
                return
        raise OverflowError(v)


def _pack(out: bytearray, v: Any) -> None:
    if v is None:
        out.append(0xC0)
    elif v is True or v is False:
        out.append(0xC3 if v else 0xC2)
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out += struct.pack(">Bd", 0xCB, v)
    elif isinstance(v, str):
        b = v.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(v, (bytes, bytearray)):
        _pack_len(out, len(v), None, 0, (0xC4, 0xC5, 0xC6))
        out += v
    elif isinstance(v, (list, tuple)):
        _pack_len(out, len(v), 0x90, 15, (None, 0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    elif isinstance(v, dict):
        _pack_len(out, len(v), 0x80, 15, (None, 0xDE, 0xDF))
        for k, x in v.items():
            _pack(out, k)
            _pack(out, x)
    elif isinstance(v, _Leaf):
        # the payload [shape, dtype name, raw C-order bytes], its bytes copied once
        data = memoryview(np.ascontiguousarray(v.array).reshape(-1)).cast("B")
        head = bytearray([0x93])
        _pack(head, list(v.array.shape))
        _pack(head, v.name)
        _pack_len(head, data.nbytes, None, 0, (0xC4, 0xC5, 0xC6))
        n = len(head) + data.nbytes
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(fixext[n])
        else:
            _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", _EXT_NDARRAY)
        out += head
        out += data
    else:
        raise TypeError(f"cannot serialise {type(v).__name__}")


class _Leaf:
    """An array leaf: its data and the dtype name written beside it (numpy has
    no bfloat16, so a bf16 tensor travels as its raw 16-bit words)."""

    def __init__(self, array: np.ndarray, name: str):
        self.array, self.name = array, name


def _leaf(v: Any) -> _Leaf:
    if type(v).__module__ == "torch":  # a torch.Tensor
        import torch

        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _Leaf(t.view(torch.int16).numpy().view(np.uint16), "bfloat16")
        v = t.numpy()
    a = np.asarray(v)
    return _Leaf(a, a.dtype.name)


def _to_state(v: Any) -> Any:
    """The tree the JAX ``save`` serialises: maps keyed by str in sorted order
    (its ``jax.tree.map`` sorts dict keys), lists and tuples as maps in index
    order (``flax.serialization.to_state_dict``), shaped leaves as arrays
    (those above 1 GiB chunked)."""
    if isinstance(v, dict):
        return {str(k): _to_state(v[k]) for k in sorted(v)}
    if isinstance(v, (list, tuple)):
        return {str(i): _to_state(x) for i, x in enumerate(v)}
    if not hasattr(v, "shape"):
        return v
    leaf = _leaf(v)
    if leaf.array.nbytes <= _MAX_CHUNK_BYTES:
        return leaf
    flat = leaf.array.reshape(-1)
    size = max(1, _MAX_CHUNK_BYTES // flat.dtype.itemsize)
    chunks = [_Leaf(flat[i : i + size], leaf.name) for i in range(0, flat.size, size)]
    return {"__msgpack_chunked_array__": True,
            "shape": {str(i): n for i, n in enumerate(leaf.array.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def packb(tree: Any) -> bytearray:
    """Encode one tree of dicts, lists, scalars and arrays as msgpack bytes."""
    out = bytearray()
    _pack(out, tree)
    return out


def save(path: str, payload: dict) -> None:
    """Write ``payload`` atomically (a temporary file, then a rename) in the
    format of the JAX package's ``save``."""
    data = packb(_to_state(dict(payload)))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


class AsyncWriter:
    """Checkpoint writes on one background thread (the JAX package's
    ``save_async``/``wait``): a bounded FIFO, so writes keep their order and
    the trainer overlaps the next epoch with them, and blocks when 8 are
    queued. An error of a queued write is raised by the next ``save_async``
    or by ``wait``. Payloads must be host trees that the caller no longer
    mutates. The thread starts at the first ``save_async``."""

    def __init__(self):
        self._q: queue.Queue | None = None
        self._errors: list[BaseException] = []
        self._lock = threading.Lock()

    def _loop(self) -> None:
        while True:
            path, payload = self._q.get()
            try:
                save(path, payload)
            except Exception as e:  # raised in the caller's thread by the next call
                with self._lock:
                    self._errors.append(e)
            finally:
                self._q.task_done()

    def _raise_pending(self) -> None:
        with self._lock:
            errors, self._errors = self._errors, []
        if len(errors) > 1:
            raise RuntimeError(f"{len(errors)} checkpoint writes failed; first: "
                               f"{errors[0]!r}") from errors[0]
        if errors:
            raise errors[0]

    def save_async(self, path: str, payload: dict) -> None:
        """Queue an atomic write of ``payload`` to ``path``; first raise the
        error of an earlier write, if one failed."""
        self._raise_pending()
        if self._q is None:
            self._q = queue.Queue(maxsize=8)
            threading.Thread(target=self._loop, daemon=True).start()
        self._q.put((path, payload))

    def wait(self) -> None:
        """Block until every queued write is on disk; raise a writer's error."""
        if self._q is not None:
            self._q.join()
        self._raise_pending()


def get_save_dict(variables: dict, opt_state: dict, epoch: int) -> dict:
    """The trainers' checkpoint payload: ``epoch + 1``, the variables tree and
    the optimizer's state (host trees)."""
    return {"epoch": epoch + 1, "state_dict": variables, "optim_state_dict": opt_state}


CONVERT_HINT = ("convert the reference's checkpoints first: python -m "
                "image2video_synthesis_using_cinns_tpu_torch.cli.convert_weights model_dir "
                "--src <stage2 dir> (or one of its other kinds; docs/WEIGHTS.md)")


def load(path: str) -> dict:
    """Read a flax ``.msgpack`` checkpoint into a tree of dicts and numpy
    arrays. A missing ``x.msgpack`` with an ``x.pth`` beside it, or a path
    to a ``.pth``/``.pth.tar`` file, gives that file's raw torch payload."""
    if not os.path.exists(path) and path.endswith(".msgpack"):
        torch_path = path[: -len(".msgpack")] + ".pth"
        if os.path.exists(torch_path):
            path = torch_path
    if path.endswith((".pth", ".pth.tar")):
        from .convert import load_torch_checkpoint

        return load_torch_checkpoint(path)
    with open(path, "rb") as f:
        return _unchunk(unpackb(f.read()))


def find(path_no_ext: str) -> str | None:
    """The checkpoint for a stem: ``.msgpack``, else ``.pth``, else
    ``.pth.tar``; None if there is none."""
    for suffix in (".msgpack", ".pth", ".pth.tar"):
        if os.path.exists(path_no_ext + suffix):
            return path_no_ext + suffix
    return None


def variables(payload: dict, path: str) -> dict:
    """The variables tree of a loaded checkpoint (``{"state_dict": tree}`` or
    the bare tree). A state dict in the reference framework's key layout
    (dotted keys, torch tensors) raises, naming the converter."""
    tree = payload.get("state_dict", payload) if isinstance(payload, dict) else payload
    if isinstance(tree, dict) and tree and all(
            isinstance(k, str) and "." in k and not isinstance(v, dict) for k, v in tree.items()):
        raise ValueError(f"{path} holds a state dict in the reference framework's key layout; "
                         + CONVERT_HINT)
    if not isinstance(tree, dict) or not ({"params", "buffers"} & set(tree)):
        raise ValueError(f"{path} is not a variables checkpoint of the JAX package")
    return tree
