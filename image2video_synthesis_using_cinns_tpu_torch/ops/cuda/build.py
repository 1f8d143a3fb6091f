"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

``csrc/<name>.cu`` has a plain C interface and is compiled for Hopper
(``sm_90a``) into ``lib<name>-<digest>.so`` under the package's ``_build/``
directory (listed in ``.gitignore``) the first time it is needed. The digest
covers the source, the ``csrc/`` files it includes with quotes, and the
flags, so an edited source is rebuilt and an unchanged one is reused.
Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise FileNotFoundError("nvcc not found on PATH, in $CUDA_HOME/bin or /usr/local/cuda/bin")
    return path


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and, recursively, the ``csrc/`` files it includes with quotes."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path not in found:
            found.append(path)
            todo += [CSRC / inc for inc in re.findall(r'^#include "([^"]+)"', path.read_text(), re.M)]
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless it is built already.
    Returns {"path", "seconds", "log"}; raises if nvcc fails."""
    target = library_path(name)
    if target.exists():
        return {"path": str(target), "seconds": 0.0, "log": "(cached)"}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA build of {name} failed: nvcc exited {proc.returncode}\n"
                           f"{proc.stdout}")
    os.replace(tmp, target)
    return {"path": str(target), "seconds": time.perf_counter() - t0, "log": proc.stdout}


def load(name: str, declare) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.
    ``declare(lib)`` sets the functions' argtypes/restype once, at first load."""
    if name not in _loaded:
        _loaded[name] = declare(ctypes.CDLL(build(name)["path"]))
    return _loaded[name]
