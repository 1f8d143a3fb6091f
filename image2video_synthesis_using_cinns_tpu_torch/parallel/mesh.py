"""Serving devices and batch splitting for data-parallel serving (port of
``parallel/mesh.py``).

JAX serves data-parallel from one SPMD program over a 1-D ``data`` mesh:
weights replicated, the batch sharded on axis 0, XLA deriving the (absent)
collectives. PyTorch's counterpart is one module replica per device in one
process: the "mesh" is the list of serving devices, ``replicate`` copies a
module onto each, ``shard_batch`` gives each device its contiguous block of
rows in device order, and ``pad_to_multiple`` repeats the last row until the
batch divides the devices, as the JAX package pads. An explicit device list
stands in for XLA's forced host device count: ``["cpu", "cpu"]`` serves two
replicas on the CPU, ``["cuda:0", "cuda:0"]`` two on one card.

Multi-process training is ``parallel/distributed.py``.
"""

from __future__ import annotations

import copy
from functools import partial
from typing import Any, Sequence

import torch


def make_mesh(n_devices: int | None = None,
              devices: Sequence[str | torch.device] | None = None) -> list[torch.device]:
    """The serving devices: ``devices`` as given, or every visible CUDA
    device; the first ``n_devices`` of them when that is given. Raises
    without a card when no devices are given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass the serving devices "
                               "(devices=['cpu', 'cpu'] serves two replicas on the CPU)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(f"n_devices={n_devices}: {len(devices)} devices are available")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("the mesh needs at least one device")
    return devices


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def pad_to_multiple(batch: Any, multiple: int) -> tuple[Any, int | None]:
    """Pad the leading axis of every tensor of ``batch`` (a tensor, or a
    dict, list or tuple of them; ``None`` entries pass) to a multiple of
    ``multiple`` by repeating its last row. Returns ``(padded, true_b)``:
    the original batch size, or ``None`` when no padding was needed."""
    leaves = _leaves(batch)
    if not leaves:
        return batch, None
    b = leaves[0].shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return batch, None
    return _map(lambda x: torch.cat([x, x[-1:].expand((rem,) + tuple(x.shape[1:]))]), batch), b


def shard_batch(mesh: Sequence[torch.device], batch: Any) -> list:
    """One copy of ``batch`` per device of ``mesh``, each holding that
    device's contiguous block of rows (device ``i`` rows ``[i B/n, (i+1)
    B/n)``), moved there. The batch must divide the mesh (``pad_to_multiple``)."""
    n = len(mesh)
    b = _leaves(batch)[0].shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} rows does not divide the {n}-device mesh; "
                         "pad it first (pad_to_multiple)")
    per = b // n
    return [_map(lambda x, i=i, d=d: x[i * per:(i + 1) * per].to(d), batch)
            for i, d in enumerate(mesh)]


def replicate(mesh: Sequence[torch.device], module: torch.nn.Module) -> list[torch.nn.Module]:
    """A copy of ``module`` on each device of ``mesh`` (two entries of one
    device get two copies)."""
    return [copy.deepcopy(module).to(d) for d in mesh]


def data_parallel_sharding(mesh: Sequence[torch.device]):
    """``(split rows, replicate)`` over ``mesh``: the counterparts of the JAX
    package's batch-sharded and replicated shardings."""
    return partial(shard_batch, mesh), partial(replicate, mesh)
