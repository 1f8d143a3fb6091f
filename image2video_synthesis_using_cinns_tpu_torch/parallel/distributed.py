"""Opt-in multi-process data-parallel training (port of
``parallel/distributed.py``): one process per card, explicit collectives.

The JAX package runs one SPMD program over a global mesh and lets XLA insert
the reductions. Here every rank runs the trainer on its own rows of each
global batch, and the trainers reduce explicitly:

* gradients: one all-reduce of a flat buffer per optimizer step, divided by
  the world size (``all_reduce_mean_``, called by ``train.optim.Adam``);
* batch statistics: ``all_reduce_sum`` is differentiable (its backward is
  the same all-reduce), so ``BatchNorm`` in train mode and the ActNorm
  inits take the global batch's mean and variance (``batch_moments``), as
  ``jnp.mean`` over a sharded axis does;
* logged scalars and every value that steers control flow (schedulers, the
  best checkpoint, the AE discriminator's ``d_loss > 0``): ``mean_scalars``;
* host arrays (the FVD activations, the posterior cache's partial tables):
  ``process_allgather`` through a CPU gloo group.

Opt-in via ``Training.distributed``:

.. code-block:: yaml

    Training:
      distributed: true            # torchrun's environment (RANK, WORLD_SIZE,
                                   # LOCAL_RANK, MASTER_ADDR, MASTER_PORT)
      # or explicit:
      distributed:
        coordinator_address: "10.0.0.1:1234"
        num_processes: 2
        process_id: 0
        backend: gloo              # optional: nccl for cards, gloo for the CPU

Each rank runs on ``cuda:{LOCAL_RANK}`` (``local_rank`` in the mapping),
unless the caller passes an indexed device. The backend is NCCL for a card,
gloo for the CPU, or the mapping's ``backend``; nothing switches it behind
the caller's back. NCCL refuses two ranks on one card, gloo takes CUDA
tensors for ``all_reduce``.

Semantics, enforced loudly as in the JAX package: the global batch must
divide the world (``require_mesh_divisible``, ``host_batch_slice``) and the
loaders drop an indivisible tail batch (``Loader(tail_multiple=...)``),
because the mean of the ranks' means equals the global mean only when every
rank holds ``B / world`` rows. Every rank runs the same config and seed: the
batch order is shared, rank ``p`` takes rows ``[p B/P, (p+1) B/P)``, and
every random draw is made for the global batch and sliced to those rows.
Only rank 0 touches the filesystem.

The JAX functions without a counterpart here, and why:

* ``put_global_batch``, ``put_global``, ``make_global_batch``: they build
  one global ``jax.Array`` out of each host's rows for the SPMD program. A
  rank's tensors are already its own rows, and the single-process padding
  path is ``mesh.pad_to_multiple`` with ``mesh.shard_batch``.
* ``fetch_local_rows``, ``fetch_local_rows_tree``: they read a host's rows
  back out of a global array. A rank's outputs are its rows already.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 1800.0  # rendezvous and collectives: the trainers' builds differ in time

_host_group = None  # the CPU gloo group for host arrays (the default group when that is gloo)
_local_rank = 0
_joined = False  # whether the live group has been set up here
_rank_local_depth = 0  # > 0 inside ``rank_local()``


def world() -> int:
    """The number of ranks of the live process group, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_primary() -> bool:
    """Whether this process may touch the filesystem: rank 0."""
    return rank() == 0


def maybe_initialize(dist_cfg, device: str | torch.device | None = None) -> tuple[int, int]:
    """Join the process group that ``Training.distributed`` describes.

    ``dist_cfg`` falsy: nothing to join. ``True``: torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``).
    A mapping: ``coordinator_address`` ("host:port"), ``num_processes``,
    ``process_id``, and optionally ``backend`` and ``local_rank``.
    ``device`` (the trainer's) picks the default backend: NCCL for a card,
    gloo for the CPU. Idempotent: a second trainer in the process (stage 1,
    then its AE) reuses the live group. Returns ``(rank, world)``."""
    global _host_group, _local_rank, _joined
    if dist.is_initialized():  # a second trainer, or a group the caller made
        if not _joined:  # the caller's: its ranks' cards by torchrun's LOCAL_RANK
            _local_rank = int(os.environ.get("LOCAL_RANK", 0))
            if dist.get_backend() != "gloo":
                _host_group = dist.new_group(backend="gloo",
                                             timeout=datetime.timedelta(seconds=TIMEOUT_S))
            _joined = True
        return rank(), world()
    if not dist_cfg:
        return 0, 1
    if dist_cfg is True:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"Training.distributed: true reads torchrun's environment, but {missing} "
                "is not set: launch with torchrun, or give the mapping coordinator_address, "
                "num_processes and process_id (see parallel/distributed.py)")
        r, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init = "env://"
        backend = None
        _local_rank = int(os.environ.get("LOCAL_RANK", 0))
    else:
        cfg = dict(dist_cfg)
        unknown = set(cfg) - {"coordinator_address", "num_processes", "process_id", "backend",
                              "local_rank"}
        if unknown:
            raise ValueError(f"Training.distributed: unknown keys {sorted(unknown)}")
        r, n = int(cfg["process_id"]), int(cfg["num_processes"])
        init = f"tcp://{cfg['coordinator_address']}"
        backend = cfg.get("backend")
        _local_rank = int(cfg.get("local_rank", os.environ.get("LOCAL_RANK", 0)))
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"the NCCL backend needs a CUDA device, not {dev}")
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    dist.init_process_group(backend, init_method=init, world_size=n, rank=r, timeout=timeout)
    _host_group = None if backend == "gloo" else dist.new_group(backend="gloo", timeout=timeout)
    _joined = True
    return r, n


def rank_device(device: str | torch.device | None) -> torch.device:
    """The device this rank runs on: ``cuda:{LOCAL_RANK}`` for an unindexed
    ``cuda`` (or none), otherwise the device given."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", _local_rank)
    return device


def destroy() -> None:
    """Leave the process group (a worker's last call)."""
    global _host_group, _joined
    if dist.is_initialized():
        dist.destroy_process_group()
    _host_group, _joined = None, False


def barrier(name: str, timeout_s: float = TIMEOUT_S) -> None:
    """Wait until every rank arrives here (on the CPU gloo group). No-op at
    world size 1. The trainers call it after their builds, whose time differs
    between ranks, so that none reaches the first collective much earlier."""
    if world() == 1:
        return
    try:
        dist.monitored_barrier(group=_host_group, timeout=datetime.timedelta(seconds=timeout_s))
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e


def require_mesh_divisible(n_devices: int, **batch_sizes: int) -> None:
    """Every named batch size must divide the ``n_devices`` ranks: a rank
    cannot take a pad row (the mean of the ranks' means would count it)."""
    bad = {k: v for k, v in batch_sizes.items() if int(v) % n_devices}
    if bad:
        raise ValueError(
            f"multi-host runs need mesh-divisible batch sizes: {bad} do not "
            f"divide the {n_devices}-device mesh — choose divisible "
            "Training batch sizes (see parallel/distributed.py)"
        )


def host_batch_slice(global_bs: int, process_index: int | None = None,
                     process_count: int | None = None) -> slice:
    """The contiguous block of each global batch that rank ``p`` loads:
    rows ``[p B/P, (p+1) B/P)``."""
    pi = rank() if process_index is None else process_index
    pc = world() if process_count is None else process_count
    if global_bs % pc:
        raise ValueError(
            f"multi-host runs need the global batch size ({global_bs}) to be "
            f"divisible by the process count ({pc}): pad rows cannot be "
            "assembled per-process — choose a divisible Training.bs (see "
            "parallel/distributed.py)"
        )
    per = global_bs // pc
    return slice(pi * per, (pi + 1) * per)


def local_rows(x):
    """This rank's rows of ``x``, drawn for the global batch: a tensor or an
    array (leading axis), or a dict of them. Identity at world size 1."""
    if world() == 1:
        return x
    if isinstance(x, dict):
        return {k: local_rows(v) for k, v in x.items()}
    return x[host_batch_slice(x.shape[0])]


# -- collectives --------------------------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; its backward is the same sum of the gradients (each
    rank's copy feeds its own loss, and the objective is their sum), built of
    itself, so a double backward (a gradient penalty) reduces too."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks; ``x`` itself at world size 1."""
    return x if world() == 1 else _AllReduceSum.apply(x)


@torch.no_grad()
def all_reduce_mean_(tensors: list[torch.Tensor]) -> None:
    """Average ``tensors`` over the ranks in place: one all-reduce of a flat
    buffer per (device, dtype), divided by the world size. No-op at world
    size 1."""
    n = world()
    if n == 1 or not tensors:
        return
    groups: dict[tuple, list[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for ts in groups.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat)
        flat.div_(n)
        for t, v in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(v.view_as(t))


def mean_scalars(values: dict) -> dict[str, float]:
    """The global mean of each scalar (floats or 0-d tensors) over the ranks,
    in float64 on the host group, the same on every rank; at world size 1
    the values as floats."""
    keys = list(values)
    floats = [float(v.detach()) if isinstance(v, torch.Tensor) else float(v)
              for v in (values[k] for k in keys)]
    if world() > 1:
        t = torch.tensor(floats, dtype=torch.float64)
        dist.all_reduce(t, group=_host_group)
        floats = (t / world()).tolist()
    return dict(zip(keys, floats))


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` is set on any rank (a SIGTERM that reached one rank
    stops them all at the same step); ``flag`` at world size 1."""
    if world() == 1:
        return bool(flag)
    t = torch.tensor([float(bool(flag))], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_host_group)
    return bool(t.item())


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """Elementwise max over the ranks (no gradient)."""
    if world() == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX)
    return y


def process_allgather(x: np.ndarray) -> np.ndarray:
    """Every rank's ``x`` (the same shape on each), stacked on a new leading
    axis in rank order, on every rank: JAX's
    ``multihost_utils.process_allgather``, through the CPU gloo group. At
    world size 1 ``x[None]``."""
    x = np.ascontiguousarray(x)
    if world() == 1:
        return x[None]
    t = torch.from_numpy(x)
    out = [torch.empty_like(t) for _ in range(world())]
    dist.all_gather(out, t, group=_host_group)
    return torch.stack(out).numpy()


def gather_rows(local: torch.Tensor, global_idx: torch.Tensor, offset: int) -> torch.Tensor:
    """Rows ``global_idx`` of the global batch whose rows ``[offset, offset +
    len(local))`` this rank holds as ``local``: each rank fills the rows it
    owns, zeros elsewhere, and a differentiable sum over the ranks assembles
    them, exactly (each row has one owner), the same on every rank. The
    gradient of a rank's copy flows back to the owner's rows, summed over
    the ranks."""
    idx = global_idx.to(local.device)
    if world() == 1:
        return local[idx - offset]
    own = (idx >= offset) & (idx < offset + local.shape[0])
    rows = local[(idx - offset).clamp(0, local.shape[0] - 1)]
    mask = own.reshape((-1,) + (1,) * (local.dim() - 1))
    return all_reduce_sum(torch.where(mask, rows, torch.zeros_like(rows)))


# -- global batch statistics ----------------------------------------------------


def global_stats() -> bool:
    """Whether batch statistics are taken over the global batch: a group of
    more than one rank is live and no ``rank_local()`` is open."""
    return world() > 1 and _rank_local_depth == 0


@contextlib.contextmanager
def rank_local() -> Iterator[None]:
    """Within: batch statistics over this rank's input alone, for inputs that
    every rank holds whole (stage 1's patch frames, gathered by
    ``gather_rows``)."""
    global _rank_local_depth
    _rank_local_depth += 1
    try:
        yield
    finally:
        _rank_local_depth -= 1


def batch_moments(x: torch.Tensor, dims: list[int], correction: int = 0):
    """(mean, var, n): the mean and variance of ``x`` over ``dims``, with
    ``correction`` (0 biased, 1 unbiased), and the count of values they
    cover. Over the global batch while ``global_stats()``: the sum, then the
    sum of squared deviations from the global mean, each all-reduced (two
    passes, no sums of squares), with every rank holding as many rows as
    this one (the trainers enforce it). Differentiable."""
    n = int(np.prod([x.shape[d] for d in dims]))
    if not global_stats():
        var, mean = torch.var_mean(x, dim=dims, correction=correction)
        return mean, var, n
    n *= world()
    keep = [1 if d in dims else x.shape[d] for d in range(x.dim())]
    mean = all_reduce_sum(x.sum(dims)) / n
    dev = all_reduce_sum((x - mean.reshape(keep)).square().sum(dims))
    return mean, dev / max(n - correction, 1), n
