"""Tensor parallelism for the cINN flow on a 2-D ``data x model`` mesh (port
of ``parallel/tp.py``).

The JAX package shards the coupling MLPs Megatron-style with
``NamedSharding``s and lets XLA derive the collectives. In one PyTorch
process the sharding is explicit. The mesh is ``mesh.make_2d_mesh``'s grid:
one row of ``model`` devices per ``data`` index.

* ``flow_param_specs`` gives, for each leaf of
  ``ConditionalFlow.blocks_dict()``, the dim its shards split, or ``None``
  (replicated), as the JAX specs are written (``tp.py:38-55``; not its
  docstring's "alternately"). A JAX kernel is ``(n, in, out)`` and a port
  weight ``(n, out, in)``: ``l0``'s weight and bias split their output (port
  dim 1, column-parallel); ``l1``, ``l2`` and ``l3`` split their contraction
  (port dim 2) with their biases replicated; ActNorm's ``loc`` and
  ``scale`` and the shuffles are replicated.
* ``shard_flow_params`` holds the master shards (``nn.Parameter``s, each
  its own leaf for ``Adam``) on row 0's model devices, the replicated
  leaves on row 0's first device.
* ``mlp`` is the tensor-parallel ``_mlp``: ``l0`` gives each model device
  its slice of the hidden width, LeakyReLU acts on each slice; every later
  layer multiplies the slice of its input that its device holds (``l1``
  has it from ``l0``; ``l2`` and ``l3`` slice their replicated input), the
  partial products are summed onto the row's first device in float32 (float64
  for float64 input), and the bias is added once after the sum.
* ``TensorParallelFlow`` runs the flow over the mesh: each data row its
  block of the batch, row 0 on the masters, every later row on
  differentiable ``.to(device)`` copies of them, so autograd sums the
  data-parallel gradient onto the masters (JAX's specs are replicated over
  ``data``). In one process nothing is all-reduced.
* ``gather_flow_params`` rebuilds whole weights. The chain kernel runs on
  one device, so a tensor-parallel flow is served by gathering, packing
  (``ConditionalFlow.pack_kernel_weights``) and launching the kernel.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F

from .mesh import _leaves, _map, make_2d_mesh, shard_batch

__all__ = ["make_2d_mesh", "flow_param_specs", "shard_flow_params", "replicated",
           "batch_sharded", "Split", "mlp", "gather_flow_params", "TensorParallelFlow"]


class Split(list):
    """One leaf split over a data row's model devices: part ``j`` on device
    ``j``, along ``dim``."""

    def __init__(self, parts, dim: int):
        super().__init__(parts)
        self.dim = dim


def flow_param_specs(blocks: dict) -> dict:
    """The split dim of each leaf of a ``blocks_dict()`` tree, ``None`` where
    it is replicated: ``(weight, bias)`` per coupling layer."""
    return {
        "loc": None,
        "scale": None,
        "coupling": {net: [(1, 1) if li == 0 else (2, None) for li in range(len(layers))]
                     for net, layers in blocks["coupling"].items()},
    }


def _zip_specs(fn, blocks: dict, specs: dict) -> dict:
    return {
        "loc": fn(blocks["loc"], specs["loc"]),
        "scale": fn(blocks["scale"], specs["scale"]),
        "coupling": {net: [(fn(w, sw), fn(b, sb)) for (w, b), (sw, sb) in
                           zip(layers, specs["coupling"][net])]
                     for net, layers in blocks["coupling"].items()},
    }


def shard_flow_params(mesh: list[list[torch.device]], blocks: dict) -> dict:
    """The master shards of ``blocks`` on row 0 of ``mesh``: a ``Split`` of
    parameters for each split leaf, a parameter on row 0's first device for
    each replicated one."""
    row = mesh[0]

    def shard(t: torch.Tensor, dim: int | None):
        t = t.detach()
        if dim is None:
            return nn.Parameter(t.to(row[0], copy=True))
        if t.shape[dim] % len(row):
            raise ValueError(f"dim {dim} of a {tuple(t.shape)} weight does not divide the "
                             f"{len(row)} model devices")
        return Split([nn.Parameter(c.to(d, copy=True).contiguous())
                      for c, d in zip(t.chunk(len(row), dim), row)], dim)

    return _zip_specs(shard, blocks, flow_param_specs(blocks))


def replicated(mesh: list[list[torch.device]], tree):
    """A copy of ``tree`` on each data row's first device, where the row's
    replicated work runs (JAX's ``P()``)."""
    return [_map(lambda t, d=row[0]: t.to(d), tree) for row in mesh]


def batch_sharded(mesh: list[list[torch.device]], tree):
    """Each data row's contiguous block of the batch rows of ``tree``, on
    the row's first device (JAX's ``P("data")``); the batch must divide the
    rows."""
    return shard_batch([row[0] for row in mesh], tree)


def _on_row(blocks: dict, row: list[torch.device]) -> dict:
    """Differentiable copies of row 0's ``blocks`` on ``row``'s devices."""
    def to(leaf):
        if isinstance(leaf, Split):
            return Split([p.to(d) for p, d in zip(leaf, row)], leaf.dim)
        return leaf.to(row[0])

    return {"loc": to(blocks["loc"]), "scale": to(blocks["scale"]),
            "coupling": {net: [(to(w), to(b)) for w, b in layers]
                         for net, layers in blocks["coupling"].items()}}


def mlp(layers, i: int, h: torch.Tensor, act: Callable[[torch.Tensor], torch.Tensor]):
    """Block ``i``'s MLP over sharded ``layers`` (``[(w, b), ...]``, two or
    more, their shards on one data row's model devices) from ``h`` on the
    row's first device; ``act`` between layers. The result is on that
    device."""
    devices = [p.device for p in layers[0][0]]
    first, dt = h.device, h.dtype
    acc = torch.promote_types(dt, torch.float32)
    shards = None  # the activation split over the devices, after l0
    for li, (w, b) in enumerate(layers):
        if li == 0:  # column-parallel: each device its slice of the output
            shards = [act(F.linear(h.to(d), wj[i], bj[i])) for d, wj, bj in zip(devices, w, b)]
            continue
        if shards is None:  # a replicated input: each device its slice of the contraction
            k = h.shape[1] // len(devices)
            shards = [h[:, j * k:(j + 1) * k].to(d) for j, d in enumerate(devices)]
        partial = [F.linear(s, wj[i]) for s, wj in zip(shards, w)]
        total = partial[0].to(first, acc)
        for p in partial[1:]:
            total = total + p.to(first, acc)
        h, shards = (total + b[i]).to(dt), None
        if li < len(layers) - 1:
            h = act(h)
    return h


def gather_flow_params(blocks_tp: dict) -> dict:
    """Whole (detached) weights of a sharded ``blocks`` tree, on the first
    device of each leaf: ``blocks_dict()``'s layout."""
    def whole(leaf):
        if isinstance(leaf, Split):
            return torch.cat([p.detach().to(leaf[0].device) for p in leaf], dim=leaf.dim)
        return leaf.detach()

    return _zip_specs(lambda t, _: whole(t), blocks_tp, flow_param_specs(blocks_tp))


class TensorParallelFlow(nn.Module):
    """``flow`` (a ``ConditionalFlow``) with its blocks sharded over ``mesh``:
    ``plain`` is its autograd path over the mesh, in place of the flow's, so
    the stage-2 step (``train.stage2._flow_step``) trains it as it is; the
    masters are its parameters. ``gather_into`` writes the trained weights
    back into a whole flow."""

    def __init__(self, flow: nn.Module, mesh: list[list[torch.device]]):
        super().__init__()
        self.mesh = [[torch.device(d) for d in row] for row in mesh]
        self.blocks = shard_flow_params(self.mesh, flow.blocks_dict())
        self.masters = nn.ParameterList(_leaves(self.blocks))
        self._rows = replicated(self.mesh, {"shuffle": flow.shuffle_dict(), "mask": flow.mask})

    def blocks_dict(self) -> dict:
        return self.blocks

    def plain(self, x: torch.Tensor, embedding: torch.Tensor, reverse: bool = False):
        """The flow over the mesh: each data row its block of the batch (which
        must divide the rows); the outputs' rows on the mesh's first device."""
        from ..models.stage2.flow import flow_forward, flow_reverse

        first = self.mesh[0][0]
        outs = []
        for r, (row, rep, part) in enumerate(zip(self.mesh, self._rows, batch_sharded(
                self.mesh, {"x": x, "emb": embedding}))):
            blocks = self.blocks if r == 0 else _on_row(self.blocks, row)
            run = flow_reverse if reverse else flow_forward
            outs.append(run(blocks, rep["shuffle"], part["x"], part["emb"], rep["mask"]))
        if reverse:
            return torch.cat([o.to(first) for o in outs])
        return (torch.cat([o[0].to(first) for o in outs]),
                torch.cat([o[1].to(first) for o in outs]))

    @torch.no_grad()
    def gather_into(self, flow: nn.Module) -> nn.Module:
        """Copy the whole weights into ``flow`` (a ``ConditionalFlow`` of the
        same shape); its kernel pack is not refreshed here."""
        whole = gather_flow_params(self.blocks)
        flow.blocks.actnorm.loc.copy_(whole["loc"])
        flow.blocks.actnorm.scale.copy_(whole["scale"])
        for net, layers in flow.blocks.coupling.items():
            for lay, (w, b) in zip(layers.values(), whole["coupling"][net]):
                lay.weight.copy_(w)
                lay.bias.copy_(b)
        return flow
