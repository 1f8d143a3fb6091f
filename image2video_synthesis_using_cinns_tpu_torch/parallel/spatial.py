"""Width-sharded decoding for the SPADE video decoder (port of
``parallel/spatial.py``).

Data parallelism scales throughput with the batch; nothing there lowers the
latency of a single video. This splits the decoder's activations along
their width over the ``model`` devices of a data row, so that each device
convolves a slab of columns. The JAX package annotates shardings and lets
GSPMD insert the halo exchanges and the norm-statistic all-reduces; in one
PyTorch process they are explicit:

* ``WidthShards``: a width-sharded activation, ``(B, C, T, H, W/n)``
  tensors, one on each model device, in column order.
* ``constrain_spatial(x, devices)`` splits a whole tensor at the JAX
  anchors (before ``g_0`` ... ``g_4`` and ``conv_img``,
  ``models/stage1/decoder.py:107-139``) and leaves it whole where the width
  does not divide the devices: ``head_0`` at width 4 stays whole, as in JAX.
  Once split, a tensor stays split: nearest upsampling (``each``) acts on
  each shard and its integer factors keep the boundaries aligned.
* ``halo(x, k)``: before a convolution k wide, each shard takes ``k // 2``
  columns from each neighbour and zero columns at the two outer edges, then
  convolves with no padding on the width (``conv``): the same sums as the
  whole convolution.
* ``group_norm``: a GroupNorm (InstanceNorm is its one-channel-a-group
  case) over shards. Each shard's (count, mean, M2) from ``torch.var_mean``
  are combined on the first device with Chan's parallel formula, one
  exchange a norm, in float32 (float64 for float64 input), as the whole
  path takes its statistics.
* ``columns(t, like)`` sends each shard its columns of a whole tensor (the
  SPADE modulation, computed once at full width on the first device).
* ``gather`` concatenates the shards on the first device.

Nothing here waits on the host: the copies between devices are queued on
the devices, so shards on different cards overlap.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

__all__ = ["WidthShards", "spatial_sharding", "constrain_spatial", "gather", "halo", "conv",
           "columns", "each", "group_norm"]


class WidthShards:
    """A width-sharded activation: ``parts[j]`` is columns ``[j W/n, (j + 1)
    W/n)`` of the whole ``(B, C, ..., W)`` tensor, on the ``j``-th model
    device of a data row."""

    def __init__(self, parts: Sequence[torch.Tensor]):
        self.parts = list(parts)

    @property
    def shape(self) -> torch.Size:
        """The whole tensor's shape."""
        s = self.parts[0].shape
        return torch.Size(tuple(s[:-1]) + (sum(p.shape[-1] for p in self.parts),))

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def devices(self) -> list[torch.device]:
        return [p.device for p in self.parts]


def spatial_sharding(mesh, axis_name: str = "data",
                     batch_axis: str | None = None) -> list[list[torch.device]]:
    """The device groups that width-shard a decode, each in column order (the
    port of the JAX scope). A 1-D mesh (a list of devices) is one group over
    its one axis, whatever ``axis_name`` calls it. A 2-D mesh
    (``mesh.make_2d_mesh``: rows of ``model`` devices, one row a ``data``
    index) shards over ``axis_name``: ``"model"`` gives its rows, and with
    ``batch_axis="data"`` the caller decodes one block of the batch's rows on
    each (``Model`` does); ``"data"`` gives its columns."""
    if not mesh or not isinstance(mesh[0], (list, tuple)):
        return [[torch.device(d) for d in mesh]]
    if axis_name == "model":
        return [[torch.device(d) for d in row] for row in mesh]
    if axis_name == "data" and batch_axis is None:
        return [[torch.device(row[j]) for row in mesh] for j in range(len(mesh[0]))]
    raise ValueError(f"cannot width-shard over {axis_name!r} with the batch on {batch_axis!r}")


def constrain_spatial(x, devices: Sequence[torch.device]):
    """``x`` split over ``devices`` along its width if it is whole and the
    width divides them; otherwise ``x`` as it is."""
    if isinstance(x, WidthShards) or len(devices) < 2 or x.shape[-1] % len(devices):
        return x
    return WidthShards([c.to(d).contiguous() for c, d in zip(x.chunk(len(devices), -1),
                                                              devices)])


def gather(x):
    """The whole tensor on the first shard's device (a whole ``x`` as it is)."""
    if not isinstance(x, WidthShards):
        return x
    first = x.parts[0].device
    return torch.cat([p.to(first) for p in x.parts], dim=-1)


def each(fn: Callable, *args):
    """``fn`` on each shard: the ``j``-th part of every ``WidthShards``
    argument, every other tensor argument copied to that part's device. With
    no sharded argument, ``fn(*args)``."""
    sharded = [a for a in args if isinstance(a, WidthShards)]
    if not sharded:
        return fn(*args)
    out = []
    for j, d in enumerate(sharded[0].devices):
        out.append(fn(*(a.parts[j] if isinstance(a, WidthShards)
                        else a.to(d) if isinstance(a, torch.Tensor) else a for a in args)))
    return WidthShards(out)


def columns(t: torch.Tensor, like: WidthShards) -> WidthShards:
    """Each shard of ``like`` its columns of the whole ``t`` (the same
    width), on its device."""
    out, start = [], 0
    for p in like.parts:
        w = p.shape[-1]
        out.append(t[..., start:start + w].to(p.device))
        start += w
    return WidthShards(out)


def halo(x: WidthShards, k: int = 3) -> list[torch.Tensor]:
    """Each shard widened by ``k // 2`` columns a side: its neighbours', zeros
    past the outer edges."""
    h = k // 2
    parts, out = x.parts, []
    for j, p in enumerate(parts):
        if h == 0:
            out.append(p)
            continue
        left = (parts[j - 1][..., -h:].to(p.device) if j > 0
                else torch.zeros_like(p[..., :h]))
        right = (parts[j + 1][..., :h].to(p.device) if j < len(parts) - 1
                 else torch.zeros_like(p[..., :h]))
        out.append(torch.cat([left, p, right], dim=-1))
    return out


def conv(x: WidthShards, layers: Sequence[torch.nn.Module]) -> WidthShards:
    """A convolution over shards: ``layers[j]`` (an ``SNConv``, stride 1,
    padding half its kernel) is the layer's copy on shard ``j``'s device."""
    layer = layers[0]
    k = layer.kernel_size
    pad = layer.padding if isinstance(layer.padding, (tuple, list)) else (layer.padding,) * len(k)
    if layer.stride not in (1, (1,) * len(k)) or pad[-1] != k[-1] // 2:
        raise ValueError(f"a width-sharded conv needs stride 1 and padding {k[-1] // 2} on "
                         f"the width, got stride {layer.stride} and padding {layer.padding}")
    op = F.conv2d if len(k) == 2 else F.conv3d
    pad = tuple(pad[:-1]) + (0,)
    return WidthShards([op(p, lay.effective_weight(), lay.bias, 1, pad)
                        for p, lay in zip(halo(x, k[-1]), layers)])


def group_norm(x: WidthShards, groups: int, weight: torch.Tensor | None = None,
               bias: torch.Tensor | None = None, eps: float = 1e-5) -> WidthShards:
    """GroupNorm over a width-sharded ``(B, C, ...)`` activation, statistics
    per (sample, group) over every shard, with the affine step when
    ``weight`` is given; computed in float32 (float64 input stays float64)
    and cast back to the input's dtype."""
    dt = torch.promote_types(x.dtype, torch.float32)
    first = x.parts[0].device
    b = x.shape[0]
    xs = [p.to(dt).reshape(b, groups, -1) for p in x.parts]
    count = mean = m2 = None
    for p in xs:
        var, m = torch.var_mean(p, dim=-1, unbiased=False)
        n = p.shape[-1]
        var, m = var.to(first), m.to(first)
        if mean is None:
            count, mean, m2 = n, m, var * n
        else:  # Chan et al.'s pairwise combination
            total = count + n
            delta = m - mean
            mean = mean + delta * (n / total)
            m2 = m2 + var * n + delta * delta * (count * n / total)
            count = total
    rstd = torch.rsqrt(m2 / count + eps)
    out = []
    for p, part in zip(xs, x.parts):
        d = part.device
        y = ((p - mean.to(d)[..., None]) * rstd.to(d)[..., None]).reshape(part.shape)
        if weight is not None:
            shape = (1, -1) + (1,) * (part.dim() - 2)
            y = y * weight.to(d, dt).reshape(shape) + bias.to(d, dt).reshape(shape)
        out.append(y.to(x.dtype))
    return WidthShards(out)
