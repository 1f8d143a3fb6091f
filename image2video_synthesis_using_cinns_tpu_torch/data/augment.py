"""Clip augmentation on the batch's device (port of ``data/augment.py``).

``build_augment(img_size, params, random_crop, train)`` returns the JAX
package's transform as torch ops on the device the batch lies on. The layout
is the JAX package's: uint8 (B, T, H, W, 3) in, float32 (B, T, H, W, 3) in
[-1, 1] out.

* eval: ``uint8 / 255 -> resize_bilinear -> (x - 0.5) / 0.5``. The resize is
  the JAX package's ``jax.image.resize(..., 'bilinear')``: half-pixel
  centres, antialiased when it downsamples, the input unchanged when the
  size matches (``ops/resize.py``).
* train: the resize (to ``img_size + 16`` with ``random_crop``, the
  landscape and DTDB pipeline), a horizontal flip per clip with probability
  ``prob_hflip``, with ``random_crop`` an ``img_size`` crop at offsets in
  [0, 16], then the enabled colour ops (factor != 0) in a random order per
  clip: brightness, contrast and saturation blend with factors ~ U(max(0,
  1 - x), 1 + x) and clip to [0, 1]; contrast blends with the grayscale mean
  of each frame, summed exactly (``_frame_mean``), so that a frame's result
  does not depend on the other frames of its batch; hue shifts by U(-h, h)
  in HSV and does not clip.

The train branch is two parts, so that a test can hand another package's
draws to the apply: ``draw_augment`` draws the per-clip parameters from a
``torch.Generator`` (on the CPU), ``apply_augment`` applies them.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.resize import resize_bilinear
from ..utils.profiling import annotate

COLOUR_OPS = ("brightness", "contrast", "saturation", "hue")
CROP_RANGE = 17  # crop offsets are drawn from [0, CROP_RANGE)
FIXED_POINT_BITS = 40  # the contrast mean's fixed point: int64 holds 2**23 values <= 1 a frame


def enabled_ops(params: dict) -> tuple[str, ...]:
    """The colour ops with a non-zero factor, in ``COLOUR_OPS`` order: the
    indices that ``order`` permutes."""
    return tuple(name for name in COLOUR_OPS if params.get(name, 0.0))


def draw_augment(n: int, params: dict, random_crop: bool,
                 generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Per-clip draws for ``n`` clips: ``flip`` (n,) bool, ``crop`` (n, 2)
    int64 (y, x) offsets, ``factors`` (n, n_ops) float32, one per enabled op
    in ``enabled_ops`` order, and ``order`` (n, n_ops) int64, a permutation
    of the enabled ops per clip."""
    ops = enabled_ops(params)
    flip = torch.rand(n, generator=generator) < params.get("prob_hflip", 0.5)
    crop = torch.randint(0, CROP_RANGE, (n, 2), generator=generator)
    lo = torch.tensor([-params[o] if o == "hue" else max(0.0, 1.0 - params[o]) for o in ops])
    hi = torch.tensor([params[o] if o == "hue" else 1.0 + params[o] for o in ops])
    factors = lo + (hi - lo) * torch.rand(n, len(ops), generator=generator)
    order = torch.argsort(torch.rand(n, len(ops), generator=generator), dim=1)
    return {"flip": flip, "crop": crop, "factors": factors.float(), "order": order}


def _grayscale(x: torch.Tensor) -> torch.Tensor:
    r, g, b = x[..., 0:1], x[..., 1:2], x[..., 2:3]
    return 0.299 * r + 0.587 * g + 0.114 * b


def _adjust_brightness(x, factor):
    return torch.clamp(x * factor, 0.0, 1.0)


def _frame_mean(g: torch.Tensor) -> torch.Tensor:
    """The mean over (H, W, 1) of each frame of ``g`` (B, T, H, W, 1), summed
    exactly: each value in fixed point (int64 steps of ``2**-FIXED_POINT_BITS``,
    exact for values from ``2**-17`` up; smaller ones round on their own), so
    that the order of the sum cannot move the result. A card's reduction
    picks that order by how many frames the batch holds, so a float sum gives
    a frame other bits in a batch of 3 than in one of 6, and a rank's rows
    would not be the one-process rows (``parallel/distributed.py``)."""
    scale = 2.0 ** FIXED_POINT_BITS
    fixed = torch.round(g.to(torch.float64) * scale).to(torch.int64)
    total = fixed.sum(dim=(-3, -2, -1), keepdim=True)
    n = g.shape[-3] * g.shape[-2] * g.shape[-1]
    return (total.to(torch.float64) / (n * scale)).to(g.dtype)


def _adjust_contrast(x, factor):
    mean = _frame_mean(_grayscale(x))
    return torch.clamp(factor * x + (1 - factor) * mean, 0.0, 1.0)


def _adjust_saturation(x, factor):
    return torch.clamp(factor * x + (1 - factor) * _grayscale(x), 0.0, 1.0)


def _rgb_to_hsv(x: torch.Tensor) -> torch.Tensor:
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = x.amax(dim=-1)
    minc = x.amin(dim=-1)
    deltac = maxc - minc
    s = torch.where(maxc > 0, deltac / torch.clamp(maxc, min=1e-12), 0.0)
    deltac_safe = torch.where(deltac == 0, 1.0, deltac)
    rc = (maxc - r) / deltac_safe
    gc = (maxc - g) / deltac_safe
    bc = (maxc - b) / deltac_safe
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(deltac == 0, 0.0, h)
    h = torch.remainder(h / 6.0, 1.0)  # a floor-mod: h may be negative
    return torch.stack([h, s, maxc], dim=-1)


def _hsv_to_rgb(x: torch.Tensor) -> torch.Tensor:
    h, s, v = x[..., 0], x[..., 1], x[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.to(torch.int64), 6).unsqueeze(-1)

    def select(*choices):
        return torch.stack(choices, dim=-1).gather(-1, i).squeeze(-1)

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-1)


def _adjust_hue(x, shift):
    hsv = _rgb_to_hsv(x)
    h = torch.remainder(hsv[..., 0] + shift[..., 0], 1.0)
    return _hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


_ADJUST = {"brightness": _adjust_brightness, "contrast": _adjust_contrast,
           "saturation": _adjust_saturation, "hue": _adjust_hue}


def _resize(x: torch.Tensor, size: int) -> torch.Tensor:
    """(B, T, H, W, 3) -> (B, T, size, size, 3)."""
    return resize_bilinear(x.permute(0, 1, 4, 2, 3), (size, size)).permute(0, 1, 3, 4, 2)


def apply_augment(batch_u8, img_size: int, params: dict, random_crop: bool,
                  draws: dict[str, torch.Tensor]) -> torch.Tensor:
    """The train transform with the per-clip ``draws`` of ``draw_augment``."""
    with annotate("data/augment"):
        return _apply_augment(batch_u8, img_size, params, random_crop, draws)


def _apply_augment(batch_u8, img_size: int, params: dict, random_crop: bool,
                   draws: dict[str, torch.Tensor]) -> torch.Tensor:
    x = torch.as_tensor(batch_u8).to(torch.float32) / 255.0
    dev = x.device
    x = _resize(x, img_size + 16 if random_crop else img_size)
    flip = draws["flip"].to(dev).view(-1, 1, 1, 1, 1)
    x = torch.where(flip, x.flip(3), x)
    if random_crop:
        x = torch.stack([x[b, :, y0:y0 + img_size, x0:x0 + img_size]
                         for b, (y0, x0) in enumerate(draws["crop"].tolist())])
    ops = enabled_ops(params)
    if ops:
        factors = draws["factors"].to(dev, torch.float32).view(x.shape[0], len(ops), 1, 1, 1, 1)
        order = draws["order"].to(dev).view(x.shape[0], len(ops), 1, 1, 1, 1)
        for k in range(len(ops)):  # the op at place k of each clip's order
            out = x
            for j, name in enumerate(ops):
                out = torch.where(order[:, k] == j, _ADJUST[name](x, factors[:, j]), out)
            x = out
    return (x - 0.5) / 0.5


def build_augment(img_size: int, params: dict | None, random_crop: bool,
                  train: bool) -> Callable[..., torch.Tensor]:
    """``augment(batch_u8, draws=None)``: uint8 batch (B, T, H, W, 3), a
    tensor on any device or a numpy array (taken on the CPU), -> float32 (B,
    T, H, W, 3) in [-1, 1] on the same device. The train transform takes its
    per-clip ``draws`` (``draw_augment``); the eval transform ignores them."""
    params = dict(params or {})

    def augment(batch_u8, draws: dict | None = None) -> torch.Tensor:
        if not train:
            x = torch.as_tensor(batch_u8).to(torch.float32) / 255.0
            return ((_resize(x, img_size) - 0.5) / 0.5).contiguous()
        if draws is None:
            raise ValueError("the train augmentation takes per-clip draws (draw_augment, "
                             "from an explicit generator)")
        return apply_augment(batch_u8, img_size, params, random_crop, draws)

    return augment
