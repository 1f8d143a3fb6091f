"""Seeded random weights, drawn on the device in a few large calls.

``draw_state(module_fn, gen, device, dtype)`` returns a state dict for the
module that ``module_fn()`` builds (the reference's, whose names are the
port's), its keys and shapes taken from a build on the meta device. The
rules are the port's own random init: a weight of two or more axes and its
bias from U(-1/sqrt(fan_in), +1/sqrt(fan_in)) (a stacked flow layer
(n, out, in) has fan_in = in); a norm's weight 1 and bias 0; ActNorm's loc 0
and scale 1; running statistics 0 and 1; spectral vectors unit normals; a
random permutation per flow block beside its inverse. A spectral layer's
vectors are then moved by ``SPECTRAL_ITERS`` power iterations of its weight,
so that its sigma is the weight's leading singular value, as in a trained
checkpoint, and not the product of two random vectors, which can lie near
zero. All uniform leaves come
from one draw, the normals from another, the permutations from a third; the
floating leaves are cast to ``dtype``, the type they are served in. The same
tensors go to the port and to the reference.
"""

from __future__ import annotations

import torch


SPECTRAL_ITERS = 20


def _fan_in(key: str, shapes: dict) -> int:
    prefix = key.rpartition(".")[0]
    w = shapes.get(f"{prefix}.weight", ((), None))[0]
    if len(w) < 2:
        return 0
    return w[-1] if ".coupling." in key else int(torch.Size(w[1:]).numel())


def draw_state(module_fn, gen: torch.Generator, device: torch.device,
               dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    with torch.device("meta"):
        shapes = {k: (tuple(t.shape), t.dtype) for k, t in module_fn().state_dict().items()}
    uniform, normal, perms, out = [], [], [], {}
    for key, (shape, _) in shapes.items():
        name = key.rpartition(".")[2]
        fan_in = _fan_in(key, shapes)
        if name in ("weight", "bias") and fan_in:
            uniform.append((key, shape, fan_in))
        elif name in ("weight", "scale", "var"):
            out[key] = torch.ones(shape, device=device, dtype=dtype)
        elif name in ("bias", "loc", "mean"):
            out[key] = torch.zeros(shape, device=device, dtype=dtype)
        elif name in ("u", "v"):
            normal.append((key, shape))
        elif name == "fwd":
            perms.append((key, shape))
        elif name != "inv":
            raise ValueError(f"{key}: no rule to draw this leaf")
    if uniform:
        sizes = [torch.Size(s).numel() for _, s, _ in uniform]
        bound = torch.tensor([f ** -0.5 for _, _, f in uniform], device=device)
        flat = torch.empty(sum(sizes), device=device).uniform_(-1.0, 1.0, generator=gen)
        flat = (flat * bound.repeat_interleave(torch.tensor(sizes, device=device))).to(dtype)
        for (key, shape, _), piece in zip(uniform, flat.split(sizes)):
            out[key] = piece.view(shape)
    if normal:
        sizes = [torch.Size(s).numel() for _, s in normal]
        flat = torch.randn(sum(sizes), device=device, generator=gen)
        for (key, shape), piece in zip(normal, flat.split(sizes)):
            out[key] = (piece / torch.linalg.vector_norm(piece)).view(shape).to(dtype)
    for key, _ in normal:
        prefix, _, name = key.rpartition(".")
        if name == "u":
            _power_iterate(out[f"{prefix}.weight"], out[key], out[f"{prefix}.v"])
    for key, shape in perms:
        fwd = torch.argsort(torch.rand(shape, device=device, generator=gen), dim=1)
        out[key] = fwd.to(shapes[key][1])
        inv = key[:-len("fwd")] + "inv"
        out[inv] = torch.argsort(fwd, dim=1).to(shapes[inv][1])
    return {k: out[k] for k in shapes}


@torch.no_grad()
def _power_iterate(weight: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> None:
    w = weight.float().reshape(weight.shape[0], -1)
    uu = u.float()
    for _ in range(SPECTRAL_ITERS):
        vv = w.t() @ uu
        vv = vv / (torch.linalg.vector_norm(vv) + 1e-12)
        uu = w @ vv
        uu = uu / (torch.linalg.vector_norm(uu) + 1e-12)
    u.copy_(uu)
    v.copy_(vv)


def seeded(seed: int, device: torch.device, purpose: int) -> torch.Generator:
    """A generator on ``device`` for one purpose of a run's ``seed``."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + purpose) % (1 << 63))
