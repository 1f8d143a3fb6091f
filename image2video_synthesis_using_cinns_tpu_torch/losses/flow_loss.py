"""cINN NLL objective (port of ``losses/flow_loss.py``).

``loss = mean(0.5 * sum gauss^2) - mean(logdet)``, with the NLL of true
Gaussian noise of the same shape logged beside it for calibration.
"""

from __future__ import annotations

import torch


def nll(sample: torch.Tensor) -> torch.Tensor:
    return 0.5 * sample.square().sum(dim=tuple(range(1, sample.dim())))


def flow_loss(gauss: torch.Tensor, logdet: torch.Tensor,
              generator: torch.Generator | None = None,
              noise: torch.Tensor | None = None):
    """(loss, aux). ``aux`` holds detached ``Loss``, ``nlogdet_loss`` and
    ``nll_loss``, and ``reference_nll_loss`` when reference noise is given
    (``noise``, injected) or drawn (from ``generator``, on the CPU, in
    float32)."""
    nll_loss = nll(gauss).mean()
    nlogdet_loss = -logdet.mean()
    loss = nll_loss + nlogdet_loss
    aux = {"Loss": loss.detach(), "nlogdet_loss": nlogdet_loss.detach(),
           "nll_loss": nll_loss.detach()}
    if noise is None and generator is not None:
        noise = torch.randn(tuple(gauss.shape), generator=generator, dtype=torch.float32)
    if noise is not None:
        aux["reference_nll_loss"] = nll(noise.to(gauss.device, gauss.dtype)).mean()
    return loss, aux
