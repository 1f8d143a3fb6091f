"""Loss primitives of stage-1 training (port of ``losses/common.py:16-90``):
the KL term, feature matching, the hinge loss, PSNR and SSIM.

PSNR and SSIM follow pytorch-lightning's functional versions, as the JAX
package does: the data range is the target's max - min over the whole
batch; SSIM filters with an 11x11 Gaussian of sigma 1.5, depthwise and
valid, over (B, C, H, W) images.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def KL(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    return -0.5 * torch.mean(torch.sum(1.0 + logvar - mu.square() - logvar.exp(), dim=1))


def fmap_loss(fmap1: Sequence[torch.Tensor], fmap2: Sequence[torch.Tensor],
              metric: str = "L1") -> torch.Tensor:
    loss = 0.0
    for f1, f2 in zip(fmap1, fmap2):
        if metric == "L1":
            loss = loss + torch.mean(torch.abs(f1 - f2))
        elif metric == "L2":
            loss = loss + torch.mean(torch.square(f1 - f2))
    return loss / len(fmap1)


def hinge_loss(fake_data: torch.Tensor, orig_data: torch.Tensor | None,
               update: str) -> torch.Tensor:
    if update == "disc":
        return (torch.mean(F.relu(1.0 - orig_data)) + torch.mean(F.relu(1.0 + fake_data))) / 2.0
    if update == "gen":
        return -torch.mean(fake_data)
    raise ValueError(update)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    data_range = target.max() - target.min()
    mse = torch.mean(torch.square(pred - target))
    return 10.0 * torch.log10(data_range ** 2 / mse)


def _gaussian_kernel(size: int, sigma: float, like: torch.Tensor) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-coords.square() / (2 * sigma ** 2))
    g = g / g.sum()
    return torch.outer(g, g).to(like.device, like.dtype)


def ssim(pred: torch.Tensor, target: torch.Tensor, kernel_size: int = 11, sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03,
         data_range: torch.Tensor | None = None) -> torch.Tensor:
    """SSIM of (B, C, H, W) images, averaged over every valid window;
    ``data_range`` defaults to the target's max - min over the batch."""
    if data_range is None:
        data_range = target.max() - target.min()
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    c = pred.shape[1]
    kernel = _gaussian_kernel(kernel_size, sigma, pred).expand(c, 1, kernel_size, kernel_size)

    def filt(x):
        return F.conv2d(x, kernel, groups=c)

    mu_p, mu_t = filt(pred), filt(target)
    mu_p2, mu_t2, mu_pt = mu_p * mu_p, mu_t * mu_t, mu_p * mu_t
    sigma_p = filt(pred * pred) - mu_p2
    sigma_t = filt(target * target) - mu_t2
    sigma_pt = filt(pred * target) - mu_pt
    num = (2 * mu_pt + c1) * (2 * sigma_pt + c2)
    den = (mu_p2 + mu_t2 + c1) * (sigma_p + sigma_t + c2)
    return torch.mean(num / den)
