"""Diagonal Gaussian posterior (port of ``models/stage2/distributions.py``):
parameters split into (mean, logvar), logvar clipped to [-30, 10].

With ``deterministic`` the standard deviation and the variance are zero and
``kl``/``nll`` are 0. ``kl()``, against the standard normal, is the batch
mean of each item's sum. A sample draws
its eps in float32 and casts it to the mean's dtype, so a compute dtype
changes rounding only, never the draw.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass
class DiagonalGaussianDistribution:
    mean: torch.Tensor
    logvar: torch.Tensor
    deterministic: bool = False

    @classmethod
    def from_params(cls, parameters: torch.Tensor, deterministic: bool = False):
        mean, logvar = torch.chunk(parameters, 2, dim=1)
        return cls(mean=mean, logvar=torch.clamp(logvar, -30.0, 10.0),
                   deterministic=deterministic)

    @property
    def std(self) -> torch.Tensor:
        if self.deterministic:
            return torch.zeros_like(self.mean)
        return torch.exp(0.5 * self.logvar)

    @property
    def var(self) -> torch.Tensor:
        if self.deterministic:
            return torch.zeros_like(self.mean)
        return torch.exp(self.logvar)

    def sample(self, generator: torch.Generator | None = None,
               eps: torch.Tensor | None = None) -> torch.Tensor:
        """mean + std * eps, with eps given or drawn from ``generator`` (on
        the generator's device, then moved to the mean's)."""
        if eps is None:
            dev = generator.device if generator is not None else self.mean.device
            eps = torch.randn(self.mean.shape, generator=generator, device=dev,
                              dtype=torch.float32)
        return self.mean + self.std * eps.to(self.mean.device, self.mean.dtype)

    def _reduce_dims(self) -> tuple[int, ...]:
        return tuple(range(1, self.mean.ndim))

    def kl(self) -> torch.Tensor:
        """KL to the standard normal: the batch mean of each item's sum."""
        if self.deterministic:
            return torch.zeros((), device=self.mean.device)
        return torch.mean(0.5 * torch.sum(
            torch.square(self.mean) + self.var - 1.0 - self.logvar, dim=self._reduce_dims()))

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        if self.deterministic:
            return torch.zeros((), device=self.mean.device)
        logtwopi = math.log(2.0 * math.pi)
        return 0.5 * torch.sum(
            logtwopi + self.logvar + torch.square(sample - self.mean) / self.var,
            dim=self._reduce_dims())

    def mode(self) -> torch.Tensor:
        return self.mean
