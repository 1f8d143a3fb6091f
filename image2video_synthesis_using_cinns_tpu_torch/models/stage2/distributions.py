"""Diagonal Gaussian posterior (port of ``models/stage2/distributions.py``,
the parts the sampling path uses): parameters split into (mean, logvar),
logvar clipped to [-30, 10]."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class DiagonalGaussianDistribution:
    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_params(cls, parameters: torch.Tensor):
        mean, logvar = torch.chunk(parameters, 2, dim=1)
        return cls(mean=mean, logvar=torch.clamp(logvar, -30.0, 10.0))

    def mode(self) -> torch.Tensor:
        return self.mean
