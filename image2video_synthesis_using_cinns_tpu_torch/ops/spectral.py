"""Spectral normalisation at inference (port of ``ops/spectral.py:34-68``).

In eval mode torch's ``spectral_norm`` divides the weight by
sigma = u^T W_mat v, computed from the stored vectors u and v with no power
iteration. That division is the same on every call, so the port folds it
into the weight once, when the checkpoint is loaded (``utils/convert.py``).
"""

from __future__ import annotations

import torch


def kernel_to_matrix(weight: torch.Tensor) -> torch.Tensor:
    """Flatten a torch-layout weight (out, in, *k) to (out, in * prod(k)).

    The column order is (in, *k) row-major, torch's own, so the stored ``v``
    lines up without a permutation.
    """
    return weight.reshape(weight.shape[0], -1)


def sigma(weight: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Leading singular value estimate u^T W_mat v from the stored vectors."""
    return u @ kernel_to_matrix(weight) @ v


def fold(weight: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """W / sigma, computed in float64 and returned in the weight's dtype."""
    w64 = weight.double()
    return (w64 / sigma(w64, u.double(), v.double())).to(weight.dtype)
