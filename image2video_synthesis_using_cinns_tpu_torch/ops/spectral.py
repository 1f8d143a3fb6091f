"""Spectral normalisation (port of ``ops/spectral.py:34-68``).

torch's ``spectral_norm`` divides the weight by sigma = u^T W_mat v. At
inference sigma comes from the stored vectors u and v with no power
iteration; that division is the same on every call, so the serving modules
fold it into the weight once, when the checkpoint is loaded (``fold``,
``utils/convert.py``). Training keeps the raw weight and the vectors
(``models/layers.py``): every forward divides by sigma from the stored
vectors, so the gradient flows through W alone, and one power iteration
(``spectral_normalize``) refreshes them once a step, as the JAX trainer's
``mutable=["spectral"]`` pass does.

The stage-2 AE's BigGAN layers use a third form (``biggan_sigma``,
``ops/spectral.py:34-57`` with ``update=True`` and nothing written back):
every forward, in training and in eval alike, iterates once from the stored
``u`` with eps 1e-4 and divides by the sigma of the iterated vectors, which
carry no gradient; the stored vectors never change.
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


def _l2normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + eps)


@torch.no_grad()
def spectral_normalize(weight: torch.Tensor, u: torch.Tensor,
                       eps: float = 1e-12) -> tuple[torch.Tensor, torch.Tensor]:
    """One power iteration of W_mat from the stored ``u``: v <- normalize(W_mat^T
    u), u <- normalize(W_mat v), each normalised by its L2 norm plus ``eps``.
    Returns the new (u, v); no gradient."""
    w = kernel_to_matrix(weight)
    v = _l2normalize(w.t() @ u, eps)
    return _l2normalize(w @ v, eps), v


def biggan_sigma(weight: torch.Tensor, u: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """sigma = u'^T W_mat v with (u', v) one power iteration from the stored
    ``u`` (``spectral_normalize``, no gradient): the gradient reaches the
    weight through W_mat alone."""
    u_new, v = spectral_normalize(weight, u, eps)
    return u_new @ kernel_to_matrix(weight) @ v
