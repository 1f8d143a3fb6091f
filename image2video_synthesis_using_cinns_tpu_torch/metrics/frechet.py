"""Fréchet distance between Gaussian activation statistics (port of
``metrics/frechet.py``).

``d^2 = |mu1 - mu2|^2 + Tr(C1 + C2 - 2 sqrtm(C1 C2))``, with ``Tr sqrtm(C1
C2) = Tr sqrtm(S C2 S)`` for ``S = sqrtm(C1)``, so everything reduces to two
symmetric eigendecompositions. In float64 numpy on the host, as the JAX
package's ``frechet_from_activations`` computes it: the activations are
small beside the feature extraction, and float32 would lose about 1e-3 of
the metric. The JAX package's jittable helpers (``trace_sqrt_product``,
``frechet_distance``, ``activation_statistics``) are here in the same
float64 host arithmetic.
"""

from __future__ import annotations

import numpy as np


def _psd_sqrt(mat: np.ndarray) -> np.ndarray:
    vals, vecs = np.linalg.eigh(mat)
    return (vecs * np.sqrt(np.clip(vals, 0.0, None))) @ vecs.T


def trace_sqrt_product(sigma1, sigma2) -> float:
    """Tr sqrtm(sigma1 @ sigma2) for symmetric PSD inputs."""
    s = _psd_sqrt(np.asarray(sigma1, np.float64))
    vals = np.linalg.eigvalsh(s @ np.asarray(sigma2, np.float64) @ s)
    return float(np.sum(np.sqrt(np.clip(vals, 0.0, None))))


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """The Fréchet distance of N(mu1, sigma1) and N(mu2, sigma2), with ``eps``
    added to both covariances' diagonals inside the square root."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    sigma1, sigma2 = np.asarray(sigma1, np.float64), np.asarray(sigma2, np.float64)
    diff = mu1 - mu2
    offset = np.eye(sigma1.shape[0]) * eps
    tr_covmean = trace_sqrt_product(sigma1 + offset, sigma2 + offset)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr_covmean)


def activation_statistics(acts) -> tuple[np.ndarray, np.ndarray]:
    """(N, D) activations -> (mu (D,), unbiased covariance (D, D)), float64."""
    acts = np.asarray(acts, np.float64)
    mu = acts.mean(0)
    centered = acts - mu
    return mu, centered.T @ centered / (acts.shape[0] - 1)


def frechet_from_activations(act1, act2, eps: float = 1e-6) -> float:
    """(N, D) activations of two sets -> their Fréchet distance."""
    return frechet_distance(*activation_statistics(act1), *activation_statistics(act2), eps)
