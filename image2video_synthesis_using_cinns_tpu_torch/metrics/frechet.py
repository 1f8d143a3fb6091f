"""Fréchet distance between Gaussian activation statistics (port of
``metrics/frechet.py``, its host path).

``d^2 = |mu1 - mu2|^2 + Tr(C1 + C2 - 2 sqrtm(C1 C2))``, with ``Tr sqrtm(C1
C2) = Tr sqrtm(S C2 S)`` for ``S = sqrtm(C1)``, so everything reduces to two
symmetric eigendecompositions. In float64 numpy on the host, as the JAX
package computes it: the activations are small beside the feature
extraction, and float32 would lose about 1e-3 of the metric.
"""

from __future__ import annotations

import numpy as np


def frechet_from_activations(act1, act2, eps: float = 1e-6) -> float:
    """(N, D) activations of two sets -> their Fréchet distance."""
    a1 = np.asarray(act1, np.float64)
    a2 = np.asarray(act2, np.float64)
    mu1, mu2 = a1.mean(0), a2.mean(0)
    s1 = np.cov(a1, rowvar=False)
    s2 = np.cov(a2, rowvar=False)
    offset = np.eye(s1.shape[0]) * eps

    def psd_sqrt(m):
        vals, vecs = np.linalg.eigh(m)
        return (vecs * np.sqrt(np.clip(vals, 0, None))) @ vecs.T

    s = psd_sqrt(s1 + offset)
    vals = np.linalg.eigvalsh(s @ (s2 + offset) @ s)
    tr_covmean = np.sum(np.sqrt(np.clip(vals, 0, None)))
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(s1) + np.trace(s2) - 2.0 * tr_covmean)
