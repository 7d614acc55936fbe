"""Latent-space initialization, numpy only: a copy of gpy_tpu/util/
initialization.py:10-38 (GPy/util/initialization.py:10), so that one Y gives
both packages the same latent start bit for bit."""
from __future__ import annotations

import numpy as np

__all__ = ["pca", "initialize_latent"]


def pca(Y, input_dim):
    """PCA projection of Y to input_dim by numpy's SVD. Returns (X, fracs).

    Each retained direction is scaled to unit variance; when input_dim
    exceeds the rank of Y, the remaining columns are small normals from
    default_rng(0)."""
    Y = np.asarray(Y, dtype=float)
    Yc = Y - Y.mean(0)
    U, s, Vt = np.linalg.svd(Yc, full_matrices=False)
    k = min(input_dim, s.shape[0])
    X = U[:, :k] * s[:k]
    fracs = np.zeros(input_dim)
    fracs[:k] = s[:k] ** 2 / np.sum(s**2)
    std = X.std(0)
    std[std == 0] = 1.0
    X = X / std
    if k < input_dim:
        rng = np.random.default_rng(0)
        X = np.hstack([X, 1e-2 * rng.standard_normal((Y.shape[0], input_dim - k))])
    return X, fracs


def initialize_latent(init, input_dim, Y, seed=0):
    """'PCA' or 'random' (standard normals from default_rng(seed))."""
    if isinstance(init, str) and init.lower() == "pca":
        return pca(Y, input_dim)
    rng = np.random.default_rng(seed)
    return rng.standard_normal((np.asarray(Y).shape[0], input_dim)), np.ones(input_dim)
