"""PCA by numpy's eigh, primal or dual, with NaN-tolerant centering: a copy
of gpy_tpu/util/pca.py:16-56 (GPy/util/pca.py:18), numpy only."""
from __future__ import annotations

import numpy as np

__all__ = ["PCA"]


class PCA:
    """Eigendecomposition PCA: of the covariance if N >= D, else of the Gram
    (the same spectrum, cheaper in the smaller dimension)."""

    def __init__(self, X):
        X = np.array(X, dtype=float)
        self.mu = np.nanmean(X, axis=0)
        self.sigma = np.nanstd(X, axis=0)
        Xc = self._center(X)
        if Xc.shape[0] >= Xc.shape[1]:
            vals, vecs = np.linalg.eigh(Xc.T @ Xc)
        else:
            dvals, dvecs = np.linalg.eigh(Xc @ Xc.T)
            vecs = Xc.T @ dvecs
            norms = np.sqrt((vecs**2).sum(0))
            vecs = vecs / np.where(norms == 0, 1e-30, norms)
            vals = dvals
        order = np.argsort(vals)[::-1]
        self.eigvals = np.clip(vals[order], 0.0, np.inf)
        self.eigvectors = vecs[:, order]
        self.fracs = self.eigvals / max(self.eigvals.sum(), 1e-300)
        self.Q = self.eigvals.shape[0]

    def _center(self, X):
        X = np.where(np.isnan(X), self.mu, X)
        return (X - self.mu) / np.where(self.sigma == 0, 1e-30, self.sigma)

    def project(self, X, Q=None):
        """Project (new) data onto the first Q principal components."""
        Q = self.Q if Q is None else Q
        return self._center(np.array(X, dtype=float)) @ self.eigvectors[:, :Q]
