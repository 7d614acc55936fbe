"""SparseGPRegression with the VarDTC bound.

Counterpart of gpy_tpu/models/sparse_gp_regression.py:21-101 (GPy/models/
sparse_gp_regression.py). FITC, DTC and PEP and the minibatched bound wait
for ROADMAP A8, uncertain inputs (X_variance) for A12, SparseGPRegressionMD
for A8.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.sparse_gp import SparseGP
from ..inference.var_dtc import VarDTC
from ..kern import RBF
from ..likelihoods import Gaussian

__all__ = ["SparseGPRegression"]


def _default_Z(X, num_inducing, seed=0):
    """num_inducing rows of X by a numpy permutation: the reference's pick."""
    idx = np.random.default_rng(seed).permutation(X.shape[0])[:num_inducing]
    if torch.is_tensor(X):
        return X[torch.as_tensor(idx, device=X.device)].clone()
    return np.asarray(X)[idx].copy()


class SparseGPRegression(SparseGP):
    """Sparse GP regression on the collapsed VarDTC bound.

    SparseGPRegression(X, Y, num_inducing=M, device="cuda").optimize()
    mirrors the GPy call surface; device and dtype as GPRegression's.
    """

    def __init__(self, X, Y, kernel=None, Z=None, num_inducing=10, mean_function=None,
                 X_variance=None, normalizer=None, noise_var=1.0, infer="vardtc",
                 name="sparse_gp", device=None, dtype=None):
        if X_variance is not None:
            raise NotImplementedError("uncertain inputs (X_variance) are not ported yet "
                                      "(ROADMAP A12)")
        if isinstance(infer, str):
            if infer in ("fitc", "dtc", "pep"):
                raise NotImplementedError(f"infer={infer!r} is not ported yet (ROADMAP A8); "
                                          "use 'vardtc'")
            if infer != "vardtc":
                raise ValueError(f"unknown infer {infer!r}")
            infer = VarDTC()
        if kernel is None:
            kernel = RBF(np.shape(X)[1], device=device, dtype=dtype)
        if Z is None:
            Z = _default_Z(X, num_inducing)
        super().__init__(X, Y, Z, kernel, Gaussian(variance=noise_var, device=device, dtype=dtype),
                         inference_method=infer, mean_function=mean_function, name=name,
                         normalizer=normalizer, device=device, dtype=dtype)
