"""SparseGPRegression (VarDTC, FITC, DTC or PEP) and SparseGPRegressionMD.

Counterpart of gpy_tpu/models/sparse_gp_regression.py:21-139 (GPy/models/
sparse_gp_regression.py, sparse_gp_regression_md.py). With X_variance the
inputs are uncertain, X ~ N(X, X_variance), fixed data: the VarDTC bound
takes the psi statistics of that q(X) instead of the Grams.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..core.sparse_gp import SparseGP
from ..inference.fitc import DTC, FITC, PEP
from ..inference.var_dtc import VarDTC
from ..inference.var_dtc_missing import VarDTCMissingData
from ..kern import RBF
from ..likelihoods import Gaussian

__all__ = ["SparseGPRegression", "SparseGPRegressionMD"]


def _default_Z(X, num_inducing, seed=0):
    """num_inducing rows of X by a numpy permutation: the reference's pick."""
    idx = np.random.default_rng(seed).permutation(X.shape[0])[:num_inducing]
    if torch.is_tensor(X):
        return X[torch.as_tensor(idx, device=X.device)].clone()
    return np.asarray(X)[idx].copy()


class SparseGPRegression(SparseGP):
    """Sparse GP regression, by default on the collapsed VarDTC bound.

    SparseGPRegression(X, Y, num_inducing=M, device="cuda").optimize()
    mirrors the GPy call surface; device and dtype as GPRegression's.
    infer is "vardtc", "fitc", "dtc" or "pep" (power EP at pep_alpha), or
    an inference instance such as VarDTC_minibatch(batchsize=2048).
    """

    def __init__(self, X, Y, kernel=None, Z=None, num_inducing=10, mean_function=None,
                 X_variance=None, normalizer=None, noise_var=1.0, infer="vardtc",
                 pep_alpha=0.5, name="sparse_gp", device=None, dtype=None):
        if X_variance is not None and not (infer == "vardtc" or isinstance(infer, VarDTC)):
            raise ValueError("uncertain inputs need the VarDTC bound")
        if isinstance(infer, str):
            methods = {"vardtc": VarDTC, "fitc": FITC, "dtc": DTC, "pep": lambda: PEP(pep_alpha)}
            if infer not in methods:
                raise ValueError(f"unknown infer {infer!r}")
            infer = methods[infer]()
        if kernel is None:
            kernel = RBF(np.shape(X)[1], device=device, dtype=dtype)
        if Z is None:
            Z = _default_Z(X, num_inducing)
        super().__init__(X, Y, Z, kernel, Gaussian(variance=noise_var, device=device, dtype=dtype),
                         inference_method=infer, mean_function=mean_function, name=name,
                         normalizer=normalizer, device=device, dtype=dtype)
        self._X_variance = None if X_variance is None else self._as_data(X_variance)

    def _bound_args(self):
        args = super()._bound_args()
        if self._X_variance is None:
            return args
        return args[:-1] + (SimpleNamespace(mean=self.X, variance=self._X_variance),)


class SparseGPRegressionMD(SparseGP):
    """Sparse GP regression with missing data (GPy sparse_gp_regression_md.py:12).

    D outputs share one GP prior, each observed on its own rows of the
    stacked inputs: indexD[n] is row n's output. The stacked (X, Y, indexD)
    is scattered into an (N, D) Y with NaN where an output is not observed,
    which VarDTCMissingData reads as zero noise precision. With
    individual_Y_noise each output has its own noise variance.
    """

    def __init__(self, X, Y, indexD, kernel=None, Z=None, num_inducing=10, normalizer=None,
                 individual_Y_noise=False, name="sparse_gp_md", device=None, dtype=None):
        X = np.asarray(X, dtype=float)
        Y = np.asarray(Y, dtype=float).reshape(-1)
        indexD = np.asarray(indexD).astype(int).reshape(-1)
        if not X.shape[0] == Y.shape[0] == indexD.shape[0]:
            raise ValueError("X, Y and indexD need one row each")
        D = int(indexD.max()) + 1
        N = X.shape[0]
        Yfull = np.full((N, D), np.nan)
        Yfull[np.arange(N), indexD] = Y
        if kernel is None:
            kernel = RBF(X.shape[1], device=device, dtype=dtype)
        if Z is None:
            Z = _default_Z(X, num_inducing)
        if individual_Y_noise:
            noise0 = np.array([np.var(Y[indexD == d]) * 0.01 + 1e-8 for d in range(D)])
        else:
            noise0 = float(np.var(Y)) * 0.01
        super().__init__(X, Yfull, Z, kernel, Gaussian(variance=noise0, device=device, dtype=dtype),
                         inference_method=VarDTCMissingData(), name=name, normalizer=normalizer,
                         device=device, dtype=dtype)
        self.indexD = indexD
        self.individual_Y_noise = bool(individual_Y_noise)
