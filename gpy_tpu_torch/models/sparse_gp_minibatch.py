"""SparseGPMiniBatch and BayesianGPLVMMiniBatch: sparse models with missing
entries of Y.

Counterpart of gpy_tpu/models/sparse_gp_minibatch.py:28-73 (GPy/models/
sparse_gp_minibatch.py:18, bayesian_gplvm_minibatch.py:12). A NaN in Y is a
missing entry: such a model goes to VarDTCMissingData, whose output columns
are one batch of bounds, so every column is evaluated in full where GPy
subsampled them; `stochastic` and `batchsize` are accepted and not used, as
in the reference.
"""
from __future__ import annotations

import numpy as np

from ..core.sparse_gp import SparseGP
from ..core.variational import NormalPosterior
from ..inference.var_dtc import VarDTC
from ..inference.var_dtc_missing import VarDTCMissingData
from ..kern import RBF
from ..likelihoods import Gaussian
from ..util.initialization import initialize_latent
from .sparse_gp_regression import _default_Z

__all__ = ["SparseGPMiniBatch", "BayesianGPLVMMiniBatch"]


class SparseGPMiniBatch(SparseGP):
    def __init__(self, X, Y, Z, kernel, likelihood, inference_method=None, missing_data=False,
                 stochastic=False, batchsize=1, name="sparse gp minibatch", **kw):
        Ynp = np.asarray(Y, dtype=float)
        missing = bool(missing_data) or bool(np.isnan(Ynp).any())
        if inference_method is None:
            inference_method = VarDTCMissingData() if missing else VarDTC()
        super().__init__(X, Ynp, Z, kernel, likelihood, inference_method=inference_method,
                         name=name, **kw)
        self.missing_data = missing


class BayesianGPLVMMiniBatch(SparseGPMiniBatch):
    """Bayesian GPLVM with missing data (GPy: bayesian_gplvm_minibatch.py:12):
    the PCA start fills a missing entry with its column's mean."""

    def __init__(self, Y, input_dim, X=None, X_variance=None, init="PCA", num_inducing=10,
                 Z=None, kernel=None, missing_data=True, stochastic=False, batchsize=1,
                 name="bgplvm minibatch", device=None, dtype=None):
        Ynp = np.asarray(Y, dtype=float)
        Yfill = np.where(np.isnan(Ynp), np.nanmean(Ynp, axis=0, keepdims=True), Ynp)
        if X is None:
            X, _ = initialize_latent(init, input_dim, Yfill)
        if X_variance is None:
            X_variance = 0.5 * np.ones_like(X)
        if Z is None:
            Z = _default_Z(X, num_inducing)
        if kernel is None:
            kernel = RBF(input_dim, ARD=True, device=device, dtype=dtype)
        super().__init__(X, Ynp, Z, kernel, Gaussian(variance=1.0, device=device, dtype=dtype),
                         missing_data=missing_data, name=name, device=device, dtype=dtype)
        self.qX = NormalPosterior(X, X_variance, device=device, dtype=dtype)

    def _bound_args(self):
        return super()._bound_args()[:-1] + (self.qX,)

    def _kl(self):
        return self.qX.KL()
