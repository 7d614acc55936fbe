"""Spike-and-slab GPLVM and MRD.

Counterpart of gpy_tpu/models/ss_gplvm.py:23-73 (GPy/models/ss_gplvm.py:177,
ss_mrd.py:19): a variational GPLVM whose q(X) has an inclusion probability
gamma per point and latent dimension, under the spike-and-slab psi
statistics (kern/psi_comp.py) and the spike-and-slab KL.
"""
from __future__ import annotations

import numpy as np

from ..core.sparse_gp import SparseGP
from ..core.variational import SpikeAndSlabPosterior
from ..inference.var_dtc import VarDTC
from ..kern import RBF
from ..likelihoods import Gaussian
from ..util.initialization import initialize_latent
from .sparse_gp_regression import _default_Z

__all__ = ["SSGPLVM", "SSMRD"]


class SSGPLVM(SparseGP):
    """Gamma defaults to 0.5 + 0.1 (default_rng(0).random - 0.5), the noise
    variance to max(0.01 var(Y), 1e-4): the reference's start."""

    def __init__(self, Y, input_dim, X=None, X_variance=None, Gamma=None, init="PCA",
                 num_inducing=10, Z=None, kernel=None, pi=0.5, name="ss_gplvm", device=None,
                 dtype=None):
        Y = np.asarray(Y, dtype=float)
        if X is None:
            X, _ = initialize_latent(init, input_dim, Y)
        if X_variance is None:
            X_variance = 0.5 * np.ones_like(X)
        if Gamma is None:
            Gamma = 0.5 + 0.1 * (np.random.default_rng(0).random(X.shape) - 0.5)
        if Z is None:
            Z = _default_Z(X, num_inducing)
        if kernel is None:
            kernel = RBF(input_dim, ARD=True, device=device, dtype=dtype)
        noise0 = max(0.01 * float(np.var(Y)), 1e-4)
        super().__init__(X, Y, Z, kernel, Gaussian(variance=noise0, device=device, dtype=dtype),
                         inference_method=VarDTC(), name=name, device=device, dtype=dtype)
        self.pi = float(pi)
        self.qX = SpikeAndSlabPosterior(X, X_variance, Gamma, device=device, dtype=dtype)

    def _bound_args(self):
        return super()._bound_args()[:-1] + (self.qX,)

    def _kl(self):
        return self.qX.KL(self.pi)

    @property
    def latent_gamma(self):
        return self.qX.gamma.numpy()


class SSMRD:
    """Multi-view spike-and-slab MRD (GPy: ss_mrd.py:19): one SSGPLVM per
    view. Like the reference, a plain container, not a Model."""

    def __init__(self, Ylist, input_dim, num_inducing=10, pi=0.5, name="ss_mrd", device=None,
                 dtype=None):
        self.models = [SSGPLVM(Y, input_dim, num_inducing=num_inducing, pi=pi,
                               name=f"{name}_view{i}", device=device, dtype=dtype)
                       for i, Y in enumerate(Ylist)]

    def optimize(self, **kw):
        for m in self.models:
            m.optimize(**kw)

    def log_likelihood(self):
        return sum(m.log_likelihood().item() for m in self.models)
