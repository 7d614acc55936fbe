"""Sparse GP classification. Reference: gpy_tpu/models/
sparse_gp_classification.py (GPy/models/sparse_gp_classification.py:12,
103): the uncollapsed SVGP bound with a Bernoulli likelihood, whose data
term is the Gauss-Hermite quadrature; GPy's constructor surface."""
from __future__ import annotations

import numpy as np
import torch

from ..core.svgp import SVGP
from ..kern import RBF
from ..likelihoods import Bernoulli
from .sparse_gp_regression import _default_Z

__all__ = ["SparseGPClassification", "SparseGPClassificationUncertainInput"]


class SparseGPClassification(SVGP):
    """Z defaults to num_inducing rows of X by numpy's default_rng(0)
    permutation, the reference's pick."""

    def __init__(self, X, Y=None, likelihood=None, kernel=None, Z=None, num_inducing=10,
                 Y_metadata=None, name="SparseGPClassification", device=None, dtype=None):
        X = X.detach().cpu().numpy() if torch.is_tensor(X) else np.asarray(X, dtype=float)
        if kernel is None:
            kernel = RBF(X.shape[1], device=device, dtype=dtype)
        if Z is None:
            Z = _default_Z(X, num_inducing)
        super().__init__(X, Y, Z, kernel, likelihood or Bernoulli(device=device, dtype=dtype),
                         Y_metadata=Y_metadata, name=name, device=device, dtype=dtype)


class SparseGPClassificationUncertainInput(SparseGPClassification):
    """Classification with uncertain inputs X ~ N(X_mean, X_var) (GPy:
    sparse_gp_classification.py:103). It needs core/variational's
    NormalPosterior, which is not ported yet."""

    def __init__(self, X, X_variance, Y, kernel=None, Z=None, num_inducing=10,
                 Y_metadata=None, name="SparseGPClassificationUI", device=None, dtype=None):
        raise NotImplementedError("uncertain inputs (NormalPosterior) are not ported yet "
                                  "(ROADMAP A12)")
