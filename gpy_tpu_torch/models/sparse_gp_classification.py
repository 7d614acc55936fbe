"""Sparse GP classification. Reference: gpy_tpu/models/
sparse_gp_classification.py (GPy/models/sparse_gp_classification.py:12,
103): the uncollapsed SVGP bound with a Bernoulli likelihood, whose data
term is the Gauss-Hermite quadrature; GPy's constructor surface, and the
uncertain-input form."""
from __future__ import annotations

import numpy as np
import torch

from ..core.svgp import SVGP
from ..core.variational import NormalPosterior
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
    sparse_gp_classification.py:103), as the reference has it
    (gpy_tpu/models/sparse_gp_classification.py:33-46): SparseGPClassification
    with a NormalPosterior qX beside it. qX never enters the objective, so
    X_variance does not move the bound and qX's gradient is 0 (ROADMAP
    C(o)); an expected-Gram SVGP bound would be a feature the reference
    lacks."""

    def __init__(self, X, X_variance, Y, kernel=None, Z=None, num_inducing=10,
                 Y_metadata=None, name="SparseGPClassificationUI", device=None, dtype=None):
        super().__init__(X, Y, kernel=kernel, Z=Z, num_inducing=num_inducing,
                         Y_metadata=Y_metadata, name=name, device=device, dtype=dtype)
        X = X.detach().cpu().numpy() if torch.is_tensor(X) else np.asarray(X, dtype=float)
        self.qX = NormalPosterior(X, np.asarray(X_variance, dtype=float), device=device,
                                  dtype=dtype)
