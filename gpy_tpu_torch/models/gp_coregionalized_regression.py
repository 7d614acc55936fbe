"""GPHeteroscedasticRegression: exact GP regression, one noise variance per point.

Counterpart of gpy_tpu/models/gp_coregionalized_regression.py:63-74 (GPy/
models/gp_heteroscedastic_regression.py:10). The file keeps the reference's
name; its other classes (GPCoregionalizedRegression,
SparseGPCoregionalizedRegression, GPOffsetRegression) wait for the
multi-output slice (ROADMAP A11).
"""
from __future__ import annotations

import numpy as np

from ..core.gp import GP
from ..inference.exact import ExactGaussianInference
from ..kern import RBF
from ..likelihoods import HeteroscedasticGaussian

__all__ = ["GPHeteroscedasticRegression"]


class GPHeteroscedasticRegression(GP):
    """Exact GP regression whose likelihood learns one variance per data
    point, indexed by Y_metadata["output_index"] (default: point n has
    variance n)."""

    def __init__(self, X, Y, kernel=None, Y_metadata=None, name="GPHR", device=None,
                 dtype=None):
        N, D = np.shape(X)
        if Y_metadata is None:
            Y_metadata = {"output_index": np.arange(N).reshape(-1, 1)}
        if kernel is None:
            kernel = RBF(D, device=device, dtype=dtype)
        likelihood = HeteroscedasticGaussian(Y_metadata, device=device, dtype=dtype)
        super().__init__(X, Y, kernel, likelihood, Y_metadata=Y_metadata, name=name,
                         inference_method=ExactGaussianInference(), device=device, dtype=dtype)
