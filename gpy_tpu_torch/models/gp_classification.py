"""GP classification. Reference: gpy_tpu/models/gp_classification.py
(GPy/models/gp_classification.py:10, and the Laplace alternative of GPy's
examples/classification.py)."""
from __future__ import annotations

import numpy as np

from ..core.gp import GP
from ..inference.ep import EP
from ..inference.laplace import Laplace
from ..kern import RBF
from ..likelihoods import Bernoulli

__all__ = ["GPClassification", "GPClassificationLaplace"]


class GPClassification(GP):
    """Binary GP classification: Bernoulli(probit) likelihood and EP.

    GPClassification(X, Y, device="cuda").optimize().predict(Xs) mirrors
    the GPy call surface, Y in {0, 1}; predict's mean is p(y* = 1). device
    and dtype as GPRegression's.
    """

    def __init__(self, X, Y, kernel=None, Y_metadata=None, mean_function=None,
                 inference_method=None, likelihood=None, name="gp_classification",
                 device=None, dtype=None):
        if kernel is None:
            kernel = RBF(np.shape(X)[1], device=device, dtype=dtype)
        super().__init__(
            X, Y, kernel, likelihood or Bernoulli(device=device, dtype=dtype),
            inference_method=inference_method or EP(),
            mean_function=mean_function, name=name, Y_metadata=Y_metadata,
            device=device, dtype=dtype,
        )


class GPClassificationLaplace(GPClassification):
    """GPClassification with the Laplace approximation in place of EP."""

    def __init__(self, X, Y, kernel=None, **kw):
        super().__init__(X, Y, kernel=kernel, inference_method=Laplace(), **kw)
