"""GPVariationalGaussianApproximation.

Counterpart of gpy_tpu/models/gp_var_gauss.py:17-42 (GPy/models/
gp_var_gauss.py:12 with inference/var_gauss.py): the variational parameters
alpha (N, 1, free) and lam (N, 1, positive) are the model's own, ahead of
the kernel's and the likelihood's in the flat vector.
"""
from __future__ import annotations

import numpy as np

from ..core.gp import GP
from ..core.transformations import Logexp
from ..inference.var_gauss import VarGauss

__all__ = ["GPVariationalGaussianApproximation"]


class GPVariationalGaussianApproximation(GP):
    def __init__(self, X, Y, kernel, likelihood, Y_metadata=None, name="VarGP", device=None,
                 dtype=None):
        super().__init__(X, Y, kernel, likelihood, inference_method=VarGauss(),
                         Y_metadata=Y_metadata, name=name, device=device, dtype=dtype)
        N = self.num_data
        self._add_param("alpha", np.zeros((N, 1)))
        self._add_param("lam", np.ones((N, 1)), transform=Logexp())

    def log_likelihood(self):
        return self.inference_method.elbo(self.kern, self._inputs(), self.likelihood,
                                          self.Y_normalized, self.alpha.values,
                                          self.lam.values, self.Y_metadata)

    def _compute_posterior(self):
        # alpha is the parameter itself (no transform): the posterior keeps a
        # copy, which later writes to the parameter do not reach
        return self.inference_method.inference(self.kern, self._inputs(), self.likelihood,
                                               self.Y_normalized, self.alpha.values.clone(),
                                               self.lam.values, self.Y_metadata)[0]
