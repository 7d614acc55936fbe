"""SparseGP base: an inducing-point GP with Z as a trainable parameter.

Counterpart of gpy_tpu/core/sparse_gp.py:20-86 (GPy/core/sparse_gp.py). The
psi-statistics routing of GPy's gradients is gone: dF/dZ is autograd's,
since Z is one more raw leaf. The reference's jitted posterior program is a
plain no_grad call here, cached against the parameters as GP.posterior is.
"""
from __future__ import annotations

import torch

from ..inference.var_dtc import VarDTC
from .gp import GP

__all__ = ["SparseGP"]


class SparseGP(GP):
    def __init__(self, X, Y, Z, kernel, likelihood, inference_method=None, mean_function=None,
                 name="sparse_gp", Y_metadata=None, normalizer=None, device=None, dtype=None):
        super().__init__(X, Y, kernel, likelihood,
                         inference_method=inference_method or VarDTC(),
                         mean_function=mean_function, name=name, Y_metadata=Y_metadata,
                         normalizer=normalizer, device=device, dtype=dtype)
        self._add_param("Z", self._as_data(Z))
        self.num_inducing = self.Z.shape[0]

    @property
    def _predictive_variable(self) -> torch.Tensor:
        return self.Z.values

    def log_likelihood(self) -> torch.Tensor:
        return self.inference_method.marginal_likelihood(
            self.kern, self.X, self.Z.values, self.likelihood, self.Y_normalized, None,
            self.Y_metadata)

    def _compute_posterior(self):
        return self.inference_method.inference(
            self.kern, self.X, self.Z.values, self.likelihood, self.Y_normalized, None,
            self.Y_metadata)[0]
