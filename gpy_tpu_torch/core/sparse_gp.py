"""SparseGP base: an inducing-point GP with Z as a trainable parameter.

Counterpart of gpy_tpu/core/sparse_gp.py:20-86 (GPy/core/sparse_gp.py). The
psi-statistics routing of GPy's gradients is gone: dF/dZ is autograd's,
since Z is one more raw leaf. The reference's jitted posterior program is a
plain no_grad call here, cached against the parameters as GP.posterior is.

A subclass names the bound's arguments (`_bound_args`: the latent inputs of
a GPLVM, a q(X)) and the terms its objective adds to the bound (`_kl`).
The batched objective (HMC chains, parallel restarts; the reference vmaps
the objective, gpy_tpu/mcmc/__init__.py:228-264) evaluates each row's
operands under its binding -- Kmm, Kmn or the psi statistics, one Gram
launch each on the card -- stacks them and factors the (C, M, M) systems in
one batched call (`batched_log_marginal` of VarDTC, VarDTC_minibatch, FITC,
DTC and PEP). Any other sparse model evaluates the rows one after the
other: an inference without `operands` (VarDTCMissingData, EPDTC,
SVGPInference), or a model whose log_likelihood is not the one bound
minus `_kl` (MRD's sum over views, SVGP's ELBO).
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

    # --- the bound and what the objective adds to it ------------------------
    def _bound_args(self):
        """(kern, X, Z, likelihood, Y, mean_function, Y_metadata, qX) of the
        inference's bound."""
        return (self.kern, self._inputs(), self.Z.values, self.likelihood, self.Y_normalized,
                None, self.Y_metadata, None)

    def _kl(self):
        """What log_likelihood subtracts from the bound: KL(q(X) || p(X))
        for the Bayesian GPLVMs, 0 here."""
        return 0.0

    def log_likelihood(self) -> torch.Tensor:
        return self.inference_method.marginal_likelihood(*self._bound_args()) - self._kl()

    def _compute_posterior(self):
        return self.inference_method.inference(*self._bound_args())[0]

    # --- the batched objective ---------------------------------------------
    def _batched_objective(self, flats: torch.Tensor) -> torch.Tensor:
        """(C,) objectives at the rows of `flats` (Model._batched_objective)."""
        inf = self.inference_method
        if hasattr(inf, "operands") and type(self).log_likelihood is SparseGP.log_likelihood:
            ops, extra = [], []
            for row in flats:
                with self.bind_flat_raw(row):
                    ops.append(inf.operands(*self._bound_args()))
                    extra.append(self._kl() - self.log_prior())
            stacked = {k: torch.stack([o[k] for o in ops]) for k in ops[0]}
            return -inf.batched_log_marginal(stacked, self.Y_normalized) + torch.stack(extra)
        return torch.stack([self._flat_objective(row) for row in flats])
