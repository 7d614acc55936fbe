"""Likelihood base class.

Counterpart of the part of gpy_tpu/likelihoods/likelihood.py that the
Gaussian likelihoods use. The Gauss-Hermite engine (variational
expectations, EP moments, generic predictive moments) waits for the
non-Gaussian slice, which is the first to use it (ROADMAP A9).
"""
from __future__ import annotations

from typing import Optional

from ..core.module import Module
from .link_functions import GPTransformation, Identity

__all__ = ["Likelihood"]


class Likelihood(Module):
    """Base likelihood p(y | f). Subclasses implement `logpdf_link` (given
    the transformed latent) and `conditional_mean/variance`."""

    log_concave = False

    def __init__(self, gp_link: Optional[GPTransformation] = None, name: str = "likelihood",
                 device=None, dtype=None):
        super().__init__(name=name, device=device, dtype=dtype)
        self.gp_link = gp_link or Identity()

    def logpdf_link(self, link_f, y, Y_metadata=None):
        raise NotImplementedError

    def logpdf(self, f, y, Y_metadata=None):
        return self.logpdf_link(self.gp_link.transf(f), y, Y_metadata)

    def variational_expectations(self, Y, m, v, Y_metadata=None):
        """F_n = E_{N(f; m_n, v_n)}[log p(y_n | f)]; the Gaussian likelihood
        has it in closed form, every other one needs the quadrature."""
        raise NotImplementedError(
            f"{type(self).__name__}.variational_expectations needs the Gauss-Hermite engine, "
            "not ported yet (ROADMAP A9, which took over A4's quadrature)")

    def predictive_values(self, mu, var, full_cov=False, Y_metadata=None):
        raise NotImplementedError

    def predictive_quantiles(self, mu, var, quantiles, Y_metadata=None):
        raise NotImplementedError
