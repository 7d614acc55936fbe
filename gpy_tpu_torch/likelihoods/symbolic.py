"""SymbolicLikelihood: a likelihood from a sympy log-pdf.

Counterpart of gpy_tpu/likelihoods/symbolic.py (the reference's stand-in
for GPy/core/symbolic.py's code generation, which GPy advertises for
likelihoods but ships no class for). log p(y | f), and optionally the
conditional mean and variance, are lambdified to torch
(kern/symbolic.py's `lambdify_torch`, with its handling of numeric
constants, its broadcasting and its pickling); everything else is the
Likelihood base: autograd derivatives, Gauss-Hermite quadrature, EP
moments, variational expectations and the Metropolis sampler.
"""
from __future__ import annotations

import torch

from ..config import resolve_device
from ..core.transformations import Logexp
from ..kern.symbolic import as_shape, lambdify_torch
from .likelihood import Likelihood

__all__ = ["SymbolicLikelihood"]


class SymbolicLikelihood(Likelihood):
    """Likelihood from a sympy log-pdf expression.

    log_pdf: a sympy expression for log p(y | f) in the symbols `f` (the
    GP link output) and `y` (the observation); every other free symbol is
    a trainable parameter (positive by default). Optional expressions
    `conditional_mean` / `conditional_variance` (in `f` and the
    parameters) enable the moment-based predictive API.

    Example (Gaussian with trainable noise):
        f, y, s = sympy.symbols("f y s", positive=True)
        lik = SymbolicLikelihood(-(y - f)**2/(2*s) - sympy.log(2*sympy.pi*s)/2,
                                 conditional_mean=f, conditional_variance=s,
                                 device="cuda")
    """

    def __init__(self, log_pdf, parameters=None, conditional_mean=None,
                 conditional_variance=None, gp_link=None, name="symbolic", positive_params=True,
                 device=None, dtype=None):
        super().__init__(gp_link=gp_link, name=name, device=device, dtype=dtype)
        resolve_device(device)  # raises for "cuda" without a card, parameters or not
        names = {s.name for s in log_pdf.free_symbols}
        if "f" not in names or "y" not in names:
            raise ValueError("log_pdf must use symbols 'f' and 'y'")
        param_syms = sorted((s for s in log_pdf.free_symbols if s.name not in ("f", "y")),
                            key=lambda s: s.name)
        parameters = dict(parameters or {})
        unknown = set(parameters) - {s.name for s in param_syms}
        if unknown:
            raise ValueError(f"parameters {sorted(unknown)} not in the expression")
        tr = Logexp() if positive_params else None
        for s in param_syms:
            self._add_param(s.name, float(parameters.get(s.name, 1.0)), transform=tr)
        self.__dict__["_param_names"] = [s.name for s in param_syms]
        self.__dict__["_sym_logpdf"] = log_pdf
        self.__dict__["_sym_cmean"] = conditional_mean
        self.__dict__["_sym_cvar"] = conditional_variance
        self._rebuild_after_load()

    def _rebuild_after_load(self):
        """(Re)lambdify the stored expressions."""
        import sympy

        f, y = sympy.Symbol("f"), sympy.Symbol("y")
        ps = [sympy.Symbol(n) for n in self._param_names]
        self.__dict__["_logpdf_fn"] = lambdify_torch([f, y, *ps], self._sym_logpdf)
        for attr, expr in (("_cmean_fn", self._sym_cmean), ("_cvar_fn", self._sym_cvar)):
            self.__dict__[attr] = None if expr is None else lambdify_torch([f, *ps], expr)

    def __getstate__(self):
        d = dict(self.__dict__)
        for k in ("_logpdf_fn", "_cmean_fn", "_cvar_fn"):
            d.pop(k, None)
        return d

    def __setstate__(self, d):
        super().__setstate__(d)
        self._rebuild_after_load()

    def _pvals(self):
        return [getattr(self, n).values for n in self._param_names]

    def logpdf_link(self, link_f, y, Y_metadata=None):
        y = self._as_tensor(y, link_f)
        out = self._logpdf_fn(link_f, y, *self._pvals())
        return as_shape(out, torch.broadcast_shapes(link_f.shape, y.shape), link_f)

    def conditional_mean(self, f):
        if self._cmean_fn is None:
            raise NotImplementedError(
                "pass conditional_mean= to enable the moment predictive API")
        return as_shape(self._cmean_fn(f, *self._pvals()), f.shape, f)

    def conditional_variance(self, f):
        if self._cvar_fn is None:
            raise NotImplementedError(
                "pass conditional_variance= to enable the moment predictive API")
        return as_shape(self._cvar_fn(f, *self._pvals()), f.shape, f)

    def __str__(self):
        return f"SymbolicLikelihood({self._sym_logpdf})"
