"""Output warping functions for WarpedGP.

Counterpart of gpy_tpu/util/warping_functions.py (GPy/util/
warping_functions.py: WarpingFunction:10, TanhFunction:71, LogFunction,
IdentityFunction). A warping function is a Module whose parameters follow
the model's kernel and likelihood in the flat vector. The generic
derivative f'(y) is autograd's; f_inv is a fixed number of Newton steps
with no read back to the host.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.module import Module
from ..core.transformations import Logexp

__all__ = ["WarpingFunction", "TanhFunction", "LogFunction", "IdentityFunction"]


class WarpingFunction(Module):
    """A monotone map f of the outputs, elementwise."""

    def f(self, y):
        raise NotImplementedError

    def fgrad_y(self, y):
        """f'(y) elementwise by autograd, kept differentiable with respect
        to the parameters where a graph is being recorded."""
        record = torch.is_grad_enabled()
        with torch.enable_grad():
            x = y if y.requires_grad else y.detach().requires_grad_(True)
            return torch.autograd.grad(torch.sum(self.f(x)), x, create_graph=record)[0]

    def f_inv(self, z, max_iterations: int = 100, y=None):
        """f^-1(z) by max_iterations Newton steps from y (z when None), every
        step taken: nothing is read back to the host to stop early. GPy:
        warping_functions.py:34."""
        yy = z if y is None else y
        for _ in range(max_iterations):
            yy = yy - (self.f(yy) - z) / torch.clamp(self.fgrad_y(yy), min=1e-12)
        return yy


class TanhFunction(WarpingFunction):
    """f(y) = d y + sum_i a_i tanh(b_i (y + c_i)) (Snelson et al. 2004), a
    and b positive (psi_ab, (n_terms, 2)), c free (psi_c, (n_terms, 1)), d
    positive. GPy: warping_functions.py:71-120."""

    def __init__(self, n_terms: int = 3, initial_y=None, name="warp_tanh", device=None,
                 dtype=None):
        super().__init__(name=name, device=device, dtype=dtype)
        self.n_terms = n_terms
        self._add_param("psi_ab", np.ones((n_terms, 2)), transform=Logexp())
        self._add_param("psi_c", np.ones((n_terms, 1)))
        self._add_param("d", 1.0, transform=Logexp())
        self.initial_y = initial_y

    def _terms(self, y):
        ab = self.psi_ab.values
        a, b = ab[:, 0], ab[:, 1]
        t = torch.tanh(b * (y[..., None] + self.psi_c.values[:, 0]))
        return a, b, t

    def f(self, y):
        a, _, t = self._terms(y)
        return self.d.values * y + torch.sum(a * t, dim=-1)

    def fgrad_y(self, y):
        a, b, t = self._terms(y)
        return self.d.values + torch.sum(a * b * (1 - t * t), dim=-1)


class LogFunction(WarpingFunction):
    """f(y) = log(y). GPy: warping_functions.py LogFunction."""

    def __init__(self, name="warp_log", device=None, dtype=None):
        super().__init__(name=name, device=device, dtype=dtype)

    def f(self, y):
        return torch.log(y)

    def fgrad_y(self, y):
        return 1.0 / y

    def f_inv(self, z, **kw):
        return torch.exp(z)


class IdentityFunction(WarpingFunction):
    def __init__(self, name="warp_identity", device=None, dtype=None):
        super().__init__(name=name, device=device, dtype=dtype)

    def f(self, y):
        return y

    def fgrad_y(self, y):
        return torch.ones_like(y)

    def f_inv(self, z, **kw):
        return z
