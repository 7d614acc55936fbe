"""Periodic kernels: StdPeriodic and the circle-embedded Matern family.

Counterpart of gpy_tpu/kern/periodic.py:20-130 (GPy/kern/src/
standard_periodic.py StdPeriodic:21, K:125-133). PeriodicExponential and
PeriodicMatern32/52 are, as in the reference, the stationary kernels on the
(cos, sin) embedding of each input dimension (MacKay's construction), not
GPy's finite Fourier bases; their distance is taken from differences, exact
at coincident points. StdPeriodic has a state-space form
(kern/sde.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.transformations import Logexp
from ..util.linalg import safe_sqrt
from .kern import Kern

__all__ = ["StdPeriodic", "PeriodicExponential", "PeriodicMatern32", "PeriodicMatern52"]


class StdPeriodic(Kern):
    """k(x,x') = v * exp(-0.5 sum_d sin^2(pi (x_d - x'_d)/T_d)/l_d^2).

    GPy: standard_periodic.py:125-133.
    """

    def __init__(self, input_dim, variance=1.0, period=None, lengthscale=None, ARD1=False,
                 ARD2=False, active_dims=None, name="std_periodic", device=None, dtype=None):
        super().__init__(input_dim, active_dims, name, device=device, dtype=dtype)
        self.ARD1, self.ARD2 = bool(ARD1), bool(ARD2)
        period = np.ones(input_dim) * (1.0 if period is None else period) if ARD1 else float(
            1.0 if period is None else np.asarray(period).reshape(-1)[0])
        lengthscale = (np.ones(input_dim) * (1.0 if lengthscale is None else lengthscale)
                       if ARD2 else float(1.0 if lengthscale is None
                                          else np.asarray(lengthscale).reshape(-1)[0]))
        self._add_param("variance", variance, transform=Logexp())
        self._add_param("period", period, transform=Logexp())
        self._add_param("lengthscale", lengthscale, transform=Logexp())

    def K(self, X, X2=None):
        X, X2 = self._slice(X), self._slice(X2)
        if X2 is None:
            X2 = X
        base = np.pi * (X[:, None, :] - X2[None, :, :]) / self.period.values
        expo = -0.5 * torch.sum((torch.sin(base) / self.lengthscale.values) ** 2, dim=-1)
        return self.variance.values * torch.exp(expo)

    def Kdiag(self, X):
        return self.variance.values * torch.ones(X.shape[0], dtype=X.dtype, device=X.device)

    def input_sensitivity(self, summarize=True):
        v = float(self.variance)
        ls = np.broadcast_to(self.lengthscale.numpy().reshape(-1), (self.input_dim,))
        return v / ls**2


class _WarpedPeriodic(Kern):
    """k(x,x') = base(u(x), u(x')) with u(x) = (cos(2 pi x/T), sin(2 pi x/T)):
    an exactly periodic stationary covariance. The subclass gives the base
    as a function of the scaled distance r."""

    def __init__(self, input_dim=1, variance=1.0, lengthscale=1.0, period=2 * np.pi,
                 active_dims=None, name="periodic", device=None, dtype=None):
        super().__init__(input_dim, active_dims, name, device=device, dtype=dtype)
        self._add_param("variance", variance, transform=Logexp())
        self._add_param("lengthscale", lengthscale, transform=Logexp())
        self._add_param("period", period, transform=Logexp())

    def _embed(self, X):
        ang = 2 * np.pi * X / self.period.values
        return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)

    def _r(self, X, X2):
        # r2 from the differences of the embeddings, not the reference's
        # |u|^2 + |u'|^2 - 2 u.u': that expansion leaves ~1e-16 at
        # coincident points, whose square root moves K by ~1e-8 and whose
        # gradient is ~1e8 (ROADMAP C(v)); the differences give exactly 0
        U1 = self._embed(X)
        U2 = U1 if X2 is None else self._embed(X2)
        r2 = torch.sum((U1[:, None, :] - U2[None, :, :]) ** 2, dim=-1)
        return safe_sqrt(r2) / self.lengthscale.values

    def _K_of_r(self, r):
        raise NotImplementedError

    def K(self, X, X2=None):
        X, X2 = self._slice(X), self._slice(X2)
        return self._K_of_r(self._r(X, X2))

    def Kdiag(self, X):
        return self.variance.values * torch.ones(X.shape[0], dtype=X.dtype, device=X.device)


class PeriodicExponential(_WarpedPeriodic):
    def __init__(self, input_dim=1, variance=1.0, lengthscale=1.0, period=2 * np.pi,
                 active_dims=None, name="periodic_exponential", device=None, dtype=None, **kw):
        super().__init__(input_dim, variance, lengthscale, period, active_dims, name,
                         device=device, dtype=dtype)

    def _K_of_r(self, r):
        return self.variance.values * torch.exp(-r)


class PeriodicMatern32(_WarpedPeriodic):
    def __init__(self, input_dim=1, variance=1.0, lengthscale=1.0, period=2 * np.pi,
                 active_dims=None, name="periodic_Mat32", device=None, dtype=None, **kw):
        super().__init__(input_dim, variance, lengthscale, period, active_dims, name,
                         device=device, dtype=dtype)

    def _K_of_r(self, r):
        s3 = np.sqrt(3.0)
        return self.variance.values * (1 + s3 * r) * torch.exp(-s3 * r)


class PeriodicMatern52(_WarpedPeriodic):
    def __init__(self, input_dim=1, variance=1.0, lengthscale=1.0, period=2 * np.pi,
                 active_dims=None, name="periodic_Mat52", device=None, dtype=None, **kw):
        super().__init__(input_dim, variance, lengthscale, period, active_dims, name,
                         device=device, dtype=dtype)

    def _K_of_r(self, r):
        s5 = np.sqrt(5.0)
        return self.variance.values * (1 + s5 * r + 5.0 / 3.0 * r**2) * torch.exp(-s5 * r)
