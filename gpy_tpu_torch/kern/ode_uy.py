"""ODE_UY, ODE_UYC, ODE_st and ODE_t: joint covariances of an ODE's input
and output.

Counterpart of gpy_tpu/kern/ode_uy.py (GPy/kern/src/ODE_UY.py, ODE_UYC.py,
ODE_st.py, ODE_t.py). The reference's row loops are index masks here and
the gradients autograd's. Index conventions are the reference's: ODE_UY and
ODE_UYC take X = [t, index] with 0 = U, 1 = Y; ODE_st takes [t, x, index]
and ODE_t [t, index], both with 0 = Y, 1 = U.

One reference fault is not copied (ROADMAP C(ab)): ODE_UY's U-Y crosses
select by the sign of d = t - t' between two forms, each of which
overflows for the other sign once |d| passes ~709 lengthscales, and the
unselected inf times the where's zero cotangent is NaN in the gradient.
Here each cross form is evaluated at |d| or -|d| only, where it is
bounded, and its exponentials are grouped as e^{-...}: no branch overflows.
"""
from __future__ import annotations

import math

import torch

from ..core.transformations import Logexp
from .kern import Kern

__all__ = ["ODE_UY", "ODE_UYC", "ODE_st", "ODE_t"]

SQRT3 = math.sqrt(3.0)


def _index(X, col):
    """The index column as integers, truncated as the reference's int32 cast."""
    return X[:, col].to(torch.int64)


class ODE_UY(Kern):
    """a dy/dt + b y = U with a Matern-3/2 prior on U."""

    def __init__(self, input_dim=2, variance_U=3.0, variance_Y=1.0, lengthscale_U=1.0,
                 lengthscale_Y=1.0, active_dims=None, name="ode_uy", device=None, dtype=None):
        assert input_dim == 2, "only defined for 2 input dims (t + index)"
        super().__init__(input_dim, active_dims, name, device=device, dtype=dtype)
        self._add_param("variance_U", variance_U, transform=Logexp())
        self._add_param("variance_Y", variance_Y, transform=Logexp())
        self._add_param("lengthscale_U", lengthscale_U, transform=Logexp())
        self._add_param("lengthscale_Y", lengthscale_Y, transform=Logexp())

    def _rates(self):
        return SQRT3 / self.lengthscale_U.values, 1.0 / self.lengthscale_Y.values

    def K(self, X, X2=None):
        X = self._slice(X)
        X2 = X if X2 is None else self._slice(X2)
        i1, i2 = _index(X, 1), _index(X2, 1)
        rdist = X[:, 0:1] - X2[:, 0:1].T
        ad = torch.abs(rdist)
        lu, ly = self._rates()
        Vu, Vy = self.variance_U.values, self.variance_Y.values

        kuu = Vu * (1 + lu * ad) * torch.exp(-lu * ad)
        k1 = torch.exp(-ly * ad) * (2 * lu + ly) / (lu + ly) ** 2
        k2 = (torch.exp(-lu * ad) * (ly - 2 * lu + lu * ly * ad - lu ** 2 * ad)
              + torch.exp(-ly * ad) * (2 * lu - ly)) / (ly - lu) ** 2
        k3 = torch.exp(-lu * ad) * ((1 + lu * ad) / (lu + ly) + lu / (lu + ly) ** 2)
        kyy = Vu * Vy * (k1 + k2 + k3)

        # the cross forms at d >= 0 (kyu3) and d <= 0 (k1cros + k2cros): the
        # reference evaluates both at every d. |d| by a where, whose gradient
        # at d = 0 is the reference's branch's
        dpos = torch.where(rdist > 0, rdist, -rdist)
        dneg = -dpos
        e_lu, e_ly = torch.exp(lu * dneg), torch.exp(ly * dneg)
        kyu3 = torch.exp(-lu * dpos) / (lu + ly) * (1 + lu * (dpos + 1 / (lu + ly)))
        k1cros = (e_ly - e_lu + lu * (dneg * e_lu + (e_ly - e_lu) / (lu - ly))) / (lu - ly)
        k2cros = e_ly * (1 / (lu + ly) + lu / (lu + ly) ** 2)
        Vuy = Vu * torch.sqrt(Vy * ly * 2)
        kcros = Vuy * (k1cros + k2cros)
        kuy = torch.where(rdist > 0, Vuy * kyu3, kcros)  # U rows, Y columns
        kyu = torch.where(rdist > 0, kcros, Vuy * kyu3)  # Y rows, U columns

        mU1 = (i1 == 0)[:, None]
        mU2 = (i2 == 0)[None, :]
        return torch.where(mU1 & mU2, kuu,
                           torch.where(mU1 & ~mU2, kuy, torch.where(~mU1 & mU2, kyu, kyy)))

    def Kdiag(self, X):
        X = self._slice(X)
        lu, ly = self._rates()
        Vu, Vy = self.variance_U.values, self.variance_Y.values
        kyy0 = Vu * Vy * ((2 * lu + ly) / (lu + ly) ** 2
                          + (ly - 2 * lu + 2 * lu - ly) / (ly - lu) ** 2
                          + (1 / (lu + ly) + lu / (lu + ly) ** 2))
        return torch.where(_index(X, 1) == 0, Vu, kyy0)


class ODE_UYC(ODE_UY):
    """ODE_UY with a constant bias on the U-U block (GPy ODE_UYC.py)."""

    def __init__(self, input_dim=2, variance_U=3.0, variance_Y=1.0, lengthscale_U=1.0,
                 lengthscale_Y=1.0, ubias=1.0, active_dims=None, name="ode_uyc", device=None,
                 dtype=None):
        super().__init__(input_dim, variance_U, variance_Y, lengthscale_U, lengthscale_Y,
                         active_dims, name, device=device, dtype=dtype)
        self._add_param("ubias", ubias, transform=Logexp())

    def K(self, X, X2=None):
        base = super().K(X, X2)
        i1 = _index(self._slice(X), 1)
        i2 = i1 if X2 is None else _index(self._slice(X2), 1)
        mUU = (i1 == 0)[:, None] & (i2 == 0)[None, :]
        return base + torch.where(mUU, self.ubias.values, 0.0)

    def Kdiag(self, X):
        i1 = _index(self._slice(X), 1)
        return super().Kdiag(X) + torch.where(i1 == 0, self.ubias.values, 0.0)


class ODE_st(Kern):
    """-a d2y/dx2 + b dy/dt + c y = U with an RBF prior on Y over (t, x)."""

    def __init__(self, input_dim=3, a=1.0, b=1.0, c=1.0, variance_Yx=3.0, variance_Yt=1.5,
                 lengthscale_Yx=1.5, lengthscale_Yt=1.5, active_dims=None, name="ode_st",
                 device=None, dtype=None):
        assert input_dim == 3
        super().__init__(input_dim, active_dims, name, device=device, dtype=dtype)
        self._add_param("a", a, transform=Logexp())
        self._add_param("b", b, transform=Logexp())
        self._add_param("c", c, transform=Logexp())
        self._add_param("variance_Yt", variance_Yt, transform=Logexp())
        self._add_param("variance_Yx", variance_Yx, transform=Logexp())
        self._add_param("lengthscale_Yt", lengthscale_Yt, transform=Logexp())
        self._add_param("lengthscale_Yx", lengthscale_Yx, transform=Logexp())

    def K(self, X, X2=None):
        X = self._slice(X)
        X2 = X if X2 is None else self._slice(X2)
        ttdist = X[:, 0:1] - X2[:, 0:1].T
        tdist = ttdist ** 2
        xdist = (X[:, 1:2] - X2[:, 1:2].T) ** 2
        vy = self.variance_Yt.values * self.variance_Yx.values
        lyt = 1.0 / (2 * self.lengthscale_Yt.values)
        lyx = 1.0 / (2 * self.lengthscale_Yx.values)
        a, b, c = self.a.values, self.b.values, self.c.values
        kyy = torch.exp(-lyt * tdist - lyx * xdist)
        k1 = 2 * lyt - 4 * lyt ** 2 * tdist
        k2 = 4 * lyx ** 2 * xdist - 2 * lyx
        k3 = 12 * lyx ** 2 - 48 * xdist * lyx ** 3 + 16 * xdist ** 2 * lyx ** 4
        k4 = 2 * lyt * ttdist
        Kyy = vy * kyy
        Kyu = (-a * k2 + b * k4 + c) * vy * kyy
        Kuy = (-a * k2 - b * k4 + c) * vy * kyy
        Kuu = (b ** 2 * k1 - 2 * a * c * k2 + a ** 2 * k3 + c ** 2) * vy * kyy
        mY1 = (_index(X, 2) == 0)[:, None]
        mY2 = (_index(X2, 2) == 0)[None, :]
        return torch.where(mY1 & mY2, Kyy,
                           torch.where(mY1 & ~mY2, Kyu, torch.where(~mY1 & mY2, Kuy, Kuu)))

    def Kdiag(self, X):
        return torch.diagonal(self.K(X))


class ODE_t(Kern):
    """The temporal transfer kernel, first order in t. Its default name is
    the reference's, "ode_st" (gpy_tpu/kern/ode_uy.py:175)."""

    def __init__(self, input_dim=2, a=1.0, c=1.0, variance_Yt=3.0, lengthscale_Yt=1.5,
                 ubias=1.0, active_dims=None, name="ode_st", device=None, dtype=None):
        assert input_dim == 2
        super().__init__(input_dim, active_dims, name, device=device, dtype=dtype)
        self._add_param("a", a, transform=Logexp())
        self._add_param("c", c, transform=Logexp())
        self._add_param("variance_Yt", variance_Yt, transform=Logexp())
        self._add_param("lengthscale_Yt", lengthscale_Yt, transform=Logexp())
        self._add_param("ubias", ubias, transform=Logexp())

    def K(self, X, X2=None):
        X = self._slice(X)
        X2 = X if X2 is None else self._slice(X2)
        ttdist = X[:, 0:1] - X2[:, 0:1].T
        tdist = ttdist ** 2
        vyt = self.variance_Yt.values
        lyt = 1.0 / (2 * self.lengthscale_Yt.values)
        kyy = torch.exp(-lyt * tdist)
        k1 = 2 * lyt - 4 * lyt ** 2 * tdist
        k4 = 2 * lyt * ttdist
        Kyy = vyt * kyy
        Kyu = (k4 + 1) * vyt * kyy
        Kuy = (-k4 + 1) * vyt * kyy
        Kuu = (k1 + 1.0) * vyt * kyy + self.ubias.values
        mY1 = (_index(X, 1) == 0)[:, None]
        mY2 = (_index(X2, 1) == 0)[None, :]
        return torch.where(mY1 & mY2, Kyy,
                           torch.where(mY1 & ~mY2, Kyu, torch.where(~mY1 & mY2, Kuy, Kuu)))

    def Kdiag(self, X):
        return torch.diagonal(self.K(X))
