"""Priors attachable to parameters (the MAP term of the objective).

Counterpart of gpy_tpu/core/priors.py:37-342 (GPy/core/parameterization/
priors.py), the discriminative GPLVM priors (DGPLVM*) included. Only
`lnpdf` is needed: autograd supplies the gradient through the constraint
bijector. `lnpdf` takes a tensor
and returns a tensor on its device and dtype; the constants are Python
floats, so nothing here picks a device of its own.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "Prior",
    "Gaussian",
    "Uniform",
    "LogGaussian",
    "MultivariateGaussian",
    "Gamma",
    "InverseGamma",
    "Exponential",
    "StudentT",
    "HalfT",
    "DGPLVM",
    "DGPLVM_Lamda",
    "DGPLVM_T",
    "DGPLVM_KFDA",
]


class Prior:
    domain = "real"

    def lnpdf(self, x):
        raise NotImplementedError

    def pdf(self, x):
        return torch.exp(self.lnpdf(x))

    def rvs(self, n, rng=None):
        raise NotImplementedError

    def __repr__(self):
        return self.__class__.__name__


class Gaussian(Prior):
    def __init__(self, mu=0.0, sigma=1.0):
        self.mu, self.sigma = float(mu), float(sigma)

    def lnpdf(self, x):
        return -0.5 * math.log(2 * math.pi * self.sigma**2) - 0.5 * ((x - self.mu) / self.sigma) ** 2

    def rvs(self, n, rng=None):
        rng = rng or np.random.default_rng()
        return rng.normal(self.mu, self.sigma, n)

    def __repr__(self):
        return f"N({self.mu}, {self.sigma**2})"


class Uniform(Prior):
    def __init__(self, lower=0.0, upper=1.0):
        self.lower, self.upper = float(lower), float(upper)

    def lnpdf(self, x):
        inside = (x >= self.lower) & (x <= self.upper)
        return torch.where(inside, torch.full_like(x, -math.log(self.upper - self.lower)), -math.inf)

    def rvs(self, n, rng=None):
        rng = rng or np.random.default_rng()
        return rng.uniform(self.lower, self.upper, n)


class LogGaussian(Prior):
    domain = "positive"

    def __init__(self, mu=0.0, sigma=1.0):
        self.mu, self.sigma = float(mu), float(sigma)

    def lnpdf(self, x):
        lx = torch.log(x)
        return (
            -0.5 * math.log(2 * math.pi * self.sigma**2)
            - lx
            - 0.5 * ((lx - self.mu) / self.sigma) ** 2
        )

    def rvs(self, n, rng=None):
        rng = rng or np.random.default_rng()
        return np.exp(rng.normal(self.mu, self.sigma, n))


class MultivariateGaussian(Prior):
    def __init__(self, mu, var):
        self.mu = np.asarray(mu, dtype=np.float64)
        self.var = np.asarray(var, dtype=np.float64)
        self._L = np.linalg.cholesky(self.var)
        self._logdet = 2.0 * float(np.sum(np.log(np.diagonal(self._L))))

    def lnpdf(self, x):
        mu = torch.as_tensor(self.mu, dtype=x.dtype, device=x.device)
        L = torch.as_tensor(self._L, dtype=x.dtype, device=x.device)
        d = x.reshape(-1, 1) - mu[:, None]
        a = torch.linalg.solve_triangular(L, d, upper=False)
        k = self.mu.shape[0]
        return -0.5 * (k * math.log(2 * math.pi) + self._logdet + torch.sum(a**2))


class Gamma(Prior):
    """Shape/rate parameterization (GPy: priors.py:291 -- a=shape, b=rate)."""

    domain = "positive"

    def __init__(self, a=1.0, b=0.5):
        self.a, self.b = float(a), float(b)

    @staticmethod
    def from_EV(E, V):
        """GPy: Gamma.from_EV -- construct from mean and variance."""
        return Gamma(E**2 / V, E / V)

    def lnpdf(self, x):
        return self.a * math.log(self.b) - math.lgamma(self.a) + (self.a - 1) * torch.log(x) - self.b * x

    def rvs(self, n, rng=None):
        rng = rng or np.random.default_rng()
        return rng.gamma(self.a, 1.0 / self.b, n)

    def __repr__(self):
        return f"Ga({self.a}, {self.b})"


class InverseGamma(Prior):
    domain = "positive"

    def __init__(self, a=1.0, b=0.5):
        self.a, self.b = float(a), float(b)

    def lnpdf(self, x):
        return self.a * math.log(self.b) - math.lgamma(self.a) - (self.a + 1) * torch.log(x) - self.b / x


class Exponential(Prior):
    domain = "positive"

    def __init__(self, l=1.0):
        self.l = float(l)

    def lnpdf(self, x):
        return math.log(self.l) - self.l * x

    def rvs(self, n, rng=None):
        rng = rng or np.random.default_rng()
        return rng.exponential(1.0 / self.l, n)


class StudentT(Prior):
    def __init__(self, mu=0.0, sigma=1.0, nu=4.0):
        self.mu, self.sigma, self.nu = float(mu), float(sigma), float(nu)

    def lnpdf(self, x):
        z = (x - self.mu) / self.sigma
        return (
            math.lgamma((self.nu + 1) / 2.0)
            - math.lgamma(self.nu / 2.0)
            - 0.5 * math.log(self.nu * math.pi * self.sigma**2)
            - (self.nu + 1) / 2.0 * torch.log1p(z**2 / self.nu)
        )


class HalfT(Prior):
    domain = "positive"

    def __init__(self, A=1.0, nu=4.0):
        self.A, self.nu = float(A), float(nu)

    def lnpdf(self, x):
        base = (
            math.lgamma((self.nu + 1) / 2.0)
            - math.lgamma(self.nu / 2.0)
            - 0.5 * math.log(self.nu * math.pi * self.A**2)
            + math.log(2.0)
            - (self.nu + 1) / 2.0 * torch.log1p((x / self.A) ** 2 / self.nu)
        )
        return torch.where(x > 0, base, -math.inf)


# ---------------------------------------------------------------------------
# Discriminative GPLVM priors (gpy_tpu/core/priors.py:206-342; GPy priors.py:
# 416-1258). Each goes on a GPLVM's latent X or a Bayesian GPLVM's q(X)
# mean: lnpdf reshapes the (possibly flat) latent to x_shape and returns a
# scalar. The class scatter matrices are one-hot products, the reference's
# form; autograd replaces GPy's hand-written lnpdf_grad.
# ---------------------------------------------------------------------------

def _class_scatter(x, onehot):
    """(Sb, Sw): Sb = sum_c (N_c/N) (M_c - M0)(M_c - M0)', Sw = (1/N)
    sum_k (x_k - M_c(k))(x_k - M_c(k))'; onehot (N, C) labels."""
    onehot = torch.as_tensor(np.asarray(onehot, dtype=np.float64), dtype=x.dtype,
                             device=x.device)
    N = x.shape[0]
    n_c = torch.sum(onehot, dim=0)
    M = (onehot.T @ x) / n_c[:, None]  # class means (C, Q)
    dB = M - torch.mean(x, dim=0)[None, :]
    Sb = (dB * (n_c / N)[:, None]).T @ dB
    xc = x - onehot @ M
    return Sb, (xc.T @ xc) / N


def _spd_solve(A, B):
    """A^-1 B for SPD A by its Cholesky factor (the reference's cho_solve)."""
    return torch.cholesky_solve(B, torch.linalg.cholesky(A))


class DGPLVM(Prior):
    """Discriminative GPLVM prior (Urtasun and Darrell):
    lnpdf = -(1/sigma2) tr((Sb + 0.1 I)^-1 Sw). GPy: priors.py:570-788."""

    def __init__(self, sigma2, lbl, x_shape):
        self.sigma2 = float(sigma2)
        self.lbl = np.asarray(lbl)
        self.x_shape = tuple(x_shape)
        self.ridge = 0.1

    def _xprime(self, x):
        return x

    def lnpdf(self, x):
        x = self._xprime(x.reshape(self.x_shape))
        Sb, Sw = _class_scatter(x, self.lbl)
        eye = torch.eye(Sb.shape[0], dtype=x.dtype, device=x.device)
        return (-1.0 / self.sigma2) * torch.trace(_spd_solve(Sb + self.ridge * eye, Sw))

    def rvs(self, n, rng=None):
        rng = rng or np.random.default_rng()
        return rng.random(n)

    def __repr__(self):
        return "DGPLVM_prior_Raq"


class DGPLVM_Lamda(DGPLVM):
    """DGPLVM on x' = x diag(lamda), ridge 0.9. GPy: priors.py:786-1030. As
    in the reference, lamda is a fixed attribute, not a parameter."""

    def __init__(self, sigma2, lbl, x_shape, lamda, name="DP_prior"):
        super().__init__(sigma2, lbl, x_shape)
        lam = np.diag(np.atleast_2d(lamda)) if np.ndim(lamda) == 2 else lamda
        self.lamda = np.asarray(lam, dtype=np.float64)
        self.ridge = 0.9
        self.name = name

    def _xprime(self, x):
        return x * torch.as_tensor(self.lamda, dtype=x.dtype, device=x.device)[None, :]

    def __repr__(self):
        return "DGPLVM_prior_Raq_Lamda"


class DGPLVM_T(DGPLVM):
    """DGPLVM on a fixed projection x' = x vec. GPy: priors.py:1033-1258."""

    def __init__(self, sigma2, lbl, x_shape, vec):
        super().__init__(sigma2, lbl, x_shape)
        self.vec = np.asarray(vec, dtype=np.float64)

    def _xprime(self, x):
        return x @ torch.as_tensor(self.vec, dtype=x.dtype, device=x.device)

    def __repr__(self):
        return "DGPLVM_prior_Raq_TTT"


class DGPLVM_KFDA(Prior):
    """Kernel Fisher discriminant prior (two label columns):
    J = (1/lambda) (a' K a - a' K A (lambda I + A K A)^-1 A K a),
    lnpdf = -J / sigma2, K the kernel's Gram of the latent points. GPy:
    priors.py:416-568. a and A are built per index, so the rows need not be
    sorted by class (the reference's choice; GPy's positional build assumes
    sorted rows)."""

    def __init__(self, lambdaa, sigma2, lbl, kern, x_shape):
        lbl = np.asarray(lbl)
        self.datanum, self.classnum = lbl.shape
        if self.classnum < 2:
            raise ValueError("DGPLVM_KFDA needs two label columns")
        self.lambdaa = float(lambdaa)
        self.sigma2 = float(sigma2)
        self.lbl = lbl
        self.kern = kern
        self.x_shape = tuple(x_shape)
        c0, c1 = lbl[:, 0] == 1, lbl[:, 1] == 1
        n0, n1 = float(c0.sum()), float(c1.sum())
        self.a = np.where(c0, 1.0 / n0, np.where(c1, -1.0 / n1, 0.0))[:, None]
        A = np.zeros((self.datanum, self.datanum))
        for mask, n in ((c0, n0), (c1, n1)):
            idx = np.where(mask)[0]
            A[np.ix_(idx, idx)] = (np.eye(len(idx)) - 1.0 / n) / np.sqrt(n)
        self.A = A

    def lnpdf(self, x):
        x = x.reshape(self.x_shape)
        K = self.kern.K(x)
        a = torch.as_tensor(self.a, dtype=K.dtype, device=K.device)
        A = torch.as_tensor(self.A, dtype=K.dtype, device=K.device)
        AK = A @ K
        AKa = AK @ a
        P = self.lambdaa * torch.eye(self.datanum, dtype=K.dtype, device=K.device) + AK @ A
        J = a.T @ K @ a - AKa.T @ _spd_solve(P, AKa)
        return torch.squeeze((-1.0 / self.sigma2) * J / self.lambdaa)

    def rvs(self, n, rng=None):
        rng = rng or np.random.default_rng()
        return rng.random(n)

    def __repr__(self):
        return "DGPLVM_prior"
