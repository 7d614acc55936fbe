"""Non-Gaussian likelihood families.

Counterpart of gpy_tpu/likelihoods/families.py:37-280 (GPy/likelihoods/
{poisson,binomial,exponential,gamma,student_t,weibull,loglogistic,
loggaussian}.py). Each family is `logpdf_link` and its conditional moments:
every derivative is autograd's, every expectation the base class's
quadrature. Samplers draw from the caller's torch.Generator; where torch's
sampler takes none (Gamma, Student t) the draw is built from its normals
and uniforms.
"""
from __future__ import annotations

import math

import torch
from torch.special import log_ndtr

from ..core.transformations import Logexp
from .likelihood import Likelihood
from .link_functions import Identity, Log, Probit

__all__ = ["Poisson", "Binomial", "Exponential", "Gamma", "StudentT", "Weibull", "LogLogistic",
           "LogGaussian"]


def _metadata(lik, Y_metadata, key, y):
    return lik._as_tensor(Y_metadata[key], y)


def _censoring(lik, y, Y_metadata):
    if Y_metadata is not None and "censored" in Y_metadata:
        return _metadata(lik, Y_metadata, "censored", y)
    return torch.zeros_like(y)


def _uniform(gen, f):
    return torch.rand(f.shape, generator=gen, dtype=f.dtype, device=f.device)


def _standard_gamma(alpha, gen):
    """Gamma(alpha, 1) draws by Marsaglia & Tsang's squeeze on normals and
    uniforms of `gen`, rejected draws redrawn until every element has one;
    alpha < 1 by the boost Gamma(alpha) = Gamma(alpha + 1) U^(1 / alpha)."""
    small = alpha < 1
    a = torch.where(small, alpha + 1.0, alpha)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a)
    done = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    while not bool(done.all()):
        x = torch.randn(a.shape, generator=gen, dtype=a.dtype, device=a.device)
        u = _uniform(gen, a)
        v = (1.0 + c * x) ** 3
        vpos = torch.clamp(v, min=torch.finfo(a.dtype).tiny)
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(vpos))
        out = torch.where(ok & ~done, d * v, out)
        done = done | ok
    boost = _uniform(gen, a) ** (1.0 / alpha)
    return torch.where(small, out * boost, out)


class Poisson(Likelihood):
    """GPy: poisson.py. Default Log link; rate = link_f."""

    log_concave = True  # W >= 0 everywhere (Laplace's Cholesky path)

    def __init__(self, gp_link=None, name="Poisson", device=None, dtype=None):
        super().__init__(gp_link or Log(), name=name, device=device, dtype=dtype)

    def logpdf_link(self, link_f, y, Y_metadata=None):
        lam = torch.clamp(link_f, min=1e-15)
        return y * torch.log(lam) - lam - torch.lgamma(y + 1.0)

    def conditional_mean(self, f):
        return self.gp_link.transf(f)

    def conditional_variance(self, f):
        return self.gp_link.transf(f)

    def samples_given_f(self, gen, f, Y_metadata=None):
        return torch.poisson(self.gp_link.transf(f), generator=gen).to(f.dtype)


class Binomial(Likelihood):
    """GPy: binomial.py. Trials in Y_metadata['trials']; p = link_f (Probit)."""

    def __init__(self, gp_link=None, name="Binomial", device=None, dtype=None):
        super().__init__(gp_link or Probit(), name=name, device=device, dtype=dtype)

    def _trials(self, y, Y_metadata):
        if Y_metadata is None or "trials" not in Y_metadata:
            raise ValueError("Binomial needs Y_metadata['trials']")
        return _metadata(self, Y_metadata, "trials", y)

    def logpdf_link(self, link_f, y, Y_metadata=None):
        N = self._trials(y, Y_metadata)
        p = torch.clamp(link_f, 1e-12, 1 - 1e-12)
        return (torch.lgamma(N + 1) - torch.lgamma(y + 1) - torch.lgamma(N - y + 1)
                + y * torch.log(p) + (N - y) * torch.log1p(-p))

    def conditional_mean(self, f):
        # per unit trial, as the reference
        return self.gp_link.transf(f)

    def conditional_variance(self, f):
        p = self.gp_link.transf(f)
        return p * (1 - p)

    def samples_given_f(self, gen, f, Y_metadata=None):
        N = self._trials(f, Y_metadata)
        p = self.gp_link.transf(f)
        return torch.binomial(N.expand(p.shape).contiguous(), p.contiguous(), generator=gen)


class Exponential(Likelihood):
    """GPy: exponential.py:44-61. Rate = link_f: ln p = ln(lam) - y lam."""

    def __init__(self, gp_link=None, name="Exponential", device=None, dtype=None):
        super().__init__(gp_link or Log(), name=name, device=device, dtype=dtype)

    def logpdf_link(self, link_f, y, Y_metadata=None):
        lam = torch.clamp(link_f, min=1e-15)
        return torch.log(lam) - y * lam

    def conditional_mean(self, f):
        return 1.0 / torch.clamp(self.gp_link.transf(f), min=1e-15)

    def conditional_variance(self, f):
        return 1.0 / torch.clamp(self.gp_link.transf(f), min=1e-15) ** 2

    def samples_given_f(self, gen, f, Y_metadata=None):
        e = torch.empty_like(f).exponential_(1.0, generator=gen)
        return e / self.gp_link.transf(f)


class Gamma(Likelihood):
    """GPy: gamma.py:52-74. Shape alpha = link_f * beta, rate beta fixed."""

    def __init__(self, gp_link=None, beta=1.0, name="Gamma", device=None, dtype=None):
        super().__init__(gp_link or Log(), name=name, device=device, dtype=dtype)
        self._add_param("beta", beta, transform=Logexp(), fixed=True)

    def logpdf_link(self, link_f, y, Y_metadata=None):
        beta = self.beta.values
        alpha = torch.clamp(link_f, min=1e-15) * beta
        return alpha * torch.log(beta) - torch.lgamma(alpha) + (alpha - 1) * torch.log(y) - beta * y

    def conditional_mean(self, f):
        return self.gp_link.transf(f)  # alpha / beta

    def conditional_variance(self, f):
        return self.gp_link.transf(f) / self.beta.values

    def samples_given_f(self, gen, f, Y_metadata=None):
        beta = self.beta.values
        return _standard_gamma(self.gp_link.transf(f) * beta, gen) / beta


class StudentT(Likelihood):
    """GPy: student_t.py:27. Scale t_scale2 (Logexp) and deg_free (fixed)."""

    def __init__(self, gp_link=None, deg_free=5.0, sigma2=2.0, name="Student_T", device=None,
                 dtype=None):
        super().__init__(gp_link or Identity(), name=name, device=device, dtype=dtype)
        self._add_param("t_scale2", sigma2, transform=Logexp())
        self._add_param("deg_free", float(deg_free), transform=Logexp(), fixed=True)

    @property
    def sigma2(self):
        return self.t_scale2.values

    def logpdf_link(self, link_f, y, Y_metadata=None):
        s2 = self.t_scale2.values
        v = self.deg_free.values
        e = y - link_f
        return (torch.lgamma((v + 1) / 2.0) - torch.lgamma(v / 2.0)
                - 0.5 * torch.log(v * math.pi * s2)
                - (v + 1) / 2.0 * torch.log1p(e**2 / (v * s2)))

    def conditional_mean(self, f):
        return self.gp_link.transf(f)

    def conditional_variance(self, f):
        v = self.deg_free.values
        return (self.t_scale2.values * v / (v - 2.0)).expand(f.shape)

    def samples_given_f(self, gen, f, Y_metadata=None):
        v = self.deg_free.values
        z = torch.randn(f.shape, generator=gen, dtype=f.dtype, device=f.device)
        chi2 = 2.0 * _standard_gamma((v / 2.0).expand(f.shape), gen)
        return self.gp_link.transf(f) + torch.sqrt(self.t_scale2.values) * z / torch.sqrt(chi2 / v)


class Weibull(Likelihood):
    """GPy: weibull.py. Shape r (Logexp), scale lambda = link_f; right
    censoring by Y_metadata['censored'] (1 = censored)."""

    def __init__(self, gp_link=None, beta=1.0, name="Weibull", device=None, dtype=None):
        super().__init__(gp_link or Log(), name=name, device=device, dtype=dtype)
        self._add_param("r_shape", beta, transform=Logexp())

    def logpdf_link(self, link_f, y, Y_metadata=None):
        r = self.r_shape.values
        c = _censoring(self, y, Y_metadata)
        lam = torch.clamp(link_f, min=1e-15)
        yc = torch.clamp(y, min=1e-15)
        yr = yc**r
        uncens = torch.log(r) - torch.log(lam) + (r - 1) * torch.log(yc) - yr / lam
        cens = -yr / lam
        return (1 - c) * uncens + c * cens

    def conditional_mean(self, f):
        r = self.r_shape.values
        return self.gp_link.transf(f) ** (1.0 / r) * torch.exp(torch.lgamma(1 + 1.0 / r))

    def conditional_variance(self, f):
        r = self.r_shape.values
        g1 = torch.exp(torch.lgamma(1 + 1.0 / r))
        g2 = torch.exp(torch.lgamma(1 + 2.0 / r))
        return self.gp_link.transf(f) ** (2.0 / r) * (g2 - g1**2)

    def samples_given_f(self, gen, f, Y_metadata=None):
        r = self.r_shape.values
        lam = self.gp_link.transf(f)
        return (-lam * torch.log1p(-_uniform(gen, f))) ** (1.0 / r)


class LogLogistic(Likelihood):
    """GPy: loglogistic.py:52-88. Shape r (Logexp), median lambda = link_f."""

    def __init__(self, gp_link=None, r=1.0, name="LogLogistic", device=None, dtype=None):
        super().__init__(gp_link or Log(), name=name, device=device, dtype=dtype)
        self._add_param("r_log_shape", r, transform=Logexp())

    def logpdf_link(self, link_f, y, Y_metadata=None):
        r = self.r_log_shape.values
        c = _censoring(self, y, Y_metadata)
        lam = torch.clamp(link_f, 1e-100, 1e100)
        ly = torch.log(torch.clamp(y, min=1e-100))
        ylam_r = torch.exp(r * (ly - torch.log(lam)))
        uncens = torch.log(r) + (r - 1) * ly - r * torch.log(lam) - 2 * torch.log1p(ylam_r)
        cens = -torch.log1p(ylam_r)
        return (1 - c) * uncens + c * cens

    def conditional_mean(self, f):
        b = math.pi / self.r_log_shape.values
        return self.gp_link.transf(f) * b / torch.sin(b)  # valid for r > 1

    def conditional_variance(self, f):
        b = math.pi / self.r_log_shape.values
        m = b / torch.sin(b)
        return self.gp_link.transf(f) ** 2 * (2 * b / torch.sin(2 * b) - m**2)  # r > 2

    def samples_given_f(self, gen, f, Y_metadata=None):
        u = _uniform(gen, f)
        return self.gp_link.transf(f) * (u / (1 - u)) ** (1.0 / self.r_log_shape.values)


class LogGaussian(Likelihood):
    """GPy: loggaussian.py:47-65. log y ~ N(f, sigma2), censoring supported."""

    def __init__(self, gp_link=None, sigma=1.0, name="LogGaussian", device=None, dtype=None):
        super().__init__(gp_link or Identity(), name=name, device=device, dtype=dtype)
        self._add_param("variance", float(sigma) ** 2, transform=Logexp())

    def logpdf_link(self, link_f, y, Y_metadata=None):
        s2 = self.variance.values
        c = _censoring(self, y, Y_metadata)
        ly = torch.log(torch.clamp(y, min=1e-100))
        uncens = -0.5 * torch.log(2 * math.pi * s2) - ly - (ly - link_f) ** 2 / (2 * s2)
        cens = log_ndtr(-(ly - link_f) / torch.sqrt(s2))
        return (1 - c) * uncens + c * cens

    def conditional_mean(self, f):
        return torch.exp(self.gp_link.transf(f) + self.variance.values / 2.0)

    def conditional_variance(self, f):
        s2 = self.variance.values
        return (torch.exp(s2) - 1) * torch.exp(2 * self.gp_link.transf(f) + s2)

    def samples_given_f(self, gen, f, Y_metadata=None):
        z = torch.randn(f.shape, generator=gen, dtype=f.dtype, device=f.device)
        return torch.exp(self.gp_link.transf(f) + torch.sqrt(self.variance.values) * z)
