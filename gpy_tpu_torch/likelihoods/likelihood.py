"""Likelihood base: one Gauss-Hermite engine in place of GPy's derivative towers.

Counterpart of gpy_tpu/likelihoods/likelihood.py:31-214 (GPy/likelihoods/
likelihood.py: moments_match_ep:226-267, variational_expectations:358-412,
predictive_mean/variance:413-498, predictive_values/quantiles:734-767,
samples:768, MCMC_pdf_samples:780-852). Every non-analytic quantity is one
vectorized Gauss-Hermite quadrature over the latent marginal, and every
derivative (dF/dm, dF/dv, the EP and Laplace towers) is autograd through
`logpdf`, the one method a subclass must provide.

Randomness takes a torch.Generator made from `seed`, whose draws differ from
jax.random's: sample parity with the reference is by moments.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..core.module import Module
from .link_functions import GPTransformation, Identity

__all__ = ["Likelihood", "gh_points"]

_GH_DEGREE = 20


def gh_points(degree: int = _GH_DEGREE, dtype=torch.float64, device=None):
    """Hermite-Gauss nodes and weights for N(0, 1) expectations, from
    numpy's hermgauss in float64 exactly as the reference takes them. Made
    once per degree, dtype and device (a copy to the card is a host sync,
    and EP's quadrature asks every sweep); callers must not write to them."""
    return _gh_points(int(degree), dtype, torch.device("cpu" if device is None else device))


@functools.lru_cache(maxsize=None)
def _gh_points(degree, dtype, device):
    x, w = np.polynomial.hermite.hermgauss(degree)
    x = x * np.sqrt(2.0)
    w = w / np.sqrt(np.pi)
    return (torch.tensor(x, dtype=dtype, device=device),
            torch.tensor(w, dtype=dtype, device=device))


def _generator(seed: int, like: torch.Tensor) -> torch.Generator:
    return torch.Generator(device=like.device).manual_seed(int(seed))


def _grad_graph(out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """d out / d x with the graph kept (create_graph), zeros where `out` does
    not depend on x (a step link), as jax.grad returns them."""
    if not out.requires_grad:
        return torch.zeros_like(x)
    g = torch.autograd.grad(out, x, create_graph=True, allow_unused=True)[0]
    return torch.zeros_like(x) if g is None else g


class Likelihood(Module):
    """Base likelihood p(y | f). Subclasses implement `logpdf_link` (given
    the transformed latent) and `conditional_mean/variance`."""

    # True where log p(y|f) is concave in f everywhere (W = -d2 logpdf >= 0):
    # Laplace then solves through the Cholesky of B = I + sqrtW K sqrtW
    log_concave = False

    def __init__(self, gp_link: Optional[GPTransformation] = None, name: str = "likelihood",
                 device=None, dtype=None):
        super().__init__(name=name, device=device, dtype=dtype)
        self.gp_link = gp_link or Identity()

    def _as_tensor(self, a, like: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`a` as a tensor on `like`'s device and dtype, else the likelihood's."""
        if like is not None:
            dev, dt = like.device, like.dtype
        else:
            dev, dt = resolve_device(self._device_arg), resolve_dtype(self._dtype_arg)
        if torch.is_tensor(a):
            return a.to(device=dev, dtype=dt)
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dt, device=dev)

    # --- core density -----------------------------------------------------
    def logpdf_link(self, link_f, y, Y_metadata=None):
        raise NotImplementedError

    def logpdf(self, f, y, Y_metadata=None):
        return self.logpdf_link(self.gp_link.transf(f), y, Y_metadata)

    def pdf(self, f, y, Y_metadata=None):
        return torch.exp(self.logpdf(f, y, Y_metadata))

    def conditional_mean(self, f):
        raise NotImplementedError

    def conditional_variance(self, f):
        raise NotImplementedError

    # --- Gauss-Hermite engine ---------------------------------------------
    def _quad_over_f(self, fn, mu, var, degree=_GH_DEGREE):
        """E_{N(f; mu, var)}[fn(f)] elementwise over mu and var."""
        x, w = gh_points(degree, dtype=mu.dtype, device=mu.device)
        sd = torch.sqrt(torch.clamp(var, min=1e-15))
        f = mu[..., None] + sd[..., None] * x  # (..., P)
        return torch.sum(w * fn(f), dim=-1)

    def variational_expectations(self, Y, m, v, Y_metadata=None, gh_points_=_GH_DEGREE):
        """F_n = E_{N(f; m_n, v_n)}[log p(y_n | f)]. GPy: likelihood.py:358-412.
        Only F: its gradients are autograd's."""
        Y = self._as_tensor(Y, m)
        return self._quad_over_f(lambda f: self.logpdf(f, Y[..., None], Y_metadata), m, v,
                                 gh_points_)

    def moments_match_ep(self, Y, tau, v, Y_metadata=None, degree=_GH_DEGREE):
        """(log Z_hat, mu_hat, sigma2_hat) of p(y|f) N(f; v/tau, 1/tau) for
        every site at once, Z by log-sum-exp. GPy: likelihood.py:226-267."""
        mu = v / tau
        sigma2 = 1.0 / tau
        x, w = gh_points(degree, dtype=mu.dtype, device=mu.device)
        f = mu[..., None] + torch.sqrt(sigma2)[..., None] * x
        logp = self.logpdf(f, self._as_tensor(Y, mu)[..., None], Y_metadata)
        logw = torch.log(w)
        logZ = torch.logsumexp(logp + logw, dim=-1)
        p = torch.exp(logp + logw - logZ[..., None])
        Ef = torch.sum(p * f, dim=-1)
        Ef2 = torch.sum(p * f * f, dim=-1)
        return logZ, Ef, torch.clamp(Ef2 - Ef**2, min=1e-15)

    # --- predictive density -----------------------------------------------
    def predictive_values(self, mu, var, full_cov=False, Y_metadata=None):
        """Mean and variance of p(y* | x*). GPy: likelihood.py:734-757."""
        Ey = self.predictive_mean(mu, var, Y_metadata)
        return Ey, self.predictive_variance(mu, var, Ey, Y_metadata)

    def predictive_mean(self, mu, var, Y_metadata=None):
        return self._quad_over_f(self.conditional_mean, mu, var)

    def predictive_variance(self, mu, var, predictive_mean=None, Y_metadata=None):
        if predictive_mean is None:
            predictive_mean = self.predictive_mean(mu, var, Y_metadata)
        Ey2 = self._quad_over_f(
            lambda f: self.conditional_variance(f) + self.conditional_mean(f) ** 2, mu, var)
        return torch.clamp(Ey2 - predictive_mean**2, min=1e-15)

    def predictive_quantiles(self, mu, var, quantiles, Y_metadata=None, n_samples=2000, seed=0):
        """Quantiles of p(y*) by Monte Carlo: n_samples latent draws per point,
        one y draw each, then the percentiles (linear interpolation, as
        jnp.percentile). The Gaussian likelihood overrides with the closed form."""
        gen = _generator(seed, mu)
        eps = torch.randn(mu.shape + (n_samples,), generator=gen, dtype=mu.dtype,
                          device=mu.device)
        f = mu[..., None] + torch.sqrt(var)[..., None] * eps
        ys = self.samples_given_f(gen, f, Y_metadata)
        q = torch.tensor(np.asarray(quantiles, dtype=np.float64) / 100.0, dtype=mu.dtype,
                         device=mu.device)
        qs = torch.quantile(ys, q, dim=-1)
        return [qs[i] for i in range(len(quantiles))]

    def log_predictive_density(self, y_test, mu_star, var_star, Y_metadata=None):
        """log p(y* | x*) = log E_{N(f)}[p(y* | f)] by the quadrature."""
        x, w = gh_points(dtype=mu_star.dtype, device=mu_star.device)
        f = mu_star[..., None] + torch.sqrt(var_star)[..., None] * x
        logp = self.logpdf(f, self._as_tensor(y_test, mu_star)[..., None], Y_metadata)
        return torch.logsumexp(logp + torch.log(w), dim=-1)

    # --- sampling -----------------------------------------------------------
    def samples_given_f(self, gen: torch.Generator, f, Y_metadata=None):
        raise NotImplementedError

    def samples(self, gp, Y_metadata=None, seed=0):
        """y drawn given latent sample(s) gp, as numpy. GPy: likelihood.py:768."""
        f = self._as_tensor(gp)
        with torch.no_grad():
            return self.samples_given_f(_generator(seed, f), f, Y_metadata).cpu().numpy()

    def MCMC_pdf_samples(self, fNew, num_samples=1000, starting_loc=None, stepsize=0.1,
                         burn_in=1000, Y_metadata=None, seed=0):
        """Random-walk Metropolis samples of y* | f*, one chain per row of
        fNew, for likelihoods with no direct sampler. GPy: likelihood.py:
        780-852. All chains step together; acceptance is in the log domain.
        The reference's lax.scan is a loop here. Returns numpy
        (n_chains, num_samples)."""
        with torch.no_grad():
            fNew = self._as_tensor(fNew).reshape(-1, 1)
            y = (fNew if starting_loc is None else self._as_tensor(starting_loc, fNew)).reshape(-1)
            y = y.clone()
            n = y.shape[0]
            gen = _generator(seed, y)

            def logp(yy):
                return self.logpdf(fNew, yy[:, None], Y_metadata).reshape(-1)

            lp = logp(y)
            kept, accepted = [], []
            for it in range(int(burn_in) + int(num_samples)):
                prop = y + stepsize * torch.randn(n, generator=gen, dtype=y.dtype, device=y.device)
                lp_prop = logp(prop)
                u = torch.rand(n, generator=gen, dtype=y.dtype, device=y.device)
                accept = torch.log(u) < (lp_prop - lp)
                y = torch.where(accept, prop, y)
                lp = torch.where(accept, lp_prop, lp)
                if it >= burn_in:
                    kept.append(y)
                    accepted.append(accept)
            self.last_mcmc_accept_ratio = float(torch.stack(accepted).to(y.dtype).mean())
            return torch.stack(kept, dim=1).cpu().numpy()

    # --- EP / Laplace helpers -----------------------------------------------
    def d_logpdf_df(self, f, y, Y_metadata=None):
        """d log p(y|f) / df elementwise, differentiable: autograd of sum
        logpdf with the graph kept, so a caller's gradient flows through it
        (to f where f carries a graph, and to the likelihood's parameters)."""
        with torch.enable_grad():
            x = f if f.requires_grad else f.detach().requires_grad_(True)
            return _grad_graph(torch.sum(self.logpdf(x, y, Y_metadata)), x)

    def d2_logpdf_df2(self, f, y, Y_metadata=None):
        """Diagonal of the Hessian of sum logpdf in f (the likelihood
        factorizes): the gradient of the sum of the first derivatives,
        differentiable again, so Laplace's Newton step carries the third
        derivative into the hyperparameter gradient."""
        with torch.enable_grad():
            x = f if f.requires_grad else f.detach().requires_grad_(True)
            d1 = _grad_graph(torch.sum(self.logpdf(x, y, Y_metadata)), x)
            return _grad_graph(torch.sum(d1), x)
