"""Expectation propagation with parallel damped site updates.

Counterpart of gpy_tpu/inference/ep.py:33-197 (GPy/inference/
latent_function_inference/expectation_propagation.py: EPBase:187, the site
loop :286-358, alternated and nested modes :188-213). Every site is updated
at once from the current posterior marginals with damping, then the
posterior is formed again with one Cholesky of B = I + sT K sT; damped
parallel EP has sequential EP's fixed points (Minka).

The reference's lax.while_loop is a Python loop here with its stopping rule
unchanged, `(diff > epsilon) & (it < max_iters)`, so both packages stop on
the same sweep. The rule reads one device scalar: one host sync a sweep,
and one more from jitchol's probe. The loop runs with no graph on the
likelihood's detached parameters; the evidence is then evaluated
differentiably at the converged sites (constants in the hyperparameters,
as in GPy).
"""
from __future__ import annotations

import math

import torch

from ..util.linalg import jitchol
from .exact import LatentFunctionInference
from .posterior import Posterior

__all__ = ["EP"]

def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _posterior_diag_from_sites(K, tau, v):
    """(diag Sigma, mu = Sigma v, L) for Sigma = (K^-1 + diag tau)^-1 in the
    stable B form, B = I + sT K sT = L L', without forming Sigma:
    diag Sigma = diag K - colsums(V * V), mu = K v - V'(V v), V = L^-1 sT K."""
    sT = torch.sqrt(torch.clamp(tau, min=1e-300))[:, None]
    B = _eye(K.shape[0], K) + (sT * K) * sT.T
    L = jitchol(B)
    V = torch.linalg.solve_triangular(L, sT * K, upper=False)
    diag = torch.diagonal(K) - torch.sum(V * V, dim=0)
    mu = K @ v - V.T @ (V @ v)
    return diag, mu, L


class _EPSites(LatentFunctionInference):
    """The damped parallel site loop, the site cache and the alternated-mode
    hooks that EP and EPDTC share; each supplies the posterior marginals of
    its sites and its site update."""

    def __init__(self, epsilon=1e-6, eta=1.0, delta=0.8, max_iters=60, ep_mode="nested"):
        """eta: power-EP fraction; delta: damping of the site updates.
        ep_mode "nested" converges the sites inside every evaluation;
        "alternated" converges them once when optimize() starts and holds
        them through it (GPy's default)."""
        if ep_mode not in ("nested", "alternated"):
            raise ValueError(f"ep_mode must be 'nested' or 'alternated', not {ep_mode!r}")
        self.epsilon = epsilon
        self.eta = eta
        self.delta = delta
        self.max_iters = max_iters
        self.ep_mode = ep_mode
        self._frozen = False
        self._site_cache = None  # (N, tau, v), detached
        self._loading = False  # right after a load: reuse the stored sites
        # the last convergence's sweeps and its last change (a device scalar)
        self.last_sweeps = self.last_change = None

    def _rebuild_after_load(self):
        """Called by util/serialization.py when a saved model is loaded: the
        model predicts and evaluates from its stored converged sites
        without a new sweep until the next optimize() converges them again
        (GPy's `loading` flag)."""
        self._loading = self._site_cache is not None

    def on_optimization_start(self):
        # drop stale sites so that GP.optimize's eager refresh converges them
        # at the current hyperparameters
        self._site_cache = None
        self._loading = False
        self._frozen = self.ep_mode == "alternated"

    def on_optimization_end(self):
        self._frozen = False

    def _site_update(self, mu_hat, s2_hat, tau_c, v_c):
        raise NotImplementedError

    def _cavity(self, sig2, mu, tau, v):
        sig2 = torch.clamp(sig2, 1e-12, 1e12)
        tau_c = torch.clamp(1.0 / sig2 - self.eta * tau, min=1e-12)
        return tau_c, mu / sig2 - self.eta * v

    def _run_sweeps(self, marginals, likelihood, Y, Y_metadata, N, like):
        """Damped parallel sweeps from zero sites until the change
        max|dtau| + max|dv| is at most epsilon or max_iters sweeps ran.
        `marginals(tau, v)` gives the posterior's (diag, mean) at the sites.
        Where the change grew from one sweep to the next the damping halves
        (floor 0.05): parallel updates can oscillate on near-separable data."""
        with torch.no_grad(), likelihood.stop_gradient():
            Ysg = Y.detach()[:, 0]
            tau = torch.zeros(N, dtype=like.dtype, device=like.device)
            v = torch.zeros_like(tau)
            diff = torch.full((), math.inf, dtype=like.dtype, device=like.device)
            dlt = torch.full((), self.delta, dtype=like.dtype, device=like.device)
            it = 0
            while it < self.max_iters and bool(diff > self.epsilon):
                sig2, mu = marginals(tau, v)
                tau_c, v_c = self._cavity(sig2, mu, tau, v)
                _, mu_hat, s2_hat = likelihood.moments_match_ep(Ysg, tau_c, v_c, Y_metadata)
                tau_new, v_new = self._site_update(mu_hat, s2_hat, tau_c, v_c)
                tau2 = (1 - dlt) * tau + dlt * tau_new
                v2 = (1 - dlt) * v + dlt * v_new
                diff_new = torch.max(torch.abs(tau2 - tau)) + torch.max(torch.abs(v2 - v))
                dlt = torch.where(diff_new > diff, torch.clamp(0.5 * dlt, min=0.05), dlt)
                tau, v, diff = tau2, v2, diff_new
                it += 1
        self.last_sweeps, self.last_change = it, diff
        return tau, v, it

    def _sites(self, converge, N, like):
        """The cached sites (alternated mode mid-optimization, or the first
        use after a load), else `converge()`'s, which are cached."""
        cache = self._site_cache
        if (self._frozen or self._loading) and cache is not None and cache[0] == N:
            return cache[1].to(like), cache[2].to(like)
        tau, v, _ = converge()
        self._site_cache = (N, tau, v)
        return tau, v

    def _evidence(self, sig2, mu, half_logdet_B, likelihood, Y, Y_metadata, tau, v):
        """log Z_EP at fixed sites (R&W 3.65 with the 3.73 grouping):
        differentiable in the marginals and the likelihood's parameters."""
        tau_c, v_c = self._cavity(sig2, mu, tau, v)
        logZ_hat, _, _ = likelihood.moments_match_ep(Y[:, 0], tau_c, v_c, Y_metadata)
        mu_c = v_c / tau_c
        term_quad = 0.5 * torch.sum(v * mu)  # +1/2 v' Sigma v (mu = Sigma v)
        term_cavity = 0.5 * torch.sum(torch.log1p(tau / tau_c)) + 0.5 * torch.sum(
            (mu_c**2 * tau_c * tau - 2 * mu_c * tau_c * v - v**2) / (tau_c + tau))
        return torch.sum(logZ_hat) - half_logdet_B + term_quad + term_cavity


class EP(_EPSites):
    def _site_update(self, mu_hat, s2_hat, tau_c, v_c):
        # site-variance floor 1e-6: binds only for noise-free likelihoods (the
        # Heaviside link), whose site precisions otherwise run to ~1e12
        s2_hat = torch.clamp(s2_hat, 1e-6, 1e12)
        tau_new = torch.clamp((1.0 / s2_hat - tau_c) / self.eta, min=0.0)
        # consistent with the clamped tau_new: the site mean stays mu_hat
        v_new = (mu_hat * (tau_c + self.eta * tau_new) - v_c) / self.eta
        return tau_new, v_new

    def _converge_sites(self, K, likelihood, Y, Y_metadata):
        """(tau, v, sweeps): the sites converged with no graph."""
        K = K.detach()
        return self._run_sweeps(lambda tau, v: _posterior_diag_from_sites(K, tau, v)[:2],
                                likelihood, Y, Y_metadata, K.shape[0], K)

    def _log_marginal(self, K, likelihood, Y, Y_metadata, tau, v):
        diag, mu, L = _posterior_diag_from_sites(K, tau, v)
        half_logdet_B = torch.sum(torch.log(torch.diagonal(L)))
        return self._evidence(diag, mu, half_logdet_B, likelihood, Y, Y_metadata, tau, v)

    def _prepare(self, kern, X, likelihood, Y, mean_function, Y_metadata):
        N, D = Y.shape
        if D != 1:
            raise ValueError("EP inference supports single-output models (as GPy)")
        if mean_function is not None:
            raise NotImplementedError("EP with a mean function is not supported (as the "
                                      "reference)")
        K = kern.K(X) + 1e-8 * _eye(N, X)
        tau, v = self._sites(lambda: self._converge_sites(K, likelihood, Y, Y_metadata), N, K)
        return K, tau, v

    def marginal_likelihood(self, kern, X, likelihood, Y, mean_function=None, Y_metadata=None):
        """The evidence alone: the posterior's woodbury terms, which the
        reference's jit drops from an NLML, are not formed."""
        K, tau, v = self._prepare(kern, X, likelihood, Y, mean_function, Y_metadata)
        return self._log_marginal(K, likelihood, Y, Y_metadata, tau, v)

    def inference(self, kern, X, likelihood, Y, mean_function=None, Y_metadata=None):
        K, tau, v = self._prepare(kern, X, likelihood, Y, mean_function, Y_metadata)
        log_marginal = self._log_marginal(K, likelihood, Y, Y_metadata, tau, v)
        # woodbury_inv = sT B^-1 sT through U = L^-1 diag(sT), not an inverse
        # of the ill-conditioned B
        sT = torch.sqrt(torch.clamp(tau, min=1e-300))
        L = jitchol(_eye(K.shape[0], K) + (sT[:, None] * K) * sT[None, :])
        U = torch.linalg.solve_triangular(L, torch.diag(sT), upper=False)
        woodbury_inv = U.T @ U
        # alpha = v - W K v = (K + S~^-1)^-1 S~^-1 v
        alpha = v[:, None] - woodbury_inv @ (K @ v[:, None])
        return Posterior(woodbury_vector=alpha, woodbury_inv=woodbury_inv, K=K), log_marginal
