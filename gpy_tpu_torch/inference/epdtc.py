"""EPDTC: expectation propagation for sparse (DTC) GPs.

Counterpart of gpy_tpu/inference/epdtc.py:26-157 (GPy/inference/
latent_function_inference/expectation_propagation.py EPDTC:443-622). As in
dense EP (ep.py), the sites update in parallel with damping, from the same
loop; every solve lives in the whitened inducing space: R = Lm^-1 Kmn and
B = I_M + R diag(tau) R' are (M, M), so a sweep is O(N M^2 + M^3). Kmm
carries CONST_JITTER and goes through jitchol_and_inv, so R is a product.
"""
from __future__ import annotations

import torch

from ..util.linalg import dpotrs, dtrtrs, jitchol, jitchol_and_inv
from .ep import _EPSites
from .posterior import Posterior

__all__ = ["EPDTC"]

CONST_JITTER = 1e-6


def _posterior_w(R, tau, v):
    """Posterior over the whitened u given sites on f = R' w:
    (mu_f (N,), sig2_f (N,), m_w, S_w, LB)."""
    eye = torch.eye(R.shape[0], dtype=R.dtype, device=R.device)
    LB = jitchol(eye + (R * tau[None, :]) @ R.T)
    S_w = dpotrs(LB, eye)
    m_w = S_w @ (R @ v)
    V = torch.linalg.solve_triangular(LB, R, upper=False)
    return R.T @ m_w, torch.sum(V * V, dim=0), m_w, S_w, LB


class EPDTC(_EPSites):
    """ep_mode as in EP: "alternated" holds the converged sites through an
    optimize(); "nested" (the default) converges them every evaluation."""

    def _site_update(self, mu_hat, s2_hat, tau_c, v_c):
        # the reference's own floor here, 1e-12 (EP's is 1e-6)
        s2_hat = torch.clamp(s2_hat, 1e-12, 1e12)
        tau_new = torch.clamp((1.0 / s2_hat - tau_c) / self.eta, min=0.0)
        return tau_new, (mu_hat / s2_hat - v_c) / self.eta

    def _converge_sites(self, R, likelihood, Y, Y_metadata):
        """(tau, v, sweeps): the sites converged with no graph."""
        R = R.detach()

        def marginals(tau, v):
            mu, sig2 = _posterior_w(R, tau, v)[:2]
            return sig2, mu

        return self._run_sweeps(marginals, likelihood, Y, Y_metadata, R.shape[1], R)

    def _log_marginal(self, R, likelihood, Y, Y_metadata, tau, v):
        mu, sig2, _, _, LB = _posterior_w(R, tau, v)
        half_logdet_B = torch.sum(torch.log(torch.diagonal(LB)))
        return self._evidence(sig2, mu, half_logdet_B, likelihood, Y, Y_metadata, tau, v)

    def _prepare(self, kern, X, Z, likelihood, Y, mean_function):
        if mean_function is not None:
            raise NotImplementedError("EPDTC with a mean function is not supported (as the "
                                      "reference)")
        M = Z.shape[0]
        Kmm = kern.K(Z) + CONST_JITTER * torch.eye(M, dtype=Z.dtype, device=Z.device)
        Lm, Lmi = jitchol_and_inv(Kmm)
        R = Lmi @ kern.K(Z, X)  # (M, N)
        return Kmm, Lm, R

    def marginal_likelihood(self, kern, X, Z, likelihood, Y, mean_function=None,
                            Y_metadata=None, qX=None):
        """The evidence alone, with no posterior (the reference's jit drops it)."""
        _, _, R = self._prepare(kern, X, Z, likelihood, Y, mean_function)
        tau, v = self._sites(lambda: self._converge_sites(R, likelihood, Y, Y_metadata),
                             R.shape[1], R)
        return self._log_marginal(R, likelihood, Y, Y_metadata, tau, v)

    def inference(self, kern, X, Z, likelihood, Y, mean_function=None, Y_metadata=None,
                  qX=None):
        Kmm, Lm, R = self._prepare(kern, X, Z, likelihood, Y, mean_function)
        tau, v = self._sites(lambda: self._converge_sites(R, likelihood, Y, Y_metadata),
                             R.shape[1], R)
        log_marginal = self._log_marginal(R, likelihood, Y, Y_metadata, tau, v)
        # the posterior over Z: Lm^-T m_w and Lm^-T (I - S_w) Lm^-1
        _, _, m_w, S_w, _ = _posterior_w(R, tau, v)
        eye = torch.eye(Z.shape[0], dtype=Z.dtype, device=Z.device)
        wv = dtrtrs(Lm, m_w[:, None], trans=True)
        tmp = dtrtrs(Lm, eye - S_w, trans=True)
        wi = dtrtrs(Lm, tmp.T, trans=True).T
        return Posterior(woodbury_vector=wv, woodbury_inv=0.5 * (wi + wi.T), K=Kmm), log_marginal
