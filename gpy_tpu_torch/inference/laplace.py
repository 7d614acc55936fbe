"""Laplace approximation for non-Gaussian likelihoods.

Counterpart of gpy_tpu/inference/laplace.py:37-283 (GPy/inference/
latent_function_inference/laplace.py: Laplace:24, rasm_mode:148-231,
mode_computations:233-307; LaplaceBlock:355-502).

- The mode is found by damped Newton with a vectorized line search: all
  n_linesearch step sizes 1, 1/2, ... are scored at once, the quadratic
  term in closed form, and the first best is taken; no candidate better
  than the old point keeps it. It runs with no graph on the likelihood's
  detached parameters. The reference's lax.while_loop is a Python loop with
  its rule, `(delta > tol) & (it < max_iters)`: one host sync a Newton step,
  and one more from jitchol's probe.
- The hyperparameter gradient comes from one differentiable Newton step
  from the detached mode: the Newton map has zero derivative in f at its
  root, so its derivative in theta is the implicit-function one. Its W is
  autograd's second derivative with the graph kept, so the third derivative
  of logpdf reaches the gradient.
- Log-concave likelihoods (W >= 0) solve through the Cholesky of
  B = I + sqrtW K sqrtW; the others (StudentT) through the LU of I + W K,
  with slogdet for the evidence.
"""
from __future__ import annotations

import numpy as np
import torch

from ..util.linalg import dpotrs, jitchol, slogdet_lu_safe, solve_lu_safe
from .exact import LatentFunctionInference
from .posterior import Posterior

__all__ = ["Laplace", "LaplaceBlock"]


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _W_grad(f, likelihood, Y, Y_metadata, m):
    W = -likelihood.d2_logpdf_df2(f + m, Y, Y_metadata)
    grad = likelihood.d_logpdf_df(f + m, Y, Y_metadata)
    return W, grad


def _sqrt_B(W, K):
    """(sqrt W, B = I + sqrtW K sqrtW) for W >= 0."""
    sW = torch.sqrt(torch.clamp(W, min=0.0))
    return sW, _eye(K.shape[0], K) + (sW * K) * sW[:, 0][None, :]


def _newton_direction(f, K, likelihood, Y, Y_metadata, m, psd_W=False):
    """(f_nt, a) with the full Newton target f_nt = K (I + W K)^-1 (W f + grad)
    = K a. psd_W: GPML algorithm 3.1, a = b - sqrtW B^-1 sqrtW K b, one
    Cholesky; else one general LU solve, valid for any sign of W."""
    W, grad = _W_grad(f, likelihood, Y, Y_metadata, m)
    b = W * f + grad  # (N, 1)
    if psd_W:
        sW, B = _sqrt_B(W, K)
        a = b - sW * dpotrs(jitchol(B), sW * (K @ b))
        return K @ a, a
    a = solve_lu_safe(_eye(K.shape[0], K) + W * K, b)
    return K @ a, a


class Laplace(LatentFunctionInference):
    def __init__(self, max_iters: int = 100, tol: float = 1e-10, n_linesearch: int = 12,
                 psd_W=None):
        """psd_W: True solves through the Cholesky of B = I + sqrtW K sqrtW
        (log-concave likelihoods, W >= 0 everywhere); None takes the
        likelihood's `log_concave`; False forces the general LU path."""
        self.max_iters = max_iters
        self.tol = tol
        self.n_linesearch = n_linesearch
        self.psd_W = psd_W
        # the last mode search's Newton steps and its last change in psi (a
        # device scalar)
        self.last_newton_steps = self.last_change = None

    def _psd(self, likelihood):
        if self.psd_W is not None:
            return bool(self.psd_W)
        return bool(getattr(likelihood, "log_concave", False))

    def _direction(self, f, K, likelihood, Y, Y_metadata, m):
        return _newton_direction(f, K, likelihood, Y, Y_metadata, m, self._psd(likelihood))

    def _candidates_logpdf(self, likelihood, cand, Y, Y_metadata, m):
        """sum logpdf at each of the (S, N, 1) candidates, shape (S,)."""
        return torch.sum(likelihood.logpdf(cand + m[None], Y[None], Y_metadata), dim=(1, 2))

    def _find_mode(self, K, likelihood, Y, Y_metadata, m):
        """(f*, Newton steps): damped Newton from f = 0, no graph."""
        with torch.no_grad(), likelihood.stop_gradient():
            K, Y, m = K.detach(), Y.detach(), m.detach()
            L_K = jitchol(K)
            steps = torch.tensor(2.0 ** -np.arange(self.n_linesearch), dtype=K.dtype,
                                 device=K.device)  # 1, 1/2, ...

            def psi(f):
                return torch.sum(likelihood.logpdf(f + m, Y, Y_metadata)) - 0.5 * torch.sum(
                    f * dpotrs(L_K, f))

            f = torch.zeros_like(Y)
            prev_psi = psi(f)
            delta = torch.full((), float("inf"), dtype=K.dtype, device=K.device)
            it = 0
            while it < self.max_iters and bool(delta > self.tol):
                f_nt, _ = self._direction(f, K, likelihood, Y, Y_metadata, m)
                d = f_nt - f
                # psi(f + s d) = sum logpdf - (qff + 2 s qfd + s^2 qdd) / 2 from
                # one two-column solve
                sol = dpotrs(L_K, torch.cat([f, d], dim=1))
                qff = torch.sum(f[:, 0] * sol[:, 0])
                qfd = torch.sum(d[:, 0] * sol[:, 0])
                qdd = torch.sum(d[:, 0] * sol[:, 1])
                cand = f[None] + steps[:, None, None] * d[None]
                vals = self._candidates_logpdf(likelihood, cand, Y, Y_metadata, m) - 0.5 * (
                    qff + 2.0 * steps * qfd + steps**2 * qdd)
                best = torch.argmax(vals)  # the first maximum, as jnp.argmax
                improved = vals[best] > prev_psi  # else keep the old point
                f_new = torch.where(improved, cand[best], f)
                new_psi = torch.where(improved, vals[best], prev_psi)
                delta = torch.abs(new_psi - prev_psi)
                f, prev_psi = f_new, new_psi
                it += 1
        self.last_newton_steps, self.last_change = it, delta
        return f, it

    def _mode_and_step(self, kern, X, likelihood, Y, mean_function, Y_metadata, what):
        N, D = Y.shape
        if D != 1:
            raise ValueError(f"{what} inference supports single-output models (as GPy)")
        if mean_function is not None:
            raise NotImplementedError("mean functions are not ported yet (ROADMAP A17)")
        m = torch.zeros_like(Y)
        # a fixed 1e-8 I, as the reference: not the jitter ladder
        K = kern.K(X) + 1e-8 * _eye(N, X)
        f_star, _ = self._find_mode(K, likelihood, Y, Y_metadata, m)
        # one differentiable Newton step from the detached mode
        f_hat, a = self._direction(f_star, K, likelihood, Y, Y_metadata, m)
        return K, m, f_hat, a

    def _evidence(self, kern, X, likelihood, Y, mean_function, Y_metadata, want_posterior):
        K, m, f_hat, a = self._mode_and_step(kern, X, likelihood, Y, mean_function, Y_metadata,
                                             "Laplace")
        W, _ = _W_grad(f_hat, likelihood, Y, Y_metadata, m)
        woodbury_inv = None
        if self._psd(likelihood):
            # |I + W K| = |B| and (I + W K)^-1 W = sqrtW B^-1 sqrtW (GPML 3.4.3)
            sW, B = _sqrt_B(W, K)
            LB = jitchol(B)
            logdetA = 2.0 * torch.sum(torch.log(torch.diagonal(LB)))
            if want_posterior:
                U = torch.linalg.solve_triangular(LB, torch.diag(sW[:, 0]), upper=False)
                woodbury_inv = U.T @ U
        else:
            A = _eye(K.shape[0], K) + W * K  # I + diag(W) K
            _, logdetA = slogdet_lu_safe(A)
            if want_posterior:
                # (K + W^-1)^-1 = (I + W K)^-1 W: no 1/W, safe for W <= 0
                Ai_W = solve_lu_safe(A, torch.diag(W[:, 0]))
                woodbury_inv = 0.5 * (Ai_W + Ai_W.T)
        log_marginal = (torch.sum(likelihood.logpdf(f_hat + m, Y, Y_metadata))
                        - 0.5 * torch.sum(a * f_hat) - 0.5 * logdetA)
        return K, a, woodbury_inv, log_marginal

    def marginal_likelihood(self, kern, X, likelihood, Y, mean_function=None, Y_metadata=None):
        """The evidence alone: the woodbury_inv that the reference's jit
        drops from an NLML is not formed."""
        return self._evidence(kern, X, likelihood, Y, mean_function, Y_metadata, False)[3]

    def inference(self, kern, X, likelihood, Y, mean_function=None, Y_metadata=None):
        K, a, woodbury_inv, log_marginal = self._evidence(kern, X, likelihood, Y, mean_function,
                                                          Y_metadata, True)
        return Posterior(woodbury_vector=a, woodbury_inv=woodbury_inv, K=K), log_marginal


# --- block (non-diagonal Hessian) Laplace ------------------------------------
def _W_block(f, likelihood, Y, Y_metadata, m):
    """The negative Hessian of sum log p(y|f) as an (N, N) matrix: the
    likelihood's `d2_logpdf_df2_block` where it has one (a coupled
    likelihood), else the diagonal tower embedded. Its diagonal is clipped to
    [1e-6, 1e30] (GPy laplace.py:375, 424)."""
    if hasattr(likelihood, "d2_logpdf_df2_block"):
        W = -likelihood.d2_logpdf_df2_block(f + m, Y, Y_metadata)
    else:
        W = torch.diagflat(-likelihood.d2_logpdf_df2(f + m, Y, Y_metadata))
    d = torch.diagonal(W)
    W = W - torch.diagflat(d) + torch.diagflat(torch.clamp(d, 1e-6, 1e30))
    return W, likelihood.d_logpdf_df(f + m, Y, Y_metadata)


def _newton_direction_block(f, K, likelihood, Y, Y_metadata, m):
    """f_nt = K (I + W K)^-1 (W f + grad) with a full-matrix W."""
    W, grad = _W_block(f, likelihood, Y, Y_metadata, m)
    a = solve_lu_safe(_eye(K.shape[0], K) + W @ K, W @ f + grad)
    return K @ a, a


class LaplaceBlock(Laplace):
    """Laplace with a full (non-diagonal) likelihood Hessian: Laplace's mode
    search and differentiable step with every diag(W) product a matrix
    product, the general B = I + W K and the slogdet evidence (GPy:
    laplace.py:355-502). For a factorized likelihood it computes Laplace's
    function."""

    def _direction(self, f, K, likelihood, Y, Y_metadata, m):
        return _newton_direction_block(f, K, likelihood, Y, Y_metadata, m)

    def _candidates_logpdf(self, likelihood, cand, Y, Y_metadata, m):
        # one candidate at a time: a coupled logpdf need not broadcast
        return torch.stack([torch.sum(likelihood.logpdf(c + m, Y, Y_metadata)) for c in cand])

    def _evidence(self, kern, X, likelihood, Y, mean_function, Y_metadata, want_posterior):
        K, m, f_hat, a = self._mode_and_step(kern, X, likelihood, Y, mean_function, Y_metadata,
                                             "LaplaceBlock")
        W, _ = _W_block(f_hat, likelihood, Y, Y_metadata, m)
        A = _eye(K.shape[0], K) + W @ K
        _, logdetA = slogdet_lu_safe(A)
        log_marginal = (torch.sum(likelihood.logpdf(f_hat + m, Y, Y_metadata))
                        - 0.5 * torch.sum(a * f_hat) - 0.5 * logdetA)
        woodbury_inv = None
        if want_posterior:
            Ai_W = solve_lu_safe(A, W)
            woodbury_inv = 0.5 * (Ai_W + Ai_W.T)
        return K, a, woodbury_inv, log_marginal
