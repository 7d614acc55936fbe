"""Pivoted (partial) Cholesky preconditioner for iterative exact-GP inference.

Counterpart of gpy_tpu/ops/pivoted_chol.py (the BBMM recipe, Gardner et
al. 2018): a rank-k pivoted Cholesky L of the noise-free kernel matrix gives
P = L L' + diag(noise), whose inverse applies in O(Nk) by Woodbury and whose
logdet is exact through the k x k capacitance matrix.

The pivot stays a device tensor (argmax, index_select, gather): a host read
per rank step would stop the card k times per factorization.
"""
from __future__ import annotations

import torch

__all__ = ["pivoted_cholesky", "woodbury_inverse_apply", "woodbury_logdet"]


def pivoted_cholesky(kern, X, rank: int, jitter: float = 1e-8):
    """Rank-`rank` pivoted Cholesky of K(X, X) -> L (N, rank).

    Greedy diagonal pivoting: at step i pick p = argmax of the residual
    diagonal and append column (K[:, p] - L L[p]') / sqrt(d[p]). Columns
    past the current step are zero, so the full (N, rank) product per step
    is exact. Once the residual diagonal is exhausted (below 1e-12 of its
    largest start value) the remaining columns are zero.
    """
    N = X.shape[0]
    d = kern.Kdiag(X) + jitter
    tol = 1e-12 * torch.max(d)
    L = torch.zeros((N, rank), dtype=X.dtype, device=X.device)
    for i in range(rank):
        p = torch.argmax(d).reshape(1)
        col = kern.K(X, X.index_select(0, p))[:, 0]
        resid = col - L @ L.index_select(0, p)[0]
        dp = d.gather(0, p)[0]
        ok = dp > tol
        l = torch.where(ok, resid / torch.sqrt(torch.where(ok, dp, 1.0)), 0.0)
        L[:, i] = l
        d = torch.clamp_min(d - l * l, 0.0).index_fill(0, p, 0.0)
    return L


def _capacitance_chol(L, noise):
    """chol(I_k + L' D^{-1} L) for P = L L' + D, D = diag(noise)."""
    k = L.shape[1]
    Ln = L / noise[:, None]
    C = torch.eye(k, dtype=L.dtype, device=L.device) + L.T @ Ln
    return torch.linalg.cholesky(C), Ln


def woodbury_inverse_apply(L, noise, capacitance=None):
    """Returns apply(V) = P^{-1} V for P = L L' + diag(noise); O(Nk) each."""
    Lc, Ln = capacitance if capacitance is not None else _capacitance_chol(L, noise)

    def apply(V):
        Vn = V / noise[:, None]
        s = torch.cholesky_solve(Ln.T @ V, Lc)
        return Vn - Ln @ s

    return apply


def woodbury_logdet(L, noise, capacitance=None):
    """Exact logdet(L L' + diag(noise))."""
    Lc, _ = capacitance if capacitance is not None else _capacitance_chol(L, noise)
    return torch.sum(torch.log(noise)) + 2.0 * torch.sum(torch.log(torch.diagonal(Lc)))
