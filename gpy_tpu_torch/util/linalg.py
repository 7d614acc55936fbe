"""Dense PSD linear algebra on torch.linalg, and the batched rules.

Counterpart of gpy_tpu/util/linalg.py:99-264, 272-461 (GPy/util/linalg.py:
jitchol:56, dtrtrs:95, dpotrs:116, dpotri:127, pdinv:193). Single-matrix
factorizations go to torch.linalg, as gpy_tpu leaves them to XLA outside
any Pallas kernel. A batch of matrices (leading dimensions: HMC chains,
parallel restarts) takes the reference's batched rules (:140-226): the
blocked Cholesky routines of ops/block_chol.py, whose kernel is B2/B3, and
a jitter ladder that escalates per batch element. The reference reaches them
through custom_vmap under jax.vmap; here the caller stacks the batch. The
TPU-only pieces (the f64 LU casts, the single-matrix blocked XLA
recursion) have no counterpart.
"""
from __future__ import annotations

import torch

from ..config import config
from ..ops.block_chol import MAX_BATCH, batched_chol_inv_ll, block_chol_available
from ..ops.blocked_linalg import BATCHED_REC_MIN_N, chol_inv_native, rec_chol_inv

__all__ = [
    "jitchol",
    "chol_jitter_used",
    "dtrtrs",
    "dpotrs",
    "dpotri",
    "pdinv",
    "tdot",
    "trace_dot",
    "symmetrify",
    "backsub_both_sides",
    "diag_add",
    "logdet_from_chol",
    "safe_sqrt",
    "cho_solve",
    "chol_and_inv",
    "jitchol_and_inv",
    "cholesky_or_nan",
    "solve_lu_safe",
    "slogdet_lu_safe",
    "expm_safe",
    "block_diag",
]


def _eye(A: torch.Tensor) -> torch.Tensor:
    return torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)


def _chol(A: torch.Tensor):
    """(L, ok): lower Cholesky factor and, per matrix of the batch, whether
    it succeeded. The probe and the result are the same factorization
    (cholesky_ex), so the ladder never accepts a jitter the final call
    refuses (gpy_tpu's round-5 fault, util/linalg.py:326-333). A NaN input
    makes LAPACK/cuSOLVER report a non-positive pivot; the isfinite term
    covers an infinite one."""
    L, info = torch.linalg.cholesky_ex(A)
    return L, (info == 0) & torch.isfinite(L.detach()).all(dim=(-2, -1))


def cholesky_or_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN for a matrix that is not positive definite,
    as jnp.linalg.cholesky returns it. Unlike torch.linalg.cholesky it reads
    no status back to the host, so a loop of them never waits on the card."""
    L, ok = _chol(A)
    return torch.where(ok[..., None, None], L, torch.full_like(L, float("nan")))


def _diag_mean(A: torch.Tensor) -> torch.Tensor:
    return torch.abs(torch.mean(torch.diagonal(A, dim1=-2, dim2=-1), dim=-1))


def _find_jitter(A_sg: torch.Tensor, ok0: torch.Tensor, probe, maxtries: int) -> torch.Tensor:
    """Per matrix of the batch, the smallest jitter of the escalation ladder
    making `probe(A + jI)` succeed, 0 where ok0 already holds:
    gpy_tpu/util/linalg.py:320-347 for one matrix, :193-216 for a batch.
    Every rung probes the whole batch at once with the factorization that
    gives the result (`probe` returns the per-matrix success); a matrix
    still failing escalates ten-fold. The rungs are jitter0 * 10**k for
    k = 0..maxtries, jitter0 = config.jitter * |mean diag|; where none
    succeeds the level is escalated once more, as the reference's loop
    leaves it."""
    jit = _diag_mean(A_sg) * config.jitter
    ok = ok0
    eye = _eye(A_sg)
    tries = 0
    while tries <= maxtries and not bool(ok.all()):
        ok_new = probe(A_sg + jit[..., None, None] * eye)
        jit = torch.where(ok | ok_new, jit, jit * 10.0)
        ok = ok | ok_new
        tries += 1
    return torch.where(ok0, torch.zeros_like(jit), jit)


def _jittered(A: torch.Tensor, jit_used: torch.Tensor, gradient_consistent: bool = True):
    """A + jitter I per matrix. Gradient-consistent: the ladder picks a
    stop-gradient *level*; the applied jitter scales differentiably with the
    matrix magnitude (d/d kern.variance sees jitter proportional to the
    variance, matching the value)."""
    if not gradient_consistent:
        return A + jit_used[..., None, None] * _eye(A)
    diag_mean = _diag_mean(A)
    mult = jit_used / torch.clamp(diag_mean.detach(), min=torch.finfo(A.dtype).tiny)
    return A + (mult * diag_mean)[..., None, None] * _eye(A)


def _jitchol(A: torch.Tensor, maxtries=None, gradient_consistent: bool = True):
    """(L, jitter) with the ladder escalating per matrix of a batch."""
    if maxtries is None:
        maxtries = config.max_jitter_tries
    L0, ok0 = _chol(A)
    if bool(ok0.all()):  # the probe is the result when every matrix is clean
        return L0, torch.zeros(A.shape[:-2], dtype=A.dtype, device=A.device)
    jit_used = _find_jitter(A.detach(), ok0, lambda Aj: _chol(Aj)[1], maxtries)
    # the reference's factorization returns NaN where it fails, which the
    # optimizer's non-finite guard turns into a rejected step
    return cholesky_or_nan(_jittered(A, jit_used, gradient_consistent)), jit_used


def _batched_chol_inv(K: torch.Tensor):
    """(L, L^-1) of (..., n, n), one batched factorization: gpy_tpu/util/
    linalg.py:140-174. Above n = 256, a batch of at most 64 goes to the
    left-looking blocked factorization (kernel B2/B3 on a CUDA tensor, its
    plain twin on a CPU tensor) and a larger one to the blocked recursion;
    torch.linalg takes n <= 256. A matrix that is not positive definite
    comes out NaN, alone in its batch."""
    n = K.shape[-1]
    if n > BATCHED_REC_MIN_N:
        n_batch = 1
        for b in K.shape[:-2]:
            n_batch *= b
        if n_batch <= MAX_BATCH and (K.device.type == "cpu" or block_chol_available(K)):
            return batched_chol_inv_ll(K)
        return rec_chol_inv(K)
    return chol_inv_native(K)


def _batched_jitchol_inv(K: torch.Tensor, maxtries=None):
    """Batched jitchol + inverse: gpy_tpu/util/linalg.py:177-226.

    One batched factorization when every element is clean. Otherwise the
    ladder escalates per element, probing with the same batched
    factorization that gives the result, and one more factorization of
    K + jitter I (zero jitter for the clean elements, whose factor is then
    bit-equal to the first one's) is the result."""
    if maxtries is None:
        maxtries = config.max_jitter_tries
    L0, Li0 = _batched_chol_inv(K)
    ok0 = torch.isfinite(L0).all(dim=(-2, -1))
    if bool(ok0.all()):
        return L0, Li0
    jit_used = _find_jitter(
        K, ok0, lambda Kj: torch.isfinite(_batched_chol_inv(Kj)[0]).all(dim=(-2, -1)), maxtries)
    return _batched_chol_inv(_jittered(K, jit_used))


def jitchol(A: torch.Tensor, maxtries=None) -> torch.Tensor:
    """Cholesky with the escalating-jitter retry ladder, reverse-mode safe.

    GPy: util/linalg.py:56-82. One differentiable factorization probes the
    matrix; when it succeeds it is the result. Only on failure does the
    stop-gradient ladder run (1e-6*mean(diag) start, 10x escalation,
    maxtries), followed by one differentiable re-factorization.
    """
    return _jitchol(A, maxtries)[0]


def chol_jitter_used(A: torch.Tensor, maxtries=None):
    """Like jitchol but also returns the (absolute) jitter applied."""
    return _jitchol(A, maxtries, gradient_consistent=False)


class _CholAndInv(torch.autograd.Function):
    """(L, L^-1) with the matmul-only backward of
    gpy_tpu/util/linalg.py:272-288: fold the inverse's cotangent into L's
    (dLi = -Li dL Li), then the Cholesky pullback Kb = Li' phi(L' Lb) Li
    with phi = tril with the diagonal halved; the symmetric part is
    returned. The jitter ladder is a data-independent diagonal shift, so the
    pullback is exact for the factored matrix K + jitter*I. A K with leading
    batch dimensions takes the batched rules; the backward broadcasts."""

    @staticmethod
    def forward(ctx, K, use_ladder):
        ctx.set_materialize_grads(False)
        if K.ndim > 2:
            L, Li = _batched_jitchol_inv(K) if use_ladder else _batched_chol_inv(K)
        else:
            L = jitchol(K) if use_ladder else cholesky_or_nan(K)
            Li = torch.linalg.solve_triangular(L, _eye(L), upper=False)
        ctx.save_for_backward(L, Li)
        return L, Li

    @staticmethod
    def backward(ctx, L_bar, Li_bar):
        L, Li = ctx.saved_tensors
        if L_bar is None and Li_bar is None:
            return None, None
        LiT = Li.transpose(-1, -2)
        Lb = torch.zeros_like(L) if L_bar is None else L_bar
        if Li_bar is not None:
            Lb = Lb - LiT @ Li_bar @ LiT
        P = torch.tril(L.transpose(-1, -2) @ Lb)
        P = P - 0.5 * torch.diag_embed(torch.diagonal(P, dim1=-2, dim2=-1))
        Kb = LiT @ P @ Li
        return 0.5 * (Kb + Kb.transpose(-1, -2)), None


def chol_and_inv(K: torch.Tensor):
    """L = chol(K) (lower) and Li = L^-1, with a matmul-only backward.
    K may carry leading batch dimensions (one batched factorization). A
    matrix that is not positive definite gives NaN, as in the reference,
    and one matrix is factored with no host sync (`cholesky_or_nan`)."""
    return _CholAndInv.apply(K, False)


def jitchol_and_inv(K: torch.Tensor):
    """`jitchol` + explicit factor inverse with the same matmul-only backward.
    K may carry leading batch dimensions; the jitter ladder then escalates
    per batch element."""
    return _CholAndInv.apply(K, True)


def tdot(A: torch.Tensor) -> torch.Tensor:
    """A @ A.T. GPy: util/linalg.py:299 (dsyrk)."""
    return A @ A.T


def trace_dot(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """tr(A @ B) without forming the product."""
    return torch.sum(A * B.T)


def symmetrify(A: torch.Tensor) -> torch.Tensor:
    """(A + A.T)/2. GPy: util/linalg.py:356."""
    return 0.5 * (A + A.T)


def diag_add(A: torch.Tensor, d) -> torch.Tensor:
    """A + diag(d) for a scalar or vector d."""
    d = torch.as_tensor(d, dtype=A.dtype, device=A.device)
    if d.ndim == 0:
        return A + d * _eye(A)
    return A + torch.diag(d)


def dtrtrs(L: torch.Tensor, B: torch.Tensor, lower: bool = True, trans: bool = False):
    """Solve the triangular system op(L) x = B. GPy: util/linalg.py:95."""
    if trans:
        return torch.linalg.solve_triangular(L.transpose(-1, -2), B, upper=lower)
    return torch.linalg.solve_triangular(L, B, upper=not lower)


def dpotrs(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A x = B given the lower Cholesky factor L of A. GPy: util/linalg.py:116."""
    return torch.cholesky_solve(B, L, upper=False)


cho_solve = dpotrs


def dpotri(L: torch.Tensor) -> torch.Tensor:
    """A^-1 from the lower Cholesky factor L. GPy: util/linalg.py:127."""
    Li = torch.linalg.solve_triangular(L, _eye(L), upper=False)
    return Li.T @ Li


def pdinv(A: torch.Tensor):
    """(Ai, L, Li, logdet) for PSD A. GPy: util/linalg.py:193."""
    L = jitchol(A)
    Li = torch.linalg.solve_triangular(L, _eye(L), upper=False)
    Ai = Li.T @ Li
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L)))
    return Ai, L, Li, logdet


def solve_lu_safe(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """General LU solve, gpy_tpu/util/linalg.py:72-79. The reference casts
    float64 to float32 there on a TPU (`_lu_dtype`), whose float64 LU fails
    to compile; the card has a float64 LU, so nothing is cast. A singular A
    gives inf or NaN, as the reference's jnp.linalg.solve does, for the
    optimizers to back off from: torch.linalg.solve would raise, after
    reading the LU's info back to the host."""
    return torch.linalg.solve_ex(A, b)[0]


def expm_safe(M: torch.Tensor) -> torch.Tensor:
    """The matrix exponential of M (batched over leading dimensions),
    gpy_tpu/util/linalg.py:91-97, by torch.linalg.matrix_exp, which
    differentiates. The reference casts float64 to float32 on a TPU, where
    the Pade denominator's float64 LU fails to compile; the card and the
    CPU have a float64 LU, so nothing is cast."""
    return torch.linalg.matrix_exp(M)


def block_diag(*mats: torch.Tensor) -> torch.Tensor:
    """jax.scipy.linalg.block_diag of 2-D tensors (torch.block_diag)."""
    return torch.block_diag(*mats)


def slogdet_lu_safe(A: torch.Tensor):
    """(sign, log|det A|) by LU, gpy_tpu/util/linalg.py:82-88, with no
    float32 cast (see solve_lu_safe)."""
    return torch.linalg.slogdet(A)


def logdet_from_chol(L: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def backsub_both_sides(L: torch.Tensor, X: torch.Tensor, transpose: str = "left"):
    """GPy: util/linalg.py:381.

    transpose='left':  L^{-T} X L^{-1}
    transpose='right': L^{-1} X L^{-T}
    """
    if transpose == "left":
        tmp = dtrtrs(L, X.T, trans=True)
        return dtrtrs(L, tmp.T, trans=True)
    tmp = dtrtrs(L, X.T)
    return dtrtrs(L, tmp.T)


def safe_sqrt(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """sqrt with a zero gradient at x <= eps (the double-where trick), so
    autograd through r = sqrt(r2) at r2 = 0 (the Gram diagonal) gives 0."""
    pos = x > eps
    safe = torch.where(pos, x, torch.ones_like(x))
    return torch.where(pos, torch.sqrt(safe), torch.zeros_like(x))
