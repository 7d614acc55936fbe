"""Batched (L, L^-1) from batched matmuls: the leaf triangular inverses and
the blocked recursion for batches above the block kernel's gate.

Counterpart of the batched pieces of gpy_tpu/ops/blocked_linalg.py
(:123-169, 275-312). They are XLA code in the reference, outside any Pallas
kernel, so here they are torch ops and torch.matmul. The reference runs its
products at a 3-pass bf16 policy on the TPU (CHOL_UPDATE_PREC); on the card
they are float32 or float64 products with TF32 off (config.py), at least as
accurate. The single-matrix TPU recursion (rec_cholesky and the
inverse-leaf solves) has no counterpart: util/linalg.py leaves one matrix to
torch.linalg.
"""
from __future__ import annotations

import torch

__all__ = ["tri8_inv_batched", "tri_inv_doubling", "rec_chol_inv", "chol_inv_native",
           "BATCHED_REC_MIN_N", "BATCHED_REC_LEAF"]

_PW = 8

# the batched rules of util/linalg.py take the blocked factorizations or this
# recursion above this n, and torch.linalg at or below it (the reference's
# values, gpy_tpu/ops/blocked_linalg.py:283-284)
BATCHED_REC_MIN_N = 256
BATCHED_REC_LEAF = 256


def _t(X: torch.Tensor) -> torch.Tensor:
    return X.transpose(-1, -2)


def tri8_inv_batched(Ld: torch.Tensor) -> torch.Tensor:
    """Exact inverse of lower-triangular (..., 8, 8) blocks.

    Ld = (I + N) diag(d) with N = Ld / d - I strictly lower, so N^8 = 0 and
    (I + N)^-1 = (I - N)(I + N^2)(I + N^4) exactly: three batched products."""
    d = torch.diagonal(Ld, dim1=-2, dim2=-1)
    eye = torch.eye(_PW, dtype=Ld.dtype, device=Ld.device)
    N = Ld / d[..., :, None] - eye
    N2 = N @ N
    Minv = ((eye - N) @ (eye + N2)) @ (eye + N2 @ N2)
    return Minv / d[..., None, :]


def tri_inv_doubling(Lb: torch.Tensor) -> torch.Tensor:
    """Inverse of lower-triangular (..., n, n) blocks, n = 8 * 2^k: 8x8 leaf
    inverses, then pairwise doubling [[A, 0], [B, C]]^-1 = [[A^-1, 0],
    [-C^-1 B A^-1, C^-1]], batched products only."""
    *batch, n, _ = Lb.shape
    nb = n // _PW
    V = Lb.reshape(*batch, nb, _PW, nb, _PW)
    inv = tri8_inv_batched(torch.diagonal(V, dim1=-4, dim2=-2).movedim(-1, -3))
    s = _PW
    while nb > 1:
        V = Lb.reshape(*batch, nb // 2, 2 * s, nb // 2, 2 * s)
        d2 = torch.diagonal(V, dim1=-4, dim2=-2).movedim(-1, -3)
        Bblk = d2[..., s:, :s]
        Ai = inv[..., 0::2, :, :]
        Ci = inv[..., 1::2, :, :]
        low = -(Ci @ (Bblk @ Ai))
        z = torch.zeros_like(low)
        inv = torch.cat([torch.cat([Ai, z], -1), torch.cat([low, Ci], -1)], -2)
        nb //= 2
        s *= 2
    return inv[..., 0, :, :]


def chol_inv_native(A: torch.Tensor):
    """(L, L^-1) of (..., n, n) by torch.linalg, element by element NaN
    where the factorization fails: cholesky_ex reports the failure instead
    of raising, and the jitter ladder reads NaN as its signal, as the
    reference's native factorization gives it."""
    L, info = torch.linalg.cholesky_ex(A)
    L = torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape)
    return L, torch.linalg.solve_triangular(L, eye, upper=False)


def rec_chol_inv(A: torch.Tensor, leaf: int = BATCHED_REC_LEAF, leaf_fn=chol_inv_native):
    """(L, L^-1) of PSD (..., n, n) by a 2x2 recursion carrying the inverse:
    `leaf_fn` (torch.linalg by default) sees only (..., leaf, leaf) problems
    and every combine is a batched product, Li = [[L11i, 0], [-L22i L21
    L11i, L22i]]."""
    n = A.shape[-1]
    if n <= leaf:
        return leaf_fn(A)
    m = n // 2
    L11, L11i = rec_chol_inv(A[..., :m, :m], leaf, leaf_fn)
    L21 = A[..., m:, :m] @ _t(L11i)
    L22, L22i = rec_chol_inv(A[..., m:, m:] - L21 @ _t(L21), leaf, leaf_fn)
    Li21 = -(L22i @ (L21 @ L11i))
    z = torch.zeros((*A.shape[:-2], m, n - m), dtype=A.dtype, device=A.device)
    L = torch.cat([torch.cat([L11, z], -1), torch.cat([L21, L22], -1)], -2)
    Li = torch.cat([torch.cat([L11i, z], -1), torch.cat([Li21, L22i], -1)], -2)
    return L, Li
