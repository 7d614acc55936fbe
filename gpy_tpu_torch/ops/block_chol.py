"""Batched block Cholesky (kernels B2/B3 and B4), their plain twins and the
blocked routines that factor a batch of (n, n) matrices from 128x128 blocks.

Counterpart of gpy_tpu/ops/pallas_chol.py. On a CUDA tensor `block_chol`
and `block_chol_inv` launch the kernels in csrc/block_chol.cu (one launch
per call, counted in `launches` and `inv_launches`); on a CPU tensor they
run `block_chol_plain` and `block_chol_inv_plain`, the column algorithm
in torch ops whose per-entry order of updates the kernels' panels keep, so
that a block that is not positive definite gives the same NaN either way.
There is no fallback from one to the other: a CUDA tensor launches the
kernel or raises. torch.linalg.cholesky is
never called here: it is only the yardstick `chip_smoke.py` times.

The blocked routines follow the reference: n is padded with an identity
block to a multiple of the block size (exact: the padding factors to I and
never couples back), each diagonal block goes to the kernel, panels are
products with the block's inverse, and L^-1 is assembled by pairwise
doubling. The
reference's glue products run at a 3-pass bf16 policy on the TPU; here they
are torch.matmul in the input's type with TF32 off (config.py), at least as
accurate. `block=256` hands 256x256 diagonal blocks to the TPU kernel; here
each such block is factored by the same routine at block 128 nested inside
it, which computes the same function and keeps the kernel at one size.
GPY_TPU_CHOL_KERNEL_STYLE and GPY_TPU_CHOL_INTERLEAVE chose between TPU
schedules of one function and have no counterpart; nothing here reads the
environment.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .blocked_linalg import rec_chol_inv, tri_inv_doubling

__all__ = ["block_chol", "block_chol_inv", "block_chol_plain", "block_chol_inv_plain",
           "block_chol_cuda", "block_chol_inv_cuda", "block_chol_available",
           "batched_chol_inv_ll", "batched_chol_inv", "rec_block_chol_inv",
           "launches", "inv_launches", "BLOCK", "MAX_BATCH"]

BLOCK = 128  # the kernels' block edge
# util/linalg.py's batched rule hands a batch of at most this many matrices
# to the blocked factorization (the reference's gate, gpy_tpu/util/linalg.py:159)
MAX_BATCH = 64

# launches of each CUDA kernel since import (or since a caller reset them)
launches = 0
inv_launches = 0

_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("block_chol")
        p = ctypes.c_void_p
        for fn in (lib.block_chol_f32, lib.block_chol_f64):
            fn.argtypes = [p, p, ctypes.c_int, p]
            fn.restype = ctypes.c_int
        for fn in (lib.block_chol_inv_f32, lib.block_chol_inv_f64):
            fn.argtypes = [p, p, p, ctypes.c_int, p]
            fn.restype = ctypes.c_int
        lib.block_chol_error_string.argtypes = [ctypes.c_int]
        lib.block_chol_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def block_chol_available(K: torch.Tensor) -> bool:
    """Whether the kernels take K's blocks: a CUDA tensor of float32 or
    float64 (the reference's gate is a TPU with float32)."""
    return K.device.type == "cuda" and K.dtype in (torch.float32, torch.float64)


# --- plain twins ------------------------------------------------------------

def block_chol_plain(A: torch.Tensor) -> torch.Tensor:
    """L = chol(A) for (C, n, n) by the kernel's right-looking column
    algorithm in torch ops: NaN from a bad pivot on. Only the lower triangle
    is read (column k from the diagonal down); the rank-1 updates also
    touch the upper triangle, which is never read."""
    A = A.clone()
    n = A.shape[-1]
    L = torch.zeros_like(A)
    for k in range(n):
        piv = torch.sqrt(A[:, k, k])
        lk = A[:, k:, k] * (1.0 / piv)[:, None]
        lk[:, 0] = piv
        L[:, k:, k] = lk
        if k + 1 < n:
            tail = lk[:, 1:]
            A[:, k + 1:, k + 1:] -= tail[:, :, None] * tail[:, None, :]
    return L


def block_chol_inv_plain(A: torch.Tensor):
    """(L, L^-1) for (C, n, n): the factor as `block_chol_plain`, then the
    forward substitution X[k] = B[k] / L[k, k], B[i] -= L[i, k] X[k], whose
    per-entry order the kernel keeps (it multiplies by 1 / L[k, k], taken
    once, where this divides). L^-1 is returned lower-triangular: above the
    diagonal X is exactly 0 for an SPD block, and NaN in the rows from a bad
    pivot on, which the kernel never computes."""
    L = block_chol_plain(A)
    n = A.shape[-1]
    X = torch.eye(n, dtype=A.dtype, device=A.device).repeat(A.shape[0], 1, 1)
    for k in range(n):
        X[:, k, :] = X[:, k, :] / L[:, k, k, None]
        if k + 1 < n:
            X[:, k + 1:, :] -= L[:, k + 1:, k, None] * X[:, k, None, :]
    return L, torch.tril(X)


# --- the kernels ------------------------------------------------------------

def _check(A: torch.Tensor, who: str):
    if A.device.type != "cuda":
        raise ValueError(f"{who}: A is on {A.device}, not a CUDA device")
    if A.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{who}: dtype {A.dtype} is not float32 or float64")
    if A.ndim != 3 or A.shape[1:] != (BLOCK, BLOCK) or A.shape[0] < 1:
        raise ValueError(f"{who}: shape {tuple(A.shape)} is not (C, {BLOCK}, {BLOCK}), C >= 1")
    if not A.is_contiguous():
        raise ValueError(f"{who}: A is not contiguous")


def _raise_on(rc, lib, who):
    if rc != 0:
        raise RuntimeError(
            f"{who} kernel launch failed: {lib.block_chol_error_string(rc).decode()}")


def block_chol_cuda(A: torch.Tensor) -> torch.Tensor:
    """The B2/B3 kernel: one launch of C blocks on the current stream."""
    global launches
    _check(A, "block_chol_cuda")
    L = torch.empty_like(A)
    lib = _lib()
    fn = lib.block_chol_f32 if A.dtype == torch.float32 else lib.block_chol_f64
    with torch.cuda.device(A.device):
        rc = fn(A.data_ptr(), L.data_ptr(), A.shape[0],
                torch.cuda.current_stream(A.device).cuda_stream)
    _raise_on(rc, lib, "block_chol")
    launches += 1
    return L


def block_chol_inv_cuda(A: torch.Tensor):
    """The B4 kernel: one launch of C blocks, (L, L^-1)."""
    global inv_launches
    _check(A, "block_chol_inv_cuda")
    L, Li = torch.empty_like(A), torch.empty_like(A)
    lib = _lib()
    fn = lib.block_chol_inv_f32 if A.dtype == torch.float32 else lib.block_chol_inv_f64
    with torch.cuda.device(A.device):
        rc = fn(A.data_ptr(), L.data_ptr(), Li.data_ptr(), A.shape[0],
                torch.cuda.current_stream(A.device).cuda_stream)
    _raise_on(rc, lib, "block_chol_inv")
    inv_launches += 1
    return L, Li


def block_chol(A: torch.Tensor) -> torch.Tensor:
    """L of a (C, 128, 128) batch: the kernel on CUDA, the twin on the CPU."""
    if A.device.type == "cpu":
        return block_chol_plain(A)
    return block_chol_cuda(A.contiguous())


def block_chol_inv(A: torch.Tensor):
    """(L, L^-1) of a (C, 128, 128) batch: the kernel on CUDA, the twin on the CPU."""
    if A.device.type == "cpu":
        return block_chol_inv_plain(A)
    return block_chol_inv_cuda(A.contiguous())


# --- blocked factorizations -------------------------------------------------

def _t(X: torch.Tensor) -> torch.Tensor:
    return X.transpose(-1, -2)


def _flatten_pad(K: torch.Tensor, blk: int):
    """(C, npad, npad): the batch flattened, n padded with an identity block."""
    n = K.shape[-1]
    K = K.reshape(-1, n, n)
    npad = -(-n // blk) * blk
    if npad == n:
        return K
    Kp = torch.zeros((K.shape[0], npad, npad), dtype=K.dtype, device=K.device)
    Kp[:, :n, :n] = K
    Kp[:, n:, n:] = torch.eye(npad - n, dtype=K.dtype, device=K.device)
    return Kp


def _unpad(X: torch.Tensor, shape) -> torch.Tensor:
    n = shape[-1]
    return X[:, :n, :n].reshape(shape)


def _diag_factor(Ablk: torch.Tensor, version: int, nested):
    """(Ljj, Ljj^-1) of the diagonal blocks: B4 (version 1) or B2/B3 plus the
    doubling inverse (version 2); a block wider than 128 goes to `nested`."""
    if Ablk.shape[-1] != BLOCK:
        return nested(Ablk)
    if version == 1:
        return block_chol_inv(Ablk)
    Ljj = block_chol(Ablk)
    return Ljj, tri_inv_doubling(Ljj)


def _assemble_inverse(L, dinvs, blk):
    """L^-1 from the diagonal blocks' inverses by pairwise doubling over
    adjacent ranges, [[A, 0], [B, C]]^-1 = [[Ai, 0], [-Ci B Ai, Ci]]; log2(nb)
    levels, an odd tail carried to the next level."""
    C = L.shape[0]
    items = [(d, blk, j * blk) for j, d in enumerate(dinvs)]
    while len(items) > 1:
        nxt = []
        for p in range(0, len(items) - 1, 2):
            Ai, sa, oa = items[p]
            Ci, sc, oc = items[p + 1]
            low = -(Ci @ (L[:, oc:oc + sc, oa:oa + sa] @ Ai))
            z = torch.zeros((C, sa, sc), dtype=L.dtype, device=L.device)
            nxt.append((torch.cat([torch.cat([Ai, z], -1), torch.cat([low, Ci], -1)], -2),
                        sa + sc, oa))
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0][0]


def batched_chol_inv_ll(K: torch.Tensor, block=None):
    """(L, L^-1) of PSD (..., n, n), left-looking: block column j takes its
    Schur correction as one batched product against the factored panels,
    its diagonal block goes to `block_chol`, its panel is a product with the
    block's inverse. Counterpart of pallas_batched_chol_inv_ll
    (pallas_chol.py:345-418); at n = 1000 that is 8 kernel launches."""
    blk = BLOCK if block is None else int(block)
    shape = K.shape
    K = _flatten_pad(K, blk)
    C, npad = K.shape[0], K.shape[-1]
    cols, dinvs = [], []
    for j in range(npad // blk):
        o = j * blk
        Acol = K[:, o:, o:o + blk]
        if j:
            Lrows = torch.cat([cb[:, o - k * blk:, :] for k, cb in enumerate(cols)], -1)
            Acol = Acol - Lrows @ _t(Lrows[:, :blk, :])
        Ljj, Dinv = _diag_factor(Acol[:, :blk, :], 2,
                                 lambda A: batched_chol_inv_ll(A, block=BLOCK))
        dinvs.append(Dinv)
        cols.append(torch.cat([Ljj, Acol[:, blk:, :] @ _t(Dinv)], 1))
    L = torch.cat([torch.cat([torch.zeros((C, j * blk, blk), dtype=K.dtype, device=K.device),
                              cb], 1) for j, cb in enumerate(cols)], -1)
    Li = _assemble_inverse(L, dinvs, blk)
    return _unpad(L, shape), _unpad(Li, shape)


def batched_chol_inv(K: torch.Tensor, version: int = 2, block=None):
    """(L, L^-1) of PSD (..., n, n), right-looking: each diagonal block is
    factored (and inverted) by B4 (version=1) or B2/B3 (version=2), the
    panel below it is a product with its inverse, and the trailing matrix
    takes a rank-`block` update. Counterpart of pallas_batched_chol_inv
    (pallas_chol.py:421-496)."""
    if version not in (1, 2):
        raise ValueError(f"version must be 1 or 2, got {version!r}")
    blk = BLOCK if block is None else int(block)
    shape = K.shape
    A = _flatten_pad(K, blk)
    C, npad = A.shape[0], A.shape[-1]
    cols, dinvs = [], []
    for j in range(npad // blk):
        Ljj, Dinv = _diag_factor(A[:, :blk, :blk], version,
                                 lambda X: batched_chol_inv(X, version=version, block=BLOCK))
        dinvs.append(Dinv)
        P = A[:, blk:, :blk] @ _t(Dinv)
        cols.append(torch.cat([torch.zeros((C, j * blk, blk), dtype=A.dtype, device=A.device),
                               Ljj, P], 1))
        A = A[:, blk:, blk:]
        if A.shape[-1]:
            A = A - P @ _t(P)
    L = torch.cat(cols, -1)
    Li = _assemble_inverse(L, dinvs, blk)
    return _unpad(L, shape), _unpad(Li, shape)


def _block_chol_inv_leaf(A: torch.Tensor):
    shape = A.shape
    L, Li = block_chol_inv(A.reshape(-1, shape[-2], shape[-1]))
    return L.reshape(shape), Li.reshape(shape)


def rec_block_chol_inv(A: torch.Tensor, leaf: int = BLOCK):
    """(L, L^-1) of (..., n, n) by `rec_chol_inv`'s 2x2 recursion with B4
    leaves. Counterpart of rec_pallas_chol_inv (pallas_chol.py:316-342); n
    must be 128 * 2^k (identity-padded by the caller), as there."""
    return rec_chol_inv(A, leaf, _block_chol_inv_leaf)
