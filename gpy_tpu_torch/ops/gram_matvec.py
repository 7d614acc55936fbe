"""Matrix-free Gram matvec: (K(X, X) + diag(noise)) @ V in row blocks.

Counterpart of gpy_tpu/ops/gram_matvec.py. Each step builds one (block, N)
tile of K with the kernel's own K (on the card an RBF tile is kernel B1),
multiplies it into V and drops it: O(block * N) transient memory instead of
O(N^2). Under autograd each block runs in torch.utils.checkpoint, the
counterpart of the reference's jax.checkpoint, so the backward also holds
one tile at a time instead of every tile of the Gram.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["gram_matvec", "make_gram_matvec", "gram_materialize", "torch_dtype"]


def _pad_rows(X, block):
    n = X.shape[0]
    n_pad = (-n) % block
    if n_pad:
        X = torch.cat([X, torch.zeros((n_pad, X.shape[1]), dtype=X.dtype, device=X.device)], 0)
    return X, n + n_pad


def gram_matvec(kern, X, V, noise=None, block=2048, X2=None):
    """(K + diag(noise)) @ V for any kernel with a .K(X, X2) method.

    V: (N, R) or (N,). The last row block is ragged rather than padded: rows
    are independent, so the result is the reference's. With X2 (M, D) given
    it is the rectangular slab K(X, X2) @ V, V of M rows (a rank's rows of
    the sharded product, parallel/iterative.py), and `noise` is refused.
    """
    if X2 is not None and noise is not None:
        raise ValueError("noise diagonal undefined for rectangular slabs")
    N = X.shape[0]
    X2 = X if X2 is None else X2
    V2 = V if V.ndim == 2 else V[:, None]

    def one_block(xb):
        return kern.K(xb, X2) @ V2

    remat = torch.is_grad_enabled()
    outs = []
    for i in range(0, N, block):
        xb = X[i:i + block]
        outs.append(checkpoint(one_block, xb, use_reentrant=False) if remat else one_block(xb))
    out = torch.cat(outs, 0)
    if noise is not None:
        out = out + noise[:, None] * V2
    return out if V.ndim == 2 else out[:, 0]


def make_gram_matvec(kern, X, noise, block=2048):
    """Closure form used by the CG loop."""

    def mv(V):
        return gram_matvec(kern, X, V, noise=noise, block=block)

    return mv


def gram_materialize(kern, X, noise=None, block=2048, out_dtype=None, symmetric=False):
    """Materialize K(X, X) + diag(noise) in row blocks -> (P, P), P.

    P = ceil(N / block) * block; padded rows and columns are zero, so a
    zero-padded right-hand side is safe. The blocks are written into one
    preallocated (P, P) tensor (stacking them would double the peak: 10 GB
    at N = 50k in float32), cast to `out_dtype` (a torch dtype or its name)
    as each block is written. Call it under torch.no_grad(): the result is
    a stop-gradient Gram.

    symmetric=True computes only the lower-triangle (block, block) tiles and
    writes each twice (tile and transpose), as the reference does; its
    result equals the row-strip build's.
    """
    N = X.shape[0]
    Xp, n_tot = _pad_rows(X, block)
    blocks = n_tot // block
    dt = torch_dtype(out_dtype) or X.dtype
    row_ok = (torch.arange(n_tot, device=X.device) < N).to(X.dtype)
    noise_p = torch.zeros(n_tot, dtype=X.dtype, device=X.device)
    if noise is not None:
        noise_p[:N] = noise
    K = torch.empty((n_tot, n_tot), dtype=dt, device=X.device)

    if symmetric and blocks > 1:
        ii, jj = np.tril_indices(blocks)
        for bi, bj in zip(ii.tolist(), jj.tolist()):
            oi, oj = bi * block, bj * block
            Kb = kern.K(Xp[oi:oi + block], Xp[oj:oj + block])
            Kb = Kb * row_ok[oi:oi + block, None] * row_ok[None, oj:oj + block]
            if oi == oj:
                Kb.diagonal().add_(noise_p[oi:oi + block])
            Kb = Kb.to(dt)
            K[oi:oi + block, oj:oj + block] = Kb
            K[oj:oj + block, oi:oi + block] = Kb.T
        return K, n_tot

    for b in range(blocks):
        off = b * block
        Kb = kern.K(Xp[off:off + block], Xp)  # (block, P)
        Kb = Kb * row_ok[off:off + block, None] * row_ok[None, :]
        # the diagonal noise lands on the block's own columns
        Kb.diagonal(offset=off).add_(noise_p[off:off + block])
        K[off:off + block] = Kb
    return K, n_tot


def torch_dtype(d):
    """A torch dtype from a dtype or its name ("bfloat16"); None stays None."""
    if d is None or isinstance(d, torch.dtype):
        return d
    return getattr(torch, str(d))
