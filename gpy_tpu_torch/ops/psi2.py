"""Streamed psi2 contraction: sum_n W_n psi2_n(Z, q(X)) without the (N, M, M)
tensor.

Counterpart of gpy_tpu/ops/pallas_psi.py:39-66 (`rbf_psi2_weighted`), which
replaces GPy's CUDA psi-statistics reductions (rbf_psi_gpucomp.py:9-431)
and keeps SURVEY.md section 7(d)'s rule: the (N, M, M) psi2 tensor is never
held. Despite the reference file's name it holds no Pallas kernel: it is a
checkpointed lax.scan over blocks of rows. Here it is a loop over blocks of
`block` rows in torch ops, each under torch.utils.checkpoint, so autograd
keeps only each block's inputs and recomputes the block in the backward
pass: O(block M^2 Q) working memory instead of O(N M^2). The rows are padded
to a multiple of `block` as in the reference (:50-54): the mean with zeros,
the variance with ones (a finite log), the weights with zeros (no
contribution).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..kern.psi_comp import ss_rbf_psi2n

__all__ = ["rbf_psi2_weighted", "ss_rbf_psi2_weighted", "rows_checkpointed", "BLOCK"]

BLOCK = 256


def _block_psi2(v, l2, mu_b, S_b, w_b, Z):
    """sum over the block of w_n psi2_n for the RBF kernel, (M, M)."""
    denom = 2.0 * S_b + l2
    Zbar = 0.5 * (Z[:, None, :] + Z[None, :, :])
    dZ2 = (Z[:, None, :] - Z[None, :, :]) ** 2 / l2
    diff2 = (mu_b[:, None, None, :] - Zbar[None]) ** 2 / denom[:, None, None, :]
    lognorm = 0.5 * torch.sum(torch.log(l2)[None, :] - torch.log(denom), dim=-1)
    expo = lognorm[:, None, None] - 0.25 * torch.sum(dZ2, dim=-1)[None] - torch.sum(diff2, dim=-1)
    return v**2 * torch.einsum("n,nmk->mk", w_b, torch.exp(expo))


def _block_ss_psi2(v, l2, mu_b, S_b, g_b, w_b, Z):
    """sum over the block of w_n psi2_n for the spike-and-slab RBF, (M, M)."""
    return torch.einsum("n,nmk->mk", w_b, ss_rbf_psi2n(v, l2, Z, mu_b, S_b, g_b))


def _pad(t, n_pad, value):
    if not n_pad:
        return t
    return torch.cat([t, torch.full((n_pad,) + tuple(t.shape[1:]), value, dtype=t.dtype,
                                    device=t.device)], 0)


def _streamed(block_fn, v, l2, Z, rows, weights, block):
    """sum over blocks of block_fn(v, l2, *row blocks, weight block, Z), each
    block checkpointed. rows: (tensor, pad value) pairs of N rows each."""
    N = weights.shape[0]
    n_pad = (-N) % block
    rows = [_pad(t, n_pad, val) for t, val in rows]
    weights = _pad(weights, n_pad, 0.0)
    out = None
    for s in range(0, N + n_pad, block):
        part = checkpoint(block_fn, v, l2, *(t[s:s + block] for t in rows),
                          weights[s:s + block], Z, use_reentrant=False)
        out = part if out is None else out + part
    return out


def rows_checkpointed(fn, rows, block: int = BLOCK):
    """fn over blocks of `block` rows of the tensors `rows`, each block
    under torch.utils.checkpoint, the results concatenated along the rows:
    a row-wise function whose intermediates are larger than its result
    (psi1's (N, M, Q) chain) keeps only each block's inputs for the
    backward pass."""
    N = rows[0].shape[0]
    return torch.cat([checkpoint(fn, *(t[s:s + block] for t in rows), use_reentrant=False)
                      for s in range(0, N, block)], 0)


def rbf_psi2_weighted(variance, lengthscale, Z, mu, S, weights, block: int = BLOCK):
    """sum_n weights_n <K(x_n, Z) K(x_n, Z)'>_{q(x_n)} for the RBF kernel,
    (M, M), streamed over blocks of `block` rows."""
    l2 = (lengthscale**2).expand(mu.shape[1])
    return _streamed(_block_psi2, variance, l2, Z, [(mu, 0.0), (S, 1.0)], weights, block)


def ss_rbf_psi2_weighted(variance, lengthscale, Z, mu, S, gamma, weights, block: int = BLOCK):
    """The same sum for a spike-and-slab q(X) (inclusion probabilities
    gamma): the spike-and-slab RBF psi2, streamed the same way."""
    l2 = (lengthscale**2).expand(mu.shape[1])
    return _streamed(_block_ss_psi2, variance, l2, Z, [(mu, 0.0), (S, 1.0), (gamma, 0.0)],
                     weights, block)
