"""Row-sharded collapsed bounds: VarDTC, the Bayesian GPLVM and LVMOGP.

Counterpart of gpy_tpu/parallel/__init__.py:438-722 (GPy's
var_dtc_parallel.py: gatherPsiStat :72-133, the Allreduce of the row
statistics, and update_gradients :337-424, the Allreduce of the gradient).
Each bound is a sum of row statistics followed by replicated M x M algebra.
The reference psums the statistics inside a differentiated program; here
collectives have no autograd, so each evaluation runs GPy's own two phases:

  1. each rank's row statistics, one packed all_reduce of them (detached);
  2. the replicated algebra on a leaf copy of the sums, giving F and
     dF/dstats (and F's direct gradient, through Kmm, q(U) or the prior,
     where the statistics do not carry it);
  3. on each rank, the backward of its own statistics with dF/dstats as
     their cotangent, plus 1/k of the direct gradient;
  4. one packed all_reduce of the parameter gradient.

Two collectives an evaluation (one a mesh axis each), both packed. Rows that
pad N to a multiple of the shards carry weight 0.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from ..inference.svi_multiout import (_common, _elbo_from_stats, _full_row_stats,
                                      _md_elbo_from_stats, _md_row_stats, _onehot)
from ..kern.psi_comp import psi2_weighted
from ..util.linalg import dtrtrs, jitchol, jitchol_and_inv
from .mesh import (all_reduce_packed, check_device, num_shards, on_model,
                   pad_rows_to_multiple, shard_rows, shard_slice)

__all__ = ["sharded_vardtc_elbo_and_grad", "sharded_bgplvm_elbo_and_grad",
           "sharded_svi_multiout_elbo_and_grad", "sharded_svi_multiout_md_elbo_and_grad"]

LOG_2_PI = math.log(2.0 * math.pi)
CONST_JITTER = 1e-6


def _two_phase(mesh, axis_name, k, model, replicated, local, local_fn, bound_fn):
    """(F, gradients of `replicated` + `local` leaves) by the two phases.

    replicated: {raw path: leaf} bound into the model; local: leaves of this
    rank's rows (q(X)) that local_fn reads itself. local_fn() -> (list of
    row statistics, context); bound_fn(summed statistics, context) -> F."""
    leaves = list(replicated.values()) + list(local)
    with model.bind_raw_dict(replicated):
        stats, ctx = local_fn()
        total = all_reduce_packed(mesh, stats, axis_name)
        total = [t.clone().requires_grad_(True) for t in total]
        F = bound_fn(total, ctx)
        grads = torch.autograd.grad(F, total + leaves, allow_unused=True, retain_graph=True)
    d_stats, direct = grads[:len(total)], grads[len(total):]
    pairs = [(s, d) for s, d in zip(stats, d_stats) if s.requires_grad and d is not None]
    from_rows = torch.autograd.grad([s for s, _ in pairs], leaves, [d for _, d in pairs],
                                    allow_unused=True)
    out = []
    for leaf, g_rows, g_direct in zip(leaves, from_rows, direct):
        g = torch.zeros_like(leaf) if g_rows is None else g_rows
        out.append(g if g_direct is None else g + g_direct / k)
    return F.detach(), out


def _kmm_factor(kern, Z):
    """(L, L^-1) of Kmm + jitter, as the serial bound factors it."""
    eye = torch.eye(Z.shape[0], dtype=Z.dtype, device=Z.device)
    return jitchol_and_inv(kern.K(Z) + CONST_JITTER * eye)


def _collapsed_bound(AAT, Lpsi1WY, psi0_sum, YWY, logW, N, D):
    """The collapsed bound from its summed whitened statistics, AAT =
    L^-1 [sum_n W_n k_n k_n'] L^-T and L^-1 Kmn W Y: the algebra of
    inference/var_dtc.py `_collapsed`."""
    eye = torch.eye(AAT.shape[-1], dtype=AAT.dtype, device=AAT.device)
    LB = jitchol(eye + AAT)
    c = dtrtrs(LB, Lpsi1WY)
    return (-0.5 * N * D * LOG_2_PI + 0.5 * D * logW
            - D * torch.sum(torch.log(torch.diagonal(LB)))
            - 0.5 * YWY + 0.5 * torch.sum(c * c) - 0.5 * D * (psi0_sum - torch.trace(AAT)))


def _weighted_stats(W, ws, Y, Kdiag_or_psi0, first, second):
    """The six row statistics of the collapsed bound, W = ws / noise: the
    two M-sized ones given, then sum W psi0, sum W y'y, sum log W, N."""
    return [first, second, torch.sum(W * Kdiag_or_psi0), torch.sum(W[:, None] * Y * Y),
            torch.sum(ws * torch.log(torch.clamp_min(W, 1e-300))), torch.sum(ws)]


def sharded_vardtc_elbo_and_grad(model, mesh, X=None, Y=None, weights=None, axis_name="data"):
    """Collapsed VarDTC bound and its gradient with row-sharded statistics.

    model: a SparseGP with a Gaussian likelihood (SparseGPRegression). X, Y:
    full arrays with rows divisible by the number of shards (default: the
    model's own data, padded); weights: the 0/1 mask of real rows. Returns
    (log marginal + log prior, {raw name: gradient}) over the model's free
    raw parameters, the serial value on every rank.
    """
    if X is None:
        X, Y, weights = pad_rows_to_multiple(
            model.X.cpu().numpy(), model.Y_normalized.cpu().numpy(),
            num_shards(mesh, axis_name))
    check_device(mesh, model.Z.values)
    k, _, _ = shard_slice(mesh, X.shape[0], axis_name)
    if weights is None:
        weights = np.ones(X.shape[0])
    Xs, Ys, ws = on_model(model, *(shard_rows(mesh, a, axis_name) for a in (X, Y, weights)))
    D = Y.shape[1]
    raw = {n: v.detach().clone().requires_grad_(True)
           for n, v in model.get_raw_dict(free_only=True).items()}

    def local_fn():
        # the rows' statistics whitened by the (replicated) factor of Kmm,
        # A = L^-1 Kmn sqrt(W) squared per rank, as the serial bound forms
        # them: the N-summed Gram sandwiched between L^-1's loses gradient
        # precision when Kmm is ill-conditioned
        Z = model.Z.values
        var = model.likelihood.variance.values
        W = ws / var
        L, Li = _kmm_factor(model.kern, Z)
        Kmn = model.kern.K(Z, Xs)
        A = Li @ (Kmn * (torch.sqrt(ws) / torch.sqrt(var))[None, :])  # sqrt(W), finite at 0
        stats = _weighted_stats(W, ws, Ys, model.kern.Kdiag(Xs), A @ A.T,
                                dtrtrs(L, Kmn @ (W[:, None] * Ys)))
        return stats, None

    def bound_fn(s, _):
        return _collapsed_bound(*s, D) + model.log_prior()

    F, grads = _two_phase(mesh, axis_name, k, model, raw, [], local_fn, bound_fn)
    grads = all_reduce_packed(mesh, grads, axis_name)
    return F, dict(zip(raw, grads))


def sharded_bgplvm_elbo_and_grad(model, mesh, axis_name="data"):
    """Bayesian-GPLVM ELBO and its gradient with q(X)'s rows sharded over
    the mesh (GPy's BayesianGPLVM(mpi_comm=...)).

    The q(X) means and variances are row-indexed parameters: each rank
    holds its rows and computes their gradient; the kernel, Z and noise
    are replicated. Returns (elbo, {raw name: gradient}) over the model's
    free raw parameters, the qX.* entries full (N, Q) arrays (the packed
    gradient all_reduce carries each rank's rows in place).
    """
    check_device(mesh, model.Z.values)
    raw = model.get_raw_dict(free_only=True)
    sharded = [n for n in raw if n.startswith("qX.")]
    N = raw["qX.mean"].shape[0]
    k = num_shards(mesh, axis_name)
    n_pad = (-N) % k
    Y = model.Y_normalized
    D = Y.shape[1]
    w = torch.ones(N + n_pad, dtype=Y.dtype, device=Y.device)
    w[N:] = 0.0
    Yp = torch.cat([Y, Y.new_zeros((n_pad, D))], 0)
    _, i0, i1 = shard_slice(mesh, N + n_pad, axis_name)
    pad = {n: torch.cat([raw[n], raw[n].new_zeros((n_pad,) + raw[n].shape[1:])], 0)
           for n in sharded}
    local = [pad[n][i0:i1].clone().requires_grad_(True) for n in sharded]
    q_local = dict(zip(sharded, local))
    replicated = {n: v.detach().clone().requires_grad_(True)
                  for n, v in raw.items() if n not in sharded}
    Ys, ws = Yp[i0:i1], w[i0:i1]
    var_tr = model.qX._specs["variance"].transform

    def local_fn():
        Z = model.Z.values
        mu = q_local["qX.mean"]
        S = var_tr.forward(q_local["qX.variance"])
        qX = SimpleNamespace(mean=mu, variance=S)
        W = ws / model.likelihood.variance.values
        psi1 = model.kern.psi1(Z, qX)
        stats = _weighted_stats(W, ws, Ys, model.kern.psi0(Z, qX),
                                psi2_weighted(model.kern, Z, qX, W), psi1.T @ (W[:, None] * Ys))
        kl = 0.5 * torch.sum(ws[:, None] * (mu**2 + S - torch.log(S) - 1.0))
        return stats + [kl], None

    def bound_fn(s, _):
        _, Li = _kmm_factor(model.kern, model.Z.values)
        AAT = Li @ s[0] @ Li.T
        return (_collapsed_bound(0.5 * (AAT + AAT.T), Li @ s[1], *s[2:6], D) - s[6]
                + model.log_prior())

    F, grads = _two_phase(mesh, axis_name, k, model, replicated, local, local_fn, bound_fn)
    n_rep = len(replicated)
    full = []
    for g in grads[n_rep:]:
        z = g.new_zeros((N + n_pad,) + g.shape[1:])
        z[i0:i1] = g
        full.append(z)
    grads = all_reduce_packed(mesh, grads[:n_rep] + full, axis_name)
    out = dict(zip(replicated, grads[:n_rep]))
    out.update({n: g[:N] for n, g in zip(sharded, grads[n_rep:])})
    return F, {n: out[n] for n in raw}


def _real_rows(mesh, axis_name, N):
    """This rank's rows [i0, i1) of N padded to a multiple of the shards,
    the padding dropped (a weight-0 row adds nothing to a row sum)."""
    k = num_shards(mesh, axis_name)
    k, i0, i1 = shard_slice(mesh, N + (-N) % k, axis_name)
    return k, min(i0, N), min(i1, N)


def _multiout_leaves(model):
    return {n: v.detach().clone().requires_grad_(True)
            for n, v in model.get_raw_dict(free_only=True).items()}


def _multiout_common(model):
    Sr, Sc = model._qU_cov()
    Zr, Zc = model.Z_row.values, model.Z.values
    cm = _common(model.kern_row, model.kern, model.X_row, Zr, Zc, model.qU_mean.values, Sr, Sc)
    return cm, Zc, Zr.shape[0]


def sharded_svi_multiout_elbo_and_grad(model, mesh, axis_name="data"):
    """LVMOGP (GPMultioutRegression) ELBO and its gradient with the (X, Y)
    rows sharded over the mesh: the row statistics of
    inference/svi_multiout.py `_full_row_stats` summed, then the serial
    bound's own combine (`_elbo_from_stats`) replicated. Returns (elbo,
    {raw name: gradient}), the serial objective's value."""
    check_device(mesh, model.Z.values)
    k, i0, i1 = _real_rows(mesh, axis_name, model.X.shape[0])
    Xs, Ys = model.X[i0:i1], model.Y[i0:i1]
    D = model.Y.shape[1]
    raw = _multiout_leaves(model)

    def local_fn():
        cm, Zc, Mr = _multiout_common(model)
        n, *stats = _full_row_stats(cm, model.kern, Xs, Zc, Ys)
        return [Ys.new_tensor(float(n))] + stats, (cm, Zc, Mr)

    def bound_fn(s, ctx):
        cm, Zc, Mr = ctx
        s2 = model.likelihood.gaussian_variance(None)
        return (_elbo_from_stats(cm, Zc.shape[0], Mr, D, 1.0 / s2, *s) - model.X_row.KL()
                + model.log_prior())

    F, grads = _two_phase(mesh, axis_name, k, model, raw, [], local_fn, bound_fn)
    grads = all_reduce_packed(mesh, grads, axis_name)
    return F, dict(zip(raw, grads))


def sharded_svi_multiout_md_elbo_and_grad(model, mesh, axis_name="data"):
    """The missing-data LVMOGP bound (GPMultioutRegressionMD, a noise per
    output included) with the stacked (X, Y, indexD) rows sharded over the
    mesh: the per-output statistics of `_md_row_stats` summed, then
    `_md_elbo_from_stats` replicated. Returns (elbo, {raw name: gradient})."""
    check_device(mesh, model.Z.values)
    k, i0, i1 = _real_rows(mesh, axis_name, model.X.shape[0])
    D = int(model.output_dim)
    Xs, Ys = model.X[i0:i1], model.Y.reshape(-1, 1)[i0:i1]
    Woh = _onehot(model.indexD.reshape(-1)[i0:i1], D, Ys)
    raw = _multiout_leaves(model)

    def local_fn():
        cm, Zc, Mr = _multiout_common(model)
        return list(_md_row_stats(cm, model.kern, Xs, Zc, Ys, Woh)), (cm, Zc, Mr)

    def bound_fn(s, ctx):
        cm, Zc, Mr = ctx
        s2 = model.likelihood.gaussian_variance(None)
        beta = torch.broadcast_to((1.0 / s2).reshape(-1), (D,))
        return (_md_elbo_from_stats(cm, Zc.shape[0], Mr, beta, *s) - model.X_row.KL()
                + model.log_prior())

    F, grads = _two_phase(mesh, axis_name, k, model, raw, [], local_fn, bound_fn)
    grads = all_reduce_packed(mesh, grads, axis_name)
    return F, dict(zip(raw, grads))
