"""The data-parallel SVGP: its ELBO and gradient, whitening, the train step.

Counterpart of gpy_tpu/parallel/__init__.py:144-319. torch.distributed's
collectives are not differentiable, so each rank differentiates its own
term: the weighted data fit of its rows plus 1/k of the replicated terms
(log prior - KL), k the number of shards, as the reference's train step
does (:252-277). The sum over the ranks of these values and gradients is
the ELBO and its gradient; one packed all_reduce of (flat gradient, value)
carries both, |raw| + 1 numbers (one all_reduce a mesh axis).
"""
from __future__ import annotations

import torch

from ..core.optim import optax_rule
from ..inference.svgp import (CONST_JITTER, kl_qu_pu, kl_qu_pu_white, q_f_marginals,
                              q_f_marginals_white)
from ..util.choleskies import flat_to_triang, triang_to_flat
from ..util.linalg import chol_and_inv
from .mesh import (all_reduce_packed, check_device, num_shards, on_model, shard_rows,
                   shard_slice)

__all__ = ["data_parallel_elbo_and_grad", "svgp_whiten_raw", "svgp_unwhiten_raw",
           "sharded_svgp_train_step"]


def _no_mean_function(model):
    if getattr(model, "mean_function", None) is not None:
        raise NotImplementedError("the sharded SVGP ELBO has no mean-function term, as in "
                                  "the reference; subtract the mean from Y")


def _local_elbo(model, Xs, Ys, ws, k, whiten):
    """This rank's term: sum_n w_n E_q[log p(y_n|f_n)] over its rows plus
    (log prior - KL) / k, at the model's (bound) parameters."""
    Z = model.Z.values
    q_m = model.q_u_mean.values
    L_u = flat_to_triang(model.q_u_chol.values, Z.shape[0])
    if whiten:
        mu, var, _, _ = q_f_marginals_white(model.kern, Xs, Z, q_m, L_u)
        kl = kl_qu_pu_white(q_m, L_u)
    else:
        mu, var, Lmm, _ = q_f_marginals(model.kern, Xs, Z, q_m, L_u)
        kl = kl_qu_pu(q_m, L_u, Lmm)
    F = model.likelihood.variational_expectations(Ys, mu, var, model.Y_metadata)
    return torch.sum(ws[:, None] * F) + (model.log_prior() - kl) / k


def _value_and_grads(model, raw, Xs, Ys, ws, k, whiten):
    """(this rank's term, its gradient for each entry of `raw`)."""
    leaves = {n: v.detach().clone().requires_grad_(True) for n, v in raw.items()}
    with model.bind_raw_dict(leaves):
        val = _local_elbo(model, Xs, Ys, ws, k, whiten)
    grads = torch.autograd.grad(val, list(leaves.values()), allow_unused=True)
    return val.detach(), [torch.zeros_like(v) if g is None else g
                          for v, g in zip(leaves.values(), grads)]


def data_parallel_elbo_and_grad(model, mesh, X, Y, weights=None, axis_name="data"):
    """SVGP ELBO and its gradient with the data term summed over the mesh.

    model: an SVGP. X, Y: the full (padded) arrays, rows divisible by the
    number of shards; weights: a 0/1 mask of real rows. Returns (elbo,
    {raw name: gradient}) over the model's free raw parameters; every rank
    returns the same. One packed all_reduce a mesh axis.
    """
    _no_mean_function(model)
    check_device(mesh, model.Z.values)
    k, _, _ = shard_slice(mesh, X.shape[0], axis_name)
    if weights is None:
        weights = torch.ones(X.shape[0], dtype=torch.float64)
    Xs, Ys, ws = on_model(model, *(shard_rows(mesh, a, axis_name) for a in (X, Y, weights)))
    raw = model.get_raw_dict(free_only=True)
    val, grads = _value_and_grads(model, raw, Xs, Ys, ws, k, whiten=False)
    *grads, val = all_reduce_packed(mesh, grads + [val.reshape(1)], axis_name)
    return val[0], dict(zip(raw, grads))


def svgp_whiten_raw(model, raw=None) -> dict:
    """The raw dict with (q_u_mean, q_u_chol) in whitened coordinates at its
    own hyperparameters: v = Lmm^-1 m, L_w = Lmm^-1 L. For
    sharded_svgp_train_step(whiten=True)."""
    raw = dict(model.get_raw_dict(free_only=True) if raw is None else raw)
    with torch.no_grad(), model.bind_raw_dict(raw):
        Z = model.Z.values
        M = Z.shape[0]
        _, Lmi = chol_and_inv(model.kern.K(Z) + CONST_JITTER * torch.eye(M, dtype=Z.dtype,
                                                                         device=Z.device))
        L_u = flat_to_triang(model.q_u_chol.values, M)
        raw["q_u_mean"] = Lmi @ model.q_u_mean.values
        raw["q_u_chol"] = triang_to_flat(torch.einsum("ij,djk->dik", Lmi, L_u))
    return raw


def svgp_unwhiten_raw(model, raw) -> dict:
    """Inverse of svgp_whiten_raw at the raw dict's (possibly updated)
    hyperparameters: m = Lmm v, L = Lmm L_w."""
    raw = dict(raw)
    with torch.no_grad(), model.bind_raw_dict(raw):
        Z = model.Z.values
        M = Z.shape[0]
        Lmm = torch.linalg.cholesky(model.kern.K(Z) + CONST_JITTER * torch.eye(
            M, dtype=Z.dtype, device=Z.device))
        L_w = flat_to_triang(model.q_u_chol.values, M)
        raw["q_u_mean"] = Lmm @ model.q_u_mean.values
        raw["q_u_chol"] = triang_to_flat(torch.einsum("ij,djk->dik", Lmm, L_w))
    return raw


def sharded_svgp_train_step(model, mesh, step_size: float = 1e-2, axis_name="data",
                            whiten: bool = False):
    """A data-sharded SVGP training step: Adam (optax.adam's rule,
    core/optim.py) ascending the ELBO over every free raw parameter.
    Returns (step_fn, (raw0, state0), shard_fn).

    step_fn(raw, state, Xs, Ys, ws) -> (raw, state, elbo) with Xs, Ys, ws
    this rank's rows (shard_fn(full array)); raw and state are replicated
    (each rank computes the same update from the same reduced gradient).
    The step makes exactly one collective a mesh axis: the packed
    all_reduce of (flat gradient, value), |raw| + 1 numbers. The ELBO
    returned is the one at the step's start, a tensor left on the device.

    whiten=True reads (q_u_mean, q_u_chol) as the whitened (v, chol S_w):
    raw0 comes back whitened (svgp_whiten_raw); convert trained values
    back with svgp_unwhiten_raw. Plain Adam on the unwhitened factor stalls
    when Kmm is ill-conditioned; the reference recommends whitening for
    training over many cards.
    """
    _no_mean_function(model)
    adam = optax_rule("adam", step_size)
    check_device(mesh, model.Z.values)
    k = num_shards(mesh, axis_name)

    def step_fn(raw, state, Xs, Ys, ws):
        Xs, Ys, ws = on_model(model, Xs, Ys, ws)
        val, grads = _value_and_grads(model, raw, Xs, Ys, ws, k, whiten)
        *grads, val = all_reduce_packed(mesh, grads + [val.reshape(1)], axis_name)
        new_raw, new_state = {}, {}
        for (n, x), g in zip(raw.items(), grads):
            u, new_state[n] = adam.update(-g, state[n])
            new_raw[n] = x + u
        return new_raw, new_state, val[0]

    raw0 = {n: v.clone() for n, v in model.get_raw_dict(free_only=True).items()}
    if whiten:
        raw0 = svgp_whiten_raw(model, raw0)
    state0 = {n: adam.init(v) for n, v in raw0.items()}

    def shard_fn(x):
        return shard_rows(mesh, x, axis_name)

    return step_fn, (raw0, state0), shard_fn
