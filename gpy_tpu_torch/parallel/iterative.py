"""Row-sharded Gram products and the iterative exact GP over a mesh.

Counterpart of gpy_tpu/parallel/__init__.py:322-435, the within-matrix
sharding of SURVEY.md section 5: each rank streams its row slab of the
Gram, K(X_rank, X) @ V, against the full (replicated) X and V, so no rank
holds more than O(block x N) of K, and the collectives move the (N, R)
vectors only, never K. With fused=True (kernels of fused_available) the
slab is kernel B5's rectangular form (ops/gram_matvec_fused.py), else the
blockwise kern.K(xb, X) @ V (kernel B1 for an RBF).

The reference differentiates through its sharded product. Collectives have
no autograd here, so the NLML's gradient surrogate is summed per rank over
the rank's rows and its gradient reduced with one packed all_reduce; the
CG solves, which carry no gradient, run on the gathered products.
"""
from __future__ import annotations

import math

import torch

from ..inference.iterative import IterativeGaussianInference, _slq_logdet, cg_batched
from ..ops.gram_matvec import gram_matvec
from ..ops.gram_matvec_fused import fused_available, kern_gram_matvec_fused
from .mesh import all_gather_rows, all_reduce_packed, check_device, shard_slice

__all__ = ["sharded_gram_matvec", "sharded_iterative_nlml_grad"]

LOG_2_PI = math.log(2 * math.pi)


def _slab(kern, X, V, i0, i1, block, fused, fused_accum):
    """K(X[i0:i1], X) @ V, the rank's rows of the product. B5 is told that
    row r of the slab is row i0 + r of X, so it sets r2 = 0 on the diagonal
    as on the square Gram and the slab equals the serial product's rows."""
    if fused and fused_available(kern):
        return kern_gram_matvec_fused(kern, X[i0:i1], V, X2=X, accum=fused_accum,
                                      diag_offset=i0)
    return gram_matvec(kern, X[i0:i1], V, block=block, X2=X)


def sharded_gram_matvec(mesh, kern, X, V, noise=None, block=2048, axis_name="data",
                        fused=False, fused_accum="f32x3"):
    """(K(X, X) + diag(noise)) @ V with the rows of K sharded over the mesh.

    X (N, D), V (N, R) or (N,) and noise (N,) are the full arrays, the same
    on every rank and on its device; N must divide by the number of shards
    (pad_rows_to_multiple). Each rank computes its rows, K(X_rank, X) @ V +
    noise_rank V_rank, and an all_gather assembles them: every rank returns
    the full product, what the reference's row-sharded output denotes. The
    result carries no graph (collectives have no autograd).
    """
    _, i0, i1 = shard_slice(mesh, X.shape[0], axis_name)
    check_device(mesh, X)
    V2 = V if V.ndim == 2 else V[:, None]
    with torch.no_grad():
        out = _slab(kern, X, V2, i0, i1, block, fused, fused_accum)
        if noise is not None:
            out = out + noise[i0:i1, None] * V2[i0:i1]
        out = all_gather_rows(mesh, out, axis_name)
    return out if V.ndim == 2 else out[:, 0]


class ShardedIterativeNLML:
    """flat -> (objective, gradient) of an exact GP's iterative NLML with the
    Gram rows sharded over the mesh (sharded_iterative_nlml_grad).

    The probes are `inference._rademacher(N, dtype, device)` of an
    IterativeGaussianInference seeded with `seed`, the draw the serial model
    makes: a caller hands in other probes by replacing that method, as the
    serial inference allows (inference/iterative.py)."""

    def __init__(self, mesh, model, max_cg, n_probes, block, seed, axis_name, fused,
                 fused_accum):
        if getattr(model, "mean_function", None) is not None:
            raise NotImplementedError("the sharded NLML has no mean-function term, as in the "
                                      "reference")
        check_device(mesh, model.X)
        self.mesh, self.model, self.axis_name = mesh, model, axis_name
        self.block, self.fused, self.fused_accum = block, fused, fused_accum
        self.inference = IterativeGaussianInference(max_cg=max_cg, n_probes=n_probes,
                                                    block=block, seed=seed)

    def __call__(self, flat):
        m, mesh, ax = self.model, self.mesh, self.axis_name
        inf = self.inference
        X, Y = m.X, m.Y_normalized
        N, D = Y.shape
        k, i0, i1 = shard_slice(mesh, N, ax)
        leaf = torch.as_tensor(flat).to(device=X.device, dtype=X.dtype).detach().clone()
        leaf.requires_grad_(True)
        with m.bind_flat_raw(leaf):
            kern = m.kern
            noise = m.likelihood.noise_diagonal(N, m.Y_metadata) + 1e-6
            Z = inf._rademacher(N, X.dtype, X.device)
            with torch.no_grad():
                def mv(V):
                    return sharded_gram_matvec(mesh, kern, X, V, noise=noise, block=self.block,
                                               axis_name=ax, fused=self.fused,
                                               fused_accum=self.fused_accum)

                sol, alphas, betas, _ = cg_batched(mv, torch.cat([Y, Z], dim=1),
                                                   maxiter=inf.max_cg)
                alpha, Wp = sol[:, :D], sol[:, D:]
                logdet = _slq_logdet(alphas[:, D:], betas[:, D:], torch.sum(Z * Z, dim=0), N,
                                     inf.n_probes)
                value = -0.5 * (torch.sum(Y * alpha) + D * logdet + D * N * LOG_2_PI)
            # this rank's rows of the gradient surrogate 0.5 a'Ka - 0.5 D/P
            # sum_i z_i'K w_i (differentiable, blockwise: the fused kernel
            # has no backward for a slab), plus 1/k of the log prior
            U = torch.cat([alpha, Wp], dim=1)
            KU = gram_matvec(kern, X[i0:i1], U, block=self.block, X2=X) \
                + noise[i0:i1, None] * U[i0:i1]
            sur = (0.5 * torch.sum(alpha[i0:i1] * KU[:, :D])
                   - 0.5 * (D / inf.n_probes) * torch.sum(Z[i0:i1] * KU[:, D:]))
            lp = m.log_prior()
            local = -(sur + lp / k)
        g, = torch.autograd.grad(local, leaf)
        g, = all_reduce_packed(mesh, [g], ax)
        return -(value + lp.detach()), g


def sharded_iterative_nlml_grad(mesh, model, max_cg=48, n_probes=8, block=2048, seed=0,
                                axis_name="data", fused=False, fused_accum="f32x3"):
    """NLML and gradient of an exact GP with the Gram rows sharded over the
    mesh: matrix-free exact inference over several cards (the iterative
    recipe of inference/iterative.py with sharded_gram_matvec as the
    engine). Returns a callable of the model's flat raw vector giving
    (objective, flat gradient); N must divide by the number of shards.
    fused=True takes B5 for the CG products only: the gradient surrogate
    stays blockwise and differentiable (the reference's :403-405), so B6
    is not on this path. Each evaluation makes max_cg all_gathers of the
    (N, 1 + n_probes) products and one all_reduce of the gradient.
    """
    return ShardedIterativeNLML(mesh, model, max_cg, n_probes, block, seed, axis_name, fused,
                                fused_accum)
