"""psi statistics: kernel expectations under q(X) = prod_n N(mu_n, diag(S_n)).

Counterpart of gpy_tpu/kern/psi_comp.py:27-378 (GPy/kern/src/psi_comp/:
rbf_psi_comp.py, linear_psi_comp.py, sslinear_psi_comp.py,
ssrbf_psi_comp.py, gaussherm.py).

    psi0_n    = <k(x_n, x_n)>
    psi1_nm   = <k(x_n, Z_m)>
    psi2_nmm' = <k(x_n, Z_m) k(x_n, Z_m')>

The closed forms are broadcast arithmetic and products; autograd supplies
every gradient that GPy's hand-written backward passes compute. A q(X) is
read through `moments`: the mean, variance and (spike-and-slab) gamma as
tensors, from a NormalPosterior or SpikeAndSlabPosterior module or any
object with those attributes. The collapsed bounds consume sum_n W_n psi2_n;
at N >= 512 an RBF kernel streams it (ops/psi2.py) instead of holding the
(N, M, M) tensor, and above 2^22 (N, M, Q) elements its psi1 runs in
checkpointed row blocks.

The Gauss-Hermite fallback evaluates every node's rows in one Gram call,
K(x_p, Z) for all P nodes stacked as (P N, Q): the reference loops over the
P nodes, one Gram each.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..core.module import Param

__all__ = ["PSICOMP_RBF", "PSICOMP_SSRBF", "PSICOMP_Linear", "PSICOMP_SSLinear", "moments",
           "psi0_quadrature", "psi1_quadrature", "psi2n_quadrature", "slice_psi_inputs",
           "cross_psi2n_quadrature", "cross_psi2n_exact", "psi2_weighted", "rbf_psi1",
           "ClosedFormPsi",
           "STREAM_MIN_N", "PSI1_BLOCK_ELEMS"]

# from this many rows an RBF kernel's sum_n W_n psi2_n streams over row
# blocks (gpy_tpu/inference/var_dtc.py:55)
STREAM_MIN_N = 512
# RBF's psi1 forms its (rows, M, Q) intermediates at most this many
# elements at a time: above it, in checkpointed row blocks. At once, its
# closed form holds several (N, M, Q) tensors for the backward pass (256 MB
# each at N=50,000, M=128, Q=10 in float32)
PSI1_BLOCK_ELEMS = 1 << 22


def _t(a):
    return a.values if isinstance(a, Param) else a


def moments(qX):
    """q(X) as tensors: a namespace with mean, variance and, for a
    spike-and-slab posterior, gamma."""
    q = SimpleNamespace(mean=_t(qX.mean), variance=_t(qX.variance))
    if hasattr(qX, "gamma"):
        q.gamma = _t(qX.gamma)
    return q


def row_slice(qX, s, e):
    """Rows s:e of q(X), as `moments` gives it (gamma kept)."""
    q = moments(qX)
    out = SimpleNamespace(mean=q.mean[s:e], variance=q.variance[s:e])
    if hasattr(q, "gamma"):
        out.gamma = q.gamma[s:e]
    return out


def slice_psi_inputs(kern, Z, qX):
    """(Z, q(X)) restricted to kern.active_dims, as GPy's slicing metaclass
    does (kernel_slice_operations.py:19-57): the closed forms index their
    dimensions by position."""
    q = moments(qX)
    if Z.shape[-1] == kern.input_dim and np.array_equal(kern.active_dims,
                                                        np.arange(kern.input_dim)):
        return Z, q
    out = SimpleNamespace(mean=kern._slice(q.mean), variance=kern._slice(q.variance))
    if hasattr(q, "gamma"):
        out.gamma = kern._slice(q.gamma)
    return kern._slice(Z), out


# ---------------------------------------------------------------------------
# exact Add-kernel cross terms <k_i(x, Z_m) k_j(x, Z_m')> (psi_comp.py:59-176)
# ---------------------------------------------------------------------------

def _scatter_full(p, vals, Q, like):
    """A per-dimension vector of kernel p (broadcast to its input_dim)
    scattered onto the full Q dims, 0 on the others."""
    out = torch.zeros(Q, dtype=like.dtype, device=like.device)
    idx = torch.as_tensor(p.active_dims, dtype=torch.long, device=like.device)
    return out.index_put((idx,), vals.expand(p.input_dim))


def _rbf_beta_full(p, Q, like):
    return _scatter_full(p, 1.0 / p.lengthscale.values**2, Q, like)


def _lin_var_full(p, Q, like):
    return _scatter_full(p, p.variances.values, Q, like)


def _cross_rbf_rbf(p1, p2, Z, q):
    """Two RBFs on any active_dims. Per dimension the product of the two
    exponentials is a pair factor exp(-b1 b2 / (2g) (z - z')^2), g = b1 + b2,
    centred at c = (b1 z + b2 z') / g, whose integral against N(mu, S) is
    (1 + g S)^(-1/2) exp(-g / (2 (1 + g S)) (mu - c)^2); b = 0 on inactive
    dimensions reduces it to the single kernel's factor or 1."""
    mu, S = q.mean, q.variance
    Q = mu.shape[1]
    b1, b2 = _rbf_beta_full(p1, Q, mu), _rbf_beta_full(p2, Q, mu)
    g = b1 + b2
    gs = torch.where(g > 0, g, torch.ones_like(g))
    c = (b1 * Z[:, None, :] + b2 * Z[None, :, :]) / gs  # (M, M, Q)
    pairsum = -0.5 * torch.sum((b1 * b2 / gs) * (Z[:, None, :] - Z[None, :, :]) ** 2, dim=-1)
    w = g[None, :] / (1.0 + g[None, :] * S)  # (N, Q)
    lognorm = -0.5 * torch.sum(torch.log1p(g[None, :] * S), dim=-1)
    t0 = -0.5 * torch.sum(w * mu * mu, dim=-1)
    t1 = torch.einsum("nq,mkq->nmk", w * mu, c)
    t2 = -0.5 * torch.einsum("nq,mkq->nmk", w, c * c)
    expo = (lognorm + t0)[:, None, None] + pairsum[None, :, :] + t1 + t2
    return p1.variance.values * p2.variance.values * torch.exp(expo)


def _cross_rbf_lin(pr, pl, Z, q, qX):
    """RBF x Linear: psi1 of the RBF times the tilted mean
    (mu + S b z_m) / (1 + S b) contracted with the linear form."""
    mu, S = q.mean, q.variance
    Q = mu.shape[1]
    b = _rbf_beta_full(pr, Q, mu)
    a = _lin_var_full(pl, Q, mu)
    psi1r = pr.psi1(Z, qX)
    denom = 1.0 + b[None, :] * S
    mt = (mu[:, None, :] + (b * Z)[None, :, :] * S[:, None, :]) / denom[:, None, :]
    return psi1r[:, :, None] * torch.einsum("nmq,kq->nmk", mt, a * Z)


def _cross_lin_lin(p1, p2, Z, q, qX):
    """Two Linear kernels: the outer product of their psi1 plus the
    per-dimension variance term sum_d a_d b_d S_nd Z_md Z_m'd."""
    S = q.variance
    Q = S.shape[1]
    a, b = _lin_var_full(p1, Q, S), _lin_var_full(p2, Q, S)
    covterm = torch.einsum("nq,mq,kq->nmk", S * a * b, Z, Z)
    return p1.psi1(Z, qX)[:, :, None] * p2.psi1(Z, qX)[:, None, :] + covterm


def cross_psi2n_exact(p1, p2, Z, qX):
    """Exact <k1(x, Z_m) k2(x, Z_m')> as (N, M, M), or None where there is no
    closed form: White with anything (zero), Bias with anything, any pair on
    disjoint active_dims (also spike-and-slab: q factorizes per dimension),
    and RBF x RBF, RBF x Linear, Linear x Linear on overlapping dims under a
    Gaussian q."""
    from .linear import Linear
    from .static import Bias, White
    from .stationary import RBF

    q = moments(qX)
    N, M = q.mean.shape[0], Z.shape[0]
    if isinstance(p1, White) or isinstance(p2, White):
        return torch.zeros((N, M, M), dtype=Z.dtype, device=Z.device)
    if isinstance(p1, Bias):
        return p1.variance.values * p2.psi1(Z, qX)[:, None, :].expand(N, M, M)
    if isinstance(p2, Bias):
        return p2.variance.values * p1.psi1(Z, qX)[:, :, None].expand(N, M, M)
    if np.intersect1d(p1._all_dims, p2._all_dims).size == 0:
        return p1.psi1(Z, qX)[:, :, None] * p2.psi1(Z, qX)[:, None, :]
    if hasattr(q, "gamma"):
        return None  # overlapping dims under spike-and-slab: no closed form
    lin1, lin2 = type(p1) is Linear, type(p2) is Linear
    if isinstance(p1, RBF) and isinstance(p2, RBF):
        return _cross_rbf_rbf(p1, p2, Z, q)
    if isinstance(p1, RBF) and lin2:
        return _cross_rbf_lin(p1, p2, Z, q, qX)
    if lin1 and isinstance(p2, RBF):
        return _cross_rbf_lin(p2, p1, Z, q, qX).transpose(1, 2)
    if lin1 and lin2:
        return _cross_lin_lin(p1, p2, Z, q, qX)
    return None


# ---------------------------------------------------------------------------
# closed forms (psi_comp.py:179-323)
# ---------------------------------------------------------------------------

class ClosedFormPsi:
    """psi0, psi1 and psi2n of a kernel by the closed form its `_pc(q)`
    picks for the type of q(X) (Gaussian or spike-and-slab), on the
    kernel's active_dims: the mixin of RBF and Linear."""

    def _psi(self, stat, Z, qX):
        Z, q = slice_psi_inputs(self, Z, qX)
        return getattr(self._pc(q), stat)(self, Z, q)

    def psi0(self, Z, qX):
        return self._psi("psi0", Z, qX)

    def psi1(self, Z, qX):
        return self._psi("psi1", Z, qX)

    def psi2n(self, Z, qX):
        return self._psi("psi2n", Z, qX)


def _l2(kern, Q):
    return (kern.lengthscale.values ** 2).expand(Q)


class PSICOMP_RBF:
    """Closed-form RBF psi statistics (GPy: rbf_psi_comp.py:8-136)."""

    def psi0(self, kern, Z, q):
        N = q.mean.shape[0]
        return kern.variance.values * torch.ones(N, dtype=Z.dtype, device=Z.device)

    def psi1(self, kern, Z, q):
        mu, S = q.mean, q.variance
        l2 = _l2(kern, mu.shape[1])
        denom = S + l2
        dist2 = (mu[:, None, :] - Z[None, :, :]) ** 2 / denom[:, None, :]
        lognorm = 0.5 * torch.sum(torch.log(l2)[None, :] - torch.log(denom), dim=-1)
        return kern.variance.values * torch.exp(lognorm[:, None] - 0.5 * torch.sum(dist2, dim=-1))

    def psi2n(self, kern, Z, q):
        mu, S = q.mean, q.variance
        l2 = _l2(kern, mu.shape[1])
        denom = 2.0 * S + l2
        Zbar = 0.5 * (Z[:, None, :] + Z[None, :, :])
        dZ2 = (Z[:, None, :] - Z[None, :, :]) ** 2 / l2
        diff2 = (mu[:, None, None, :] - Zbar[None]) ** 2 / denom[:, None, None, :]
        lognorm = 0.5 * torch.sum(torch.log(l2)[None, :] - torch.log(denom), dim=-1)
        expo = (lognorm[:, None, None] - 0.25 * torch.sum(dZ2, dim=-1)[None]
                - torch.sum(diff2, dim=-1))
        return kern.variance.values ** 2 * torch.exp(expo)


class PSICOMP_Linear:
    """Closed-form Linear psi statistics (GPy: linear_psi_comp.py)."""

    def psi0(self, kern, Z, q):
        return torch.sum(kern.variances.values * (q.mean**2 + q.variance), dim=-1)

    def psi1(self, kern, Z, q):
        return (q.mean * kern.variances.values) @ Z.T

    def psi2n(self, kern, Z, q):
        v = kern.variances.values
        mZ = q.mean @ (Z * v).T  # (N, M)
        SZZ = torch.einsum("nq,mq,kq->nmk", q.variance * v * v, Z, Z)
        return mZ[:, :, None] * mZ[:, None, :] + SZZ


class PSICOMP_SSLinear(PSICOMP_Linear):
    """Spike-and-slab Linear psi statistics (GPy: sslinear_psi_comp.py:1-86).
    Per dimension E[x] = g mu and E[x^2] = g (mu^2 + S), so psi2 is the outer
    product of psi1 plus sum_q v_q^2 g ((1 - g) mu^2 + S) Z_mq Z_m'q."""

    def psi0(self, kern, Z, q):
        return torch.sum(kern.variances.values * q.gamma * (q.mean**2 + q.variance), dim=-1)

    def psi1(self, kern, Z, q):
        return (q.gamma * q.mean * kern.variances.values) @ Z.T

    def psi2n(self, kern, Z, q):
        v = kern.variances.values
        g, mu = q.gamma, q.mean
        psi1 = self.psi1(kern, Z, q)
        varq = g * ((1.0 - g) * mu**2 + q.variance)
        VZZ = torch.einsum("nq,mq,kq->nmk", varq * v * v, Z, Z)
        return psi1[:, :, None] * psi1[:, None, :] + VZZ


def ss_rbf_psi2n(variance, l2, Z, mu, S, g):
    """The spike-and-slab RBF psi2_n, (N, M, M): per dimension the mixture
    g h1 + (1 - g) h0 of the slab's Gaussian integral h1 and the spike's
    value at 0, multiplied over the dimensions."""
    denom = 2.0 * S + l2
    Zbar = 0.5 * (Z[:, None, :] + Z[None, :, :])
    dZ2 = (Z[:, None, :] - Z[None, :, :]) ** 2 / l2
    h1 = torch.sqrt(l2 / denom)[:, None, None, :] * torch.exp(
        -((mu[:, None, None, :] - Zbar[None]) ** 2) / denom[:, None, None, :] - 0.25 * dZ2[None])
    h0 = torch.exp(-(Zbar[None] ** 2) / l2 - 0.25 * dZ2[None])
    fac = g[:, None, None, :] * h1 + (1 - g)[:, None, None, :] * h0
    return variance**2 * torch.prod(fac, dim=-1)


class PSICOMP_SSRBF(PSICOMP_RBF):
    """Spike-and-slab RBF psi statistics (GPy: ssrbf_psi_comp.py):
    q(x_nq) = gamma_nq N(mu, S) + (1 - gamma_nq) delta_0, per dimension a
    mixture, multiplied over the dimensions."""

    def psi1(self, kern, Z, q):
        mu, S, g = q.mean, q.variance, q.gamma
        l2 = _l2(kern, mu.shape[1])
        denom = S + l2
        g1 = torch.sqrt(l2 / denom)[:, None, :] * torch.exp(
            -0.5 * (mu[:, None, :] - Z[None, :, :]) ** 2 / denom[:, None, :])
        g0 = torch.exp(-0.5 * Z[None, :, :] ** 2 / l2)
        fac = g[:, None, :] * g1 + (1 - g)[:, None, :] * g0
        return kern.variance.values * torch.prod(fac, dim=-1)

    def psi2n(self, kern, Z, q):
        mu = q.mean
        return ss_rbf_psi2n(kern.variance.values, _l2(kern, mu.shape[1]), Z, mu, q.variance,
                            q.gamma)


def rbf_psi1(kern, pc, Z, q):
    """psi1 of an RBF kernel by the closed form `pc` (Gaussian or
    spike-and-slab) on sliced inputs: at once, or in checkpointed blocks of
    PSI1_BLOCK_ELEMS / (M Q) rows (ops/psi2.py)."""
    from ..ops.psi2 import rows_checkpointed

    N, Q = q.mean.shape
    rows_per_block = max(1, PSI1_BLOCK_ELEMS // (Z.shape[0] * Q))
    if N <= rows_per_block:
        return pc.psi1(kern, Z, q)
    ss = hasattr(q, "gamma")
    rows = [q.mean, q.variance] + ([q.gamma] if ss else [])

    def block(mu, S, *g):
        qb = SimpleNamespace(mean=mu, variance=S)
        if ss:
            qb.gamma = g[0]
        return pc.psi1(kern, Z, qb)

    return rows_checkpointed(block, rows, rows_per_block)


def psi2_weighted(kern, Z, qX, W):
    """sum_n W_n psi2_n, (M, M): the operand of the collapsed bounds.

    From STREAM_MIN_N rows an RBF kernel streams it over blocks of rows
    (ops/psi2.py), as the reference does (gpy_tpu/inference/var_dtc.py:
    55-67). The streamed form follows the posterior's type: a spike-and-slab
    q(X) streams the spike-and-slab psi2. (The reference's test looks at the
    kernel only and streams the Gaussian psi2 for a spike-and-slab q(X),
    which ignores gamma: ROADMAP C(m).) Below it, or for any other kernel,
    the (N, M, M) psi2n is formed and contracted."""
    from ..ops.psi2 import rbf_psi2_weighted, ss_rbf_psi2_weighted
    from .stationary import RBF

    q = moments(qX)
    if q.mean.shape[0] >= STREAM_MIN_N and isinstance(kern, RBF):
        Zs, qs = slice_psi_inputs(kern, Z, q)
        if hasattr(qs, "gamma"):
            return ss_rbf_psi2_weighted(kern.variance.values, kern.lengthscale.values, Zs,
                                        qs.mean, qs.variance, qs.gamma, W)
        return rbf_psi2_weighted(kern.variance.values, kern.lengthscale.values, Zs, qs.mean,
                                 qs.variance, W)
    return torch.einsum("n,nmk->mk", W, kern.psi2n(Z, qX))


# ---------------------------------------------------------------------------
# Gauss-Hermite fallback for kernels without closed forms (psi_comp.py:
# 326-378, GPy gaussherm.py)
# ---------------------------------------------------------------------------

def _gh_points(Q, degree):
    x, w = np.polynomial.hermite.hermgauss(degree)
    grids = np.meshgrid(*([x] * Q), indexing="ij")
    pts = np.stack([g.reshape(-1) for g in grids], axis=-1)  # (degree^Q, Q)
    ws = np.meshgrid(*([w] * Q), indexing="ij")
    wprod = np.ones(pts.shape[0])
    for g in ws:
        wprod = wprod * g.reshape(-1)
    return pts * np.sqrt(2.0), wprod / np.pi ** (Q / 2.0)


def _gh_samples(qX, degree=5):
    """(nodes as (P N, Q), weights (P,), P): x_p = mu + sqrt(S) t_p, degree 5
    per dimension (3 above Q = 4, to bound the product grid)."""
    q = moments(qX)
    mu, S = q.mean, q.variance
    N, Q = mu.shape
    if Q > 4:
        degree = 3
    pts, w = _gh_points(Q, degree)
    pts = torch.as_tensor(pts, dtype=mu.dtype, device=mu.device)
    w = torch.as_tensor(w, dtype=mu.dtype, device=mu.device)
    xs = mu[None, :, :] + torch.sqrt(S)[None, :, :] * pts[:, None, :]  # (P, N, Q)
    return xs.reshape(-1, Q), w, pts.shape[0]


def psi0_quadrature(kern, Z, qX, degree=5):
    xs, w, P = _gh_samples(qX, degree)
    return w @ kern.Kdiag(xs).reshape(P, -1)


def psi1_quadrature(kern, Z, qX, degree=5):
    xs, w, P = _gh_samples(qX, degree)
    return torch.einsum("p,pnm->nm", w, kern.K(xs, Z).reshape(P, -1, Z.shape[0]))


def cross_psi2n_quadrature(p1, p2, Z, qX, degree=5):
    """<k1(x, Z_m) k2(x, Z_m')> by Gauss-Hermite over a Gaussian q(x), for any
    pair of kernels: what Add.psi2n takes where no closed form exists and
    the latent dimension admits the product grid."""
    xs, w, P = _gh_samples(qX, degree)
    v1 = p1.K(xs, Z).reshape(P, -1, Z.shape[0])
    v2 = p2.K(xs, Z).reshape(P, -1, Z.shape[0])
    return torch.einsum("p,pnm,pnk->nmk", w, v1, v2)


def psi2n_quadrature(kern, Z, qX, degree=5):
    xs, w, P = _gh_samples(qX, degree)
    vals = kern.K(xs, Z).reshape(P, -1, Z.shape[0])
    return torch.einsum("p,pnm,pnk->nmk", w, vals, vals)
