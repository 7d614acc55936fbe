"""State-space (SDE) forms of kernels without an exact finite-dimensional one.

Counterpart of gpy_tpu/kern/sde.py:1-247 (GPy/kern/src/sde_stationary.py
sde_RBF, sde_standard_periodic.py, sde_static.py, sde_linear.py,
sde_brownian.py). Each function returns (F, L, Qc, H, Pinf) for a
stationary prior, or (F, L, Qc, H, Pinf, P0) for a nonstationary one, as
tensors on the device and in the dtype of the kernel's parameters,
differentiable in them.

The RBF's spectral factorization is done once, on the host, for a
lengthscale-free polynomial (its roots scale as 1/lengthscale), so the
companion-form coefficients are closed forms of the hyperparameters;
RatQuad's Gauss-Hermite nodes are host constants too. No root finding runs
inside the differentiable code. `attach_sde` gives RBF, RatQuad,
StdPeriodic, Bias, Linear and Brownian their sde(); Exponential, Matern32
and Matern52 define theirs in kern/stationary.py.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..util.linalg import block_diag, solve_lu_safe

__all__ = ["rbf_sde", "std_periodic_sde", "bias_sde", "linear_sde", "brownian_sde",
           "ratquad_sde", "attach_sde"]

_RBF_ORDER = 6


def _universal_rbf_coeffs(K=_RBF_ORDER):
    """u_0 ... u_K (u_K = 1) of the monic polynomial whose roots are the
    left-half-plane roots of sum_k (-1)^k y^{2k} / k!, y = s l / sqrt(2)."""
    coeffs = np.zeros(2 * K + 1)
    for k in range(K + 1):
        coeffs[2 * k] = (-1.0) ** k / math.factorial(k)
    roots = np.roots(coeffs[::-1])
    lhp = roots[roots.real < 0]
    if len(lhp) != K:
        raise RuntimeError(f"RBF spectral factorization found {len(lhp)} stable roots, not {K}")
    return np.real(np.poly(lhp)[::-1])


def _companion(K):
    """The constant companion matrix of the universal polynomial."""
    u = _universal_rbf_coeffs(K)
    C = np.zeros((K, K))
    C[:-1, 1:] = np.eye(K - 1)
    C[-1, :] = -u[:K]
    return C


_RBF_C = _companion(_RBF_ORDER)


def _like(a, ref):
    """A host constant as a tensor on ref's device, in ref's dtype."""
    return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=ref.dtype, device=ref.device)


def rbf_sde(variance, lengthscale, K=_RBF_ORDER):
    """(F, L, Qc, H, Pinf) of the order-K RBF approximation in a balanced
    realization, F = alpha C with alpha = sqrt(2)/l (the raw companion form
    has entries ~alpha^K). Pinf solves F P + P F' + L Qc L' = 0.
    GPy: sde_stationary.py sde_RBF."""
    v = variance.reshape(())
    l = lengthscale.reshape(-1)[0]
    alpha = math.sqrt(2.0) / l
    C = _RBF_C if K == _RBF_ORDER else _companion(K)
    F = alpha * _like(C, v)
    L = _like(np.eye(K)[:, -1:], v)
    H = _like(np.eye(K)[:1], v)
    q = v * l * math.sqrt(2 * math.pi) * float(math.factorial(K)) * (2.0 / l**2) ** K
    Qc = (q / alpha ** (2 * (K - 1))).reshape(1, 1)
    eyeK = _like(np.eye(K), v)
    A = torch.kron(eyeK, F) + torch.kron(F, eyeK)
    b = -(L @ Qc @ L.T).reshape(-1)
    Pinf = solve_lu_safe(A, b).reshape(K, K)
    return F, L, Qc, H, 0.5 * (Pinf + Pinf.T)


def _bessel_i(j, x, terms=30):
    """Modified Bessel I_j(x) by its series (small orders, moderate x)."""
    m = torch.arange(terms, dtype=x.dtype, device=x.device)
    log_terms = ((2 * m + j) * torch.log(x / 2.0) - torch.lgamma(m + 1.0)
                 - torch.lgamma(m + j + 1.0))
    return torch.sum(torch.exp(log_terms))


def std_periodic_sde(variance, period, lengthscale, n_harmonics=7):
    """(F, L, Qc, H, Pinf) of StdPeriodic by its harmonic expansion (Solin and
    Sarkka 2014; GPy: sde_standard_periodic.py): with a = 1/(4 l^2) the
    harmonic weights are q_j = eps_j I_j(a) e^{-a} v (eps_0 = 1, eps_j = 2)."""
    v = variance.reshape(())
    T = period.reshape(-1)[0]
    l = lengthscale.reshape(-1)[0]
    x = 1.0 / (4.0 * l**2)
    w0 = 2.0 * math.pi / T
    rot = _like([[0.0, -1.0], [1.0, 0.0]], v)
    eye2 = _like(np.eye(2), v)
    Fs, Ps = [], []
    for j in range(n_harmonics):
        qj = (1.0 if j == 0 else 2.0) * _bessel_i(j, x) * torch.exp(-x) * v
        Fs.append(rot * (w0 * j))
        Ps.append(qj * eye2)
    s = 2 * n_harmonics
    H = np.zeros((1, s))
    H[0, ::2] = 1.0
    return (block_diag(*Fs), _like(np.eye(s), v), _like(np.zeros((s, s)), v), _like(H, v),
            block_diag(*Ps))


def bias_sde(variance):
    """The constant-offset kernel: one static state. GPy: sde_static.py."""
    v = variance.reshape(1, 1)
    zero, one = _like([[0.0]], v), _like([[1.0]], v)
    return zero, one, zero, one, v


def linear_sde(variances, t0=0.0):
    """k(s, t) = v s t as f(t) = f0 + (t - t0) b with [f0, b] ~ N(0, v [[t0^2,
    t0], [t0, 1]]): the 6-tuple (F, L, Qc, H, Pinf = 0, P0), P0 exact at the
    first filter time t0. GPy: sde_linear.py:44-66."""
    v = variances.reshape(-1)[0]
    t0 = torch.as_tensor(t0, dtype=v.dtype, device=v.device)
    one = torch.ones_like(t0)
    P0 = v * torch.stack([torch.stack([t0 * t0, t0]), torch.stack([t0, one])])
    return (_like([[0.0, 1.0], [0.0, 0.0]], v), _like([[0.0], [1.0]], v), _like([[0.0]], v),
            _like([[1.0, 0.0]], v), _like(np.zeros((2, 2)), v), P0)


def brownian_sde(variance, t0=0.0):
    """Brownian motion k(s, t) = v min(s, t) (t >= 0): df = dW, one state,
    P0 = v max(t0, 0). Valid for times >= 0 only, as the reference's: the
    dense kernel reflects around 0, which the forward-time SDE cannot.
    GPy: sde_brownian.py:35-59."""
    v = variance.reshape(())
    t0 = torch.as_tensor(t0, dtype=v.dtype, device=v.device)
    t0p = torch.where(t0 < 0, torch.zeros_like(t0), t0)
    zero, one = _like([[0.0]], v), _like([[1.0]], v)
    return zero, one, v.reshape(1, 1), one, zero, (v * t0p).reshape(1, 1)


def ratquad_sde(variance, lengthscale, power, n_nodes=12, scale=1.3, rbf_order=_RBF_ORDER):
    """(F, L, Qc, H, Pinf) of RatQuad as a Gamma scale mixture of RBF SDEs:
    k(r) = E_{u ~ Gamma(p, 1)}[v e^{-u r^2/2}], with u = e^s at Gauss-Hermite
    nodes s_j = ln p + scale h_j / sqrt(p), each an order-`rbf_order` RBF
    block, stacked block-diagonally. The log weights are shifted by their
    detached maximum before exp, which keeps the gradient in p exact where
    the raw weights reach ~e^{p ln p - p}. The reference's own extension:
    GPy leaves sde_RatQuad unimplemented (sde_stationary.py:236-241)."""
    v = variance.reshape(())
    l = lengthscale.reshape(-1)[0]
    p = power.reshape(-1)[0]
    h, om = np.polynomial.hermite_e.hermegauss(n_nodes)
    h, om = _like(h, v), _like(om, v)
    s = torch.log(p) + scale * h / torch.sqrt(p)
    u = torch.exp(s)
    lw = torch.log(om) + p * s - u + h**2 / 2.0
    w = torch.exp(lw - torch.max(lw).detach())
    w = w / torch.sum(w)
    blocks = [rbf_sde(v * w[j], l / torch.sqrt(u[j]), K=rbf_order) for j in range(n_nodes)]
    F, L, Qc, H, Pinf = zip(*blocks)
    return block_diag(*F), block_diag(*L), block_diag(*Qc), torch.cat(H, dim=1), block_diag(*Pinf)


def attach_sde():
    """sde() of RBF, RatQuad, StdPeriodic, Bias, Linear and Brownian
    (gpy_tpu/kern/sde.py:227-247). Linear's and Brownian's take the first
    filter time t0."""
    from .linear import Linear
    from .misc import Brownian
    from .periodic import StdPeriodic
    from .static import Bias
    from .stationary import RBF, RatQuad

    RBF.sde = lambda self: rbf_sde(self.variance.values, self.lengthscale.values)
    RatQuad.sde = lambda self: ratquad_sde(self.variance.values, self.lengthscale.values,
                                           self.power.values)
    StdPeriodic.sde = lambda self: std_periodic_sde(self.variance.values, self.period.values,
                                                    self.lengthscale.values)
    Bias.sde = lambda self: bias_sde(self.variance.values)
    Linear.sde = lambda self, t0=0.0: linear_sde(self.variances.values, t0)
    Brownian.sde = lambda self, t0=0.0: brownian_sde(self.variance.values, t0)


attach_sde()
