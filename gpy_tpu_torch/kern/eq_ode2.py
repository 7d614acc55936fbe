"""EQ_ODE2: the second-order latent-force kernel (Alvarez and Lawrence).

Counterpart of gpy_tpu/kern/eq_ode2.py (GPy/kern/src/eq_ode2.py): outputs
follow d2y_d/dt2 + C_d dy_d/dt + B_d y_d = sum_q W_dq u_q(t) with RBF latent
forces u_q (k_u = exp(-r^2 / l^2), GPy's convention). X = [t, index] as in
EQ_ODE1 (kern/eq_ode1.py), with its host read of the index column once per
distinct input tensor (ROADMAP C(ad) not copied).

The Green's function splits into complex exponentials, G_d(t) =
[e^{-gamma2_d t} - e^{-gamma_d t}] / (2i omega_d) with gamma = C/2 + i omega,
gamma2 = C/2 - i omega and omega = sqrt(B - C^2/4), the principal root, so
that the overdamped case (omega imaginary) is the same formula. The single
integral Upsilon has a closed form through the Faddeeva function
(util/wofz.py, complex128 or complex64 natively); Kfu is closed-form, and
Kff is one Upsilon under a 40-node Gauss-Legendre outer integral.

Memory: the reference maps the 40 nodes into (40, N, M) complex arrays at
once. Here Kff loops over the forces and over chunks of nodes (as many as
keep a chunk under 2^22 node-row-column entries) and adds each chunk's
terms, computed under torch.utils.checkpoint: their intermediates are freed
after the forward and made again in the backward, so peak memory is set by
the chunk, not by the node count. The six Faddeeva arguments of a chunk
(three per Upsilon, two Upsilons) go through one wofz call.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.transformations import Logexp
from ..util.wofz import wofz
from .eq_ode1 import first_index, force_gram, split_index
from .kern import Kern

__all__ = ["EQ_ODE2"]

SQRT_PI = math.sqrt(math.pi)
_GL_NODES = 40
_glx, _glw = np.polynomial.legendre.leggauss(_GL_NODES)
_NODES = ((_glx + 1.0) / 2.0).tolist()  # in (0, 1)
_WEIGHTS = (_glw / 2.0).tolist()
# a chunk of nodes of Kff spans at most this many (node, row, column)
# entries: 4 nodes at N = M = 1000, all 40 below N x M = 104,857
_CHUNK_ELEMENTS = 2 ** 22


def _upsilon(gamma, t, tp, l):
    """int_0^t exp(-gamma (t - tau)) exp(-(tau - tp)^2 / l^2) dtau.

    gamma complex; t, tp, l broadcastable real tensors. Branch-stable, as
    the reference (eq_ode2.py:52-92): with a = (t - tp)/l, b = tp/l and
    nu = gamma l/2, each erf is grouped with its exponential through
    erfcx(z) = w(iz), so that no factor e^{nu^2} is formed:
      Re(nu - a) <= 0:  2 e^{nu(nu - 2a)} - e^{-a^2} erfcx(a - nu) - T
      Re(nu - a)  > 0:  e^{-a^2} erfcx(nu - a) - T
      T = e^{-gamma t - b^2} erfcx(nu + b)          (Re(nu + b) >= 0)
    Each branch that the final where does not select sees nu = a, a benign
    argument, so its overflow cannot reach the gradient. The three erfcx
    arguments go through one wofz call.
    """
    nu = gamma * (l / 2.0)
    a = (t - tp) / l
    b = tp / l
    nu, a, b = torch.broadcast_tensors(nu, a, b)
    small = (nu.real - a) <= 0
    a_c = a.to(nu.dtype)
    nu1 = torch.where(small, nu, a_c)
    nu2 = torch.where(small, a_c, nu)
    erfcx = wofz(1j * torch.stack([nu + b, a - nu1, nu2 - a]))
    ea = torch.exp(-a * a)
    T = torch.exp(-(gamma * t) - b * b) * erfcx[0]
    br1 = 2.0 * torch.exp(nu1 * (nu1 - 2.0 * a)) - erfcx[1] * ea - T
    br2 = erfcx[2] * ea - T
    return torch.where(small, br1, br2) * (l * (SQRT_PI / 2.0))


def _node_term(frac, wgt, g_r, w_r, g_c, w_c, t, t2, l):
    """The Gauss-Legendre nodes' terms of Kff^{(q)}, summed: the column's
    Green's bracket at tau' = t2 * frac times the row's Upsilon bracket.
    frac and wgt are (G, 1, 1) for G nodes at once; g_r and g_c stack
    (gamma2, gamma) on a leading axis."""
    taup = t2 * frac
    e = torch.exp(-g_c[:, None] * (t2 - taup))
    colf = (e[0] - e[1]) / (2j * w_c)
    ups = _upsilon(g_r[:, None], t, taup, l)
    rowf = (ups[0] - ups[1]) / (2j * w_r)
    return torch.sum((colf * rowf).real * (wgt * t2), dim=0)


@functools.lru_cache(maxsize=None)
def _node_chunks(size, dtype, device):
    """The nodes and weights in chunks of `size`, made once per dtype and
    device (a copy to the card)."""
    f = torch.tensor(_NODES, dtype=dtype, device=device)
    w = torch.tensor(_WEIGHTS, dtype=dtype, device=device)
    return [(f[i:i + size], w[i:i + size]) for i in range(0, _GL_NODES, size)]


class EQ_ODE2(Kern):
    def __init__(self, input_dim=2, output_dim=1, rank=1, W=None, lengthscale=None,
                 C=None, B=None, active_dims=None, name="eq_ode2", device=None, dtype=None):
        assert input_dim == 2, "only defined for 1 input dim + index column"
        super().__init__(input_dim, active_dims, name, device=device, dtype=dtype)
        self.rank = int(rank)
        self.output_dim = int(output_dim)
        rng = np.random.default_rng(0)
        if lengthscale is None:
            lengthscale = 0.5 + rng.random(self.rank)
        if W is None:
            W = 0.5 * rng.standard_normal((self.output_dim, self.rank)) / np.sqrt(self.rank)
        if C is None:
            C = np.ones(self.output_dim)
        if B is None:
            B = np.ones(self.output_dim)
        self._add_param("lengthscale", np.asarray(lengthscale, float).reshape(-1),
                        transform=Logexp())
        self._add_param("C", np.asarray(C, float).reshape(-1), transform=Logexp())
        self._add_param("B", np.asarray(B, float).reshape(-1), transform=Logexp())
        self._add_param("W", np.asarray(W, float))

    # --- helpers ------------------------------------------------------------
    def _gammas(self):
        """(gamma, gamma2, omega) per output, complex. omega is the principal
        root of the real B - C^2/4: +sqrt on the positive axis, +i sqrt(-x)
        on the negative one (the reference's csqrt, gpy_tpu/util/cplx.py:
        158-177), each half under a double where so that the half that is
        exactly sqrt(0) has gradient 0, not inf."""
        C, B = self.C.values, self.B.values
        x = B - C * C / 4.0
        pos, neg = x > 0, x < 0
        re = torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)
        im = torch.where(neg, torch.sqrt(torch.where(neg, -x, 1.0)), 0.0)
        omega = torch.complex(re, im)
        # critical damping (omega -> 0) makes the two-pole Green's function
        # 0/0: nudge to a nearby underdamped system (error O(1e-8))
        omega = torch.where(omega.abs() < 1e-8, omega + 1e-8, omega)
        alpha = C / 2.0
        return 1j * omega + alpha, -1j * omega + alpha, omega

    def _stacked(self, idx):
        """(gamma2, gamma) of the outputs `idx` stacked on a leading axis,
        and their omega."""
        gamma, gamma2, omega = self._gammas()
        return torch.stack([gamma2[idx], gamma[idx]]), omega[idx]

    def _Kuu(self, t, q_idx):
        return force_gram(self.lengthscale.values, t, q_idx)

    def _Kfu(self, t, d_idx, z, q_idx):
        """Outputs x latent forces, closed form."""
        g, w = self._stacked(d_idx)
        lq = self.lengthscale.values[q_idx][None, :]
        Sdq = self.W.values[d_idx][:, q_idx]
        ups = _upsilon(g[:, :, None], t[:, None], z[None, :], lq)
        return Sdq * ((ups[0] - ups[1]) / (2j * w[:, None])).real

    def _Kff(self, t, d_idx, t2, d2_idx):
        """Output x output: the exact Upsilon under the Gauss-Legendre outer
        integral over tau' in [0, t'], force by force and node by node."""
        lq = self.lengthscale.values
        S = self.W.values
        g_r, w_r = self._stacked(d_idx)
        g_c, w_c = self._stacked(d2_idx)
        g_r, w_r = g_r[:, :, None], w_r[:, None]
        g_c, w_c = g_c[:, None, :], w_c[None, :]
        tt, tt2 = t[:, None], t2[None, :]
        size = max(1, min(_GL_NODES, _CHUNK_ELEMENTS // max(t.shape[0] * t2.shape[0], 1)))
        chunks = _node_chunks(size, t.dtype, t.device)
        total = 0.0
        for q in range(self.rank):
            acc = 0.0
            for frac, wgt in chunks:
                acc = acc + checkpoint(_node_term, frac[:, None, None], wgt[:, None, None], g_r,
                                       w_r, g_c, w_c, tt, tt2, lq[q], use_reentrant=False)
            total = total + acc * (S[d_idx, q][:, None] * S[d2_idx, q][None, :])
        return total

    def Kdiag_per_force(self, t, d_idx):
        """(N, R): each force's contribution Kff^{(q)}(t_n, t_n) to the
        outputs' variances, O(N x 40 x R), the 40 nodes at once. GPy's kern._Kdiag consumed by
        VarDTC_minibatch_IBPLFM.gatherPsiStat (ibp_lfm.py:62-63): IBPLFM's
        exact psi0."""
        lq = self.lengthscale.values
        S = self.W.values
        g, w = self._stacked(d_idx)
        frac, wgt = _node_chunks(_GL_NODES, t.dtype, t.device)[0]
        cols = [_node_term(frac[:, None], wgt[:, None], g, w, g, w, t, t, lq[q]) * S[d_idx, q] ** 2
                for q in range(self.rank)]
        return torch.stack(cols, dim=1)

    # --- dispatch (reference eq_ode2.py:194-219) ----------------------------
    def K(self, X, X2=None):
        X = self._slice(X)
        t, idx = split_index(X)
        X_is_u = first_index(X) >= self.output_dim
        if X2 is None:
            if X_is_u:
                return self._Kuu(t, idx - self.output_dim)
            return self._Kff(t, idx, t, idx)
        X2 = self._slice(X2)
        t2, idx2 = split_index(X2)
        X2_is_u = first_index(X2) >= self.output_dim
        if not X_is_u and X2_is_u:
            return self._Kfu(t, idx, t2, idx2 - self.output_dim)
        if X_is_u and not X2_is_u:
            return self._Kfu(t2, idx2, t, idx - self.output_dim).T
        if X_is_u and X2_is_u:
            return force_gram(self.lengthscale.values, t, idx - self.output_dim, t2,
                              idx2 - self.output_dim)
        return self._Kff(t, idx, t2, idx2)

    def Kdiag(self, X):
        """The row sum of Kdiag_per_force; the reference takes the diagonal
        of the whole Kff (eq_ode2.py:253-257), O(N^2 x 40 x R), the same
        numbers."""
        X = self._slice(X)
        t, idx = split_index(X)
        if first_index(X) >= self.output_dim:
            return torch.ones_like(t)
        return torch.sum(self.Kdiag_per_force(t, idx), dim=1)
