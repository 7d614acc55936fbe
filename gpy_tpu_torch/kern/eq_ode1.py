"""EQ_ODE1: the first-order latent-force kernel.

Counterpart of gpy_tpu/kern/eq_ode1.py (GPy/kern/src/eq_ode1.py): outputs
y_d follow dy_d/dt = sum_q W_dq u_q(t) - decay_d y_d with independent RBF
latent forces u_q (k_u = exp(-r^2 / l_q^2), GPy's convention). X = [t,
index]: an index below output_dim selects an output, one at or above it a
latent force. The blocks are the reference's: Kuu, Kfu/Kuf, the output
block's Kdiag and the force-force cross block; the output-output block
raises NotImplementedError, as in GPy (latent-force models use the joint
(f, u) representation). Gradients are autograd's.

One reference fault is not copied (ROADMAP C(ad)): the reference reads the
index column with numpy, which fails on a traced X, so a GP over this
kernel cannot be optimized. Here the index column stays on the device for
the gathers, and the one decision the host must make -- are these rows
outputs or forces -- reads X[0, 1] once per distinct input tensor
(`block_kind`; the reads are counted in `index_reads`). A model's X is
read once; Z, a parameter, once after each change.
"""
from __future__ import annotations

import math
import weakref

import numpy as np
import torch

from ..core.transformations import Logexp
from ..util.ln_diff_erfs import ln_diff_erf
from .kern import Kern

__all__ = ["EQ_ODE1"]

SQRT_PI = math.sqrt(math.pi)

# host reads of an index column (each a device sync on the card)
index_reads = 0
_first_index = {}


def first_index(X) -> int:
    """round(X[0, 1]) as a Python int, read once per distinct tensor and
    in-place version of it."""
    global index_reads
    hit = _first_index.get(id(X))
    if hit is not None and hit[0]() is X and hit[1] == X._version:
        return hit[2]
    if len(_first_index) > 64:
        for k in [k for k, v in _first_index.items() if v[0]() is None]:
            del _first_index[k]
    value = int(torch.round(X[0, 1]).item())
    index_reads += 1
    _first_index[id(X)] = (weakref.ref(X), X._version, value)
    return value


def split_index(X):
    """(t, index as a long tensor on X's device) of rows [t, index]."""
    return X[:, 0], torch.round(X[:, 1]).long()


def force_gram(lq, t, q_idx, t2=None, q2_idx=None):
    """The latent forces' block exp(-(t/l_q - t'/l_q')^2), zero across
    forces (eq_ode1.py:50-56, 104-111 of the reference)."""
    if t2 is None:
        r = t[:, None] - t[None, :]
        same = q_idx[:, None] == q_idx[None, :]
        return torch.where(same, torch.exp(-(r ** 2) / (lq[q_idx][:, None] ** 2)), 0.0)
    r = t[:, None] / lq[q_idx][:, None] - t2[None, :] / lq[q2_idx][None, :]
    same = q_idx[:, None] == q2_idx[None, :]
    return torch.where(same, torch.exp(-(r ** 2)), 0.0)


class EQ_ODE1(Kern):
    def __init__(self, input_dim=2, output_dim=1, rank=1, W=None, lengthscale=None,
                 decay=None, active_dims=None, name="eq_ode1", device=None, dtype=None):
        assert input_dim == 2, "only defined for 1 input dim + index column"
        super().__init__(input_dim, active_dims, name, device=device, dtype=dtype)
        self.rank = int(rank)
        self.output_dim = int(output_dim)
        rng = np.random.default_rng(0)
        if lengthscale is None:
            lengthscale = 0.5 + rng.random(self.rank)
        if W is None:
            W = 0.5 * rng.standard_normal((self.output_dim, self.rank)) / np.sqrt(self.rank)
        if decay is None:
            decay = np.ones(self.output_dim)
        self._add_param("lengthscale", np.asarray(lengthscale, float).reshape(-1),
                        transform=Logexp())
        self._add_param("decay", np.asarray(decay, float).reshape(-1), transform=Logexp())
        self._add_param("W", np.asarray(W, float))

    # --- blocks (reference eq_ode1.py:48-81, GPy eq_ode1.py:339-431) --------
    def _Kuu(self, t, q_idx):
        # exp(-r^2 / l^2): no factor 1/2, as the reference (eq_ode1.py:53)
        return force_gram(self.lengthscale.values, t, q_idx)

    def _Kfu(self, t, d_idx, z, q_idx):
        """Outputs x latent forces. Where t = 0 the block is 0; there
        ln_diff_erf would see two equal arguments, so the rows at t = 0 are
        evaluated at t = 1 and their values discarded."""
        B = self.decay.values[d_idx][:, None]  # (N, 1)
        lq = self.lengthscale.values[q_idx][None, :]  # (1, M)
        Sdq = self.W.values[d_idx][:, q_idx]  # (N, M)
        c0 = Sdq * (0.5 * SQRT_PI * lq)
        nu = B * (0.5 * lq)
        z_lq = z[None, :] / lq
        zero = (t == 0.0)[:, None]
        ts = torch.where(t == 0.0, 1.0, t)[:, None]
        tz = ts - z[None, :]
        upsi = torch.exp(nu ** 2 - B * tz + ln_diff_erf(-tz / lq + nu, z_lq + nu))
        return c0 * torch.where(zero, 0.0, upsi)

    def _Kdiag_ff(self, t, d_idx):
        """The outputs' marginal variances, summed over the forces
        (GPy eq_ode1.py:158-214); 0 at t = 0, with the rows there
        evaluated at t = 1 as in _Kfu."""
        B = self.decay.values[d_idx][:, None]  # (N, 1)
        S = self.W.values[d_idx]  # (N, R)
        lq = self.lengthscale.values[None, :]  # (1, R)
        c0 = (S ** 2 / B) * (0.5 * SQRT_PI * lq)
        nu = lq * (B * 0.5)
        zero = (t == 0.0)[:, None]
        ts = torch.where(t == 0.0, 1.0, t)[:, None]
        t_lq = ts / lq
        upm = torch.exp(nu ** 2 + ln_diff_erf(nu, t_lq + nu))
        upv = torch.exp(nu ** 2 - 2.0 * B * ts + ln_diff_erf(-t_lq + nu, nu))
        return torch.sum(torch.where(zero, 0.0, c0 * (upm - upv)), dim=1)

    # --- dispatch (reference eq_ode1.py:84-116) -----------------------------
    def K(self, X, X2=None):
        X = self._slice(X)
        t, idx = split_index(X)
        X_is_u = first_index(X) >= self.output_dim
        if X2 is None:
            if X_is_u:
                return self._Kuu(t, idx - self.output_dim)
            raise NotImplementedError("ff block not defined (as in GPy eq_ode1)")
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
        raise NotImplementedError("ff block not defined (as in GPy eq_ode1)")

    def Kdiag(self, X):
        X = self._slice(X)
        t, idx = split_index(X)
        if first_index(X) >= self.output_dim:
            return torch.ones_like(t)
        return self._Kdiag_ff(t, idx)
