"""IBPLFM: the Indian Buffet Process latent force model.

Counterpart of gpy_tpu/models/ibp_lfm.py (GPy/models/ibp_lfm.py: IBPLFM
:467, IBPPosterior :378, IBPPrior :418, VarDTC_minibatch_IBPLFM :19).
Outputs are driven by latent forces through the second-order LFM kernel
(EQ_ODE2), each force d-q link gated by a spike-and-slab variational
posterior gamma_dq under an IBP(alpha) prior. The collapsed bound takes the
exact spike-and-slab expectations of the reference's gatherPsiStat
(ibp_lfm.py:28-100):
  psi0 = sum_nq gamma_{d_n q} Kdiag^{(q)}(t_n) (EQ_ODE2.Kdiag_per_force);
  psi1 = G o Kfu, G_nm = gamma_{d_n q_m} (linear in the Bernoulli gates);
  psi2 = sum_d (Kfu_d' W_d Kfu_d) o Zp2_d with the Bernoulli second moment
         Zp2 = g g' - diag(g^2) + diag(g).
They are VarDTC's psi-form operands (inference/var_dtc.py `_collapsed`,
which adds the reference's 1e-6 jitter), and the IBP term, the
reference's finite Beta-Bernoulli E_q[log p(Z|pi) + log p(pi)] + H[q(Z)] +
H[q(pi)] (IBPPrior.KL_divergence, ibp_lfm.py:426-449), is what the
objective adds (`_kl`). So HMC chains and parallel restarts stack the
gated operands of each row (SparseGP._batched_objective) and evaluate the
gated bound, not VarDTC's.

The posterior is the gated bound's, as GPy's (VarDTC_minibatch_IBPLFM.
inference builds it from the gated psi statistics), and predict takes
K(Z, X*) from it as SparseGP does. One reference fault is not copied
(ROADMAP C(ae)): the reference's posterior is plain VarDTC's over the
ungated kernel (its SparseGP posterior calls VarDTC.inference, which
_GatedVarDTC inherits), and its predict raises (the index column's host
read of C(ad) inside its jitted predict).
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..core.sparse_gp import SparseGP
from ..core.transformations import Logexp, Logistic
from ..inference.var_dtc import VarDTC, _precision
from ..kern.eq_ode2 import EQ_ODE2
from ..likelihoods import Gaussian

__all__ = ["IBPLFM"]


class _GatedVarDTC(VarDTC):
    """VarDTC's collapsed bound over the gated (expected) LFM kernel
    matrices. qX carries the gates and the index structure (IBPLFM
    `_bound_args`)."""

    def operands(self, kern, X, Z, likelihood, Y, mean_function=None, Y_metadata=None,
                 qX=None):
        W = _precision(likelihood, Y.shape[0], mean_function, Y_metadata)
        g, d_idx, q_idx, onehot = qX.gates, qX.d_idx, qX.q_idx, qX.onehot
        t, tz = X[:, 0], Z[:, 0]
        Kfu = kern._Kfu(t, d_idx, tz, q_idx)  # (N, M), ungated
        # psi0: the per-force diagonal gated by E[z] = gamma
        psi0_sum = torch.sum(W * torch.sum(g[d_idx] * kern.Kdiag_per_force(t, d_idx), dim=1))
        # psi2: each output's Kfu_d' W_d Kfu_d in one contraction over the
        # one-hot output index, times its Bernoulli second moment
        P = torch.einsum("nd,nm,nk->dmk", onehot * W[:, None], Kfu, Kfu)  # (D, M, M)
        Zp2 = g[:, :, None] * g[:, None, :] + torch.diag_embed(g - g * g)  # (D, R, R)
        Psi2W = torch.sum(P * Zp2[:, q_idx][:, :, q_idx], dim=0)
        psi1 = g[d_idx][:, q_idx] * Kfu
        return {"Kmm": kern._Kuu(tz, q_idx), "psi1WY": psi1.T @ (W[:, None] * Y),
                "Psi2W": Psi2W, "W": W, "psi0_sum": psi0_sum,
                "YWY": torch.sum(W[:, None] * Y * Y)}


class IBPLFM(SparseGP):
    def __init__(self, X, Y, input_dim=2, output_dim=1, rank=1, Gamma=None, num_inducing=10,
                 Z=None, kernel=None, likelihood=None, alpha=2.0, name="IBP for LFM",
                 device=None, dtype=None):
        X = np.asarray(X, dtype=float)
        Y = np.asarray(Y, dtype=float)
        if kernel is None:
            kernel = EQ_ODE2(input_dim, output_dim, rank, device=device, dtype=dtype)
        R, D = int(rank), int(output_dim)
        if Gamma is None:
            rng = np.random.default_rng(0)
            Gamma = np.clip(0.5 + 0.1 * rng.standard_normal((D, R)), 1e-6, 1 - 1e-6)
        if Z is None:
            # inducing inputs on the latent-force side: times spanning the data
            # with force indices >= output_dim (EQ_ODE2's convention)
            rng = np.random.default_rng(1)
            tz = np.linspace(X[:, 0].min(), X[:, 0].max(), num_inducing)
            qz = rng.integers(0, R, num_inducing)
            Z = np.stack([tz, D + qz.astype(float)], axis=1)
        likelihood = likelihood or Gaussian(variance=0.1 * float(np.var(Y)), device=device,
                                            dtype=dtype)
        super().__init__(X, Y, Z, kernel, likelihood, inference_method=_GatedVarDTC(),
                         name=name, device=device, dtype=dtype)
        self.rank = R
        self.output_dim_lfm = D
        self.alpha = float(alpha)
        # the index columns are discrete and fixed, as in the reference: only
        # the inducing times are continuous (Z's index column has gradient 0)
        d_idx = np.int_(np.round(X[:, 1]))
        q_idx = np.int_(np.round(np.asarray(Z)[:, 1])) - D
        self._d_idx = torch.as_tensor(d_idx, device=self.device)
        self._q_idx = torch.as_tensor(q_idx, device=self.device)
        self._onehot = torch.as_tensor(np.eye(D)[d_idx], dtype=self.dtype, device=self.device)
        self._add_param("gamma", np.asarray(Gamma, dtype=float),
                        transform=Logistic(1e-9, 1 - 1e-9))
        # the variational Beta posterior over the inclusion probabilities
        # pi_q (GPy: IBPPosterior.tau, ibp_lfm.py:389-394)
        self._add_param("tau", np.ones((2, R)), transform=Logexp())

    def _bound_args(self):
        gates = SimpleNamespace(gates=self.gamma.values, d_idx=self._d_idx, q_idx=self._q_idx,
                                onehot=self._onehot)
        return (self.kern, self.X, self.Z.values, self.likelihood, self.Y_normalized, None,
                self.Y_metadata, gates)

    def _ibp_elbo_term(self):
        """E_q[log p(Z|pi) + log p(pi)] + H[q(Z)] + H[q(pi)] under the finite
        Beta-Bernoulli IBP approximation pi_q ~ Beta(alpha/R, 1), term for
        term the reference's (ibp_lfm.py:75-102)."""
        from torch.special import digamma

        g = self.gamma.values
        tau = self.tau.values
        D, R = g.shape
        ad = self.alpha / R
        sum_g = torch.sum(g, dim=0)
        psi1 = digamma(tau[0])
        psi2 = digamma(tau[1])
        sumtau = tau[0] + tau[1]
        psit = digamma(sumtau)
        part1 = torch.sum(sum_g * psi1 + (D - sum_g) * psi2 - D * psit)
        part1 = part1 + (ad - 1.0) * torch.sum(psi1 - psit) + R * float(np.log(ad))
        part2 = torch.sum(-(1.0 - g) * torch.log1p(-g) - g * torch.log(g))
        part2 = part2 + torch.sum(
            torch.lgamma(tau[0]) + torch.lgamma(tau[1]) - torch.lgamma(sumtau)
            - (tau[0] - 1.0) * psi1 - (tau[1] - 1.0) * psi2 + (sumtau - 2.0) * psit)
        return part1 + part2

    def _kl(self):
        return -self._ibp_elbo_term()

    @property
    def gates(self):
        """Posterior inclusion probabilities (D, R). GPy: m.Zp.gamma."""
        return self.gamma.numpy()
