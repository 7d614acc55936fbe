"""Matrix-free iterative exact-GP inference: CG solves and stochastic Lanczos
quadrature, never factorizing the N x N Gram.

Counterpart of gpy_tpu/inference/iterative.py (the GPyTorch/BBMM recipe,
Gardner et al. 2018):

  * log marginal: -0.5 (y' K^-1 y + logdet K + N log 2pi), with K^-1 y from
    batched conjugate gradients and logdet from SLQ over Hutchinson probes;
    the Lanczos tridiagonal is rebuilt from the CG coefficients.
  * gradient: d logdet/dtheta = tr(K^-1 dK), estimated with the same probes
    and assembled as a differentiable surrogate of quadratic forms, so
    autograd of the returned value gives the estimator exactly.

Every solve runs under torch.no_grad(); `x.detach()` stands for the
reference's lax.stop_gradient. CG is a Python loop of `maxiter` steps whose
guards are torch.where, so a solve never waits on the host. The reference's
jit caches have no counterpart: torch runs eagerly.

Probes come from a torch.Generator seeded with `seed` on the model's device
(`_rademacher` and `_normals`); they are not the reference's jax.random
draws (ROADMAP C(b)).
"""
from __future__ import annotations

import math

import torch

from ..ops.gram_matvec import gram_materialize, gram_matvec, make_gram_matvec, torch_dtype
from ..ops.gram_matvec_fused import (fused_available, kern_gram_matvec_fused,
                                     kern_gram_matvec_fused_diff)
from ..ops.pivoted_chol import (_capacitance_chol, pivoted_cholesky, woodbury_inverse_apply,
                                woodbury_logdet)
from .exact import LatentFunctionInference

__all__ = ["IterativeGaussianInference", "IterativePosterior", "cg_batched", "pcg_batched"]

LOG_2_PI = math.log(2 * math.pi)


def cg_batched(mv, B, maxiter=64):
    """Conjugate gradients on (K x = b) for every column of B (N, R).

    A fixed `maxiter` steps (the coefficient history is what SLQ needs).
    Returns (X, alphas, betas, r0norm2) with alphas and betas (maxiter, R).
    """
    X = torch.zeros_like(B)
    Rr = B
    P = B
    rs = rs0 = torch.sum(Rr * Rr, dim=0)
    alphas, betas = [], []
    for _ in range(maxiter):
        Ap = mv(P)
        pAp = torch.sum(P * Ap, dim=0)
        alpha = torch.where(rs > 1e-300, rs / torch.where(pAp > 1e-300, pAp, 1.0), 0.0)
        X = X + alpha[None, :] * P
        Rr = Rr - alpha[None, :] * Ap
        rs_new = torch.sum(Rr * Rr, dim=0)
        beta = torch.where(rs > 1e-300, rs_new / rs, 0.0)
        P = Rr + beta[None, :] * P
        rs = rs_new
        alphas.append(alpha)
        betas.append(beta)
    return X, torch.stack(alphas), torch.stack(betas), rs0


def pcg_batched(mv, pinv, B, maxiter=64):
    """Preconditioned CG on (K x = b) per column of B with `pinv` = P^{-1}.
    Returns (X, alphas, betas, rho0), rho0 = b' P^{-1} b per column (the
    |z|^2 of the implicit plain-CG start z = P^{-1/2} b that SLQ needs)."""
    X = torch.zeros_like(B)
    Rr = B
    Y = pinv(Rr)
    P = Y
    rho = rho0 = torch.sum(Rr * Y, dim=0)
    alphas, betas = [], []
    for _ in range(maxiter):
        Ap = mv(P)
        pAp = torch.sum(P * Ap, dim=0)
        alpha = torch.where(rho > 1e-300, rho / torch.where(pAp > 1e-300, pAp, 1.0), 0.0)
        X = X + alpha[None, :] * P
        Rr = Rr - alpha[None, :] * Ap
        Y = pinv(Rr)
        rho_new = torch.sum(Rr * Y, dim=0)
        beta = torch.where(rho > 1e-300, rho_new / rho, 0.0)
        P = Y + beta[None, :] * P
        rho = rho_new
        alphas.append(alpha)
        betas.append(beta)
    return X, torch.stack(alphas), torch.stack(betas), rho0


def _slq_logdet(alphas, betas, z_norm2, n, n_probes):
    """logdet(K) estimate from CG coefficients of the probe solves.

    The Lanczos tridiagonal of column i is
      T[0,0] = 1/alpha_0,  T[k,k] = 1/alpha_k + beta_{k-1}/alpha_{k-1},
      T[k-1,k] = sqrt(beta_{k-1})/alpha_{k-1},
    and z' log(K) z ~= |z|^2 e1' log(T) e1 (Golub & Meurant quadrature).
    """
    k, R = alphas.shape
    a = torch.where(alphas > 1e-300, alphas, 1.0)  # converged columns: T padding
    inv_a = 1.0 / a
    diag = inv_a + torch.cat([torch.zeros((1, R), dtype=alphas.dtype, device=alphas.device),
                              betas[:-1] * inv_a[:-1]], dim=0)
    off = torch.sqrt(torch.clamp_min(betas[:-1], 0.0)) * inv_a[:-1]
    T = (torch.diag_embed(diag.T) + torch.diag_embed(off.T, offset=1)
         + torch.diag_embed(off.T, offset=-1))  # (R, k, k)
    w, U = torch.linalg.eigh(T)
    w = torch.clamp_min(w, 1e-30)
    quad = torch.sum((U[:, 0, :] ** 2) * torch.log(w), dim=-1)  # e1' log(T) e1
    return torch.sum(z_norm2 * quad) / n_probes


class IterativePosterior:
    """Posterior container backed by CG solves (no Cholesky anywhere)."""

    def __init__(self, kern, X, noise, alpha, max_cg=64, block=2048, fused=False,
                 fused_accum="f32x3"):
        self.kern = kern
        self._X = X
        self._noise = noise
        self.woodbury_vector = alpha  # K^-1 (Y - m); the role it has in Posterior
        self.max_cg = max_cg
        self.block = block
        self.fused = fused
        self.fused_accum = fused_accum

    def _raw_predict(self, kern, Xnew, pred_var, full_cov=False):
        with torch.no_grad():
            Kx = kern.K(pred_var, Xnew)  # (N, n*)
            mu = Kx.T @ self.woodbury_vector
            if self.fused and fused_available(self.kern, pred_var.device):
                def mv(V):
                    return kern_gram_matvec_fused(self.kern, pred_var, V, noise=self._noise,
                                                  accum=self.fused_accum)
            else:
                mv = make_gram_matvec(self.kern, pred_var, self._noise, self.block)
            sol = cg_batched(mv, Kx, maxiter=self.max_cg)[0]
            if full_cov:
                var = kern.K(Xnew) - Kx.T @ sol
            else:
                var = kern.Kdiag(Xnew) - torch.sum(Kx * sol, dim=0)
                var = torch.clamp_min(var, 1e-12)[:, None]
        return mu, var


class IterativeGaussianInference(LatentFunctionInference):
    """Drop-in inference_method for GPRegression at large N.

    max_cg: CG/Lanczos iterations (also the SLQ quadrature order).
    n_probes: Hutchinson probes for logdet and its gradient.
    block: row-block size of the streamed Gram matvec.
    seed: seeds the probe generator.
    materialize: "auto" builds the stop-gradient Gram once while
      N <= materialize_max_n and runs CG as dense products; True always,
      False never (blockwise or fused).
    materialize_max_n: 50,000, the reference's value, sized for a 16 GB
      TPU; 70,000 with a 2-byte gram_dtype. The crossover on an 80 GB H100
      is not measured.
    precond_rank: > 0 preconditions CG with a rank-k pivoted Cholesky.
    gram_dtype: "bfloat16" stores the materialized Gram half-width and runs
      CG products from it with a float32 result.
    fused: run the stop-gradient CG sweeps and the gradient surrogate
      through the fused kernels (ops/gram_matvec_fused.py); the _FAMILIES
      kernels only. Deviation: the reference engages it on a TPU only and
      falls back to the blockwise path elsewhere; here it runs on the card
      (kernels B5/B6) and on the CPU (their plain twins).
    fused_accum: "f32x3" | "exact" | "fast" (on the card all run one
      contraction: float32 FFMA in the NLML's CG, 3xTF32 with per-tile
      promotion on the tensor cores in a predict's CG at n* > 16).
    fast_grad: "auto" computes the RBF gradient surrogate from the stored
      Gram (one extra sweep) when eligible; False always rebuilds.

    It has no stacked batched form: under HMC chains and parallel restarts
    GP._batched_objective evaluates the rows one after the other, each on
    the inference's one probe draw, as the reference's vmap does.
    """

    def __init__(self, max_cg=64, n_probes=8, block=2048, seed=0, materialize="auto",
                 materialize_max_n=50_000, precond_rank=0, gram_dtype=None, fused=False,
                 fused_accum="f32x3", fast_grad="auto"):
        self.max_cg = max_cg
        self.n_probes = n_probes
        self.block = block
        self.seed = seed
        self.precond_rank = precond_rank
        self.materialize = materialize
        self.gram_dtype = torch_dtype(gram_dtype)
        if (materialize_max_n == 50_000 and self.gram_dtype is not None
                and self.gram_dtype.itemsize <= 2):
            materialize_max_n = 70_000
        self.materialize_max_n = materialize_max_n
        self.fused = fused
        self.fused_accum = fused_accum
        self.fast_grad = fast_grad

    # --- probes (one draw each, so a test can hand in other probes) --------
    def _generator(self, device):
        return torch.Generator(device=device).manual_seed(int(self.seed))

    def _rademacher(self, N, dtype, device):
        """(N, n_probes) Rademacher probes."""
        bits = torch.randint(0, 2, (N, self.n_probes), generator=self._generator(device),
                             device=device)
        return (2 * bits - 1).to(dtype)

    def _normals(self, N, dtype, device):
        """(U (rank, n_probes), W (N, n_probes)) standard normals for the
        preconditioned probes b = L U + sqrt(noise) W."""
        g = self._generator(device)
        U = torch.randn((self.precond_rank, self.n_probes), generator=g, device=device,
                        dtype=dtype)
        Wn = torch.randn((N, self.n_probes), generator=g, device=device, dtype=dtype)
        return U, Wn

    def _effective_fused(self, kern, N, dtype=None):
        """The auto policy, shared by training and the prediction posterior:
        explicit fused=True, or "auto" past the materialization cap. The
        fused kernels compute in float32, so "auto" engages only for
        float32-class inputs; fused=True is an opt-in to that cast."""
        f32_ok = dtype is None or dtype.itemsize <= 4
        return fused_available(kern) and (
            self.fused or (self.materialize == "auto" and N > self.materialize_max_n and f32_ok))

    def _rbf_moment_surrogate(self, kern, mv_sg, X, noise, alpha, Wp, Z, D):
        """Gradient surrogate for RBF kernels computed from the stored Gram.

        For an RBF kernel every dK/dtheta contraction of the surrogate
        quadratics q = u'Kv is a weighted distance moment of K itself:
            dq/d var  = (sum_ij u_i v_j k_ij) / var
            dq/d ls_d = (sum_ij u_i v_j k_ij d2_ij,d) / ls_d^3,
            sum_ij u_i v_j k_ij d2_ij,d
              = (u*x_d^2)'(K v) - 2 (u*x_d)'(K (v*x_d)) + u'(K (v*x_d^2)),
        so every moment is a product of the stored K with moment-weighted
        columns: one extra sweep instead of two Gram rebuilds. The returned
        scalar's gradient at the current theta equals the closed forms; its
        value cancels in the caller's shift.
        """
        P = Wp.shape[1]
        Xa = kern._slice(X).detach()
        Dx = Xa.shape[1]
        noise_sg = noise.detach()
        V = torch.cat([alpha, Wp], dim=1)
        Ucols = torch.cat([alpha, Z], dim=1)
        R = D + P
        cols = [V] + [V * Xa[:, d:d + 1] for d in range(Dx)] \
            + [V * (Xa[:, d:d + 1] ** 2) for d in range(Dx)]
        RHS = torch.cat(cols, dim=1)
        with torch.no_grad():
            MV = mv_sg(RHS) - noise_sg[:, None] * RHS  # K-only products
        KV = MV[:, :R]
        # per-pair weights: the caller's 0.5 q_alpha - 0.5 (D/P) q_probe
        w = torch.cat([torch.full((D,), 0.5, dtype=V.dtype, device=V.device),
                       torch.full((P,), -0.5 * D / P, dtype=V.dtype, device=V.device)])
        S0 = torch.sum(w * torch.sum(Ucols * KV, dim=0))
        ls = torch.broadcast_to(kern.lengthscale.values.reshape(-1), (Dx,))
        var = kern.variance.values
        sur = S0 / var.detach() * var
        for d in range(Dx):
            KVx = MV[:, R * (1 + d):R * (2 + d)]
            KVx2 = MV[:, R * (1 + Dx + d):R * (2 + Dx + d)]
            xd = Xa[:, d:d + 1]
            Sd = (torch.sum(w * torch.sum(Ucols * (xd ** 2) * KV, dim=0))
                  - 2.0 * torch.sum(w * torch.sum(Ucols * xd * KVx, dim=0))
                  + torch.sum(w * torch.sum(Ucols * KVx2, dim=0)))
            sur = sur - Sd / (2.0 * ls[d] ** 2)
        # the diagonal noise term of the quadratics, differentiable in the
        # likelihood parameters through `noise`
        rowdiag = torch.sum((Ucols * V) * w[None, :], dim=1)  # (N,)
        return sur + torch.sum(rowdiag * noise)

    def inference(self, kern, X, likelihood, Y, mean_function=None, Y_metadata=None):
        alpha, log_marginal, noise = self._inference_core(
            kern, X, likelihood, Y, Y_metadata, mean_function)
        posterior = IterativePosterior(
            kern, X, noise.detach(), alpha, max_cg=self.max_cg, block=self.block,
            fused=self._effective_fused(kern, X.shape[0], X.dtype),
            fused_accum=self.fused_accum)
        return posterior, log_marginal

    def _inference_core(self, kern, X, likelihood, Y, Y_metadata=None, mean_function=None):
        N, D = Y.shape
        m = mean_function.f(X) if mean_function is not None else 0.0
        YY = (Y - m).detach()
        noise = likelihood.noise_diagonal(N, Y_metadata) + 1e-6
        noise_sg = noise.detach()
        X_sg = X.detach()

        do_fused = self._effective_fused(kern, N, X.dtype)
        do_mat = (not do_fused
                  and (self.materialize is True
                       or (self.materialize == "auto" and N <= self.materialize_max_n)))
        with torch.no_grad():
            if do_fused:
                def mv_sg(V):
                    return kern_gram_matvec_fused(kern, X_sg, V, noise=noise_sg,
                                                  accum=self.fused_accum)
            elif do_mat:
                K_sg, P = gram_materialize(kern, X_sg, noise=noise_sg, block=self.block,
                                           out_dtype=self.gram_dtype)
                mv_sg = _dense_matvec(K_sg, N, P)
            else:
                mv_sg = make_gram_matvec(kern, X_sg, noise_sg, self.block)

        if self.precond_rank > 0:
            return self._preconditioned(kern, X, X_sg, YY, noise, noise_sg, mv_sg, D)

        Z = self._rademacher(N, X.dtype, X.device)
        with torch.no_grad():
            RHS = torch.cat([YY, Z], dim=1)
            sol, alphas, betas, _ = cg_batched(mv_sg, RHS, maxiter=self.max_cg)
            alpha = sol[:, :D]  # K^-1 y
            Wp = sol[:, D:]     # K^-1 z_i
            logdet = _slq_logdet(alphas[:, D:], betas[:, D:], torch.sum(Z * Z, dim=0), N,
                                 self.n_probes)
            value = -0.5 * (torch.sum(YY * alpha) + D * logdet + D * N * LOG_2_PI)

        # gradient surrogate: dL/dtheta = 0.5 alpha' dK alpha
        #                                - 0.5 D/P sum_i w_i' dK z_i
        # the reference's eligibility rule, kept so that both packages take
        # the same path (its 128 is the TPU's free matrix-unit lanes)
        fast_ok = (self.fast_grad is not False and do_mat and mean_function is None
                   and not X.requires_grad and type(kern).__name__ == "RBF"
                   and (D + self.n_probes) * (1 + 2 * kern.input_dim) <= 128)
        if fast_ok:
            surrogate = self._rbf_moment_surrogate(kern, mv_sg, X, noise, alpha, Wp, Z, D)
        else:
            U = torch.cat([alpha, Wp], dim=1)
            if do_fused:
                KU = kern_gram_matvec_fused_diff(kern, X, U, noise, accum=self.fused_accum)
            else:
                KU = gram_matvec(kern, X, U, noise=noise, block=self.block)
            q_alpha = torch.sum(alpha * KU[:, :D])
            q_probe = torch.sum(Z * KU[:, D:])  # z_i'(K w_i) == w_i' dK z_i
            surrogate = 0.5 * q_alpha - 0.5 * (D / self.n_probes) * q_probe
        return alpha, (value - surrogate).detach() + surrogate, noise

    def _preconditioned(self, kern, X, X_sg, YY, noise, noise_sg, mv_sg, D):
        """BBMM pivoted-Cholesky PCG (the reference's :430-467)."""
        N = X.shape[0]
        U, Wn = self._normals(N, X.dtype, X.device)
        with torch.no_grad():
            L = pivoted_cholesky(kern, X_sg, self.precond_rank)
            cap = _capacitance_chol(L, noise_sg)
            pinv = woodbury_inverse_apply(L, noise_sg, cap)
            logdet_P = woodbury_logdet(L, noise_sg, cap)
            # probes with covariance P: the implicit plain-CG start is then a
            # unit-covariance Hutchinson probe of P^-1/2 K P^-1/2
            B = L @ U + torch.sqrt(noise_sg)[:, None] * Wn
            RHS = torch.cat([YY, B], dim=1)
            sol, alphas, betas, rho0 = pcg_batched(mv_sg, pinv, RHS, maxiter=self.max_cg)
            alpha = sol[:, :D]
            Wp = sol[:, D:]
            # logdet K = logdet P + tr log(P^-1/2 K P^-1/2)
            logdet = logdet_P + _slq_logdet(alphas[:, D:], betas[:, D:], rho0[D:], N,
                                            self.n_probes)
            # gradient probes: E[(P^-1 b) b'] = I, so w_i' dK (P^-1 b_i)
            # estimates tr(K^-1 dK)
            Yp = pinv(B)
            value = -0.5 * (torch.sum(YY * alpha) + D * logdet + D * N * LOG_2_PI)
        KU = gram_matvec(kern, X, torch.cat([alpha, Wp], dim=1), noise=noise, block=self.block)
        q_alpha = torch.sum(alpha * KU[:, :D])
        q_probe = torch.sum(Yp * KU[:, D:])
        surrogate = 0.5 * q_alpha - 0.5 * (D / self.n_probes) * q_probe
        return alpha, (value - surrogate).detach() + surrogate, noise


def _dense_matvec(K_sg, N, P):
    """The CG product with the materialized (P, P) Gram: V zero-padded to P
    rows. A float32 or float64 Gram is a plain torch.matmul (TF32 stays off).
    A bfloat16 Gram multiplies V rounded to bfloat16 and returns V's dtype,
    as the reference's preferred_element_type=V.dtype does. On the card that
    is one torch.mm(..., out_dtype=torch.float32), which reads the stored
    Gram as it is and sums in float32 (deviation: for a float64 V the
    reference would sum in float64). The CPU has no such product, so there
    row blocks of the Gram are widened to V's dtype one at a time: the same
    products (a bf16 x bf16 product is exact in float32), summed in V's
    dtype, and never a widened copy of the whole Gram."""
    pad = P - N

    def mv(V):
        Vp = torch.cat([V, torch.zeros((pad, V.shape[1]), dtype=V.dtype, device=V.device)], 0) \
            if pad else V
        if K_sg.dtype != torch.bfloat16:
            return torch.matmul(K_sg, Vp)[:N]
        Vb = Vp.to(torch.bfloat16)
        if K_sg.device.type == "cuda":
            out = torch.mm(K_sg, Vb, out_dtype=torch.float32)
        else:
            Vw = Vb.to(V.dtype)
            out = torch.cat([K_sg[i:i + 4096].to(V.dtype) @ Vw for i in range(0, P, 4096)], 0)
        return out[:N].to(V.dtype)

    return mv

