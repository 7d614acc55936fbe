"""SVGP model: stochastic variational GP with minibatches and natural gradients.

Counterpart of gpy_tpu/core/svgp.py:29-377 (GPy/core/svgp.py:12-105: q(u)
with the flat-Cholesky parameterization, the round-robin minibatch slicer,
stochastic_grad, optimizeWithFreezingZ), with the reference's natural-
gradient steps on (m, S), which GPy never had.

`fit` is an eager loop of the reference's scanned step. Each step reads
nothing back to the host: the minibatch indices are drawn on the model's
device from a seeded torch.Generator (its draws differ from jax.random's),
the precision's Cholesky is `cholesky_ex` (NaN on failure, as
jnp.linalg.cholesky), and the ELBO trace stays on the device until the loop
ends. No CUDA graph and no fused step: the host cost of an eager step is
what the port measures first.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from ..inference.svgp import (CONST_JITTER, SVGPInference, svgp_elbo_parts, svgp_elbo_parts_L,
                              svgp_elbo_parts_S, svgp_elbo_parts_S_white)
from ..util.choleskies import flat_to_triang, triang_to_flat
from ..util.linalg import cholesky_or_nan
from .model import _adam, value_and_grad
from .sparse_gp import SparseGP

__all__ = ["SVGP"]

_VAR_PATHS = ("q_u_mean", "q_u_chol")
_SHUFFLE_SEED = 0xC0FFEE


def _sym(A):
    return 0.5 * (A + A.transpose(-1, -2))


def _tri_inv(L, eye):
    return torch.linalg.solve_triangular(L, eye.expand(L.shape), upper=False)


def _logdet_factor(L):
    return 2.0 * torch.sum(torch.log(torch.abs(torch.diagonal(L, dim1=-2, dim2=-1))))


class SVGP(SparseGP):
    def __init__(self, X, Y, Z, kernel, likelihood, mean_function=None, name="SVGP",
                 Y_metadata=None, batchsize: Optional[int] = None, device=None, dtype=None):
        super().__init__(X, Y, Z, kernel, likelihood, inference_method=SVGPInference(),
                         mean_function=mean_function, name=name, Y_metadata=Y_metadata,
                         device=device, dtype=dtype)
        M, D = self.num_inducing, self.output_dim
        self._add_param("q_u_mean", np.zeros((M, D)))
        # q(u) starts at the prior N(0, Kmm): KL = 0 and the whitened
        # coordinates start at exactly I (GPy's identity init has an enormous
        # KL when Kmm is ill-conditioned)
        with torch.no_grad():
            Kmm0 = kernel.K(self.Z.values).cpu().numpy().astype(np.float64)
        L0 = np.linalg.cholesky(Kmm0 + 1e-6 * np.eye(M))
        rows, cols = np.tril_indices(M)
        self._add_param("q_u_chol", np.tile(L0[rows, cols][:, None], (1, D)))
        self.batchsize = batchsize
        self._batch_start = 0
        self._fit_shuffle_cache = None

    # --- full-data ELBO (the optimization objective) -----------------------
    def _elbo_parts(self, X, Y, batch_scale=1.0):
        return svgp_elbo_parts(self.kern, X, self.Z.values, self.likelihood, Y,
                               self.q_u_mean.values, self.q_u_chol.values, self.Y_metadata,
                               batch_scale)

    def log_likelihood(self) -> torch.Tensor:
        datafit, kl = self._elbo_parts(self.X, self.Y_normalized)
        return datafit - kl

    def _compute_posterior(self):
        # the posterior alone: the reference's inference() also evaluates
        # the full-data ELBO here, which predict never reads
        return self.inference_method.posterior(self.kern, self.Z.values, self.q_u_mean.values,
                                               self.q_u_chol.values)

    # --- GPy's minibatch API -----------------------------------------------
    def new_batch(self):
        """The next `batchsize` rows, round robin (GPy: core/svgp.py:90-96),
        as tensors on the model's device."""
        if self.batchsize is None:
            raise ValueError("new_batch needs the model's batchsize")
        i0 = self._batch_start
        idx = torch.arange(i0, i0 + self.batchsize, device=self.device) % self.num_data
        self._batch_start = (i0 + self.batchsize) % self.num_data
        return self.X[idx], self.Y_normalized[idx]

    def stochastic_grad(self, parameters_or_batch=None) -> np.ndarray:
        """Minibatch gradient of -ELBO - log prior with respect to the flat
        raw vector (GPy's API), on the next round-robin batch."""
        Xb, Yb = self.new_batch()
        scale = self.num_data / self.batchsize

        def neg_elbo(flat):
            with self.bind_flat_raw(flat):
                datafit, kl = self._elbo_parts(Xb, Yb, scale)
                return -(datafit - kl) - self.log_prior()

        return value_and_grad(neg_elbo, self.get_flat_raw())[1].cpu().numpy().astype(np.float64)

    def optimizeWithFreezingZ(self, iters_fixed=200, iters_free=200, **kw):
        """GPy: core/svgp.py:102-105."""
        self.Z.fix()
        self.optimize(max_iters=iters_fixed, **kw)
        self.Z.unfix()
        self.optimize(max_iters=iters_free, **kw)

    # --- the stochastic training loop --------------------------------------
    def _shuffled_data(self):
        """One shuffled copy of (X, Y) per data version, made on the device."""
        cache = self._fit_shuffle_cache
        if cache is None or cache[0] != self._data_version:
            gen = torch.Generator(device=self.device).manual_seed(_SHUFFLE_SEED)
            perm = torch.randperm(self.num_data, generator=gen, device=self.device)
            cache = (self._data_version, self.X[perm], self.Y_normalized[perm])
            self._fit_shuffle_cache = cache
        return cache[1], cache[2]

    @torch.no_grad()
    def _fit_init(self, whiten, eye):
        """(m, L, S, S^-1, logdet S) from the stored q(u); with `whiten`, in
        the whitened coordinates at the current hyperparameters:
        v = Lmm^-1 m, chol(S_w) = Lmm^-1 chol(S)."""
        L = flat_to_triang(self.q_u_chol.values, self.num_inducing)
        m = self.q_u_mean.values.clone()
        if whiten:
            Kmm = self.kern.K(self.Z.values) + CONST_JITTER * eye
            Lmi = _tri_inv(cholesky_or_nan(Kmm), eye)
            m = Lmi @ m
            L = torch.einsum("ij,djk->dik", Lmi, L)
        Li = _tri_inv(L, eye)
        return m, L, L @ L.transpose(1, 2), Li.transpose(1, 2) @ Li, _logdet_factor(L)

    @torch.no_grad()
    def _fit_write_back(self, q_mean, L, whiten, eye):
        """Store (q_u_mean, q_u_chol) in unwhitened coordinates, at the
        hyperparameters already written back."""
        if whiten:
            Lmm = cholesky_or_nan(self.kern.K(self.Z.values) + CONST_JITTER * eye)
            q_mean = Lmm @ q_mean
            L = torch.einsum("ij,djk->dik", Lmm, L)
        self.q_u_mean.set_value(q_mean)
        self.q_u_chol.set_value(triang_to_flat(L))

    def fit(self, iters=1000, batchsize=None, step_size=1e-2, natgrad_step_size=0.1,
            use_natgrad=True, whiten=False, seed=0, messages=False, batch_mode="auto"):
        """Minibatch training: Adam on the hyperparameters and Z, natural-
        gradient ascent on (q_u_mean, S). With use_natgrad=False Adam takes
        (hyperparameters, m, chol(S)) jointly: the factor keeps S positive
        definite where plain ascent on S could step it indefinite.

        whiten=True trains q(u) = N(Lmm v, Lmm S_w Lmm') (solve-free KL);
        the stored (q_u_mean, q_u_chol) are converted at the fit's
        boundaries, so the public parameterization is unchanged.

        batch_mode: "gather" draws each minibatch with replacement by an
        index gather; "shuffle_slice" draws random contiguous windows of one
        shuffled copy of the data (made once per data version); "auto"
        takes shuffle_slice from num_data >= 2**20, as the reference.
        The draws come from torch.Generator(device).manual_seed(seed): one
        seed gives one trace, bit for bit, but not jax.random's batches.

        Returns the per-step ELBO trace (minibatch estimates) as numpy; it
        is read back once, after the last step, and a warning names the
        first non-finite step if there is one.
        """
        if batch_mode not in ("auto", "gather", "shuffle_slice"):
            raise ValueError(f"unknown batch_mode {batch_mode!r}")
        N, M = self.num_data, self.num_inducing
        B = min(batchsize or self.batchsize or min(256, N), N)
        scale = N / B
        md = self.Y_metadata
        dev = self.device
        eye = torch.eye(M, dtype=self.dtype, device=dev)
        full_batch = B >= N
        use_shuffle = not full_batch and (
            batch_mode == "shuffle_slice" or (batch_mode == "auto" and N >= (1 << 20)))
        X_all, Y_all = self._shuffled_data() if use_shuffle else (self.X, self.Y_normalized)
        gen = torch.Generator(device=dev).manual_seed(seed)
        window = torch.arange(B, device=dev)

        def batch():
            if full_batch:
                return X_all, Y_all
            if use_shuffle:
                idx = torch.randint(0, N - B + 1, (1,), generator=gen, device=dev) + window
            else:
                idx = torch.randint(0, N, (B,), generator=gen, device=dev)
            return X_all[idx], Y_all[idx]

        hypers = {path: mod._parameters[n].detach().clone().requires_grad_(True)
                  for path, mod, n in self._free_entries() if path not in _VAR_PATHS}
        h_leaves = list(hypers.values())
        m, L, S, Si, logdetS = self._fit_init(whiten, eye)

        def ascend(opt, leaves, grads):
            for p, g in zip(leaves, grads):
                p.grad = torch.zeros_like(p) if g is None else -g
            opt.step()

        trace = []
        if use_natgrad:
            # the ELBO is closed-form in S (no factor of S); its entropy
            # gradient +0.5 S^-1 is added here, and the new precision
            # H = S^-1 - 2 lr dS is the one matrix factored a step
            parts = svgp_elbo_parts_S_white if whiten else svgp_elbo_parts_S
            opt = _adam(h_leaves, step_size) if h_leaves else None
            lr = natgrad_step_size
            for _ in range(iters):
                Xb, Yb = batch()
                q = m.requires_grad_(True)
                Sv = S.requires_grad_(True)
                with self.bind_raw_dict(hypers):
                    datafit, kl = parts(self.kern, Xb, self.Z.values, self.likelihood, Yb, q,
                                        _sym(Sv), logdetS, md, scale)
                    val = datafit - kl + self.log_prior()
                grads = torch.autograd.grad(val, h_leaves + [q, Sv], allow_unused=True)
                if opt is not None:
                    ascend(opt, h_leaves, grads[:-2])
                with torch.no_grad():
                    dS = _sym(grads[-1]) + 0.5 * Si
                    mc = m.detach().T[:, :, None]  # (D, M, 1)
                    th1 = Si @ mc + lr * (grads[-2].T[:, :, None] - 2.0 * dS @ mc)
                    H = Si - 2.0 * lr * dS
                    Lh = cholesky_or_nan(H + 1e-10 * eye)
                    Lhi = _tri_inv(Lh, eye)
                    S = _sym(Lhi.transpose(1, 2) @ Lhi)
                    m = (S @ th1)[:, :, 0].T
                    Si = _sym(H)
                    logdetS = -_logdet_factor(Lh)
                trace.append(val.detach())
            m, L = m.detach(), cholesky_or_nan(S.detach() + 1e-10 * eye)
        else:
            q = m.requires_grad_(True)
            Ls = L.requires_grad_(True)
            leaves = h_leaves + [q, Ls]
            opt = _adam(leaves, step_size)
            for _ in range(iters):
                Xb, Yb = batch()
                with self.bind_raw_dict(hypers):
                    Lt = torch.tril(Ls)
                    if whiten:
                        # the logdet is traced, so the entropy's gradient
                        # flows through it
                        datafit, kl = svgp_elbo_parts_S_white(
                            self.kern, Xb, self.Z.values, self.likelihood, Yb, q,
                            Lt @ Lt.transpose(1, 2), _logdet_factor(Lt), md, scale)
                    else:
                        datafit, kl = svgp_elbo_parts_L(self.kern, Xb, self.Z.values,
                                                        self.likelihood, Yb, q, Lt, md, scale)
                    val = datafit - kl + self.log_prior()
                ascend(opt, leaves, torch.autograd.grad(val, leaves, allow_unused=True))
                with torch.no_grad():
                    Ls.tril_()
                trace.append(val.detach())
            m, L = q.detach(), Ls.detach()
        self.set_raw_dict({k: v.detach() for k, v in hypers.items()})
        self._fit_write_back(m, L, whiten, eye)
        trace = torch.stack(trace).cpu().numpy() if trace else np.zeros(0)
        bad = np.flatnonzero(~np.isfinite(trace))
        if bad.size:
            warnings.warn(f"SVGP.fit: the ELBO is not finite from step {bad[0]} on",
                          RuntimeWarning, stacklevel=2)
        if messages and trace.size:
            print(f"SVGP fit: ELBO {trace[0]:.2f} -> {trace[-1]:.2f}")
        return trace
