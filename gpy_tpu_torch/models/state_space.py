"""State-space (Kalman) GPs for 1-D inputs: O(N) exact inference.

Counterpart of gpy_tpu/models/state_space.py:37-589 (GPy/models/
state_space.py, state_space_main.py). A kernel supplies (F, L, Qc, H, Pinf[,
P0]) through sde() (kern/stationary.py, kern/sde.py); sums stack
block-diagonally and White summands fold exactly into the observation noise.
The model discretizes once, batched over the N-1 gaps (A = expm(F dt), Q =
Pinf - A Pinf A' for a stationary block, the Van Loan integral for a
nonstationary one or for every block when stable), and runs one of four
engines, all giving the dense GP's NLML:

- the sequential filter (`_filter`): one torch step per time point, its few
  operations on (s x s) tensors, no read back to the host; autograd through
  the loop gives the gradient;
- the chunked-hybrid parallel filter (`_filter_parallel`): C ~ 2 sqrt(N)
  chunks, element composition within chunks batched over them, a short
  loop over the chunk totals, then the plain recursion batched over the
  chunks from their entry states; ~2N/C + C steps in a row instead of N;
- the square-root filter (`stable`): QR array updates of a factor S with
  P = S S', PSD by construction;
- the C++ engine (`engine="cpp"`, ops/kalman_cpp.py): the sequential filter
  on the host in float64, for evaluation; the gradient paths (optimize,
  checkgrad, HMC) run the sequential filter instead, as in the reference.

The loops branch on host data only (the observed mask is numpy), and the
solves and factorizations are the *_ex forms, which read no status back: an
evaluation synchronizes with the host only to return its value.
"""
from __future__ import annotations

import contextlib
import inspect

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..core.model import Model
from ..core.transformations import Logexp
from ..kern import Add, Kern, Matern32, White
from ..util.linalg import block_diag, cholesky_or_nan, expm_safe

__all__ = ["StateSpace", "combined_sde", "sde_parts"]

LOG_2_PI = float(np.log(2 * np.pi))


def sde_parts(kern: Kern, t0=0.0):
    """Flatten a (possibly summed) kernel into SDE blocks.

    Returns ``(parts, white_var)``, each part ``(F, L, Qc, H, Pinf, P0,
    stationary)``. A 5-tuple sde() is stationary (P0 = Pinf); a 6-tuple with
    its own P0 is not (Linear, Brownian), and its sde() takes the first
    filter time t0. White summands have no state: their variance adds to the
    observation noise. gpy_tpu/models/state_space.py:37-69."""
    if isinstance(kern, Add):
        parts, white = [], 0.0
        for p in kern.parts:
            ps, w = sde_parts(p, t0)
            parts.extend(ps)
            white = white + w
        return parts, white
    if isinstance(kern, White):
        return [], kern.variance.values
    tup = kern.sde(t0=t0) if "t0" in inspect.signature(kern.sde).parameters else kern.sde()
    if len(tup) == 5:
        F, L, Qc, H, Pinf = tup
        return [(F, L, Qc, H, Pinf, Pinf, True)], 0.0
    F, L, Qc, H, Pinf, P0 = tup
    return [(F, L, Qc, H, Pinf, P0, False)], 0.0


def combined_sde(kern: Kern, t0=0.0):
    """(F, L, Qc, H, Pinf, P0) of a kernel, sums stacked block-diagonally,
    White summands left out. gpy_tpu/models/state_space.py:72-87."""
    parts, _ = sde_parts(kern, t0)
    if not parts:
        raise ValueError("kernel has no SDE state (White-only kernel?)")
    F, L, Qc, H, Pinf, P0, _ = zip(*parts)
    return (block_diag(*F), block_diag(*L), block_diag(*Qc), torch.cat(H, dim=1),
            block_diag(*Pinf), block_diag(*P0))


def _van_loan(F, LQcLt, dts):
    """A = expm(F dt) and Q = int_0^dt e^{Fs} L Qc L' e^{F's} ds for each dt
    of `dts` (N-1,), by the Van Loan (1978) block-matrix exponential: exact
    for any LTI SDE, stationary or not."""
    s = F.shape[0]
    M = torch.cat([torch.cat([-F, LQcLt], dim=1),
                   torch.cat([torch.zeros_like(F), F.T], dim=1)], dim=0)
    Phi = expm_safe(M * dts[:, None, None])
    A = Phi[:, s:, s:].transpose(-1, -2)
    Q = A @ Phi[:, :s, s:]
    return A, 0.5 * (Q + Q.transpose(-1, -2))


def _solve(A, B):
    """A^-1 B without reading LU's status back to the host; a singular A
    gives non-finite entries, as jnp.linalg.solve does."""
    return torch.linalg.solve_ex(A, B)[0]


def _combine(ei, ej):
    """Associative composition of two filtering elements, i before j
    (Sarkka and Garcia-Fernandez 2020), batched over leading dimensions."""
    Ai, bi, Ci, etai, Ji = ei
    Aj, bj, Cj, etaj, Jj = ej
    I = torch.eye(Ai.shape[-1], dtype=Ai.dtype, device=Ai.device)
    # A_j (I + C_i J_j)^-1 == solve((I + C_i J_j)', A_j')'
    AjM = _solve((I + Ci @ Jj).transpose(-1, -2), Aj.transpose(-1, -2)).transpose(-1, -2)
    A_new = AjM @ Ai
    b_new = AjM @ (bi + Ci @ etaj) + bj
    C_new = AjM @ Ci @ Aj.transpose(-1, -2) + Cj
    # one LU of I + J_j C_i for both of its right-hand sides
    W = _solve(I + Jj @ Ci, torch.cat([etaj - Jj @ bi, Jj @ Ai], dim=-1))
    AiT = Ai.transpose(-1, -2)
    eta_new = AiT @ W[..., :1] + etai
    J_new = AiT @ W[..., 1:] + Ji
    return A_new, b_new, C_new, eta_new, J_new


def _apply(state, e):
    """_combine of a filtered state, the element (0, m, P, 0, 0), with e: the
    filtered state at e's end. Only (m, P) of the result are nonzero."""
    m, P = state
    Aj, bj, Cj, etaj, Jj = e
    I = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
    AjM = _solve((I + P @ Jj).transpose(-1, -2), Aj.transpose(-1, -2)).transpose(-1, -2)
    return AjM @ (m + P @ etaj) + bj, AjM @ P @ Aj.transpose(-1, -2) + Cj


def _predict(m, P, A_k, Q_k):
    """One prediction: A m and the symmetrized A P A' + Q, any batch."""
    P = A_k @ P @ A_k.transpose(-1, -2) + Q_k
    return A_k @ m, 0.5 * (P + P.transpose(-1, -2))


def _update(m, P, H, y, sigma2):
    """One scalar measurement update of (m, P), any batch: the updated (m, P)
    and the innovation's variance S and value v. P is symmetric, so H P is
    (P H')'."""
    PHt = P @ H.T
    S = H @ PHt + sigma2
    v = y - H @ m
    K = PHt / S
    return m + K * v, P - K @ PHt.transpose(-1, -2), S, v


def _log_lik(S, v):
    return -0.5 * torch.sum(LOG_2_PI + torch.log(S) + v * v / S)


class StateSpace(Model):
    """Kalman-filter GP regression on sorted 1-D inputs.

    engine: "scan" (the torch filters, differentiable) or "cpp" (the C++
    filter on the host, float64, value only: log_likelihood and predict;
    the gradient paths run the sequential filter). parallel: the
    chunked-hybrid filter, `parallel_chunks` chunks (default ~2 sqrt(N),
    at most 256, the reference's count). stable: the square-root filter,
    sequential, Van Loan for every block. X and Y are numpy; the model
    keeps them sorted by X on `device` in `dtype`.
    """

    def __init__(self, X, Y, kernel=None, noise_var=1.0, parallel=False, engine="scan",
                 stable=False, parallel_chunks=None, name="StateSpace", device=None, dtype=None):
        super().__init__(name=name, device=device, dtype=dtype)
        if engine not in ("scan", "cpp"):
            raise ValueError(f"engine must be 'scan' or 'cpp', not {engine!r}")
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        X = np.asarray(X, dtype=np.float64).reshape(-1)
        Y = np.asarray(Y, dtype=np.float64).reshape(-1, 1)
        order = np.argsort(X)
        self._X_np, self._Y_np = X[order], Y[order]
        self.X = torch.tensor(self._X_np, dtype=self.dtype, device=self.device)
        self.Y = torch.tensor(self._Y_np, dtype=self.dtype, device=self.device)
        self.num_data = X.shape[0]
        self.kern = kernel or Matern32(1, device=device, dtype=dtype)
        self.parallel = bool(parallel)
        self.parallel_chunks = parallel_chunks
        self.stable = bool(stable)
        self.engine = engine
        self._add_param("noise_var", noise_var, transform=Logexp())

    # --- discretization ---------------------------------------------------
    def _ssm(self, times):
        """(H, P0, A, Q, sigma2) over the time grid, A and Q (N-1, s, s).
        Stationary blocks take Q = Pinf - A Pinf A', nonstationary ones the
        Van Loan integral, which stays finite where Pinf does not exist.
        stable takes Van Loan for every block: in float32 the shortcut's
        difference of O(variance) matrices loses Q when dt << lengthscale."""
        parts, white = sde_parts(self.kern, t0=times[0])
        if not parts:
            raise ValueError("kernel has no SDE state (White-only kernel?)")
        dts = torch.diff(times)
        As, Qs = [], []
        for F, L, Qc, _H, Pinf, _P0, stationary in parts:
            if stationary and not self.stable:
                Ap = expm_safe(F * dts[:, None, None])
                Qp = Pinf - Ap @ Pinf @ Ap.transpose(-1, -2)
            else:
                Ap, Qp = _van_loan(F, L @ Qc @ L.T, dts)
            As.append(Ap)
            Qs.append(Qp)
        if len(parts) == 1:
            A, Q = As[0], Qs[0]
        else:
            sizes = [a.shape[-1] for a in As]
            s = sum(sizes)
            A = times.new_zeros((dts.shape[0], s, s))
            Q = times.new_zeros((dts.shape[0], s, s))
            off = 0
            for Ap, Qp, sp in zip(As, Qs, sizes):
                A[:, off:off + sp, off:off + sp] = Ap
                Q[:, off:off + sp, off:off + sp] = Qp
                off += sp
        H = torch.cat([p[3] for p in parts], dim=1)
        P0 = block_diag(*[p[5] for p in parts])
        return H, P0, A, Q, self.noise_var.values + white

    # --- engines ----------------------------------------------------------
    def _filter(self, times, ys, obs_mask=None):
        """The sequential filter. obs_mask: None (all observed) or a numpy
        bool array (False: predict only). Returns (logL, filtered means (N,
        s, 1) and covariances, one-step predictions, A, H)."""
        H, P0, A, Q, sigma2 = self._ssm(times)
        n, s = ys.shape[0], P0.shape[0]
        mask = np.ones(n, dtype=bool) if obs_mask is None else np.asarray(obs_mask, dtype=bool)
        sig = sigma2.reshape(1, 1)
        ysk = ys.reshape(n, 1, 1).unbind(0)
        Ak, Qk = A.unbind(0), Q.unbind(0)
        m, P = times.new_zeros((s, 1)), P0
        ms, Ps, mpreds, Ppreds, Ss, vs = [], [], [], [], [], []
        for k in range(n):
            if k > 0:
                m, P = _predict(m, P, Ak[k - 1], Qk[k - 1])
            mpreds.append(m)
            Ppreds.append(P)
            if mask[k]:
                m, P, S, v = _update(m, P, H, ysk[k], sig)
                Ss.append(S)
                vs.append(v)
            ms.append(m)
            Ps.append(P)
        logL = _log_lik(torch.stack(Ss), torch.stack(vs)) if Ss else sigma2.new_zeros(())
        return (logL, torch.stack(ms), torch.stack(Ps), torch.stack(mpreds), torch.stack(Ppreds),
                A, H)

    def _filter_parallel(self, times, ys, obs_mask=None):
        """The chunked-hybrid temporal-parallel filter
        (gpy_tpu/models/state_space.py:194-344):

          1. batched over C chunks, compose the per-step affine elements
             within each chunk (L = N/C steps) into one per chunk;
          2. a loop over the C chunk totals gives the exact filtered state
             entering each chunk;
          3. batched over chunks, the plain recursion within each chunk from
             its entry state.

        Exact in exact arithmetic. Steps past N pad the last chunks with
        identity steps. Returns the same tuple as `_filter`."""
        n = ys.shape[0]
        if n < 2:
            return self._filter(times, ys, obs_mask)
        H, P0, A, Q, sigma2 = self._ssm(times)
        s, dt, dev = P0.shape[0], times.dtype, times.device
        eyeS = torch.eye(s, dtype=dt, device=dev)
        observed = None if obs_mask is None else torch.as_tensor(
            np.asarray(obs_mask, dtype=bool), device=dev)

        # per-step elements (Sarkka and Garcia-Fernandez eq. 10-12)
        y = ys[1:, None, None]
        S = H @ Q @ H.T + sigma2
        K = (Q @ H.T) / S
        IKH = eyeS - K @ H
        HA = H @ A
        els = [IKH @ A, K * y, IKH @ Q, HA.transpose(-1, -2) / S * y,
               HA.transpose(-1, -2) @ HA / S]
        if observed is not None:  # an unobserved step is a pure prediction
            o = observed[1:, None, None]
            pred = [A, torch.zeros_like(els[1]), Q, torch.zeros_like(els[3]),
                    torch.zeros_like(els[4])]
            els = [torch.where(o, e, p) for e, p in zip(els, pred)]

        m0 = times.new_zeros((s, 1))
        m1, P1, S1, v1 = _update(m0, P0, H, ys[:1, None], sigma2.reshape(1, 1))
        if observed is not None and not bool(obs_mask[0]):
            m1, P1 = m0, P0

        # chunking: steps 2..N, padded with identity steps
        n_el = n - 1
        C = self.parallel_chunks or max(1, min(256, int(np.sqrt(max(n_el, 1)) * 2)))
        C = min(C, max(n_el, 1))
        L = -(-n_el // C)
        pad = C * L - n_el
        ident = [eyeS, times.new_zeros((s, 1)), times.new_zeros((s, s)),
                 times.new_zeros((s, 1)), times.new_zeros((s, s))]

        def chunked(a, fill):
            return torch.cat([a, fill.expand((pad,) + fill.shape)]).reshape((C, L) + fill.shape)

        elsC = [chunked(e, i) for e, i in zip(els, ident)]

        # phase 1: within-chunk composition -> chunk totals
        tot = [e[:, 0] for e in elsC]
        for j in range(1, L):
            tot = _combine(tot, [e[:, j] for e in elsC])

        # phase 2: the filtered state entering each chunk
        state, starts = (m1, P1), []
        for c in range(C):
            starts.append(state)
            state = _apply(state, [t[c] for t in tot])
        m_st = torch.stack([st[0] for st in starts])
        P_st = torch.stack([st[1] for st in starts])

        # phase 3: the plain recursion within each chunk from its entry state
        A_c = chunked(A, eyeS)
        Q_c = chunked(Q, ident[2])
        y_c = chunked(ys[1:, None, None], times.new_zeros((1, 1)))
        obs = torch.arange(C * L, device=dev) < n_el
        if observed is not None:
            obs = obs & torch.cat([observed[1:], observed.new_zeros(pad)])
        obs_c = obs.reshape(C, L, 1, 1)
        sig = sigma2.reshape(1, 1)
        m, P = m_st, P_st
        outs = []
        for j in range(L):
            mp, Pp = _predict(m, P, A_c[:, j], Q_c[:, j])
            mu, Pu, Sj, vj = _update(mp, Pp, H, y_c[:, j], sig)
            m = torch.where(obs_c[:, j], mu, mp)
            P = torch.where(obs_c[:, j], Pu, Pp)
            outs.append((m, P, mp, Pp, Sj, vj))
        ms3, Ps3, mp3, Pp3, S3, v3 = (torch.stack(o, dim=1) for o in zip(*outs))

        def flat(a):
            return a.reshape((C * L,) + a.shape[2:])[:n_el]

        lls = -0.5 * (LOG_2_PI + torch.log(S3) + v3 * v3 / S3)
        ll1 = -0.5 * (LOG_2_PI + torch.log(S1) + v1 * v1 / S1).reshape(())
        if observed is not None and not bool(obs_mask[0]):
            ll1 = torch.zeros_like(ll1)
        logL = ll1 + torch.sum(torch.where(obs_c, lls, torch.zeros_like(lls)))
        ms = torch.cat([m1[None], flat(ms3)])
        Ps = torch.cat([P1[None], flat(Ps3)])
        mpreds = torch.cat([m0[None], flat(mp3)])
        Ppreds = torch.cat([P0[None], flat(Pp3)])
        return logL, ms, Ps, mpreds, Ppreds, A, H

    def _filter_sqrt(self, times, ys, obs_mask=None):
        """The square-root (QR array) filter: propagates S with P = S S', PSD
        by construction (gpy_tpu/models/state_space.py:388-467; GPy's
        SVD-stabilized update, state_space_main.py:1894, exists for the same
        reason). Scalar observations, Kailath's array algorithm:

          predict: qr([S' A'; Qs'])            -> S_pred
          update:  qr([sqrt(r) 0; S'H' S']')   -> [sqrt(Sy) 0; K sqrt(Sy) S_new]

        R comes from the reduced QR where a gradient is recorded (mode="r"
        has no backward) and from mode="r" where none is; the row signs of R
        cancel in every quantity taken from it. The square roots of P0
        and Q are jittered Cholesky factors (eigh's gradient is NaN at the
        repeated eigenvalues of a near-zero Q), NaN where one fails. Returns
        the same tuple as `_filter`, covariances rebuilt as S S'."""
        H, P0, A, Q, sigma2 = self._ssm(times)
        n, s, dt = ys.shape[0], P0.shape[0], times.dtype
        mask = np.ones(n, dtype=bool) if obs_mask is None else np.asarray(obs_mask, dtype=bool)
        eps = 1e-12 if dt == torch.float64 else 1e-6
        eyeS = torch.eye(s, dtype=dt, device=times.device)

        def psd_sqrt(M):
            d = torch.clamp_min(torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) / s, 1e-30)
            return cholesky_or_nan(M + (eps * d)[..., None, None] * eyeS)

        S0, sqrtQ = psd_sqrt(P0), psd_sqrt(Q).unbind(0)
        sqrt_r = torch.sqrt(sigma2).reshape(1, 1)
        zcol = times.new_zeros((s, 1))
        ysk = ys.reshape(n, 1, 1).unbind(0)
        Ak = A.unbind(0)
        qr_mode = "reduced" if torch.is_grad_enabled() else "r"

        def update(m_pred, S_pred, y):
            pre = torch.cat([torch.cat([sqrt_r, H @ S_pred], dim=1),
                             torch.cat([zcol, S_pred], dim=1)], dim=0)
            post = torch.linalg.qr(pre.T, mode=qr_mode).R.T
            Sy = post[:1, :1] ** 2
            v = y - H @ m_pred
            K = post[1:, :1] / post[:1, :1]
            return m_pred + K * v, post[1:, 1:], Sy, v

        m, Sf = times.new_zeros((s, 1)), S0
        ms, Ss, mpreds, Spreds, Sys, vs = [], [], [], [], [], []
        for k in range(n):
            if k > 0:
                m = Ak[k - 1] @ m
                pre = torch.cat([Sf.T @ Ak[k - 1].T, sqrtQ[k - 1].T], dim=0)
                Sf = torch.linalg.qr(pre, mode=qr_mode).R.T
            mpreds.append(m)
            Spreds.append(Sf)
            if mask[k]:
                m, Sf, Sy, v = update(m, Sf, ysk[k])
                Sys.append(Sy)
                vs.append(v)
            ms.append(m)
            Ss.append(Sf)
        logL = _log_lik(torch.stack(Sys), torch.stack(vs)) if Sys else sigma2.new_zeros(())
        Ss, Spreds = torch.stack(Ss), torch.stack(Spreds)
        return (logL, torch.stack(ms), Ss @ Ss.transpose(-1, -2), torch.stack(mpreds),
                Spreds @ Spreds.transpose(-1, -2), A, H)

    def _smooth(self, ms, Ps, mpreds, Ppreds, A):
        """The RTS smoother, a loop backwards over the filter's outputs
        (GPy: state_space_main.py rts_smoother). Its gains G_k = P_f,k A_k'
        P_pred,k+1^-1 depend on the filter only: one batched Cholesky solve
        before the loop (NaN where a jittered P_pred is not positive
        definite), which then carries (m_s, P_s) alone."""
        n = ms.shape[0]
        if n == 1:
            return ms, Ps
        eyeS = torch.eye(Ps.shape[-1], dtype=Ps.dtype, device=Ps.device)
        Lp = cholesky_or_nan(Ppreds[1:] + 1e-12 * eyeS)
        G = torch.cholesky_solve(A @ Ps[:-1].transpose(-1, -2), Lp).transpose(-1, -2)
        Gk, msk, Psk = G.unbind(0), ms.unbind(0), Ps.unbind(0)
        mpk, Ppk = mpreds.unbind(0), Ppreds.unbind(0)
        m_s, P_s = msk[-1], Psk[-1]
        out_m, out_P = [m_s], [P_s]
        for k in range(n - 2, -1, -1):
            m_s = msk[k] + Gk[k] @ (m_s - mpk[k + 1])
            P_s = Psk[k] + Gk[k] @ (P_s - Ppk[k + 1]) @ Gk[k].T
            out_m.append(m_s)
            out_P.append(P_s)
        return torch.stack(out_m[::-1]), torch.stack(out_P[::-1])

    def _filter_cpp(self, times, ys, obs_mask=None):
        """The C++ filter (csrc/kalman.cpp) on the host in float64: logL as a
        tensor without a gradient, the rest as numpy."""
        from ..ops import kalman_cpp

        with torch.no_grad():
            H, P0, A, Q, sigma2 = self._ssm(times)
        n = ys.shape[0]
        mask = np.ones(n, dtype=bool) if obs_mask is None else np.asarray(obs_mask, dtype=bool)
        host = [t.detach().cpu().numpy().astype(np.float64) for t in (A, Q, H, ys, P0, sigma2)]
        A_np, Q_np, H_np, y_np, P0_np, s2 = host
        logL, ms, Ps, mpreds, Ppreds = kalman_cpp.kalman_filter(A_np, Q_np, H_np, y_np, mask,
                                                               P0_np, float(s2))
        return (torch.tensor(logL, dtype=times.dtype, device=times.device), ms, Ps, mpreds,
                Ppreds, A_np, H_np)

    def _pick_filter(self):
        if self.engine == "cpp":
            return self._filter_cpp
        if self.stable:
            return self._filter_sqrt
        return self._filter_parallel if self.parallel else self._filter

    # --- Model interface --------------------------------------------------
    def log_likelihood(self) -> torch.Tensor:
        return self._pick_filter()(self.X, self.Y[:, 0])[0]

    @contextlib.contextmanager
    def _differentiable_engine(self):
        """Inside the block engine="cpp" reads as "scan": the C++ filter has
        no gradient, so the objective that is differentiated (optimize,
        checkgrad, HMC) runs the torch filter the other options pick
        (gpy_tpu/models/state_space.py:518-525)."""
        engine = self.engine
        self.engine = "scan"
        try:
            yield
        finally:
            self.engine = engine

    def _flat_objective(self, flat):
        with self._differentiable_engine():
            return super()._flat_objective(flat)

    def _objective_and_grad(self, flat):
        with self._differentiable_engine():
            return super()._objective_and_grad(flat)

    def predict(self, Xnew, include_likelihood=True):
        """Mean and variance at Xnew (numpy, (N*, 1)): filter and smooth over
        the training and new times merged and stably sorted, the new rows
        unobserved; White summands add to the variance, and the noise too
        when include_likelihood. GPy: state_space.py predict."""
        Xnew = np.asarray(Xnew, dtype=np.float64).reshape(-1)
        Xtr = self._X_np
        allX = np.concatenate([Xtr, Xnew])
        order = np.argsort(allX, kind="stable")
        inv = np.argsort(order)
        mask = np.concatenate([np.ones(Xtr.shape[0], dtype=bool),
                               np.zeros(Xnew.shape[0], dtype=bool)])[order]
        c = dict(dtype=self.dtype, device=self.device)
        times = torch.tensor(allX[order], **c)
        ys = torch.tensor(np.concatenate([self._Y_np[:, 0], np.zeros_like(Xnew)])[order], **c)
        with torch.no_grad():
            _, white = sde_parts(self.kern, t0=times[0])
            extra = white + (self.noise_var.values if include_likelihood else 0.0)
            if self.engine == "cpp":
                from ..ops import kalman_cpp

                _, ms, Ps, mpreds, Ppreds, A, H = self._filter_cpp(times, ys, mask)
                ms_s, Ps_s = kalman_cpp.rts_smoother(ms, Ps, mpreds, Ppreds, A)
                mu = (H.reshape(1, -1) @ ms_s)[:, 0, 0]
                var = np.einsum("j,njk,k->n", H.reshape(-1), Ps_s, H.reshape(-1))
                var = var + float(torch.as_tensor(extra))
            else:
                _, ms, Ps, mpreds, Ppreds, A, H = self._pick_filter()(times, ys, mask)
                ms_s, Ps_s = self._smooth(ms, Ps, mpreds, Ppreds, A)
                mu_t = (H @ ms_s)[:, 0, 0]
                var_t = (H @ Ps_s @ H.T)[:, 0, 0] + extra
                mu, var = torch.stack([mu_t, var_t]).cpu().numpy()
        n = Xtr.shape[0]
        mu, var = mu[inv][n:], var[inv][n:]
        return mu.reshape(-1, 1), np.maximum(var, 1e-12).reshape(-1, 1)
