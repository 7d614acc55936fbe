"""MCMC over model (hyper)parameters: HMC, HMC_shortcut, Metropolis_Hastings.

Counterpart of gpy_tpu/mcmc/__init__.py (GPy/inference/mcmc/hmc.py and
samplers.py). Sampling runs in the unconstrained optimizer space against
-objective (= logL + log prior); `jacobian_correction=True` adds the
log-Jacobian of the constraint transforms, as there. Samples come back in
constrained space: (num_samples, P), or (C, num_samples, P) for C chains.

The reference's `lax.scan` loops are Python loops here, and its
`jax.vmap` over chains is a batch dimension written out: C > 1 chains
evaluate logp and its gradient at all C states at once through the
model's batched objective (Model._batched_objective_and_grad), one batched
factorization per evaluation; one chain takes the unbatched objective. The
reference runs more than 8 chains in sequential groups of 8
(_CHAIN_GROUP), a workaround for the TPU compiler that it states is
bit-identical to the whole batch; here all C chains run as one batch.

Random numbers come from one torch.Generator on the CPU seeded from `seed`:
the jittered inits, then every step's momentum normals, then its uniforms,
drawn up front and moved to the model's device. They are not jax.random's
numbers. Each proposal is a deterministic function of (x, p0, log_u, eps)
(`_proposal`), so a test can hand it the reference's draws.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.model import value_and_grad

__all__ = ["HMC", "HMC_shortcut", "Metropolis_Hastings"]


def _free_blocks(model):
    """(offset, size, transform) of each free entry of the flat raw vector."""
    out, i = [], 0
    for _, mod, n in model._free_entries():
        sz = mod._parameters[n].numel()
        out.append((i, sz, mod._specs[n].transform))
        i += sz
    return out


def _dforward(transform, r: torch.Tensor) -> torch.Tensor:
    """d transform.forward / d raw, elementwise (the transforms are
    elementwise), differentiable when r requires grad."""
    with torch.enable_grad():
        x = r if r.requires_grad else r.detach().requires_grad_(True)
        y = transform.forward(x)
        return torch.autograd.grad(y.sum(), x, create_graph=r.requires_grad)[0]


def _logp_fn(model, jacobian_correction: bool):
    """logp(flat) = logL + log prior (+ sum log|d constrained / d raw|) at a
    (P,) raw vector (unbatched objective) or the rows of a (C, P) tensor
    (batched objective). gpy_tpu/mcmc/__init__.py:34-53."""

    def logp(flat):
        lp = -(model._flat_objective(flat) if flat.ndim == 1 else model._batched_objective(flat))
        if jacobian_correction:
            for i, sz, tr in _free_blocks(model):
                if tr is not None:
                    d = _dforward(tr, flat[..., i:i + sz])
                    lp = lp + torch.sum(torch.log(torch.abs(d) + 1e-300), dim=-1)
        return lp

    return logp


def _to_constrained(model, raw: torch.Tensor) -> np.ndarray:
    """Raw samples (..., P) to constrained parameter space, all parameters
    in one pass (gpy_tpu/mcmc/__init__.py:283-305)."""
    cols = []
    with torch.no_grad():
        for i, sz, tr in _free_blocks(model):
            block = raw[..., i:i + sz]
            cols.append(tr.forward(block) if tr is not None else block)
        return torch.cat(cols, dim=-1).cpu().numpy()


class HMC:
    """Hamiltonian Monte Carlo over model hyperparameters.

    HMC(model, stepsize=...).sample(num_samples) returns samples in
    constrained parameter space, (num_samples, P), or (C, num_samples, P)
    when num_chains = C > 1. GPy: hmc.py:30-65.
    """

    def __init__(self, model, M=None, stepsize: float = 0.1, num_leapfrog: int = 20,
                 jacobian_correction: bool = False):
        self.model = model
        self.stepsize = stepsize
        self.num_leapfrog = num_leapfrog
        x0 = model.get_flat_raw()
        self._user_M = M is not None
        if M is None:
            M = np.eye(x0.shape[0])
        self.M = torch.as_tensor(np.asarray(M, dtype=np.float64), dtype=x0.dtype, device=x0.device)
        self.Minv = torch.linalg.inv(self.M)
        self.M_chol = torch.linalg.cholesky(self.M)  # momenta are M_chol @ N(0, I)
        self._logp = _logp_fn(model, jacobian_correction)
        self._accept_rate = float("nan")

    def _check_mass_matrix(self, n):
        """Keep M consistent when the model's free-parameter count changed
        (fix/tie after construction): the default identity is rebuilt, a
        user's M of the wrong size raises (gpy_tpu/mcmc/__init__.py:81-95)."""
        if self.M.shape[0] == n:
            return
        if self._user_M:
            raise ValueError(
                f"mass matrix is {self.M.shape[0]}x{self.M.shape[0]} but the model now has "
                f"{n} free parameters; construct a new HMC with a matching M")
        self.M = self.Minv = self.M_chol = torch.eye(n, dtype=self.M.dtype, device=self.M.device)

    def _energy(self, v, p):
        return -v + 0.5 * torch.einsum("...i,ij,...j->...", p, self.Minv, p)

    def _proposal(self, x, p0, log_u, eps):
        """One proposal from x ((P,) or (C, P)) with momentum p0, log of the
        uniform draw log_u and step eps (shape x.shape[:-1]): Stoermer-Verlet
        with the (value, gradient) carried, 1 + num_leapfrog evaluations;
        a divergent trajectory (non-finite energy or state) is rejected.
        Returns (the next state, the acceptance probability).
        gpy_tpu/mcmc/__init__.py:105-137."""
        e = eps[..., None]
        v0, g0 = value_and_grad(self._logp, x)
        xx, pp, g, v = x, p0, g0, v0
        for _ in range(self.num_leapfrog):
            p_half = pp + 0.5 * e * g
            xx = xx + e * (p_half @ self.Minv.T)
            v, g = value_and_grad(self._logp, xx)
            pp = p_half + 0.5 * e * g
        H0, H1 = self._energy(v0, p0), self._energy(v, pp)
        diverged = ~(torch.isfinite(H1) & torch.isfinite(xx).all(dim=-1))
        log_accept = torch.where(diverged, torch.full_like(H1, -float("inf")),
                                 torch.clamp(H0 - H1, max=0.0))
        accept = log_u < log_accept
        return torch.where(accept[..., None], xx, x), torch.exp(log_accept)

    def sample(self, num_samples: int = 1000, hmc_iters=None, seed: int = 0,
               num_chains: int = 1, adapt_steps: int = 0, target_accept: float = 0.8,
               mesh=None):
        """Draw samples. GPy: hmc.py:30-59; gpy_tpu/mcmc/__init__.py:141-281.

        adapt_steps > 0 first runs dual-averaging step-size adaptation per
        chain (its draws are discarded). num_chains > 1 starts the chains at
        the model's point plus 0.01 N(0, I) and runs them as one batch.

        With `mesh` (a DeviceMesh of gpy_tpu_torch.parallel) the chains split
        over every axis of the mesh: each rank draws every chain's numbers
        from the one seed, runs its contiguous share of the chains as one
        batch and all_gathers the samples, so every rank returns the
        unsharded call's (C, num_samples, P) array. C must divide by the
        mesh's size."""
        num_samples = hmc_iters or num_samples
        x0 = self.model.get_flat_raw()
        P = x0.shape[0]
        self._check_mass_matrix(P)
        dt, dev = x0.dtype, x0.device
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        batch = () if num_chains == 1 else (num_chains,)
        x = x0
        if batch:
            x = x0[None, :] + 0.01 * torch.randn((num_chains, P), generator=gen,
                                                 dtype=dt).to(dev)
        steps = adapt_steps + num_samples
        z = torch.randn((steps, *batch, P), generator=gen, dtype=dt).to(dev)
        log_u = torch.log(torch.rand((steps, *batch), generator=gen, dtype=dt)).to(dev)
        p0 = z @ self.M_chol.T

        eps0 = torch.full(batch, float(self.stepsize), dtype=dt, device=dev)
        if mesh is not None:
            from ..parallel.mesh import check_device, shard_slice

            check_device(mesh, x0)
            _, lo, hi = shard_slice(mesh, num_chains, tuple(mesh.mesh_dim_names))
            if batch:
                x, p0, log_u, eps0 = x[lo:hi], p0[:, lo:hi], log_u[:, lo:hi], eps0[lo:hi]
        if adapt_steps > 0:
            x, eps = self._adapt(x, p0[:adapt_steps], log_u[:adapt_steps], eps0, target_accept)
        else:
            eps = eps0
        xs, accepts = [], []
        for t in range(adapt_steps, steps):
            x, a = self._proposal(x, p0[t], log_u[t], eps)
            xs.append(x)
            accepts.append(a)
        xs, accepts = torch.stack(xs), torch.stack(accepts)  # (S, [C,] P), (S, [C])
        if mesh is not None and batch:
            from ..parallel.mesh import all_gather_rows

            S = xs.shape[0]
            rows = torch.cat([xs.transpose(0, 1).reshape(xs.shape[1], -1), accepts.T], dim=1)
            rows = all_gather_rows(mesh, rows, tuple(mesh.mesh_dim_names))
            xs = rows[:, :S * P].reshape(num_chains, S, P).transpose(0, 1)
            accepts = rows[:, S * P:].T
        self._accept_rate = float(accepts.mean())
        samples = _to_constrained(self.model, xs)  # (S, [C,] P)
        return samples if not batch else np.ascontiguousarray(np.swapaxes(samples, 0, 1))

    def _adapt(self, x, p0, log_u, eps0, target_accept):
        """Dual averaging of each chain's step size over len(p0) warm-up
        proposals (gpy_tpu/mcmc/__init__.py:149-176); returns the last state
        and exp(log_eps_bar)."""
        gamma, t0, kappa = 0.05, 10.0, 0.75
        mu = torch.log(10.0 * eps0)
        log_eps_bar = torch.log(eps0)
        Hbar = torch.zeros_like(eps0)
        for i in range(p0.shape[0]):
            eps = torch.exp(mu - np.sqrt(i + 1.0) / gamma * Hbar)
            x, a = self._proposal(x, p0[i], log_u[i], eps)
            eta = 1.0 / (i + 1.0 + t0)
            Hbar = (1 - eta) * Hbar + eta * (target_accept - a)
            w = (i + 1.0) ** (-kappa)
            log_eps = mu - np.sqrt(i + 1.0) / gamma * Hbar
            log_eps_bar = w * log_eps + (1 - w) * log_eps_bar
        return x, torch.exp(log_eps_bar)


class HMC_shortcut(HMC):
    """HMC with trajectory shortcutting (GPy: mcmc/hmc.py HMC_shortcut:70-173).

    As in the reference, the leapfrog tracks the energy error and freezes a
    trajectory once |H - H0| exceeds Hstd_th[1]; a frozen trajectory is
    rejected (gpy_tpu/mcmc/__init__.py:342-404)."""

    def __init__(self, model, M=None, stepsize=0.1, num_leapfrog=20, groupsize=5,
                 Hstd_th=(1e-4, 3.0), jacobian_correction=False):
        super().__init__(model, M=M, stepsize=stepsize, num_leapfrog=num_leapfrog,
                         jacobian_correction=jacobian_correction)
        self.groupsize = groupsize
        self.Hstd_th = Hstd_th

    def _proposal(self, x, p0, log_u, eps):
        hi = self.Hstd_th[1]
        e = eps[..., None]
        v0, g0 = value_and_grad(self._logp, x)
        H0 = self._energy(v0, p0)
        xx, pp, g, v = x, p0, g0, v0
        frozen = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
        for _ in range(self.num_leapfrog):
            p_half = pp + 0.5 * e * g
            xx2 = xx + e * (p_half @ self.Minv.T)
            v2, g2 = value_and_grad(self._logp, xx2)
            pp2 = p_half + 0.5 * e * g2
            frozen = frozen | (torch.abs(self._energy(v2, pp2) - H0) > hi)
            f = frozen[..., None]
            xx, pp, g = torch.where(f, xx, xx2), torch.where(f, pp, pp2), torch.where(f, g, g2)
            v = torch.where(frozen, v, v2)
        H1 = self._energy(v, pp)
        diverged = frozen | ~(torch.isfinite(H1) & torch.isfinite(xx).all(dim=-1))
        log_accept = torch.where(diverged, torch.full_like(H1, -float("inf")),
                                 torch.clamp(H0 - H1, max=0.0))
        accept = log_u < log_accept
        return torch.where(accept[..., None], xx, x), torch.exp(log_accept)


class Metropolis_Hastings:
    """Random-walk MH in unconstrained space. GPy: samplers.py:17-82."""

    def __init__(self, model, cov=None, jacobian_correction: bool = False):
        self.model = model
        x0 = model.get_flat_raw()
        if cov is None:
            cov = np.eye(x0.shape[0])
        self.cov = torch.as_tensor(np.asarray(cov, dtype=np.float64), dtype=x0.dtype,
                                   device=x0.device)
        self._logp = _logp_fn(model, jacobian_correction)

    def sample(self, Ntotal: int = 10000, Nburn: int = 1000, Nthin: int = 10, seed: int = 0):
        """Ntotal proposals x + L z (L L' = cov); samples Nburn::Nthin, in
        constrained space (gpy_tpu/mcmc/__init__.py:318-339)."""
        x = self.model.get_flat_raw()
        dt, dev = x.dtype, x.device
        gen = torch.Generator(device="cpu").manual_seed(int(seed))
        steps = (torch.randn((Ntotal, x.shape[0]), generator=gen, dtype=dt).to(dev)
                 @ torch.linalg.cholesky(self.cov).T)
        log_u = torch.log(torch.rand((Ntotal,), generator=gen, dtype=dt)).to(dev)
        xs = []
        with torch.no_grad():
            lp = self._logp(x)
            for t in range(Ntotal):
                prop = x + steps[t]
                lp_prop = self._logp(prop)
                accept = log_u[t] < lp_prop - lp
                x = torch.where(accept, prop, x)
                lp = torch.where(accept, lp_prop, lp)
                xs.append(x)
        return _to_constrained(self.model, torch.stack(xs)[Nburn::Nthin])
