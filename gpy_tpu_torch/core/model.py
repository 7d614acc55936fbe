"""Model base: objective = -log_likelihood - log_prior, optimizers, checkgrad.

Counterpart of gpy_tpu/core/model.py. The objective is evaluated eagerly:
the flat raw vector is written into the parameters, the loss is computed,
and torch.autograd returns the gradient of the free parameters in flat
order. Each evaluation syncs with the host once for the value and once for
the gradient. scipy drives the host-side loop, as in GPy.

The reference's `jax.vmap(jax.value_and_grad(_flat_objective))` over C raw
vectors is `_batched_objective_and_grad`: each row is bound to the
parameters in turn (Module.bind_flat_raw); a model with a batched form
evaluates all C objectives with one batched factorization, any other
evaluates its rows one after the other. It carries
`optimize_restarts(parallel=True)` and the HMC chains (mcmc). torch.func
.vmap cannot run it: the jitter ladder branches on the host and the kernels
launch through ctypes.
"""
from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import torch

from .module import Module
from .optim import LBFGS, optax_rule

__all__ = ["Model", "OptimizationResult", "value_and_grad"]

_SCIPY_METHODS = {"lbfgsb": "L-BFGS-B", "bfgs": "BFGS", "tnc": "TNC",
                  "lbfgs": "L-BFGS-B", "simplex": "Nelder-Mead",
                  "neldermead": "Nelder-Mead"}
_OPTAX = ("adam", "adagrad", "rmsprop", "adadelta", "rprop")


def value_and_grad(fn, x: torch.Tensor):
    """(fn(x), d sum(fn(x)) / dx) as detached tensors, x of shape (P,) or
    (C, P). Where row c of fn(x) depends on row c of x only (the batched
    objective, the samplers' logp), the gradient of the sum is every row's
    own gradient."""
    x = x.detach().requires_grad_(True)
    v = fn(x)
    return v.detach(), torch.autograd.grad(v.sum(), x)[0]


def _adam(x, step_size: float) -> torch.optim.Adam:
    """optax.adam(step_size) of the reference: b1 0.9, b2 0.999, eps 1e-8
    outside the square root, bias-corrected. torch.optim.Adam computes the
    same update, -lr m_hat / (sqrt(v_hat) + eps), elementwise, so on a
    (R, P) leaf each row is an independent Adam run. x is one leaf or a
    list of them (optax over a tuple of arrays)."""
    leaves = [x] if torch.is_tensor(x) else list(x)
    return torch.optim.Adam(leaves, lr=step_size, betas=(0.9, 0.999), eps=1e-8)


def _rule_stepper(optimizer, x, step_size):
    """x, g -> the next x under optax.<optimizer>(step_size), with the state
    kept in the closure. Adam is torch.optim.Adam (the same rule as
    optax.adam, `_adam`); the others are core/optim.py's."""
    if optimizer == "adam":
        leaf = x.detach().clone().requires_grad_(True)
        opt = _adam(leaf, step_size)

        def step(x, g):
            leaf.grad = g
            opt.step()
            return leaf.detach().clone()

        return step
    rule = optax_rule(optimizer, step_size)
    state = [rule.init(x)]

    def step(x, g):
        u, state[0] = rule.update(g, state[0])
        return x + u

    return step


class OptimizationResult:
    """n_evals and host_syncs, where a loop counts them: objective
    evaluations and the reads its decisions made back to the host."""

    def __init__(self, x_opt, f_opt, status, n_iters, success, n_evals=None, host_syncs=None):
        self.x_opt = x_opt
        self.f_opt = f_opt
        self.status = status
        self.n_iters = n_iters
        self.success = success
        self.n_evals = n_evals
        self.host_syncs = host_syncs

    def __repr__(self):
        return f"<OptimizationResult f_opt={self.f_opt:.6g} iters={self.n_iters} status={self.status!r}>"


class Model(Module):
    """Base for all trainable models."""

    # --- interface --------------------------------------------------------
    def log_likelihood(self) -> torch.Tensor:
        raise NotImplementedError

    def objective_function(self) -> torch.Tensor:
        """-logL - log_prior. GPy: core/model.py:96-108."""
        return -self.log_likelihood() - self.log_prior()

    def objective_function_gradients(self) -> np.ndarray:
        """Gradient in unconstrained optimizer space at the current values."""
        return self._objective_and_grad(self.get_flat_raw())[1]

    def _objective_and_grad(self, flat):
        """(objective, flat gradient) at the raw vector `flat`, as a float and
        a float64 numpy array. Leaves the model's parameters at `flat`."""
        self.set_flat_raw(flat)
        params = self._free_parameters()
        obj = self.objective_function()
        if not params:
            return float(obj.item()), np.zeros(0)
        grads = torch.autograd.grad(obj, params, allow_unused=True)
        g = torch.cat([
            (torch.zeros_like(p) if gp is None else gp).reshape(-1)
            for p, gp in zip(params, grads)])
        return float(obj.item()), g.cpu().numpy().astype(np.float64)

    # --- objective at raw vectors, unbatched and batched ------------------
    def _flat_objective(self, flat: torch.Tensor) -> torch.Tensor:
        """The objective at the raw vector `flat`, differentiable with
        respect to it; the model's parameters are left as they were."""
        with self.bind_flat_raw(flat):
            return self.objective_function()

    def _batched_objective(self, flats: torch.Tensor) -> torch.Tensor:
        """(C,) objectives at the rows of the (C, P) raw tensor `flats`, row
        c differentiable with respect to row c only. Here the rows are
        evaluated one after the other through `_flat_objective`, which is
        what the reference's vmap computes for any model; GP and SparseGP
        stack their rows' factorizations instead."""
        return torch.stack([self._flat_objective(row) for row in flats])

    def _batched_objective_and_grad(self, flats: torch.Tensor):
        """((C,) objectives, (C, P) gradient) at the rows of `flats`: the
        reference's vmap(value_and_grad(_flat_objective)) (core/model.py:
        61-63, 425-435). The C objectives are summed and one
        torch.autograd.grad returns every row's gradient."""
        return value_and_grad(self._batched_objective, flats)

    # --- optimization -----------------------------------------------------
    def optimize(
        self,
        optimizer: str = "lbfgsb",
        max_iters: int = 1000,
        messages: bool = False,
        gtol: float = 1e-8,
        ftol: float = 2.2e-14,
        step_size: float = 1e-2,
        **kwargs,
    ):
        """Maximize the (penalized) marginal likelihood.

        optimizer: 'lbfgsb' | 'bfgs' | 'tnc' | 'simplex' (Nelder-Mead) |
        'scg' (Moller scaled conjugate gradients) | 'lbfgs_device' (optax.lbfgs
        with its zoom line search, state on the device) | 'adam' | 'adagrad'
        | 'rmsprop' | 'adadelta' | 'rprop' (optax's rules at `step_size`,
        core/optim.py).
        """
        self._optimization_hooks("on_optimization_start")
        try:
            if optimizer in _OPTAX:
                return self._optimize_optax(optimizer, max_iters, step_size, messages)
            if optimizer == "lbfgs_device":
                return self._optimize_lbfgs_device(max_iters, messages, gtol)
            if optimizer == "scg":
                return self._optimize_scg(max_iters, messages, gtol, ftol)
            return self._optimize_scipy(optimizer, max_iters, messages, gtol, ftol)
        finally:
            self._optimization_hooks("on_optimization_end")

    def _optimization_hooks(self, name):
        """Call `name` on every submodule that has it (gpy_tpu/core/model.py:
        108-125): the likelihoods and kernels of the tree, not the model."""
        for m in self.modules():
            hook = getattr(m, name, None)
            if hook is not None and m is not self:
                hook()

    def _optimize_optax(self, optimizer, max_iters, step_size, messages):
        """gpy_tpu/core/model.py:311-355: max_iters steps of optax's rule;
        f_opt is the objective at the last step's start, as the reference
        returns it. The loop reads nothing back to the host."""
        x = self.get_flat_raw().clone()
        v = torch.tensor(float("inf"))
        step = _rule_stepper(optimizer, x, step_size)
        for it in range(max_iters):
            v, g = value_and_grad(self._flat_objective, x)
            x = step(x, g)
            if messages and (it + 1) % 100 == 0:
                print(f"  iter {it + 1:5d}  obj {float(v):.6f}")
        self.set_flat_raw(x.detach())
        return OptimizationResult(x.detach().cpu().numpy(), float(v), f"{optimizer} finished",
                                  max_iters, True, n_evals=max_iters, host_syncs=0)

    def _optimize_lbfgs_device(self, max_iters, messages, gtol):
        """gpy_tpu/core/model.py:249-309: optax.lbfgs while
        it < max_iters and max|g| > gtol, g the gradient at the iterate the
        update starts from (the line search's last, read back from its
        state). A result that is not finite falls back to the start point.
        The stop test and the line search read the host once an evaluation
        (LBFGS.host_syncs)."""
        fn = self._flat_objective

        def vg(x):
            return value_and_grad(fn, x)

        x0 = self.get_flat_raw().clone()
        opt = LBFGS().init(x0)
        x, it, gmax = x0, 0, math.inf
        while it < max_iters and gmax > gtol:
            if math.isfinite(opt.value):
                v, g, gmax = opt.value, opt.grad, opt.max_abs_grad
            else:
                vt, g = vg(x)
                opt.evaluations += 1
                v, gmax = torch.stack([vt, torch.max(torch.abs(g))]).tolist()
                opt.host_syncs += 1
            x = opt.step(x, v, g, vg, gmax)
            it += 1
        with torch.no_grad():
            v = fn(x).item()
            if not math.isfinite(v):
                x, v = x0, fn(x0).item()
        self.set_flat_raw(x)
        if messages:
            print(f"lbfgs_device finished: f={v:.6f} after {it} iters (max|g|={gmax:.2e})")
        return OptimizationResult(x.cpu().numpy(), v,
                                  "converged" if gmax <= gtol else "max_iters", it, True,
                                  n_evals=opt.evaluations + 1, host_syncs=opt.host_syncs + 1)

    def _optimize_scipy(self, optimizer, max_iters, messages, gtol, ftol):
        import scipy.optimize

        if optimizer not in _SCIPY_METHODS:
            raise ValueError(
                f"unknown optimizer {optimizer!r}; choose from "
                f"{sorted(_SCIPY_METHODS) + ['scg', 'lbfgs_device', *_OPTAX]}")
        n_evals = [0]
        t0 = time.time()

        def fg(x):
            n_evals[0] += 1
            v, g = self._objective_and_grad(x)
            # a non-finite objective (failed Cholesky) makes scipy back off
            if not np.isfinite(v):
                return 1e100, np.zeros_like(g)
            g = np.nan_to_num(g, nan=0.0, posinf=1e10, neginf=-1e10)
            if messages and n_evals[0] % 10 == 1:
                print(f"  eval {n_evals[0]:4d}  obj {v:.6f}  t={time.time()-t0:.1f}s")
            return v, g

        x0 = self.get_flat_raw().cpu().numpy().astype(np.float64)
        method = _SCIPY_METHODS[optimizer]
        # scipy's TNC takes maxfun, not maxiter
        opts = {"maxfun": max_iters} if method == "TNC" else {"maxiter": max_iters}
        if method == "L-BFGS-B":
            opts.update(dict(gtol=gtol, ftol=ftol, maxfun=15000 if max_iters < 15000 else max_iters * 2))
        if method == "Nelder-Mead":  # GPy 'simplex': gradient-free
            r = scipy.optimize.minimize(lambda x: fg(x)[0], x0, method=method, options=opts)
        else:
            r = scipy.optimize.minimize(fg, x0, jac=True, method=method, options=opts)
        self.set_flat_raw(r.x)
        if messages:
            print(f"Optimization finished: f={r.fun:.6f} after {n_evals[0]} evals ({r.message})")
        return OptimizationResult(r.x, float(r.fun), str(r.message), int(r.get("nit", -1)), bool(r.success))

    def _optimize_scg(self, max_iters, messages, gtol, ftol, xtol=1e-8):
        """Scaled conjugate gradients (Moller 1993) -- GPy's classic 'scg',
        as gpy_tpu/core/model.py:171-247 has it."""
        fg = self._objective_and_grad
        x = self.get_flat_raw().cpu().numpy().astype(np.float64)
        sigma0 = 1e-4
        fold, gradnew = fg(x)
        fnow = fold
        gradold = gradnew.copy()
        d = -gradnew
        success = True
        nsuccess = 0
        beta, betamin, betamax = 1.0, 1e-15, 1e100
        status = "maxiter reached"
        it = 0
        mu = kappa = theta = 0.0
        for it in range(1, max_iters + 1):
            if success:
                mu = float(d @ gradnew)
                if mu >= 0:
                    d = -gradnew
                    mu = float(d @ gradnew)
                kappa = float(d @ d)
                if kappa < 1e-30:
                    status = "converged (zero direction)"
                    break
                sigma = sigma0 / np.sqrt(kappa)
                _, gplus = fg(x + sigma * d)
                theta = float(d @ (gplus - gradnew)) / sigma
            delta = theta + beta * kappa  # scaled curvature
            if delta <= 0:
                delta = beta * kappa
                beta = beta - theta / kappa
            alpha = -mu / delta
            xnew = x + alpha * d
            fnew, _ = fg(xnew)
            Delta = 2.0 * (fnew - fold) / (alpha * mu) if alpha * mu != 0 else -1.0
            if Delta >= 0 and np.isfinite(fnew):
                success = True
                nsuccess += 1
                x = xnew
                fnow = fnew
            else:
                success = False
                fnow = fold
            if messages and it % 10 == 1:
                print(f"  scg iter {it:4d}  obj {fnow:.6f}")
            if success:
                if (np.max(np.abs(alpha * d)) < xtol) and (abs(fnew - fold) < ftol):
                    status = "converged (x/f tolerance)"
                    break
                fold = fnew
                gradold = gradnew
                _, gradnew = fg(x)
                if float(gradnew @ gradnew) < gtol**2:
                    status = "converged (gradient)"
                    break
            if Delta < 0.25:
                beta = min(4.0 * beta, betamax)
            if Delta > 0.75:
                beta = max(0.5 * beta, betamin)
            if nsuccess == x.size:
                d = -gradnew
                nsuccess = 0
            elif success:
                gamma = float((gradold - gradnew) @ gradnew) / mu
                d = gamma * d - gradnew
        self.set_flat_raw(x)
        if messages:
            print(f"SCG finished: f={fnow:.6f} after {it} iters ({status})")
        return OptimizationResult(x, float(fnow), status, it, status != "maxiter reached")

    def optimize_restarts(self, num_restarts=10, robust=False, verbose=True, parallel=False,
                          seed=None, mesh=None, **kwargs):
        """GPy/paramz optimize_restarts: keep the best of several random
        inits (gpy_tpu/core/model.py:357-395). Restart i > 0 starts from
        `randomize(rng)`, rng = np.random.default_rng(seed), drawing in the
        reference's order. parallel=True runs every restart at once through
        the batched objective (`_optimize_restarts_parallel`); with `mesh`
        (a DeviceMesh of gpy_tpu_torch.parallel) the restarts split over the
        mesh's ranks. The reference ignores a mesh without parallel=True;
        here that raises."""
        if mesh is not None and not parallel:
            raise ValueError("mesh= splits the parallel restarts: pass parallel=True")
        rng = np.random.default_rng(seed)
        initial = self.get_flat_raw()
        if parallel:
            return self._optimize_restarts_parallel(num_restarts, rng, initial, verbose,
                                                    mesh=mesh, **kwargs)
        best_obj, best_x = np.inf, None
        results = []
        for i in range(num_restarts):
            try:
                if i > 0:
                    self.randomize(rng)
                res = self.optimize(**kwargs)
                results.append(res)
                if res.f_opt < best_obj:
                    best_obj, best_x = res.f_opt, self.get_flat_raw()
                if verbose:
                    print(f"Optimization restart {i+1}/{num_restarts}, f = {res.f_opt}")
            except Exception as e:
                if not robust:
                    raise
                if verbose:
                    print(f"Warning - optimization restart {i+1}/{num_restarts} failed: {e}")
        self.set_flat_raw(initial if best_x is None else best_x)
        return results

    def _optimize_restarts_parallel(self, num_restarts, rng, initial, verbose,
                                    optimizer="adam", max_iters=1000, step_size=1e-2, mesh=None,
                                    **kwargs):
        """gpy_tpu/core/model.py:397-446: R inits (the current point and R-1
        draws), max_iters Adam steps on the (R, P) tensor through the batched
        objective (one batched factorization per step), then the R
        objectives at the end points; the best finite one is kept. Each row
        keeps its own optimizer state: the rules are elementwise. With
        `mesh`, every rank draws all R inits from the one seed, runs its
        contiguous share of them (R must divide by the mesh's size) and
        all_gathers the end points and objectives, so every rank keeps the
        same best point."""
        if optimizer not in _OPTAX:
            raise ValueError("parallel restarts run as one batched loop and need an optax "
                             f"optimizer, not {optimizer!r}")
        inits = [initial]
        try:
            for _ in range(num_restarts - 1):
                self.randomize(rng)
                inits.append(self.get_flat_raw())
        finally:
            self.set_flat_raw(initial)
        xs = torch.stack(inits)
        if mesh is not None:
            from ..parallel.mesh import check_device, shard_slice

            check_device(mesh, xs)
            _, lo, hi = shard_slice(mesh, num_restarts, tuple(mesh.mesh_dim_names))
            xs = xs[lo:hi]
        step = _rule_stepper(optimizer, xs, step_size)
        for _ in range(max_iters):
            _, g = self._batched_objective_and_grad(xs)
            xs = step(xs, g)
        with torch.no_grad():
            vf = self._batched_objective(xs)
        xs = xs.detach()
        if mesh is not None:
            from ..parallel.mesh import all_gather_rows

            rows = all_gather_rows(mesh, torch.cat([xs, vf[:, None]], dim=1),
                                   tuple(mesh.mesh_dim_names))
            xs, vf = rows[:, :-1], rows[:, -1]
        vf = vf.cpu().numpy().astype(np.float64)
        vf_safe = np.where(np.isfinite(vf), vf, np.inf)
        best = int(np.argmin(vf_safe))
        if np.isfinite(vf_safe[best]):
            self.set_flat_raw(xs[best])
        if verbose:
            print(f"parallel restarts: objectives {np.round(vf, 3)} -> kept #{best}")
        x_np = xs.cpu().numpy()
        return [OptimizationResult(x_np[i], float(vf[i]), f"{optimizer} batched restart",
                                   max_iters, bool(np.isfinite(vf[i])))
                for i in range(num_restarts)]

    # --- gradient checking (GPy m.checkgrad) ------------------------------
    def checkgrad(self, verbose=False, step=1e-6, tolerance=1e-3) -> bool:
        x = self.get_flat_raw().cpu().numpy().astype(np.float64)
        try:
            _, g = self._objective_and_grad(x)
            num = np.zeros_like(x)
            for i in range(x.size):
                xp, xm = x.copy(), x.copy()
                xp[i] += step
                xm[i] -= step
                num[i] = (self._objective_and_grad(xp)[0]
                          - self._objective_and_grad(xm)[0]) / (2 * step)
        finally:
            self.set_flat_raw(x)
        denom = np.maximum(np.abs(g) + np.abs(num), 1e-10)
        ratio = np.abs(g - num) / denom
        ok = bool(np.all((ratio < tolerance) | (np.abs(g - num) < 1e-6)))
        if verbose:
            paths = [p for p, m, n in self._free_entries() for _ in range(m._parameters[n].numel())]
            print(f"{'param':<40} {'analytic':>12} {'numeric':>12} {'ratio':>10}")
            for i in range(x.size):
                print(f"{paths[i]:<40} {g[i]:>12.6f} {num[i]:>12.6f} {ratio[i]:>10.2e}")
        return ok

    # --- serialization surface (GPy: m.save_model / m.to_dict / pickle) ----
    def to_dict(self) -> dict:
        from ..util.serialization import to_dict

        return to_dict(self)

    @staticmethod
    def from_dict(d, device=None):
        """The model `d` describes, on `device` ("cuda" unless the caller
        passes "cpu")."""
        from ..util.serialization import from_dict

        return from_dict(d, device=device)

    def save_model(self, output_filename, compress=True, save_data=True):
        """gzip JSON of the whole model (util/serialization.py); returns the
        path written. The data is always saved, as in the reference."""
        from ..util.serialization import save_model

        return save_model(self, output_filename, compress=compress)

    def pickle(self, path):
        """GPy: m.pickle(path) -- a gzip pickle of the model, read back with
        pickle.load on the device it was saved from."""
        import gzip
        import pickle

        with gzip.open(path, "wb") as f:
            pickle.dump(self, f)
        return path
