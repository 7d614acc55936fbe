"""The reference's on-device optimizers as torch loops: optax 0.2.6's update
rules with optax's defaults, and optax.lbfgs with its zoom line search.

Counterpart of the optax calls in gpy_tpu/core/model.py:249-355, 397-446
(`optax.adagrad | rmsprop | adadelta | rprop(step_size)`, `optax.lbfgs()`)
and gpy_tpu/core/gp.py:520-556 (`infer_newX(optimizer="lbfgs")`). The
rules are written from optax's source, not from torch.optim, whose defaults
differ (adagrad's accumulator starts at 0.1 here, rmsprop puts eps inside
the square root, rprop is optax's one-step-lagged form).

Each rule is elementwise, so on a (R, P) tensor of R parallel restarts
every row keeps its own state, as the reference's jax.vmap does.

L-BFGS keeps its state on the device; its zoom line search decides on
host floats. Each line-search evaluation reads its value, its slope along
the direction and max|grad| back in one transfer (`LBFGS.host_syncs`
counts them), and the first also reads the slope at the start: one host
sync an evaluation. The scalar arithmetic is float64 on the host, which is
the reference's arithmetic at float64 and rounds differently at float32.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

__all__ = ["OPTAX_RULES", "LBFGS", "optax_rule"]


# --- the elementwise rules ----------------------------------------------------
class _Rule:
    """init(x) -> state; update(g, state) -> (u, state); x + u is the step,
    optax.apply_updates."""

    def __init__(self, init, update):
        self.init = init
        self.update = update


def _adagrad(learning_rate, initial_accumulator_value=0.1, eps=1e-7):
    """optax.adagrad: scale_by_rss then scale(-lr)."""

    def init(x):
        return (torch.full_like(x, initial_accumulator_value),)

    def update(g, state):
        s = g * g + state[0]
        inv = torch.where(s > 0, torch.rsqrt(s + eps), torch.zeros_like(s))
        return -learning_rate * (inv * g), (s,)

    return _Rule(init, update)


def _rmsprop(learning_rate, decay=0.9, eps=1e-8, initial_scale=0.0):
    """optax.rmsprop (not centered, no momentum): scale_by_rms with eps
    inside the square root, then scale(-lr)."""

    def init(x):
        return (torch.full_like(x, initial_scale),)

    def update(g, state):
        nu = (1 - decay) * g**2 + decay * state[0]
        return -learning_rate * (torch.rsqrt(nu + eps) * g), (nu,)

    return _Rule(init, update)


def _adadelta(learning_rate, rho=0.9, eps=1e-6):
    """optax.adadelta: scale_by_adadelta, then scale(-lr); its weight decay
    is 0."""

    def init(x):
        return (torch.zeros_like(x), torch.zeros_like(x))

    def update(g, state):
        e_g_prev, e_x_prev = state
        e_g = (1 - rho) * g**2 + rho * e_g_prev
        u = torch.sqrt(e_x_prev + eps) / torch.sqrt(e_g + eps) * g
        e_x = (1 - rho) * u**2 + rho * e_x_prev
        return -learning_rate * u, (e_g, e_x)

    return _Rule(init, update)


def _rprop(learning_rate, eta_minus=0.5, eta_plus=1.2, min_step_size=1e-6, max_step_size=50.0):
    """optax.rprop: scale_by_rprop, then scale(-1). Per element, a step size
    (starting at learning_rate) grows by eta_plus while the gradient keeps
    its sign and shrinks by eta_minus when it flips, within [min, max]; a
    flip zeroes the stored step, so the next step leaves the size alone.
    optax 0.2.6 applies the step stored at the previous update, not the one
    it has just formed: the first update is zero."""

    def init(x):
        return (torch.full_like(x, learning_rate), torch.zeros_like(x))

    def update(g, state):
        step_sizes, prev = state
        s = g * prev
        grown = torch.clamp(torch.where(s > 0, step_sizes * eta_plus, step_sizes * eta_minus),
                            min=min_step_size, max=max_step_size)
        step_sizes = torch.where(s == 0, step_sizes, grown)
        new_prev = torch.where(s < 0, torch.zeros_like(g), step_sizes * torch.sign(g))
        u = torch.where(s < 0, torch.zeros_like(prev), prev)
        return -1.0 * u, (step_sizes, new_prev)

    return _Rule(init, update)


def _adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8):
    """optax.adam: bias-corrected first and second moments, eps outside the
    square root, then scale(-lr). The functional form of the torch.optim.Adam
    that Model.optimize runs (core/model.py `_adam`), for loops that carry
    their state themselves (the sharded SVGP step)."""

    def init(x):
        return (0, torch.zeros_like(x), torch.zeros_like(x))

    def update(g, state):
        t, mu, nu = state
        t += 1
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * g * g
        m_hat = mu / (1 - b1**t)
        v_hat = nu / (1 - b2**t)
        return -learning_rate * m_hat / (torch.sqrt(v_hat) + eps), (t, mu, nu)

    return _Rule(init, update)


OPTAX_RULES = {"adam": _adam, "adagrad": _adagrad, "rmsprop": _rmsprop, "adadelta": _adadelta,
               "rprop": _rprop}


def optax_rule(name: str, learning_rate: float) -> _Rule:
    """optax.<name>(learning_rate) with optax's other defaults."""
    return OPTAX_RULES[name](learning_rate)


# --- L-BFGS ----------------------------------------------------------------------
def _f(x) -> np.float64:
    return np.float64(x)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Minimizer of the cubic through (a, fa, fpa), (b, fb), (c, fc)
    (optax linesearch.py _cubicmin)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc**2 * v0 + -(db**2) * v1) / denom
    B = (-(dc**3) * v0 + db**3 * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db**2)
    return a - C / (2.0 * B)


class LBFGS:
    """optax.lbfgs() as the reference calls it: memory 10, the scaled
    initial preconditioner, no learning rate (scale -1), and
    scale_by_zoom_linesearch(max_linesearch_steps=20,
    initial_guess_strategy="one") with its defaults (tol 0, increase
    factor 2, slope_rtol 1e-4, curv_rtol 0.9, approx_dec_rtol 1e-6,
    stepsize_precision 1e-5, no maximal step).

    `step(x, value, grad, value_and_grad)` takes the objective's value (a
    host float) and gradient at x and returns the next x; the line search's
    last value and gradient stay in `self.value` / `self.grad`, which the
    reference reads back through optax.value_and_grad_from_state."""

    def __init__(self, memory_size=10, max_linesearch_steps=20, tol=0.0, increase_factor=2.0,
                 slope_rtol=1e-4, curv_rtol=0.9, approx_dec_rtol=1e-6, interval_threshold=1e-5):
        self.m = memory_size
        self.max_ls = max_linesearch_steps
        self.tol = tol
        self.increase_factor = increase_factor
        self.slope_rtol = slope_rtol
        self.curv_rtol = curv_rtol
        self.approx_dec_rtol = approx_dec_rtol
        self.interval_threshold = interval_threshold
        self.evaluations = 0
        self.host_syncs = 0

    def init(self, x: torch.Tensor):
        P = x.numel()
        self.count = 0
        self.params = torch.zeros_like(x)
        self.updates = torch.zeros_like(x)
        self.dW = torch.zeros((self.m, P), dtype=x.dtype, device=x.device)
        self.dU = torch.zeros_like(self.dW)
        self.rho = torch.zeros(self.m, dtype=x.dtype, device=x.device)
        self.value = math.inf
        self.grad = torch.zeros_like(x)
        self.max_abs_grad = math.inf
        return self

    # -- scale_by_lbfgs -------------------------------------------------------------
    def _direction(self, x, g):
        """The preconditioned gradient P_k g (optax scale_by_lbfgs)."""
        m = self.m
        mem = self.count % m
        if self.count > 0:
            dw = x - self.params
            du = g - self.updates
            vdot = torch.dot(du, dw)
            weight = torch.where(vdot == 0.0, torch.zeros_like(vdot), 1.0 / vdot)
            prev = (self.count - 1) % m
            self.dW[prev] = dw
            self.dU[prev] = du
            self.rho[prev] = weight
            den = torch.sum(du * du)
            scale = torch.where(den > 0.0, vdot / den, torch.ones_like(den))
        else:
            scale = torch.clamp(1.0 / torch.linalg.vector_norm(g), max=1.0)
        idx = [(mem + i) % m for i in range(m)]
        vec = g
        alphas = {}
        for i in reversed(idx):
            alphas[i] = self.rho[i] * torch.dot(self.dW[i], vec)
            vec = vec + (-alphas[i]) * self.dU[i]
        vec = scale * vec
        for i in idx:
            beta = self.rho[i] * torch.dot(self.dU[i], vec)
            vec = vec + (alphas[i] - beta) * self.dW[i]
        self.count += 1
        self.params, self.updates = x, g
        return vec

    # -- zoom line search ----------------------------------------------------------
    def _on_line(self, vg, x, d, t, first_slope=None):
        """Value, gradient and slope at x + t d, read to the host in one
        transfer (with the start's slope along d at the first evaluation)."""
        v, gr = vg(x + t * d)
        self.evaluations += 1
        parts = [v.reshape(()), torch.dot(gr, d), torch.max(torch.abs(gr))]
        if first_slope is not None:
            parts.append(first_slope)
        host = torch.stack(parts).tolist()
        self.host_syncs += 1
        return gr, [_f(h) for h in host]

    def _errors(self, t, v, slope, v0, s0):
        dec = v - v0 - self.slope_rtol * t * s0
        if self.approx_dec_rtol is not None:
            approx = slope - (2 * self.slope_rtol - 1.0) * s0
            delta = v - v0 - self.approx_dec_rtol * np.abs(v0)
            dec = np.minimum(np.maximum(approx, delta), dec)
        dec = np.maximum(dec, 0.0)
        dec = np.inf if np.isnan(dec) else dec
        curv = np.maximum(np.abs(slope) - self.curv_rtol * np.abs(s0), 0.0)
        curv = np.inf if np.isnan(curv) else curv
        return dec, curv

    def _linesearch(self, vg, x, d, value, grad, max_abs_grad):
        """(step size, value, gradient, max|gradient|) of optax's zoom line
        search from x along d."""
        s = SimpleNamespace(count=0, guess=_f(1.0), t=_f(0.0), v=_f(value), g=grad, gmax=None,
                            slope=None, v0=_f(value), s0=None, dec=np.inf, interval=False,
                            done=False, failed=False, low=_f(0.0), v_low=_f(value), s_low=None,
                            high=_f(0.0), v_high=_f(value), s_high=None, cref=_f(0.0),
                            v_cref=_f(value), safe_t=_f(0.0), safe_v=_f(value), safe_g=grad,
                            safe_gmax=max_abs_grad)
        first_slope = torch.dot(d, grad)
        tol = self.tol
        while not (s.done or s.failed):
            if not s.interval:
                t = s.guess if s.count == 0 else self.increase_factor * s.t
                gr, (v, slope, gmax, *rest) = self._on_line(
                    vg, x, d, t, first_slope if s.count == 0 else None)
                if s.count == 0:
                    s.s0 = s.slope = s.s_low = s.s_high = rest[0]
                dec, curv = self._errors(t, v, slope, s.v0, s.s0)
                err = np.maximum(dec, curv)
                if dec <= tol:
                    s.safe_t, s.safe_v, s.safe_g, s.safe_gmax = t, v, gr, gmax
                high_new = (dec > 0.0) or (v >= s.v and s.count > 0)
                low_new = (slope >= 0.0) and not high_new
                if low_new:
                    s.low, s.v_low, s.s_low, s.high, s.v_high, s.s_high = (
                        t, v, slope, s.t, s.v, s.slope)
                else:
                    s.low, s.v_low, s.s_low, s.high, s.v_high, s.s_high = (
                        s.t, s.v, s.slope, t, v, slope)
                s.interval = high_new or low_new or err <= tol
                s.done = bool(err <= tol)
                s.failed = s.count + 1 >= self.max_ls and not s.done
                s.cref, s.v_cref = s.low, s.v_low
            else:
                low, high = s.low, s.high
                delta = np.abs(high - low)
                left, right = np.minimum(high, low), np.maximum(high, low)
                too_small = delta <= self.interval_threshold
                mc = _cubicmin(low, s.v_low, s.s_low, high, s.v_high, s.cref, s.v_cref)
                use_cubic = (mc > left + 0.2 * delta) and (mc < right - 0.2 * delta)
                mq = _quadmin(low, s.v_low, s.s_low, high, s.v_high)
                use_quad = (not use_cubic) and (mq > left + 0.1 * delta) and (
                    mq < right - 0.1 * delta)
                t = mc if use_cubic else (mq if use_quad else (low + high) / 2.0)
                gr, (v, slope, gmax) = self._on_line(vg, x, d, t)
                dec, curv = self._errors(t, v, slope, s.v0, s.s0)
                err = np.maximum(dec, curv)
                if dec <= tol and v < s.safe_v:
                    s.safe_t, s.safe_v, s.safe_g, s.safe_gmax = t, v, gr, gmax
                s.done = bool(err <= tol)
                high_mid = (dec > 0.0) or (v >= s.v_low)
                high_low = (slope * (high - low) >= 0.0) and not high_mid
                new_high = (t, v, slope) if high_mid else (high, s.v_high, s.s_high)
                if high_low:
                    new_high = (low, s.v_low, s.s_low)
                new_low = (t, v, slope) if not high_mid else (low, s.v_low, s.s_low)
                s.cref, s.v_cref = (high, s.v_high) if (high_mid or high_low) else (low, s.v_low)
                (s.high, s.v_high, s.s_high), (s.low, s.v_low, s.s_low) = new_high, new_low
                s.failed = ((s.count + 1 >= self.max_ls) or (too_small and s.safe_t > 0.0)) \
                    and not s.done
            s.count += 1
            s.t, s.v, s.g, s.gmax, s.slope, s.dec = t, v, gr, gmax, slope, dec
            if s.failed and (s.safe_t > 0.0 or np.isinf(s.dec)):
                # _try_safe_step
                s.t, s.v, s.g, s.gmax = s.safe_t, s.safe_v, s.safe_g, s.safe_gmax
        return s.t, s.v, s.g, s.gmax

    def step(self, x, value, grad, value_and_grad, max_abs_grad=math.inf):
        """One optax.lbfgs update from x, with `value` (a float) and `grad`
        the objective's value and gradient there (max_abs_grad, max|grad|,
        is what `self.max_abs_grad` reads if the search keeps x)."""
        d = -self._direction(x, grad)
        with np.errstate(all="ignore"):  # IEEE inf and NaN, as jnp's scalars
            t, v, g, gmax = self._linesearch(value_and_grad, x, d, value, grad, max_abs_grad)
        self.value, self.grad, self.max_abs_grad = float(v), g, gmax
        return x + t * d
