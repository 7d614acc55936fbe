"""State-space GP demos. Counterpart of gpy_tpu/examples/state_space.py
(GPy/examples/state_space.py). Each takes max_iters (the reference's fixed
100, the default here) as a keyword: the sequential filter takes one torch
step per time point, so a fit's time grows with N times its iterations."""
from __future__ import annotations

import numpy as np

from .. import kern
from ..models import GPRegression
from ..models.state_space import StateSpace


def matern_kalman_1d(optimize=True, plot=False, n=300, max_iters=100, device=None, dtype=None):
    rng = np.random.default_rng(0)
    X = np.sort(rng.random(n) * 10).reshape(-1, 1)
    Y = np.sin(X) + 0.2 * rng.standard_normal((n, 1))
    m = StateSpace(X, Y, kernel=kern.Matern32(1, device=device, dtype=dtype), device=device,
                   dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def sum_kernel_kalman(optimize=True, plot=False, n=200, max_iters=100, device=None, dtype=None):
    rng = np.random.default_rng(1)
    X = np.sort(rng.random(n) * 10).reshape(-1, 1)
    Y = np.sin(X) + 0.3 * np.sin(5 * X) + 0.1 * rng.standard_normal((n, 1))
    k = (kern.Matern32(1, lengthscale=2.0, device=device, dtype=dtype)
         + kern.Matern52(1, lengthscale=0.3, device=device, dtype=dtype))
    m = StateSpace(X, Y, kernel=k, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def state_space_example(n=2000, optimize=True, plot=False, max_iters=100, device=None,
                        dtype=None):
    """Dense GP against the O(N) Kalman state-space GP on the same Matern32
    model (GPy examples/state_space.py state_space_example)."""
    rng = np.random.default_rng(0)
    X = np.linspace(0, 10, n)[:, None]
    Y = np.sin(X) + rng.normal(size=X.shape) * 0.1
    m1 = GPRegression(X[::4], Y[::4], kernel=kern.Matern32(1, device=device, dtype=dtype),
                      device=device, dtype=dtype)  # dense on a subset
    m2 = StateSpace(X, Y, kernel=kern.Matern32(1, device=device, dtype=dtype), device=device,
                    dtype=dtype)
    if optimize:
        m1.optimize(max_iters=max_iters)
        m2.optimize(max_iters=max_iters)
    print(m1)
    print(m2)
    return m1, m2
