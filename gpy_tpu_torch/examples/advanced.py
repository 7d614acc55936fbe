"""Demos of surface the reference framework ships no runnable examples for:
parameter tying, symbolic (sympy) likelihoods, minibatch SVGP at large N
and matrix-free exact GPs on the fused Gram-matvec kernels. Counterpart of
gpy_tpu/examples/advanced.py; each function builds, optionally optimizes
and returns the model (plot=True to draw).
"""
from __future__ import annotations

import numpy as np

from .. import kern
from ..models import GPRegression


def tied_lengthscales(n=80, optimize=True, plot=False, device=None, dtype=None):
    """Sum of an RBF and a Matern32 constrained to share one lengthscale:
    `m.tie(...)` keeps the values equal with a single optimizer slot
    (paramz tie parity)."""
    rng = np.random.default_rng(0)
    X = np.sort(rng.random((n, 1)) * 8.0, axis=0)
    Y = np.sin(X) + 0.15 * rng.standard_normal((n, 1))
    k = kern.RBF(1, device=device, dtype=dtype) + kern.Matern32(1, device=device, dtype=dtype)
    m = GPRegression(X, Y, k, noise_var=0.1, device=device, dtype=dtype)
    m.tie("kern.parts#0.lengthscale", "kern.parts#1.lengthscale")
    if optimize:
        m.optimize()
    if float(m.kern.parts[0].lengthscale) != float(m.kern.parts[1].lengthscale):
        raise RuntimeError("tied lengthscales differ")
    if plot:
        m.plot()
    return m


def symbolic_laplace_regression(n=60, optimize=True, plot=False, device=None, dtype=None):
    """A likelihood written as a sympy log-pdf (heavy-tailed Student-t with
    trainable scale) trained with Laplace inference: the derivative towers
    the reference code-generates (GPy/core/symbolic.py) come from autograd."""
    import sympy

    from ..core.gp import GP
    from ..inference.laplace import Laplace
    from ..likelihoods import SymbolicLikelihood

    f, y = sympy.symbols("f y")
    s = sympy.Symbol("s", positive=True)
    nu = sympy.Integer(4)
    expr = (sympy.log(sympy.gamma((nu + 1) / 2)
                      / (sympy.gamma(nu / 2) * sympy.sqrt(nu * sympy.pi * s)))
            - (nu + 1) / 2 * sympy.log(1 + (y - f) ** 2 / (nu * s)))
    lik = SymbolicLikelihood(expr, parameters={"s": 0.1}, name="studentT_sym", device=device,
                             dtype=dtype)

    rng = np.random.default_rng(1)
    X = np.sort(rng.random((n, 1)) * 6.0, axis=0)
    Y = np.sin(X) + 0.1 * rng.standard_normal((n, 1))
    Y[::13] += 2.0  # outliers the heavy tails absorb
    m = GP(X, Y, kern.RBF(1, device=device, dtype=dtype), lik, inference_method=Laplace(),
           device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=150)
    if plot:
        m.plot()
    return m


def big_data_svgp(n=200_000, optimize=True, plot=False, device=None, dtype=None):
    """SVGP at large N with shuffled-window minibatching: fit() shuffles the
    dataset once on the device and draws contiguous windows of it, so a
    step reads one slice instead of gathering random rows (batch_mode
    'auto' switches this on from 2^20 rows; forced on here)."""
    from ..core.svgp import SVGP
    from ..likelihoods import Gaussian

    rng = np.random.default_rng(3)
    X = (rng.random((n, 4)) * 4.0).astype(np.float32)
    Y = (np.sin(X[:, :1]) + 0.1 * rng.standard_normal((n, 1))).astype(np.float32)
    Z = X[rng.permutation(n)[:256]].copy()
    m = SVGP(X, Y, Z, kern.RBF(4, ARD=True, device=device, dtype=dtype),
             Gaussian(variance=0.1, device=device, dtype=dtype), device=device, dtype=dtype)
    if optimize:
        m.fit(iters=300, batchsize=2048, batch_mode="shuffle_slice")
    if plot:
        m.plot()
    return m


def matrix_free_exact_gp(n=3000, optimize=True, plot=False, device=None, dtype=None):
    """Exact GP by CG and stochastic Lanczos quadrature on the fused
    Gram-matvec kernels (csrc/gram_matvec_fused.cu): the Gram is never
    stored, and the gradient goes through the fused moments kernel."""
    from ..inference.iterative import IterativeGaussianInference

    rng = np.random.default_rng(2)
    X = (rng.random((n, 2)) * 6.0).astype(np.float32)
    Y = (np.sin(X[:, :1]) * np.cos(0.5 * X[:, 1:])
         + 0.1 * rng.standard_normal((n, 1))).astype(np.float32)
    m = GPRegression(X, Y, noise_var=0.1,
                     inference_method=IterativeGaussianInference(max_cg=32, n_probes=8,
                                                                 fused=True),
                     device=device, dtype=dtype)
    if optimize:
        m.optimize(optimizer="adam", max_iters=60, step_size=5e-2)
    if plot:
        m.plot()
    return m
