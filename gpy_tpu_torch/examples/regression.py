"""Regression demos. Counterpart of gpy_tpu/examples/regression.py
(GPy/examples/regression.py: olympic_marathon_men:17, toy_rbf_1d,
sparse_GP_regression_1D:502, coregionalization_toy, ...). Each function
builds, optionally optimizes and returns the model (plot=True to draw).
"""
from __future__ import annotations

import numpy as np

from .. import kern
from ..models import GPCoregionalizedRegression, GPRegression, SparseGPRegression, SVGP
from ..util import datasets


def olympic_marathon_men(optimize=True, plot=False, device=None, dtype=None):
    data = datasets.olympic_marathon_men()
    m = GPRegression(data["X"], data["Y"], device=device, dtype=dtype)
    m.kern.lengthscale = 10.0
    if optimize:
        m.optimize()
    if plot:
        m.plot()
    return m


def toy_rbf_1d(optimize=True, plot=False, n=100, device=None, dtype=None):
    data = datasets.toy_rbf_1d(num_samples=n)
    m = GPRegression(data["X"], data["Y"], device=device, dtype=dtype)
    if optimize:
        m.optimize()
    if plot:
        m.plot()
    return m


def toy_rbf_1d_50(optimize=True, plot=False, device=None, dtype=None):
    return toy_rbf_1d(optimize, plot, n=50, device=device, dtype=dtype)


def sparse_GP_regression_1D(num_samples=400, num_inducing=5, optimize=True, plot=False,
                            device=None, dtype=None):
    rng = np.random.default_rng(0)
    X = rng.uniform(-3.0, 3.0, (num_samples, 1))
    Y = np.sin(X) + rng.standard_normal((num_samples, 1)) * 0.05
    m = SparseGPRegression(X, Y, num_inducing=num_inducing, device=device, dtype=dtype)
    if optimize:
        m.optimize()
    if plot:
        m.plot()
    return m


def coregionalization_toy(optimize=True, plot=False, device=None, dtype=None):
    rng = np.random.default_rng(0)
    X1 = rng.random((40, 1)) * 8
    X2 = rng.random((30, 1)) * 8
    Y1 = np.sin(X1) + rng.standard_normal((40, 1)) * 0.05
    Y2 = np.sin(X2) + rng.standard_normal((30, 1)) * 0.05 + 2.0
    m = GPCoregionalizedRegression([X1, X2], [Y1, Y2], device=device, dtype=dtype)
    if optimize:
        m.optimize()
    return m


def svgp_bigdata(n=2000, optimize=True, plot=False, device=None, dtype=None):
    """'Gaussian processes for Big Data' demo (GPy core/svgp.py docstring)."""
    from ..likelihoods import Gaussian

    rng = np.random.default_rng(0)
    X = rng.random((n, 1)) * 10
    Y = np.sin(X) + 0.1 * rng.standard_normal((n, 1))
    Z = np.linspace(0, 10, 20).reshape(-1, 1)
    m = SVGP(X, Y, Z, kern.RBF(1, device=device, dtype=dtype),
             Gaussian(variance=0.1, device=device, dtype=dtype), batchsize=256, device=device,
             dtype=dtype)
    if optimize:
        m.fit(iters=300, step_size=1e-2)
    return m


def _dataset_or(loader, fallback):
    """A registry dataset from the local cache, or the synthetic stand-in
    where it is not there. Only DatasetNotAvailable falls back: a loader
    that fails on a file it found raises."""
    try:
        return loader()
    except datasets.DatasetNotAvailable as e:
        print(f"[gpy_tpu_torch.examples] dataset unavailable ({e}); using synthetic stand-in")
        return fallback()


def _no_loader(name):
    def load():
        raise datasets.DatasetNotAvailable(f"no loader for {name!r} in util.datasets")

    return load


def olympic_100m_men(optimize=True, plot=False, device=None, dtype=None):
    """GPy examples/regression.py olympic_100m_men."""
    def synth():
        X = np.arange(1896, 2012, 4, dtype=float).reshape(-1, 1)
        Y = 10.4 - 0.005 * (X - 1896) + 0.1 * np.random.default_rng(0).normal(size=X.shape)
        return {"X": X, "Y": Y}
    data = _dataset_or(datasets.olympic_100m_men, synth)
    m = GPRegression(data["X"], data["Y"], device=device, dtype=dtype)
    m.kern.lengthscale = 10.0
    if optimize:
        m.optimize()
    if plot:
        m.plot()
    return m


def coregionalization_sparse(optimize=True, plot=False, device=None, dtype=None):
    """Sparse ICM on two related noisy sinusoids (GPy regression.py
    coregionalization_sparse)."""
    from ..models import SparseGPCoregionalizedRegression

    rng = np.random.default_rng(0)
    X1 = rng.random((40, 1)) * 8
    X2 = rng.random((30, 1)) * 5
    Y1 = np.sin(X1) + rng.normal(scale=0.05, size=X1.shape)
    Y2 = np.sin(X2) + rng.normal(scale=0.05, size=X2.shape) + 2.0
    m = SparseGPCoregionalizedRegression(X_list=[X1, X2], Y_list=[Y1, Y2], device=device,
                                         dtype=dtype)
    if optimize:
        m.optimize(max_iters=100)
    if plot:
        m.plot()
    return m


def epomeo_gpx(max_iters=200, optimize=True, plot=False, device=None, dtype=None):
    """Elevation over time on GPS runs (GPy regression.py epomeo_gpx); a
    synthetic hill profile where the data is not in the local cache."""
    def synth():
        t = np.linspace(0, 3, 120).reshape(-1, 1)
        elev = 600 * np.exp(-0.5 * (t - 1.5) ** 2 / 0.3) + \
            10 * np.random.default_rng(0).normal(size=t.shape)
        return {"X": [t], "Y": [elev]}
    data = _dataset_or(getattr(datasets, "epomeo_gpx", None) or _no_loader("epomeo_gpx"), synth)
    X, Y = np.asarray(data["X"][0], dtype=float), np.asarray(data["Y"][0], dtype=float)
    m = GPRegression(X, Y, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    if plot:
        m.plot()
    return m


def _contour_data(data, length_scales, log_SNRs, kernel_call=None, device=None, dtype=None):
    """NLML surface over (lengthscale, log-SNR) (GPy regression.py
    _contour_data, used by multiple_optima)."""
    kernel_call = kernel_call or kern.RBF
    lls = []
    total_var = float(np.var(data["Y"]))
    for log_SNR in log_SNRs:
        SNR = 10.0 ** log_SNR
        noise_var = total_var / (1.0 + SNR)
        signal_var = total_var - noise_var
        row = []
        for length_scale in length_scales:
            k = kernel_call(1, variance=signal_var, lengthscale=length_scale, device=device,
                            dtype=dtype)
            m = GPRegression(data["X"], data["Y"], kernel=k, noise_var=noise_var,
                             device=device, dtype=dtype)
            row.append(m.log_likelihood().item())
        lls.append(row)
    return np.array(lls)


def multiple_optima(gene_number=937, resolution=20, model_restarts=2,
                    seed=10000, max_iters=300, optimize=True, plot=False, device=None,
                    dtype=None):
    """NLML multi-modality demo (GPy regression.py multiple_optima) on the
    della-gatta gene series; a synthetic pulse where the data is not in
    the local cache."""
    def synth():
        t = np.linspace(0, 240, 13).reshape(-1, 1)
        y = np.exp(-0.5 * (t - 90) ** 2 / 40**2) + \
            0.05 * np.random.default_rng(0).normal(size=t.shape)
        return {"X": t, "Y": y}
    data = _dataset_or(
        lambda: datasets.della_gatta_TRP63_gene_expression(gene_number=gene_number),
        synth)
    data["Y"] = data["Y"] - np.mean(data["Y"])
    length_scales = np.linspace(0.1, 60.0, resolution)
    log_SNRs = np.linspace(-3.0, 4.0, resolution)
    lls = _contour_data(data, length_scales, log_SNRs, device=device, dtype=dtype)
    models = []
    if optimize:
        rng = np.random.default_rng(seed)
        for _ in range(model_restarts):
            kk = kern.RBF(1, variance=float(np.var(data["Y"])),
                          lengthscale=float(rng.uniform(1, 50)), device=device, dtype=dtype)
            m = GPRegression(data["X"], data["Y"], kernel=kk, noise_var=0.05, device=device,
                             dtype=dtype)
            m.optimize(max_iters=max_iters)
            models.append(m)
    return models, lls


def _ard_data(num_samples, D):
    """GPy regression.py toy_ARD's inputs and targets."""
    rng = np.random.default_rng(0)
    X = np.hstack([
        np.sin(np.sort(rng.random((num_samples, 1)) * 10, 0)),
        np.cos(np.sort(rng.random((num_samples, 1)) * 10, 0)),
        np.exp(np.sort(rng.random((num_samples, 1)), 0)),
        np.log(np.sort(rng.random((num_samples, 1)), 0)),
    ])
    Y = np.hstack([(2 * X[:, 0] + 3).reshape(-1, 1),
                   (4 * (X[:, 2] - 1.5 * X[:, 0])).reshape(-1, 1)])
    Y = Y @ rng.random((2, D))
    Y = Y + 0.2 * rng.standard_normal(Y.shape)
    Y = (Y - Y.mean()) / Y.std()
    return X, Y


def _ard_kernel(kernel_type, Q, device, dtype):
    if kernel_type == "linear":
        return kern.Linear(Q, ARD=True, device=device, dtype=dtype)
    return kern.RBF(Q, ARD=True, device=device, dtype=dtype)


def toy_ARD(max_iters=1000, kernel_type="linear", num_samples=300, D=4,
            optimize=True, plot=False, device=None, dtype=None):
    """ARD relevance recovery (GPy regression.py toy_ARD)."""
    X, Y = _ard_data(num_samples, D)
    Q = X.shape[1]
    kernel = (_ard_kernel(kernel_type, Q, device, dtype) + kern.White(Q, device=device, dtype=dtype)
              + kern.Bias(Q, device=device, dtype=dtype))
    m = GPRegression(X, Y, kernel=kernel, device=device, dtype=dtype)
    if optimize:
        m.optimize(optimizer="scg", max_iters=max_iters)
    if plot:
        m.kern.plot_ARD()
    return m


def toy_ARD_sparse(max_iters=1000, kernel_type="linear", num_samples=300, D=4,
                   optimize=True, plot=False, device=None, dtype=None):
    """Sparse variant of toy_ARD (GPy regression.py toy_ARD_sparse)."""
    X, Y = _ard_data(num_samples, D)
    m = SparseGPRegression(X, Y, kernel=_ard_kernel(kernel_type, X.shape[1], device, dtype),
                           num_inducing=20, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def robot_wireless(max_iters=100, kernel=None, optimize=True, plot=False, device=None,
                   dtype=None):
    """GP over robot WiFi signal strengths (GPy regression.py
    robot_wireless); a random-walk stand-in where the data is not in the
    local cache."""
    def synth():
        rng = np.random.default_rng(0)
        X = np.cumsum(rng.normal(size=(120, 2)) * 0.1, axis=0)
        Y = np.tanh(X @ rng.normal(size=(2, 5)))
        return {"X": X, "Y": Y}
    data = _dataset_or(datasets.robot_wireless, synth)
    m = GPRegression(data["X"], data["Y"], kernel=kernel, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def silhouette(max_iters=100, optimize=True, plot=False, device=None, dtype=None):
    """Agarwal-Triggs silhouette-to-pose regression (GPy regression.py
    silhouette); a synthetic linear map where the data is not in the local
    cache."""
    def synth():
        rng = np.random.default_rng(0)
        X = rng.normal(size=(80, 10))
        Y = X @ rng.normal(size=(10, 6)) + 0.1 * rng.normal(size=(80, 6))
        return {"X": X, "Y": Y}
    data = _dataset_or(datasets.silhouette, synth)
    m = GPRegression(data["X"], data["Y"], device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def sparse_GP_regression_2D(num_samples=400, num_inducing=50, max_iters=100,
                            optimize=True, plot=False, nan=False, device=None, dtype=None):
    """2-D sparse GP (GPy regression.py sparse_GP_regression_2D)."""
    rng = np.random.default_rng(1234)
    X = rng.uniform(-3.0, 3.0, (num_samples, 2))
    Y = np.sin(X[:, 0:1]) * np.sin(X[:, 1:2]) + rng.normal(scale=0.05, size=(num_samples, 1))
    if nan:
        Y[rng.integers(0, num_samples, 10), :] = np.nan
        keep = ~np.isnan(Y[:, 0])
        X, Y = X[keep], Y[keep]
    m = SparseGPRegression(X, Y, num_inducing=num_inducing, device=device, dtype=dtype)
    m.likelihood.variance = 0.05
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def uncertain_inputs_sparse_regression(max_iters=200, optimize=True, plot=False, device=None,
                                       dtype=None):
    """Sparse GP with uncertain (Gaussian) inputs through psi statistics
    (GPy regression.py uncertain_inputs_sparse_regression)."""
    rng = np.random.default_rng(0)
    X = np.sort(rng.uniform(-3, 3, (20, 1)), 0)
    Y = np.sin(X) + rng.normal(scale=0.05, size=X.shape)
    S = np.ones_like(X) * 0.4
    m = SparseGPRegression(X, Y, num_inducing=10, X_variance=S, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def simple_mean_function(max_iters=100, optimize=True, plot=False, device=None, dtype=None):
    """GP with a kernel-expansion mean function (GPy regression.py
    simple_mean_function)."""
    from ..mappings import Kernel as KernelMapping

    rng = np.random.default_rng(0)
    X = np.linspace(0, 10, 50).reshape(-1, 1)
    Y = (np.sin(X) + 0.5 * (X / 10.0) ** 2 + 0.05 * rng.normal(size=X.shape))
    mf = KernelMapping(1, 1, Z=X[::10].copy(), kernel=kern.RBF(1, device=device, dtype=dtype),
                       device=device, dtype=dtype)
    m = GPRegression(X, Y, mean_function=mf, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def parametric_mean_function(max_iters=100, optimize=True, plot=False, device=None,
                             dtype=None):
    """GP whose mean is a linear + constant mapping (GPy regression.py
    parametric_mean_function)."""
    from ..mappings import Constant as ConstantMapping
    from ..mappings import Linear as LinearMapping

    rng = np.random.default_rng(0)
    X = np.linspace(0, 10, 50).reshape(-1, 1)
    Y = np.sin(X) + 0.5 * X + 2.0 + 0.05 * rng.normal(size=X.shape)
    mf = (LinearMapping(1, 1, device=device, dtype=dtype)
          + ConstantMapping(1, 1, value=1.0, device=device, dtype=dtype))
    m = GPRegression(X, Y, mean_function=mf, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def warped_gp_cubic_sine(max_iters=100, optimize=True, plot=False, device=None, dtype=None):
    """Warped GP recovering a cubed-sine output warp (GPy regression.py
    warped_gp_cubic_sine)."""
    from ..models import WarpedGP

    rng = np.random.default_rng(0)
    X = rng.uniform(0, 6, (101, 1))
    Y = np.sin(X) + rng.normal(scale=0.05, size=X.shape)
    Y = (Y + 1.0) ** 3  # warp the observations
    m = WarpedGP(X, Y, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def multioutput_gp_with_derivative_observations(optimize=True, plot=False, device=None,
                                                dtype=None):
    """MultioutputGP jointly over f and df/dx observations through DiffKern
    (GPy regression.py multioutput_gp_with_derivative_observations)."""
    from ..likelihoods import Gaussian
    from ..models import MultioutputGP

    rng = np.random.default_rng(0)
    f = lambda x: np.sin(x) + 0.1 * (x - 2.0) ** 2 - 0.005 * x ** 3  # noqa: E731
    fd = lambda x: np.cos(x) + 0.2 * (x - 2.0) - 0.015 * x ** 2  # noqa: E731
    x = np.linspace(1, 10, 10).reshape(-1, 1)
    y = f(x) + 0.05 * rng.normal(size=(10, 1))
    xd = np.linspace(2, 8, 10).reshape(-1, 1)
    yd = fd(xd) + 0.05 * rng.normal(size=(10, 1))
    se = kern.RBF(1, lengthscale=1.5, variance=0.2, device=device, dtype=dtype)
    se_der = kern.DiffKern(se, 0, device=device, dtype=dtype)
    m = MultioutputGP(X_list=[x, xd], Y_list=[y, yd], kernel_list=[se, se_der],
                      likelihood_list=[Gaussian(variance=0.05**2, device=device, dtype=dtype),
                                       Gaussian(variance=0.05**2, device=device, dtype=dtype)],
                      device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=100)
    return m


def multioutput_gp_with_derivative_observations_2D(optimize=True, plot=False, device=None,
                                                   dtype=None):
    """2-D derivative observations: f plus both partials (GPy regression.py
    multioutput_gp_with_derivative_observations_2D)."""
    from ..likelihoods import Gaussian
    from ..models import MultioutputGP

    rng = np.random.default_rng(0)
    f = lambda X: np.sin(X[:, 0:1]) * np.cos(0.5 * X[:, 1:2])  # noqa: E731
    fdx = lambda X: np.cos(X[:, 0:1]) * np.cos(0.5 * X[:, 1:2])  # noqa: E731
    fdy = lambda X: -0.5 * np.sin(X[:, 0:1]) * np.sin(0.5 * X[:, 1:2])  # noqa: E731
    X = rng.uniform(0, 5, (15, 2))
    Xd = rng.uniform(0, 5, (12, 2))
    y = f(X) + 0.05 * rng.normal(size=(15, 1))
    ydx = fdx(Xd) + 0.05 * rng.normal(size=(12, 1))
    ydy = fdy(Xd) + 0.05 * rng.normal(size=(12, 1))
    se = kern.RBF(2, lengthscale=1.5, variance=0.5, device=device, dtype=dtype)
    lik = Gaussian(variance=0.05**2, device=device, dtype=dtype)
    m = MultioutputGP(X_list=[X, Xd, Xd], Y_list=[y, ydx, ydy],
                      kernel_list=[se, kern.DiffKern(se, 0, device=device, dtype=dtype),
                                   kern.DiffKern(se, 1, device=device, dtype=dtype)],
                      likelihood_list=[lik] * 3, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=100)
    return m


def large_scale_iterative_regression(num_samples=20_000, max_iters=30,
                                     optimize=True, plot=False, fused=None, device=None,
                                     dtype=None):
    """Exact GP regression past the dense-Cholesky memory wall.

    Matrix-free CG and stochastic Lanczos quadrature (inference/iterative.py);
    past 50,000 rows the auto policy switches from the materialized Gram to
    the fused Gram-matvec kernels (csrc/gram_matvec_fused.cu), which never
    store the Gram, and fused=True takes them at any size. No reference
    analogue: GPy materializes K (exact_gaussian_inference.py:53).
    """
    from ..inference.iterative import IterativeGaussianInference

    rng = np.random.default_rng(0)
    X = rng.uniform(0, 10, (num_samples, 2))
    Y = (np.sin(X[:, :1]) * np.cos(0.5 * X[:, 1:2])
         + 0.1 * rng.normal(size=(num_samples, 1)))
    inf = IterativeGaussianInference(max_cg=48, n_probes=8,
                                     **({} if fused is None else {"fused": fused}))
    m = GPRegression(X.astype(np.float32), Y.astype(np.float32),
                     noise_var=0.1, inference_method=inf, device=device, dtype=dtype)
    if optimize:
        m.optimize(optimizer="adam", max_iters=max_iters, step_size=3e-2)
    if plot:
        m.plot()
    return m
