"""The GP surface: output normalizers, mean functions (exact, SVGP, Laplace
and the batched objective), the Student-t process, predictive gradients,
samples and densities, and the MAP infer_newX, against gpy_tpu. float64 on
the CPU, twins from the same numpy arrays. Where the reference computes a
wrong number (ROADMAP C(q), C(r)) the test shows the reference's value and
the port's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpy_tpu.kern as gk
import gpy_tpu.likelihoods as jl
import gpy_tpu.mappings as jmap
import gpy_tpu.models as J
from gpy_tpu.core.gp import GP as JGP
from gpy_tpu.inference.laplace import Laplace as JLaplace
from gpy_tpu.util.normalizer import MeanNorm as JMeanNorm, Standardize as JStandardize
import gpy_tpu_torch.mappings as tmap
import gpy_tpu_torch.models as T
from gpy_tpu_torch import likelihoods as tl
from gpy_tpu_torch.core.gp import GP
from gpy_tpu_torch.inference import Laplace
from gpy_tpu_torch.kern import RBF, White
from gpy_tpu_torch.util.normalizer import MeanNorm, Standardize

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _data(N=30, D=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.random((N, D)) * 4
    Y = 3.0 + 2.0 * np.sin(X[:, :1]) + 0.5 * X[:, 1:] + 0.1 * rng.standard_normal((N, 1))
    Xs = rng.random((6, D)) * 4
    return X, Y, Xs


def _linear(pkg, D=2, out=1):
    np.random.seed(0)  # Linear draws A from numpy's global generator
    return jmap.Linear(D, out) if pkg == "ref" else tmap.Linear(D, out, device="cpu")


def _regression(normalizer=None, mean=False):
    X, Y, Xs = _data()
    jn = tn = normalizer
    if normalizer == "standardize":
        jn, tn = JStandardize(), Standardize()
    elif normalizer == "meannorm":
        jn, tn = JMeanNorm(), MeanNorm()
    jm = J.GPRegression(X, Y, gk.RBF(2, ARD=True), normalizer=jn,
                        mean_function=_linear("ref") if mean else None)
    tm = T.GPRegression(X, Y, RBF(2, ARD=True, device="cpu"), normalizer=tn, device="cpu",
                        mean_function=_linear("port") if mean else None)
    return jm, tm, X, Y, Xs


def _objective_and_grad(jm, tm):
    f, g = jm._objective_and_grad(jm.get_flat_raw())
    ft, gt = tm._objective_and_grad(tm.get_flat_raw())
    np.testing.assert_allclose(ft, float(f), rtol=1e-10)
    np.testing.assert_allclose(gt, np.asarray(g), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("normalizer", [True, "standardize", "meannorm"])
def test_normalizer_predict_and_quantiles(normalizer):
    """Y_normalized feeds inference; predict (marginal and full_cov),
    predict_noiseless and predict_quantiles map back: rel 1e-9."""
    jm, tm, X, Y, Xs = _regression(normalizer)
    np.testing.assert_allclose(tm.Y_normalized.numpy(), np.asarray(jm.Y_normalized), rtol=1e-12)
    _objective_and_grad(jm, tm)
    for full_cov in (False, True):
        for a, b in zip(tm.predict(Xs, full_cov=full_cov), jm.predict(Xs, full_cov=full_cov)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9, atol=1e-12)
    for a, b in zip(tm.predict_noiseless(Xs), jm.predict_noiseless(Xs)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9, atol=1e-12)
    for a, b in zip(tm.predict_quantiles(Xs), jm.predict_quantiles(Xs)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9)


def test_mean_function_exact_and_batched():
    """A Linear mean function in exact inference with a normalizer: its
    parameters after the kernel's and the likelihood's in the flat vector,
    the NLML, gradient and predict within rel 1e-10 / 1e-8 / 1e-9; the
    batched objective (HMC chains, parallel restarts) of three rows against
    the reference's vmapped value_and_grad, rel 1e-10 / 1e-8."""
    jm, tm, X, Y, Xs = _regression(True, mean=True)
    assert list(tm.get_raw_dict()) == list(jm.get_raw_dict())
    assert list(tm.get_raw_dict())[-1] == "mean_function.A"
    _objective_and_grad(jm, tm)
    for a, b in zip(tm.predict(Xs), jm.predict(Xs)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9)
    flats = np.asarray(jm.get_flat_raw())[None] + 0.1 * np.arange(3)[:, None]
    v, g = jax.jit(jax.vmap(jax.value_and_grad(jm._flat_objective)))(jnp.asarray(flats))
    vt, gt = tm._batched_objective_and_grad(torch.tensor(flats))
    np.testing.assert_allclose(vt.numpy(), np.asarray(v), rtol=1e-10)
    np.testing.assert_allclose(gt.numpy(), np.asarray(g), rtol=1e-8, atol=1e-10)


def test_mean_function_svgp():
    """SVGP with a Linear mean function: ELBO and gradient (rel 1e-10 /
    1e-8); predict adds the mean function at Xnew to the mean only (rel
    1e-12 against the same model with A = 0)."""
    X, Y, Xs = _data()
    Z = X[:6].copy()
    jm = J.SVGP(X, Y, Z, gk.RBF(2, ARD=True), jl.Gaussian(variance=0.2),
                mean_function=_linear("ref"))
    tm = T.SVGP(X, Y, Z, RBF(2, ARD=True, device="cpu"), tl.Gaussian(variance=0.2, device="cpu"),
                mean_function=_linear("port"), device="cpu")
    _objective_and_grad(jm, tm)
    mu, var = tm.predict(Xs)
    A = tm.mean_function.A.numpy().copy()
    tm.mean_function.A = 0.0
    mu0, var0 = tm.predict(Xs)
    np.testing.assert_allclose(mu - mu0, Xs @ A, rtol=1e-12)
    np.testing.assert_allclose(var, var0, rtol=1e-12)


def test_mean_function_laplace():
    """Laplace on a Bernoulli GP with a Linear mean function: the NLML and
    gradient (rel 1e-9 / 1e-7: the mode search runs to its tolerance in
    each package)."""
    X = _data()[0]
    Yc = (np.sin(X[:, :1]) > 0).astype(float)
    jm = JGP(X, Yc, gk.RBF(2), jl.Bernoulli(), inference_method=JLaplace(),
             mean_function=_linear("ref"))
    tm = GP(X, Yc, RBF(2, device="cpu"), tl.Bernoulli(device="cpu"), inference_method=Laplace(),
            mean_function=_linear("port"), device="cpu")
    f, g = jm._objective_and_grad(jm.get_flat_raw())
    ft, gt = tm._objective_and_grad(tm.get_flat_raw())
    np.testing.assert_allclose(ft, float(f), rtol=1e-9)
    np.testing.assert_allclose(gt, np.asarray(g), rtol=1e-7, atol=1e-9)


def _tp_twins(normalizer=None):
    X, Y, Xs = _data(40)
    jm = J.TPRegression(X, Y, kernel=gk.RBF(2, ARD=True) + gk.White(2, variance=0.05),
                        deg_free=4.0, normalizer=normalizer)
    tm = T.TPRegression(X, Y, kernel=RBF(2, ARD=True, device="cpu")
                        + White(2, variance=0.05, device="cpu"), deg_free=4.0,
                        normalizer=normalizer, device="cpu")
    return jm, tm, Xs


@pytest.mark.parametrize("normalizer", [None, True])
def test_tp_regression(normalizer):
    """TPRegression on RBF + White (a noise term, so the jitter ladder does
    not run: its gradient is NaN in the reference where it does, ROADMAP
    C(e)): deg_free before the kernel in the raw dict, the NLML and gradient
    (rel 1e-10 / 1e-8), predict with the (nu + beta/D - 2)/(nu + N - 2)
    scale (marginal and full_cov) and the Student t quantiles (rel 1e-9)."""
    jm, tm, Xs = _tp_twins(normalizer)
    assert list(tm.get_raw_dict()) == list(jm.get_raw_dict())
    _objective_and_grad(jm, tm)
    for full_cov in (False, True):
        for a, b in zip(tm.predict(Xs, full_cov=full_cov), jm.predict(Xs, full_cov=full_cov)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9)
    for a, b in zip(tm.predict_quantiles(Xs), jm.predict_quantiles(Xs)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9)


def test_predictive_gradients_and_covariances():
    """predictive_gradients (mean function included in d mu), predict_jacobian,
    predict_wishart_embedding and predict_magnification on a 3-output GP in
    2-D, and posterior_covariance_between_points of a 1-output GP (mapped
    back through the normalizer): rel 1e-9. With 3 outputs the covariance
    does not map back (ROADMAP C(t))."""
    X, Y, Xs = _data()
    Y3 = np.hstack([Y, np.cos(X[:, :1]), X[:, 1:] ** 2 / 4])
    jm = J.GPRegression(X, Y3, gk.RBF(2, ARD=True), normalizer=True,
                        mean_function=_linear("ref", out=3))
    tm = T.GPRegression(X, Y3, RBF(2, ARD=True, device="cpu"), normalizer=True,
                        mean_function=_linear("port", out=3), device="cpu")
    (dmu, dvar), (rmu, rvar) = tm.predictive_gradients(Xs), jm.predictive_gradients(Xs)
    assert dmu.shape == (6, 2, 3) and dvar.shape == (6, 2)
    np.testing.assert_allclose(dmu, rmu, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(dvar, rvar, rtol=1e-9, atol=1e-12)
    # the reference's jacobian, embedding and magnification are these forms
    # of its predictive_gradients (gpy_tpu/core/gp.py:476-499)
    G = np.einsum("nqd,npd->nqp", rmu, rmu)
    np.testing.assert_allclose(tm.predict_jacobian(Xs), rmu, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tm.predict_wishart_embedding(Xs), G, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tm.predict_magnification(Xs),
                               np.sqrt(np.maximum(np.linalg.det(G), 0.0)), rtol=1e-8)
    # with 3 outputs of different scales one covariance cannot map back: the
    # port raises; the reference scales its columns by the outputs'
    # variances where the points are 3, and raises elsewhere (ROADMAP C(t))
    with pytest.raises(ValueError, match="outputs of different scales"):
        tm.posterior_covariance_between_points(Xs[:3], Xs[:3])
    bad = jm.posterior_covariance_between_points(Xs[:3], Xs[:3])
    assert not np.allclose(bad, bad.T)
    jm, tm, _, _, _ = _regression(True)
    np.testing.assert_allclose(tm.posterior_covariance_between_points(Xs, Xs[:4]),
                               jm.posterior_covariance_between_points(Xs, Xs[:4]),
                               rtol=1e-9, atol=1e-12)


def test_posterior_samples_moments():
    """Samples are compared by their moments (ROADMAP C(b)): 20,000 draws of
    f* at 5 points with full_cov, from a seed and from a torch.Generator,
    have the predictive mean and covariance within 5 Monte-Carlo standard
    errors; posterior_samples of y* with a normalizer have the variance of
    predict (the noise drawn at the normalized scale and mapped back, ROADMAP
    C(r); the reference's sample variance is the noiseless variance plus the
    normalized noise, which the test shows too)."""
    jm, tm, X, Y, Xs = _regression(True)
    S = 20_000
    mu, cov = tm.predict_noiseless(Xs[:5], full_cov=True)
    for seed in (0, torch.Generator().manual_seed(3)):
        fs = tm.posterior_samples_f(Xs[:5], size=S, seed=seed)[:, 0, :]
        assert fs.shape == (5, S)
        se = np.sqrt(np.diag(cov) / S)
        assert np.all(np.abs(fs.mean(1) - mu[:, 0]) < 5 * se)
        emp = np.cov(fs)
        se_cov = np.sqrt((cov**2 + np.outer(np.diag(cov), np.diag(cov))) / S)
        assert np.all(np.abs(emp - cov) < 5 * se_cov)
    _, var_y = tm.predict(Xs[:5])
    ys = tm.posterior_samples(Xs[:5], size=S, full_cov=False)[:, 0, :]
    assert np.all(np.abs(ys.var(1) / var_y[:, 0] - 1) < 5 * np.sqrt(2.0 / S))
    ry = np.asarray(jm.posterior_samples(Xs[:5], size=S, full_cov=False))[:, 0, :]
    noiseless = np.diag(cov)
    s2 = float(jm.likelihood.variance)
    np.testing.assert_allclose(ry.var(1), noiseless + s2, rtol=10 * np.sqrt(2.0 / S))
    assert np.all(ry.var(1) < 0.9 * var_y[:, 0])


def test_sample_factor_failure_gives_nan():
    """Where var + 1e-8 tr(var)/n I has no Cholesky factor the full_cov draws
    are NaN, in both packages (jnp.linalg.cholesky returns NaN; the port
    masks cholesky_ex's factor on its info, no exception)."""
    mu = np.zeros((3, 1))
    var = np.diag([1.0, -1.0, 1.0])
    ref = np.asarray(JGP._sample_f_tail(jnp.asarray(mu), jnp.asarray(var),
                                        jax.random.PRNGKey(0), 4, True))
    got = GP._sample_f_tail(torch.tensor(mu), torch.tensor(var), torch.Generator(), 4, True)
    assert np.isnan(ref).all() and torch.isnan(got).all() and got.shape == (3, 1, 4)


def test_log_predictive_density():
    """Without a normalizer the density equals the reference's (rel 1e-10).
    With Standardize the reference returns the density of the normalized y
    (ROADMAP C(q)); the port's is the density of y, the reference's less
    log(std), and it equals the Gaussian density of y under predict's mean
    and variance. The sampled density agrees with the closed form within
    0.02 at 20,000 draws."""
    jm, tm, X, Y, Xs = _regression(None)
    ys = 3.0 + 2.0 * np.sin(Xs[:, :1]) + 0.5 * Xs[:, 1:]
    np.testing.assert_allclose(tm.log_predictive_density(Xs, ys),
                               np.asarray(jm.log_predictive_density(Xs, ys)), rtol=1e-10)
    jm, tm, X, Y, Xs = _regression(True)
    ref = np.asarray(jm.log_predictive_density(Xs, ys))
    got = tm.log_predictive_density(Xs, ys)
    std = float(np.std(Y))
    np.testing.assert_allclose(got, ref - np.log(std), rtol=1e-10)
    mu, var = tm.predict(Xs)
    np.testing.assert_allclose(got, -0.5 * np.log(2 * np.pi * var) - 0.5 * (ys - mu) ** 2 / var,
                               rtol=1e-10)
    sampled = tm.log_predictive_density_sampling(Xs, ys, num_samples=20_000)
    np.testing.assert_allclose(sampled, got, atol=0.02)


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
def test_infer_newX_map(optimizer):
    """MAP infer_newX on a GPLVM (variational=False, the default tol 1e-6
    early exit): X*, the returned value and the steps taken equal the
    reference's (rel 1e-8 / 1e-10); Adam at lr 1e-2 and optax.lbfgs."""
    g = np.random.default_rng(0)
    Y = g.standard_normal((30, 3)) @ g.standard_normal((3, 5)) + 0.1 * g.standard_normal((30, 5))
    Ynew = g.standard_normal((4, 3)) @ g.standard_normal((3, 5))
    jm, tm = J.GPLVM(Y, 2), T.GPLVM(Y, 2, device="cpu")
    xr, vr = jm.infer_newX(Ynew, optimize_iters=60, optimizer=optimizer)
    xt, vt = tm.infer_newX(Ynew, optimize_iters=60, optimizer=optimizer)
    np.testing.assert_allclose(xt, np.asarray(xr), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(vt, vr, rtol=1e-10)
    assert tm._infer_newX_iters == jm._infer_newX_iters
