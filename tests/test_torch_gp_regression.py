"""The exact-GP slice: gpy_tpu_torch.models.GPRegression against gpy_tpu's.

Twin models are built from the same numpy arrays, gpy_tpu on the CPU at
float64 (tests/conftest.py) and the port on the CPU at float64, and compared
in NLML, flat gradient (index by index), predictions, LOO and the optimum.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpy_tpu.inference.exact as jexact
import gpy_tpu.kern as gk
from gpy_tpu.models import GPRegression as JGPRegression
import gpy_tpu_torch.inference.exact as texact
from gpy_tpu_torch.kern import RBF
from gpy_tpu_torch.models import GPRegression
from gpy_tpu_torch.util import linalg as tl
from gpy_tpu_torch.util.convert import load_raw_params, raw_params_numpy

CASES = [(64, 3), (80, 12)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _data(N, D, seed=0):
    rng = np.random.default_rng(seed + 10 * D)
    X = rng.random((N, D)) * 2.0
    Y = np.sin(2.0 * X[:, :1]) + 0.3 * X[:, -1:] + 0.1 * rng.standard_normal((N, 1))
    ls = 0.8 + 0.5 * rng.random(D)
    Xs = rng.random((15, D)) * 2.0
    return X, Y, ls, Xs


def _twins(N, D, variance=1.3, noise_var=0.2, X=None, Y=None):
    X0, Y0, ls, _ = _data(N, D)
    X = X0 if X is None else X
    Y = Y0 if Y is None else Y
    jm = JGPRegression(X, Y, gk.RBF(D, variance=variance, lengthscale=ls, ARD=True),
                       noise_var=noise_var)
    tm = GPRegression(X, Y, RBF(D, variance=variance, lengthscale=ls, ARD=True, device="cpu"),
                      noise_var=noise_var, device="cpu")
    return jm, tm


@pytest.fixture(scope="module", params=CASES, ids=[f"N{n}_D{d}" for n, d in CASES])
def twins(request):
    torch.set_num_threads(1)
    N, D = request.param
    jm, tm = _twins(N, D)
    return jm, tm, _data(N, D)[3]


def _check_nlml_and_grad(jm, tm):
    np.testing.assert_allclose(tm.objective_function().item(),
                               float(jm.objective_function()), rtol=1e-10)
    np.testing.assert_allclose(tm.objective_function_gradients(),
                               jm.objective_function_gradients(), rtol=1e-8, atol=1e-12)


def test_nlml_and_gradient_match(twins):
    jm, tm, _ = twins
    assert tm.objective_function().dtype == torch.float64
    _check_nlml_and_grad(jm, tm)


@pytest.mark.parametrize("full_cov", [False, True])
def test_predict_matches(twins, full_cov):
    jm, tm, Xs = twins
    for inc in (True, False):
        mu_r, var_r = jm.predict(Xs, full_cov=full_cov, include_likelihood=inc)
        mu, var = tm.predict(Xs, full_cov=full_cov, include_likelihood=inc)
        assert mu.shape == mu_r.shape and var.shape == var_r.shape
        np.testing.assert_allclose(mu, mu_r, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(var, var_r, rtol=1e-9, atol=1e-12)
    mu_r, var_r = jm.predict_noiseless(Xs)
    mu, var = tm.predict_noiseless(Xs)
    np.testing.assert_allclose(mu, mu_r, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(var, var_r, rtol=1e-9, atol=1e-12)


def test_predict_quantiles_and_loo_match(twins):
    jm, tm, Xs = twins
    for q, q_r in zip(tm.predict_quantiles(Xs, (5.0, 50.0, 97.5)),
                      jm.predict_quantiles(Xs, (5.0, 50.0, 97.5))):
        np.testing.assert_allclose(q, q_r, rtol=1e-9, atol=1e-12)
    loo_r = jm.inference_method.LOO(jm.kern, jm.X, jm.likelihood, jm.Y)
    loo = tm.inference_method.LOO(tm.kern, tm.X, tm.likelihood, tm.Y)
    np.testing.assert_allclose(loo.detach().numpy(), np.asarray(loo_r), rtol=1e-9)


def test_checkgrad(twins):
    _, tm, _ = twins
    x0 = tm.optimizer_array
    assert tm.checkgrad()
    np.testing.assert_array_equal(tm.optimizer_array, x0)


def test_chol_branch_matches(twins, monkeypatch):
    """EXPLICIT_INV_MAX_N below N: the port's chol/dpotrs branch against the
    reference's explicit-inverse branch."""
    jm, tm, _ = twins
    monkeypatch.setattr(texact, "EXPLICIT_INV_MAX_N", 8)
    _check_nlml_and_grad(jm, tm)


@pytest.mark.parametrize("N,D", CASES, ids=[f"N{n}_D{d}" for n, d in CASES])
def test_optimize_matches(N, D):
    jm, tm = _twins(N, D)
    f0 = tm.objective_function().item()
    jm.optimize(max_iters=30)
    res = tm.optimize(max_iters=30)
    assert res.f_opt < f0
    np.testing.assert_allclose(tm.objective_function().item(),
                               float(jm.objective_function()), rtol=1e-6)
    np.testing.assert_allclose(tm.param_array, jm.param_array, rtol=1e-4)


def test_scg_lowers_objective():
    _, tm = _twins(40, 2)
    f0 = tm.objective_function().item()
    res = tm.optimize(optimizer="scg", max_iters=20)
    assert res.f_opt < f0
    np.testing.assert_allclose(tm.objective_function().item(), res.f_opt, rtol=1e-12)


def _ladder_twins():
    """Duplicated X rows (D=1, so both packages' distances of a duplicate
    pair are exactly 0), noise fixed near 0 and variance 1e10: the 1e-8
    diagonal floor is below rounding, the second pivot is exactly
    1e10 - (1e10/1e5)**2 = 0, the first Cholesky fails in both packages and
    the ladder's first rung (1e-6 * mean diagonal = 1e4) succeeds."""
    rng = np.random.default_rng(3)
    X = np.repeat(rng.random((24, 1)), 2, axis=0)
    Y = np.sin(X) + 0.1 * rng.standard_normal((48, 1))
    jm, tm = _twins(48, 1, variance=1e10, noise_var=1e-300, X=X, Y=Y)
    jm.likelihood.variance.fix()
    tm.likelihood.variance.fix()
    K = tm.kern.K(tm.X).detach() + (1e-300 + 1e-8) * torch.eye(48, dtype=torch.float64)
    _, jitter = tl.chol_jitter_used(K)
    assert jitter.item() == pytest.approx(1e4, rel=1e-12)
    return jm, tm


def test_jitter_ladder_matches_explicit_branch():
    jm, tm = _ladder_twins()
    _check_nlml_and_grad(jm, tm)


def test_jitter_ladder_chol_branch(monkeypatch):
    """On the chol branch the reference's gradient is NaN whenever the ladder
    runs (its failed probe is an operand of lax.cond, and the zero cotangent
    times the NaN Cholesky pullback is NaN; ROADMAP C(e)), so the port's
    gradient is held to the NLML and to the explicit branch: equal lengthscale
    entries, and a variance entry that differs by the gradient-consistent
    jitter's own term."""
    monkeypatch.setattr(texact, "EXPLICIT_INV_MAX_N", 8)
    monkeypatch.setattr(jexact, "EXPLICIT_INV_MAX_N", 8)
    jm, tm = _ladder_twins()
    np.testing.assert_allclose(tm.objective_function().item(),
                               float(jm.objective_function()), rtol=1e-10)
    assert np.isnan(jm.objective_function_gradients()).all()
    g = tm.objective_function_gradients()
    monkeypatch.setattr(jexact, "EXPLICIT_INV_MAX_N", 1024)
    g_ref = _ladder_twins()[0].objective_function_gradients()
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g[1:], g_ref[1:], rtol=1e-8)
    assert g[0] != g_ref[0]


def test_load_raw_params_carries_the_reference():
    jm, _ = _twins(64, 3)
    jm.kern.lengthscale = [0.4, 1.7, 0.9]
    jm.likelihood.variance = 0.05
    raw = {k: np.asarray(v) for k, v in jm.get_raw_dict().items()}
    tm = GPRegression(jm.X, jm.Y, RBF(3, ARD=True, device="cpu"), device="cpu")
    load_raw_params(tm, raw)
    np.testing.assert_allclose(tm.log_likelihood().item(), float(jm.log_likelihood()), rtol=1e-10)
    back = raw_params_numpy(tm)
    assert list(back) == list(raw)
    for k in raw:
        np.testing.assert_array_equal(back[k], raw[k])
    with pytest.raises(KeyError):
        load_raw_params(tm, {k: v for k, v in raw.items() if k != "kern.variance"})
    with pytest.raises(KeyError):
        load_raw_params(tm, {**raw, "kern.bias": np.zeros(())})


def test_set_xy_refreshes_the_posterior_and_logpdf_matches():
    jm, tm = _twins(64, 3)
    X, Y, _, Xs = _data(40, 3, seed=5)
    mu0 = tm.predict(Xs)[0]
    jm.set_XY(X, Y)
    tm.set_XY(X, Y)
    assert tm.num_data == 40
    mu = tm.predict(Xs)[0]
    assert not np.allclose(mu, mu0)
    np.testing.assert_allclose(mu, jm.predict(Xs)[0], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tm.log_likelihood().item(), float(jm.log_likelihood()), rtol=1e-10)
    f = np.linspace(-2.0, 2.0, 7)[:, None]
    y = np.cos(f)
    ref = np.asarray(jm.likelihood.logpdf(jnp.asarray(f), jnp.asarray(y)))
    got = tm.likelihood.logpdf(torch.as_tensor(f, device="cpu"), torch.as_tensor(y, device="cpu"))
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-13)


def test_unported_options_raise_not_implemented():
    """A mesh without parallel=True, or a mesh that is not a DeviceMesh,
    raises (mesh-sharded restarts are ported: tests/test_torch_parallel.py);
    an unknown optimizer is a ValueError. The options this check once held
    to a raise (lbfgs_device, rprop, normalizer=True) now compute: each
    leaves a finite objective no higher than its start."""
    _, tm = _twins(20, 2)
    with pytest.raises(ValueError, match="parallel=True"):
        tm.optimize_restarts(num_restarts=2, mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        tm.optimize_restarts(num_restarts=2, parallel=True, max_iters=1, mesh=object())
    with pytest.raises(ValueError, match="unknown optimizer"):
        tm.optimize(optimizer="newton")
    f0 = tm.objective_function().item()
    for opt in ("lbfgs_device", "rprop"):
        _, m = _twins(20, 2)
        res = m.optimize(optimizer=opt, max_iters=10)
        assert np.isfinite(res.f_opt) and m.objective_function().item() <= f0
    X, Y, _, Xs = _data(20, 2)
    m = GPRegression(X, Y, RBF(2, device="cpu"), normalizer=True, device="cpu")
    assert np.isfinite(m.predict(Xs)[0]).all()
