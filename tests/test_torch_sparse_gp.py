"""The collapsed sparse GP: gpy_tpu_torch's SparseGPRegression (VarDTC),
VarDTC_minibatch, SparseGPRegressionMD (VarDTCMissingData) and the
heteroscedastic likelihood (in SparseGP and GPHeteroscedasticRegression)
against gpy_tpu's, and against the port's own exact GP with Z = X.

Twin models are built from the same numpy arrays on the CPU at float64 and
their raw dicts compared before anything else.
"""
import numpy as np
import pytest
import torch

import gpy_tpu.kern as gk
from gpy_tpu.core.sparse_gp import SparseGP as JSparseGP
from gpy_tpu.inference.var_dtc import VarDTC_minibatch as JVarDTC_minibatch
from gpy_tpu.likelihoods import HeteroscedasticGaussian as JHeteroscedasticGaussian
from gpy_tpu.models import GPHeteroscedasticRegression as JGPHeteroscedasticRegression
from gpy_tpu.models import SparseGPRegressionMD as JSparseGPRegressionMD
from gpy_tpu.models.sparse_gp_regression import SparseGPRegression as JSparseGPRegression
from gpy_tpu.models.sparse_gp_regression import _default_Z as j_default_Z
from gpy_tpu_torch.core.sparse_gp import SparseGP
from gpy_tpu_torch.inference import VarDTC, VarDTC_minibatch
from gpy_tpu_torch.kern import RBF
from gpy_tpu_torch.likelihoods import Gaussian, HeteroscedasticGaussian
from gpy_tpu_torch.models import (GPHeteroscedasticRegression, GPRegression, SparseGPRegression,
                                  SparseGPRegressionMD)
from gpy_tpu_torch.models.sparse_gp_regression import _default_Z
from gpy_tpu_torch.util.convert import load_raw_params, raw_params_numpy

CASES = [(50, 2, 10, 1), (60, 3, 12, 2)]  # N, input dim, M, outputs


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _data(N, D, Dout, seed=0):
    rng = np.random.default_rng(seed + D)
    X = rng.random((N, D)) * 3.0
    Y = np.sin(2.0 * X[:, :Dout]) + 0.3 * X[:, -1:] + 0.1 * rng.standard_normal((N, Dout))
    ls = 0.6 + 0.5 * rng.random(D)
    Xs = rng.random((13, D)) * 3.0
    return X, Y, ls, Xs


def _twins(N, D, M, Dout):
    X, Y, ls, Xs = _data(N, D, Dout)
    jm = JSparseGPRegression(X, Y, kernel=gk.RBF(D, variance=1.3, lengthscale=ls, ARD=True),
                             num_inducing=M, noise_var=0.15)
    tm = SparseGPRegression(X, Y, kernel=RBF(D, variance=1.3, lengthscale=ls, ARD=True,
                                             device="cpu"),
                            num_inducing=M, noise_var=0.15, device="cpu")
    ref = {k: np.asarray(v) for k, v in jm.get_raw_dict().items()}
    got = raw_params_numpy(tm)
    assert list(got) == list(ref) == ["Z", "kern.variance", "kern.lengthscale",
                                      "likelihood.variance"]
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-14, err_msg=k)
    return jm, tm, Xs


@pytest.fixture(scope="module", params=CASES, ids=[f"N{c[0]}_D{c[1]}_M{c[2]}_out{c[3]}"
                                                   for c in CASES])
def twins(request):
    torch.set_num_threads(1)
    return _twins(*request.param)


def test_default_z_is_the_reference_pick():
    X = np.random.default_rng(1).random((30, 2))
    np.testing.assert_array_equal(_default_Z(X, 7), j_default_Z(X, 7))
    np.testing.assert_array_equal(_default_Z(torch.tensor(X), 7).numpy(), j_default_Z(X, 7))


def test_bound_and_gradient_match_reference(twins):
    jm, tm, _ = twins
    np.testing.assert_allclose(tm.log_likelihood().item(), float(jm.log_likelihood()),
                               rtol=1e-10)
    g_ref = np.asarray(jm.objective_function_gradients())
    np.testing.assert_allclose(tm.objective_function_gradients(), g_ref, rtol=1e-8,
                               atol=1e-8 * np.abs(g_ref).max())


@pytest.mark.parametrize("full_cov", [False, True])
def test_predict_matches_reference(twins, full_cov):
    """Against the inducing inputs Z, not X: the port's predict used X for
    every model before sparse GPs came."""
    jm, tm, Xs = twins
    for include_likelihood in (True, False):
        mu_r, var_r = jm.predict(Xs, full_cov=full_cov, include_likelihood=include_likelihood)
        mu, var = tm.predict(Xs, full_cov=full_cov, include_likelihood=include_likelihood)
        np.testing.assert_allclose(mu, mu_r, rtol=1e-9, atol=1e-9 * np.abs(mu_r).max())
        np.testing.assert_allclose(var, var_r, rtol=1e-9, atol=1e-9 * np.abs(var_r).max())


def test_optimize_matches_reference():
    jm, tm, Xs = _twins(40, 2, 8, 1)
    jm.optimize(max_iters=15)
    tm.optimize(max_iters=15)
    ref = {k: np.asarray(v) for k, v in jm.get_raw_dict().items()}
    for k, v in raw_params_numpy(tm).items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-5, atol=1e-5 * np.abs(ref[k]).max(),
                                   err_msg=k)
    assert tm.checkgrad()


def test_load_raw_params_carries_a_changed_reference():
    jm, tm, _ = _twins(40, 2, 8, 1)
    rng = np.random.default_rng(4)
    jm.Z.set_value(np.asarray(jm.Z) + 0.1 * rng.standard_normal((8, 2)))
    jm.kern.lengthscale = np.array([0.9, 1.4])
    jm.likelihood.variance = 0.05
    load_raw_params(tm, {k: np.asarray(v) for k, v in jm.get_raw_dict().items()})
    np.testing.assert_allclose(tm.log_likelihood().item(), float(jm.log_likelihood()),
                               rtol=1e-10)


def test_sparse_with_z_equal_x_matches_exact():
    """With every input inducing, the collapsed bound is the exact marginal
    likelihood up to Kmm's jitter (1e-6 at cond(Kmm) ~7e5), and so are the
    predictions: ~10x the readings (bound rel 4.8e-6, mean 1.8e-5,
    variance 5.3e-6)."""
    X, Y, ls, Xs = _data(30, 2, 1)
    kern = dict(variance=1.3, lengthscale=ls, ARD=True, device="cpu")
    exact = GPRegression(X, Y, RBF(2, **kern), noise_var=0.1, device="cpu")
    sparse = SparseGPRegression(X, Y, RBF(2, **kern), Z=X.copy(), noise_var=0.1, device="cpu")
    np.testing.assert_allclose(sparse.log_likelihood().item(), exact.log_likelihood().item(),
                               rtol=5e-5)
    mu_e, var_e = exact.predict(Xs)
    mu_s, var_s = sparse.predict(Xs)
    np.testing.assert_allclose(mu_s, mu_e, atol=2e-4)
    np.testing.assert_allclose(var_s, var_e, atol=5e-5)
    assert sparse.log_likelihood().item() <= exact.log_likelihood().item() + 1e-9


def test_unported_options_raise():
    """Uncertain inputs are ported (A12): X_variance builds a model whose
    bound is VarDTC's under the q(X), and VarDTC_minibatch's chunks under
    it give VarDTC's bound (rel 1e-10). Only VarDTC takes uncertain inputs,
    as in the reference; an unknown infer raises."""
    from gpy_tpu_torch.kern.psi_comp import moments
    from types import SimpleNamespace

    X, Y, _, _ = _data(20, 2, 1)
    m = SparseGPRegression(X, Y, num_inducing=5, X_variance=np.full_like(X, 0.1), device="cpu")
    q = moments(SimpleNamespace(mean=m.X, variance=torch.full_like(m.X, 0.1)))
    lm = VarDTC().marginal_likelihood(m.kern, m.X, m.Z.values, m.likelihood, m.Y, qX=q)
    np.testing.assert_allclose(m.log_likelihood().item(), lm.item(), rtol=1e-14)
    lmb = VarDTC_minibatch(batchsize=7).marginal_likelihood(m.kern, m.X, m.Z.values,
                                                           m.likelihood, m.Y, qX=q)
    np.testing.assert_allclose(lmb.item(), lm.item(), rtol=1e-10)
    with pytest.raises(ValueError, match="VarDTC"):
        SparseGPRegression(X, Y, X_variance=np.full_like(X, 0.1), infer="fitc", device="cpu")
    with pytest.raises(ValueError, match="unknown infer"):
        SparseGPRegression(X, Y, infer="ep", device="cpu")


def _flat_grad(m):
    return m.objective_function_gradients()


@pytest.mark.parametrize("batchsize", [7, 60])
def test_minibatch_matches_vardtc_and_reference(batchsize):
    """VarDTC_minibatch at a batchsize that does not divide N (a short last
    chunk) and at one chunk, against VarDTC (bound, woodbury vector and
    inverse, gradient) and against the reference's minibatch bound
    (tests/test_surface_extras.py:22-33): rel 1e-10 for the bounds, 1e-8 for
    the gradients and the posterior."""
    jm, tm, Xs = _twins(50, 2, 10, 2)
    X, Y = tm.X.numpy(), tm.Y.numpy()
    Z = tm.Z.numpy()
    kern = dict(variance=1.3, lengthscale=tm.kern.lengthscale.numpy(), ARD=True)
    mb = SparseGPRegression(X, Y, kernel=RBF(2, device="cpu", **kern), Z=Z, noise_var=0.15,
                            infer=VarDTC_minibatch(batchsize=batchsize), device="cpu")
    np.testing.assert_allclose(mb.log_likelihood().item(), tm.log_likelihood().item(),
                               rtol=1e-10)
    g = _flat_grad(tm)
    np.testing.assert_allclose(_flat_grad(mb), g, rtol=1e-8, atol=1e-8 * np.abs(g).max())
    for a, b in ((mb.posterior.woodbury_vector, tm.posterior.woodbury_vector),
                 (mb.posterior.woodbury_inv, tm.posterior.woodbury_inv)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-8,
                                   atol=1e-8 * b.abs().max().item())
    jp, jl = JVarDTC_minibatch(batchsize=batchsize).inference(
        gk.RBF(2, **kern), X, Z, jm.likelihood, Y)
    np.testing.assert_allclose(mb.log_likelihood().item(), float(jl), rtol=1e-10)
    np.testing.assert_allclose(mb.posterior.woodbury_vector.numpy(),
                               np.asarray(jp.woodbury_vector), rtol=1e-8,
                               atol=1e-8 * np.abs(np.asarray(jp.woodbury_vector)).max())


def _md_data(N=60, D_out=3, seed=5):
    rng = np.random.default_rng(seed)
    X = rng.random((N, 2)) * 3.0
    idx = rng.integers(0, D_out, N)
    y = np.sin(2.0 * X[:, 0]) + 0.3 * idx + 0.1 * rng.standard_normal(N)
    return X, y, idx, X[::6].copy()


@pytest.mark.parametrize("individual_Y_noise", [False, True])
def test_md_matches_reference(individual_Y_noise):
    """SparseGPRegressionMD's bound and flat gradient (Z, kernel, one or D
    noise variances) against the reference's, rel 1e-8; the gradient is
    finite with every row missing D - 1 of its D outputs; the predictions
    from the averaged posterior, rel 1e-8."""
    X, y, idx, Z = _md_data()
    kw = dict(Z=Z, individual_Y_noise=individual_Y_noise)
    jm = JSparseGPRegressionMD(X, y, idx, kernel=gk.RBF(2, ARD=True), **kw)
    tm = SparseGPRegressionMD(X, y, idx, kernel=RBF(2, ARD=True, device="cpu"), device="cpu",
                              **kw)
    assert torch.isnan(tm.Y).sum().item() == 2 * 60 and tm.output_dim == 3
    ref = {k: np.asarray(v) for k, v in jm.get_raw_dict().items()}
    assert ref["likelihood.variance"].shape == ((3,) if individual_Y_noise else ())
    got = raw_params_numpy(tm)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-14, err_msg=k)
    np.testing.assert_allclose(tm.log_likelihood().item(), float(jm.log_likelihood()), rtol=1e-8)
    g, g_ref = _flat_grad(tm), np.asarray(jm.objective_function_gradients())
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, g_ref, rtol=1e-8, atol=1e-8 * np.abs(g_ref).max())
    Xs = np.random.default_rng(2).random((9, 2)) * 3.0
    for a, b in zip(tm.predict(Xs), jm.predict(Xs)):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8 * np.abs(b).max())


def test_md_is_the_sum_of_per_output_bounds():
    """tests/test_svi_multiout.py:203-221: the MD bound is the sum of the
    outputs' own VarDTC bounds on their rows (rel 1e-8, the reference's
    limit), and so is its gradient (each output's bound differentiated)."""
    X, y, idx, Z = _md_data()
    m = SparseGPRegressionMD(X, y, idx, Z=Z, device="cpu")
    m.likelihood.variance = 0.07
    m.kern.lengthscale = 1.2
    parts = []
    for d in range(3):
        md = SparseGPRegression(X[idx == d], y[idx == d].reshape(-1, 1), Z=Z.copy(),
                                device="cpu")
        md.likelihood.variance = 0.07
        md.kern.lengthscale = 1.2
        parts.append(md)
    np.testing.assert_allclose(m.log_likelihood().item(),
                               sum(p.log_likelihood().item() for p in parts), rtol=1e-8)
    g = sum(_flat_grad(p) for p in parts)
    np.testing.assert_allclose(_flat_grad(m), g, rtol=1e-8, atol=1e-8 * np.abs(g).max())


def test_heteroscedastic_sparse_gp_matches_reference():
    """tests/test_sparse_gp.py:64-73: VarDTC with one noise variance per
    point, bound and gradient (the N variances included) rel 1e-8; with every
    variance equal it is the Gaussian likelihood's bound (rel 1e-12)."""
    rng = np.random.default_rng(7)
    X = np.linspace(0, 5, 20).reshape(20, 1)
    Y = np.sin(X) + 0.2 * rng.standard_normal((20, 1))
    md = {"output_index": np.arange(20).reshape(-1, 1)}
    jm = JSparseGP(X, Y, X[::3].copy(), gk.RBF(1), JHeteroscedasticGaussian(md, variance=0.2),
                   Y_metadata=md, name="het_sgp")
    lik = HeteroscedasticGaussian(md, variance=0.2, device="cpu")
    tm = SparseGP(X, Y, X[::3].copy(), RBF(1, device="cpu"), lik, Y_metadata=md,
                  name="het_sgp", device="cpu")
    tm.likelihood.variance = 0.2 + 0.1 * rng.random(20)
    load_raw_params(tm, raw_params_numpy(tm))
    jm.likelihood.variance = np.asarray(tm.likelihood.variance)
    np.testing.assert_allclose(tm.log_likelihood().item(), float(jm.log_likelihood()), rtol=1e-8)
    g_ref = np.asarray(jm.objective_function_gradients())
    assert g_ref.shape == (7 + 2 + 20,)
    np.testing.assert_allclose(_flat_grad(tm), g_ref, rtol=1e-8, atol=1e-8 * np.abs(g_ref).max())
    tm.likelihood.variance = 0.1
    gauss = SparseGP(X, Y, X[::3].copy(), RBF(1, device="cpu"),
                     Gaussian(variance=0.1, device="cpu"), device="cpu")
    np.testing.assert_allclose(tm.log_likelihood().item(), gauss.log_likelihood().item(),
                               rtol=1e-12)
    assert lik.conditional_variance(torch.zeros(3)).shape == (3,)


def test_gp_heteroscedastic_regression_matches_reference():
    """The exact GP with one noise variance per point: NLML and gradient rel
    1e-8, predictions (Y_metadata picks the test points' variances) rel 1e-8."""
    rng = np.random.default_rng(8)
    X = rng.random((30, 2)) * 3.0
    Y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((30, 1))
    jm = JGPHeteroscedasticRegression(X, Y, kernel=gk.RBF(2, ARD=True))
    tm = GPHeteroscedasticRegression(X, Y, kernel=RBF(2, ARD=True, device="cpu"), device="cpu")
    noise = 0.05 + 0.1 * rng.random(30)
    jm.likelihood.variance = noise
    tm.likelihood.variance = noise
    got, ref = raw_params_numpy(tm), {k: np.asarray(v) for k, v in jm.get_raw_dict().items()}
    assert list(got) == list(ref)
    np.testing.assert_allclose(tm.log_likelihood().item(), float(jm.log_likelihood()), rtol=1e-8)
    g_ref = np.asarray(jm.objective_function_gradients())
    np.testing.assert_allclose(_flat_grad(tm), g_ref, rtol=1e-8, atol=1e-8 * np.abs(g_ref).max())
    meta = {"output_index": np.arange(5).reshape(-1, 1)}
    for a, b in zip(tm.predict(X[:5], Y_metadata=meta), jm.predict(X[:5], Y_metadata=meta)):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8 * np.abs(b).max())
