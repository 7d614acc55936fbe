"""The collapsed sparse GP: gpy_tpu_torch's SparseGPRegression (VarDTC)
against gpy_tpu's, and against the port's own exact GP with Z = X.

Twin models are built from the same numpy arrays on the CPU at float64 and
their raw dicts compared before anything else.
"""
import numpy as np
import pytest
import torch

import gpy_tpu.kern as gk
from gpy_tpu.models.sparse_gp_regression import SparseGPRegression as JSparseGPRegression
from gpy_tpu.models.sparse_gp_regression import _default_Z as j_default_Z
from gpy_tpu_torch.inference import VarDTC
from gpy_tpu_torch.kern import RBF
from gpy_tpu_torch.models import GPRegression, SparseGPRegression
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
    X, Y, _, _ = _data(20, 2, 1)
    for infer in ("fitc", "dtc", "pep"):
        with pytest.raises(NotImplementedError, match="A8"):
            SparseGPRegression(X, Y, infer=infer, device="cpu")
    with pytest.raises(NotImplementedError, match="A12"):
        SparseGPRegression(X, Y, X_variance=np.full_like(X, 0.1), device="cpu")
    m = SparseGPRegression(X, Y, num_inducing=5, device="cpu")
    with pytest.raises(NotImplementedError, match="A12"):
        VarDTC().inference(m.kern, m.X, m.Z.values, m.likelihood, m.Y, qX=object())
