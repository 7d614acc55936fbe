"""FITC, DTC and PEP: gpy_tpu_torch's SparseGPRegression(infer=...) against
gpy_tpu's, and against the port's own exact GP with Z = X.

Twin models are built from the same numpy arrays on the CPU at float64; the
bound, the flat gradient (Z included) and the predictions are compared.
"""
import numpy as np
import pytest
import torch

import gpy_tpu.kern as gk
from gpy_tpu.models.sparse_gp_regression import SparseGPRegression as JSparseGPRegression
from gpy_tpu_torch.inference import DTC, FITC, PEP
from gpy_tpu_torch.kern import RBF
from gpy_tpu_torch.models import GPRegression, SparseGPRegression
from gpy_tpu_torch.util.convert import load_raw_params, raw_params_numpy

INFER = [("fitc", 0.5), ("dtc", 0.5), ("pep", 0.5)]
INFER_IDS = ["fitc", "dtc", "pep0.5"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _data(N=50, D=2, Dout=2, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.random((N, D)) * 3.0
    Y = np.sin(2.0 * X[:, :Dout]) + 0.3 * X[:, -1:] + 0.1 * rng.standard_normal((N, Dout))
    ls = 0.6 + 0.5 * rng.random(D)
    Xs = rng.random((13, D)) * 3.0
    return X, Y, ls, Xs


def _twins(infer, pep_alpha, N=50, D=2, M=10, Dout=2):
    X, Y, ls, Xs = _data(N, D, Dout)
    kw = dict(num_inducing=M, noise_var=0.15, infer=infer, pep_alpha=pep_alpha)
    jm = JSparseGPRegression(X, Y, kernel=gk.RBF(D, variance=1.3, lengthscale=ls, ARD=True),
                             **kw)
    tm = SparseGPRegression(X, Y, kernel=RBF(D, variance=1.3, lengthscale=ls, ARD=True,
                                             device="cpu"), device="cpu", **kw)
    ref = {k: np.asarray(v) for k, v in jm.get_raw_dict().items()}
    got = raw_params_numpy(tm)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-14, err_msg=k)
    return jm, tm, Xs


@pytest.fixture(scope="module", params=INFER, ids=INFER_IDS)
def twins(request):
    torch.set_num_threads(1)
    return _twins(*request.param)


def test_bound_and_gradient_match_reference(twins):
    """rel 1e-8 for the bound and every gradient entry (Z, the kernel's and
    the noise's), the collapsed family's limit."""
    jm, tm, _ = twins
    np.testing.assert_allclose(tm.log_likelihood().item(), float(jm.log_likelihood()),
                               rtol=1e-8)
    g_ref = np.asarray(jm.objective_function_gradients())
    np.testing.assert_allclose(tm.objective_function_gradients(), g_ref, rtol=1e-8,
                               atol=1e-8 * np.abs(g_ref).max())


def test_predict_matches_reference(twins):
    """The posterior (woodbury_inv = Kmm^-1 - P) by its predictions, with
    and without the noise, full covariance and diagonal: rel 1e-8."""
    jm, tm, Xs = twins
    for full_cov in (False, True):
        for include_likelihood in (True, False):
            mu_r, var_r = jm.predict(Xs, full_cov=full_cov, include_likelihood=include_likelihood)
            mu, var = tm.predict(Xs, full_cov=full_cov, include_likelihood=include_likelihood)
            np.testing.assert_allclose(mu, mu_r, rtol=1e-8, atol=1e-8 * np.abs(mu_r).max())
            np.testing.assert_allclose(var, var_r, rtol=1e-8, atol=1e-8 * np.abs(var_r).max())


def test_pep_at_alpha_one_is_fitc():
    """PEP(1) has no power-EP constant and FITC's diagonal correction: the
    same bound and posterior to the last bits (rel 1e-14)."""
    _, fitc, Xs = _twins("fitc", 0.5)
    _, pep, _ = _twins("pep", 1.0)
    assert isinstance(fitc.inference_method, FITC) and isinstance(pep.inference_method, PEP)
    np.testing.assert_allclose(pep.log_likelihood().item(), fitc.log_likelihood().item(),
                               rtol=1e-14)
    for a, b in zip(pep.predict(Xs), fitc.predict(Xs)):
        np.testing.assert_allclose(a, b, rtol=1e-14)


def test_pep_alpha_range_and_dtc():
    with pytest.raises(ValueError, match="alpha"):
        PEP(0.0)
    with pytest.raises(ValueError, match="alpha"):
        PEP(1.5)
    assert DTC().alpha == 0.0 and FITC().alpha == 1.0
    X, Y, _, _ = _data(20, 2, 1)
    with pytest.raises(ValueError, match="VarDTC"):
        FITC().inference(RBF(2, device="cpu"), torch.tensor(X), torch.tensor(X[:4]), None,
                         torch.tensor(Y), qX=object())


@pytest.mark.parametrize("infer", ["vardtc", "fitc", "dtc", "pep"])
def test_full_inducing_matches_exact(infer):
    """tests/test_sparse_gp.py:22-37 against the port's exact GP: with every
    input inducing, each bound is the exact marginal likelihood up to Kmm's
    1e-6 jitter, and so are the predictions (the reference's limits: bound
    rel 1e-2 or abs 0.5, mean and variance abs 5e-2)."""
    rng = np.random.default_rng(7)
    X = np.linspace(0, 5, 25).reshape(25, 1)
    Y = np.sin(X) + 0.2 * rng.standard_normal((25, 1))
    exact = GPRegression(X, Y, noise_var=0.1, device="cpu")
    exact.kern.lengthscale = 1.2
    m = SparseGPRegression(X, Y, Z=X.copy(), noise_var=0.1, infer=infer, device="cpu")
    m.kern.lengthscale = 1.2
    assert m.log_likelihood().item() == pytest.approx(exact.log_likelihood().item(),
                                                      rel=1e-2, abs=0.5)
    Xs = np.linspace(0, 5, 11).reshape(-1, 1)
    for a, b in zip(m.predict(Xs), exact.predict(Xs)):
        np.testing.assert_allclose(a, b, atol=5e-2)


def test_optimize_matches_reference():
    """20 L-BFGS-B iterations of FITC from the same start end where the
    reference's end (rel 1e-5, as the VarDTC trajectory test)."""
    jm, tm, _ = _twins("fitc", 0.5, N=40, M=8, Dout=1)
    jm.optimize(max_iters=20)
    tm.optimize(max_iters=20)
    ref = {k: np.asarray(v) for k, v in jm.get_raw_dict().items()}
    for k, v in raw_params_numpy(tm).items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-5, atol=1e-5 * np.abs(ref[k]).max(),
                                   err_msg=k)
    load_raw_params(tm, ref)
    np.testing.assert_allclose(tm.log_likelihood().item(), float(jm.log_likelihood()),
                               rtol=1e-8)
