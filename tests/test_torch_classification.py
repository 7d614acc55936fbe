"""Non-Gaussian inference: gpy_tpu_torch's EP, Laplace, LaplaceBlock, EPDTC,
SparseGPClassification and OneVsAllClassification against gpy_tpu's.

Twin models are built from the same numpy arrays on the CPU at float64 and
their raw dicts compared before anything else. Then the NLML (rel 1e-9),
the flat gradient (max abs error 1e-7 of its largest entry), predictions
(1e-8) and the count of EP sweeps or Newton steps, which must be equal:
the port's Python loops keep the reference's stopping rules. Then the
reference's own oracles on the port (EP and Laplace are exact for a
Gaussian likelihood, EPDTC with Z = X is dense EP) and finite differences.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpy_tpu.kern as gk
import gpy_tpu.likelihoods as jl
from gpy_tpu.core.gp import GP as JGP
from gpy_tpu.core.sparse_gp import SparseGP as JSparseGP
from gpy_tpu.inference import EP as JEP
from gpy_tpu.inference import EPDTC as JEPDTC
from gpy_tpu.inference import Laplace as JLaplace
from gpy_tpu.inference import LaplaceBlock as JLaplaceBlock
from gpy_tpu.models import OneVsAllClassification as JOneVsAll
from gpy_tpu.models import SparseGPClassification as JSparseGPClassification
from gpy_tpu.util.linalg import jitchol_and_inv
import gpy_tpu_torch.inference.laplace as tlaplace
import gpy_tpu_torch.likelihoods as tl
from gpy_tpu_torch.core.gp import GP
from gpy_tpu_torch.core.sparse_gp import SparseGP
from gpy_tpu_torch.inference import EP, EPDTC, ExactGaussianInference, Laplace, LaplaceBlock
from gpy_tpu_torch.kern import RBF
from gpy_tpu_torch.models import (GPClassification, GPClassificationLaplace,
                                  OneVsAllClassification, SparseGPClassification)
from gpy_tpu_torch.util.convert import load_raw_params, raw_params_numpy

N, NS, M = 40, 60, 8  # dense banana, EPDTC's, its inducing points


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _banana(n, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 2))
    f = np.sin(2 * X[:, 0]) + 0.5 * X[:, 1]
    Y = (f + 0.3 * rng.standard_normal(n) > 0).astype(float).reshape(-1, 1)
    return X, Y


def _regression(n, seed=5):
    rng = np.random.default_rng(seed)
    X = np.linspace(0, 4, n).reshape(-1, 1)
    return X, np.sin(X) + 0.1 * rng.standard_normal((n, 1)), rng


XS = np.random.default_rng(11).standard_normal((7, 2))


def _kerns(D=2, **kw):
    return gk.RBF(D, **kw), RBF(D, device="cpu", **kw)


def _check_raw(jm, tm):
    ref = {k: np.asarray(v) for k, v in jm.get_raw_dict().items()}
    got = raw_params_numpy(tm)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-14, err_msg=k)


def _check_objective(jm, tm):
    # the reference's log likelihood from its jitted objective, which its
    # gradient compiles anyway: its eager log_likelihood() runs the site
    # loop op by op (~7 s an EP model)
    v_ref, g_ref = jm._objective_and_grad(jm.get_flat_raw())
    ll_ref = -float(v_ref) - float(jm.log_prior())
    np.testing.assert_allclose(tm.log_likelihood().item(), ll_ref, rtol=1e-9)
    g_ref = np.asarray(g_ref)
    g = tm.objective_function_gradients()
    assert np.max(np.abs(g - g_ref)) <= 1e-7 * np.max(np.abs(g_ref))


def _check_predictions(jm, tm, Xs, include_likelihood=True):
    for a, b in zip(tm.predict(Xs, include_likelihood=include_likelihood),
                    jm.predict(Xs, include_likelihood=include_likelihood)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8 * np.abs(b).max())


def _jK(jm):
    X = jnp.asarray(jm.X)
    return jm.kern.K(X) + 1e-8 * jnp.eye(X.shape[0], dtype=X.dtype)


def _twin(jm, tm):
    _check_raw(jm, tm)
    return jm, tm


# --- EP ------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ep_twins():
    X, Y = _banana(N)
    jk, tk = _kerns(variance=1.2, lengthscale=0.8)
    return _twin(JGP(X, Y, jk, jl.Bernoulli(), inference_method=JEP()),
                 GPClassification(X, Y, kernel=tk, device="cpu"))


def test_ep_matches_reference_with_equal_sweeps(ep_twins):
    jm, tm = ep_twins
    _check_objective(jm, tm)
    sweeps_ref = int(jm.inference_method._converge_sites(_jK(jm), jm.likelihood,
                                                        jnp.asarray(jm.Y), None)[2])
    assert tm.inference_method.last_sweeps == sweeps_ref < tm.inference_method.max_iters
    _check_predictions(jm, tm, XS)
    _check_predictions(jm, tm, XS, include_likelihood=False)


def test_ep_sweep_cap_matches_reference(ep_twins):
    """epsilon=0 runs exactly max_iters sweeps in both (bench.py's
    two-length differencing relies on it), to the same sites."""
    jm, tm = ep_twins
    K = tm.kern.K(tm.X) + 1e-8 * torch.eye(N, dtype=torch.float64)
    tau, v, it = EP(epsilon=0.0, max_iters=4)._converge_sites(K, tm.likelihood, tm.Y, None)
    tau_r, v_r, it_r = JEP(epsilon=0.0, max_iters=4)._converge_sites(
        _jK(jm), jm.likelihood, jnp.asarray(jm.Y), None)
    assert it == int(it_r) == 4
    np.testing.assert_allclose(tau.numpy(), np.asarray(tau_r), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_r), rtol=1e-10, atol=1e-12)


def test_alternated_ep_optimize_matches_reference():
    """ep_mode="alternated": the sites converge once when optimize() starts
    and are held through it; the posterior cache is dropped after it."""
    X, Y = _banana(N, seed=4)
    jk, tk = _kerns()
    jm, tm = _twin(JGP(X, Y, jk, jl.Bernoulli(), inference_method=JEP(ep_mode="alternated")),
                   GP(X, Y, tk, tl.Bernoulli(device="cpu"),
                      inference_method=EP(ep_mode="alternated"), device="cpu"))
    jm.optimize(max_iters=10)
    tm.optimize(max_iters=10)
    assert not tm.inference_method._frozen and tm._posterior_cache is None
    ref = {k: np.asarray(v) for k, v in jm.get_raw_dict().items()}
    for k, v in raw_params_numpy(tm).items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-7, err_msg=k)
    cache = tm.inference_method._site_cache
    assert cache is not None and cache[0] == N
    _check_predictions(jm, tm, XS)


def test_default_inference_for_a_non_gaussian_likelihood_is_ep():
    X, Y = _banana(12)
    assert isinstance(GP(X, Y, RBF(2, device="cpu"), tl.Bernoulli(device="cpu"),
                         device="cpu").inference_method, EP)


# --- Laplace -------------------------------------------------------------------
def _laplace_case(name):
    if name == "bernoulli":
        X, Y = _banana(N)
        return X, Y, jl.Bernoulli(), tl.Bernoulli(device="cpu"), {}
    X, Y, rng = _regression(25)
    if name == "studentt":
        Y[5] += 3.0  # an outlier
        return (X, Y, jl.StudentT(deg_free=4.0, sigma2=0.1),
                tl.StudentT(deg_free=4.0, sigma2=0.1, device="cpu"), {})
    Yp = rng.poisson(np.exp(np.sin(X) + 1.0)).astype(float)
    return X, Yp, jl.Poisson(), tl.Poisson(device="cpu"), {}


@pytest.mark.parametrize("name,psd", [("bernoulli", True), ("studentt", False),
                                      ("poisson", True)])
def test_laplace_matches_reference_with_equal_newton_steps(name, psd):
    """Bernoulli and Poisson on the Cholesky path, StudentT on the LU path."""
    X, Y, jlik, tlik, _ = _laplace_case(name)
    D = X.shape[1]
    jk, tk = _kerns(D)
    jm, tm = _twin(JGP(X, Y, jk, jlik, inference_method=JLaplace()),
                   GP(X, Y, tk, tlik, inference_method=Laplace(), device="cpu"))
    assert tm.inference_method._psd(tm.likelihood) is psd
    _check_objective(jm, tm)
    steps_ref = int(jm.inference_method._find_mode(_jK(jm), jm.likelihood,
                                                   jnp.asarray(jm.Y), None,
                                                   jnp.zeros_like(jnp.asarray(jm.Y)))[1])
    assert tm.inference_method.last_newton_steps == steps_ref < tm.inference_method.max_iters
    Xs = XS[:, :D]
    _check_predictions(jm, tm, Xs)
    _check_predictions(jm, tm, Xs, include_likelihood=False)


def test_laplace_block_matches_reference_and_laplace():
    """For a factorized likelihood LaplaceBlock computes Laplace's function."""
    X, Y = _banana(N)
    jk, tk = _kerns()
    jm, tm = _twin(JGP(X, Y, jk, jl.Bernoulli(), inference_method=JLaplaceBlock()),
                   GP(X, Y, tk, tl.Bernoulli(device="cpu"), inference_method=LaplaceBlock(),
                      device="cpu"))
    _check_objective(jm, tm)
    _check_predictions(jm, tm, XS)
    plain = GP(X, Y, RBF(2, device="cpu"), tl.Bernoulli(device="cpu"),
               inference_method=Laplace(), device="cpu")
    np.testing.assert_allclose(tm.log_likelihood().item(), plain.log_likelihood().item(),
                               rtol=1e-12)
    assert tm.inference_method.last_newton_steps == plain.inference_method.last_newton_steps
    np.testing.assert_allclose(tm.objective_function_gradients(),
                               plain.objective_function_gradients(), rtol=1e-9, atol=1e-12)


def test_laplace_gradient_carries_the_third_derivative(monkeypatch):
    """The differentiable Newton step's W is a function of f_hat: cutting that
    dependence (W at a detached f_hat) moves the gradient off the reference's,
    so the third derivative of logpdf is on the path."""
    X, Y, _, _, _ = _laplace_case("studentt")
    m = GP(X, Y, RBF(1, device="cpu"), tl.StudentT(deg_free=4.0, sigma2=0.1, device="cpu"),
           inference_method=Laplace(), device="cpu")
    g = m.objective_function_gradients()
    W_grad = tlaplace._W_grad
    monkeypatch.setattr(tlaplace, "_W_grad", lambda f, *a: W_grad(f.detach(), *a))
    g_cut = m.objective_function_gradients()
    assert np.max(np.abs(g_cut - g)) > 1e-4 * np.max(np.abs(g))
    monkeypatch.undo()
    assert m.checkgrad()


# --- EPDTC and sparse classification ---------------------------------------------
def test_epdtc_matches_reference_with_equal_sweeps():
    X, Y = _banana(NS, seed=6)
    Z = X[::7][:M].copy()
    jk, tk = _kerns(variance=1.1, lengthscale=0.9)
    jm, tm = _twin(JSparseGP(X, Y, Z, jk, jl.Bernoulli(), inference_method=JEPDTC()),
                   SparseGP(X, Y, Z, tk, tl.Bernoulli(device="cpu"), inference_method=EPDTC(),
                            device="cpu"))
    _check_objective(jm, tm)
    Lmi = jitchol_and_inv(jm.kern.K(jnp.asarray(Z)) + 1e-6 * jnp.eye(M))[1]
    R = Lmi @ jm.kern.K(jnp.asarray(Z), jnp.asarray(X))
    sweeps_ref = int(jm.inference_method._converge_sites(R, jm.likelihood, jnp.asarray(Y),
                                                        None)[2])
    assert tm.inference_method.last_sweeps == sweeps_ref < tm.inference_method.max_iters
    _check_predictions(jm, tm, XS)


def test_sparse_gp_classification_matches_reference():
    """The SVGP bound with Bernoulli's quadrature data term, at a q(u) away
    from the prior; Z is the reference's permutation pick."""
    X, Y = _banana(NS, seed=7)
    jm = JSparseGPClassification(X, Y, num_inducing=M)
    tm = SparseGPClassification(X, Y, num_inducing=M, device="cpu")
    _check_raw(jm, tm)
    jm.q_u_mean.set_value(0.4 * np.random.default_rng(2).standard_normal((M, 1)))
    load_raw_params(tm, {k: np.asarray(v) for k, v in jm.get_raw_dict().items()})
    _check_objective(jm, tm)
    _check_predictions(jm, tm, XS)


def test_one_vs_all_classification_matches_reference():
    """Each class's model is optimized (max_iters=100, as the reference): the
    labels are noisy, so that no class is separable and each optimum is a
    point (separable classes send the kernel variance to ~1e7 along a flat
    valley, where two float64 runs stop apart)."""
    rng = np.random.default_rng(8)
    X = rng.standard_normal((30, 2))
    Yc = np.digitize(X[:, 0] + 0.3 * X[:, 1] + 0.8 * rng.standard_normal(30), [-0.5, 0.5])
    jm = JOneVsAll(X, Yc, kernel=gk.RBF(2), messages=False)
    tm = OneVsAllClassification(X, Yc, kernel=RBF(2, device="cpu"), messages=False,
                                device="cpu")
    probs, cls = tm.predict(XS)
    probs_ref, cls_ref = jm.predict(XS)
    np.testing.assert_array_equal(cls, cls_ref)
    np.testing.assert_allclose(probs, probs_ref, rtol=1e-8, atol=1e-8)


# --- the reference's oracles on the port -------------------------------------------
@pytest.mark.parametrize("method", ["laplace", "ep"])
def test_approximations_are_exact_for_a_gaussian_likelihood(method):
    """tests/test_inference_approx.py:28-56 on the port."""
    X, Y, _ = _regression(18)
    lik = tl.Gaussian(variance=0.1, device="cpu")
    k = RBF(1, variance=1.3, lengthscale=0.8, device="cpu")
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    exact_post, exact_lml = ExactGaussianInference().inference(k, Xt, lik, Yt)
    approx = Laplace() if method == "laplace" else EP(max_iters=200, delta=1.0)
    post, lml = approx.inference(k, Xt, lik, Yt)
    assert lml.item() == pytest.approx(exact_lml.item(), rel=1e-6 if method == "laplace" else 1e-5)
    xs = torch.tensor([[1.5]], dtype=torch.float64)
    with torch.no_grad():
        mu1, v1 = exact_post._raw_predict(k, xs, Xt)
        mu2, v2 = post._raw_predict(k, xs, Xt)
    assert mu2.item() == pytest.approx(mu1.item(), rel=1e-5 if method == "laplace" else 1e-4)
    assert v2.item() == pytest.approx(v1.item(), rel=1e-4 if method == "laplace" else 1e-3)


def test_epdtc_with_every_input_inducing_is_dense_ep():
    """tests/test_epdtc.py:22 on the port."""
    X, Y = _banana(25, seed=9)
    dense = GP(X, Y, RBF(2, variance=1.2, lengthscale=0.9, device="cpu"),
               tl.Bernoulli(device="cpu"), inference_method=EP(max_iters=200, delta=0.8),
               device="cpu")
    sparse = SparseGP(X, Y, X.copy(), RBF(2, variance=1.2, lengthscale=0.9, device="cpu"),
                      tl.Bernoulli(device="cpu"), inference_method=EPDTC(max_iters=200, delta=0.8),
                      device="cpu")
    assert sparse.log_likelihood().item() == pytest.approx(dense.log_likelihood().item(),
                                                           rel=5e-3)
    np.testing.assert_allclose(sparse.predict(X)[0], dense.predict(X)[0], atol=2e-2)


@pytest.mark.parametrize("model", ["ep", "laplace", "epdtc", "studentt"])
def test_port_models_pass_checkgrad(model):
    X, Y = _banana(20, seed=10)
    if model == "ep":
        m = GPClassification(X, Y, device="cpu")
    elif model == "laplace":
        m = GPClassificationLaplace(X, Y, device="cpu")
    elif model == "epdtc":
        m = SparseGP(X, Y, X[::4].copy(), RBF(2, device="cpu"), tl.Bernoulli(device="cpu"),
                     inference_method=EPDTC(), device="cpu")
    else:
        Xr, Yr, _, _, _ = _laplace_case("studentt")
        m = GP(Xr, Yr, RBF(1, device="cpu"), tl.StudentT(deg_free=4.0, sigma2=0.1, device="cpu"),
               inference_method=Laplace(), device="cpu")
    assert m.checkgrad()


def test_optimize_lowers_the_nlml_and_classifies():
    """tests/test_inference_approx.py:80-87 on the port: GPClassification
    optimize() does not raise the NLML and classifies its training set."""
    X, Y = _banana(N)
    m = GPClassification(X, Y, device="cpu")
    ll0 = m.log_likelihood().item()
    m.optimize(max_iters=50)
    assert m.log_likelihood().item() >= ll0 - 1e-6
    p, _ = m.predict(X)
    assert np.mean((p > 0.5) == (Y > 0.5)) > 0.75
