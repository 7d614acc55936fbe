"""State space (Kalman) GPs: gpy_tpu_torch.models.StateSpace against
gpy_tpu's, at float64 on the CPU.

Both packages build the model from the same numpy arrays, the raw
parameters cross by util/convert.py, and the NLML, its gradient and predict
are compared (rel 1e-8, predict atol 1e-8) for each kernel with a state-space
form: the Materns and Exponential, a sum with White, RBF, StdPeriodic, Bias
+ Matern, Linear and Brownian (Van Loan), RatQuad. The engines are held
against each other as the reference's tests hold them (tests/
test_state_space.py): parallel = sequential (rel 1e-10), stable =
sequential (rel 1e-8), cpp = scan (rel 1e-10); and the Kalman NLML against
the port's dense GPRegression, whose inference adds 1e-8 to the noise.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpy_tpu.kern as gk
from gpy_tpu.models.state_space import StateSpace as JStateSpace
import gpy_tpu_torch.kern as tk
from gpy_tpu_torch import mcmc
from gpy_tpu_torch.models import GPRegression, StateSpace
from gpy_tpu_torch.util.convert import load_raw_params, raw_params_numpy

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _toy(n, seed=17, lo=0.0, span=5.0):
    g = np.random.default_rng(seed)
    X = np.sort(lo + g.random(n) * span).reshape(-1, 1)
    return X, np.sin(X * 1.5) + 0.2 * g.standard_normal((n, 1))


def _both(make, **kw):
    """(reference kernel, port kernel) from one recipe over a kernel module."""
    return make(gk, {}), make(tk, dict(device="cpu", **kw))


KERNELS = {
    "mat32": lambda k, c: k.Matern32(1, 1.3, 0.7, **c),
    "mat52": lambda k, c: k.Matern52(1, 0.8, 1.1, **c),
    "exp": lambda k, c: k.Exponential(1, 1.1, 0.9, **c),
    "mat32+exp+white": lambda k, c: (k.Matern32(1, 1.0, 0.5, **c) + k.Exponential(1, 0.4, 2.0, **c)
                                     + k.White(1, 0.2, **c)),
    "rbf": lambda k, c: k.RBF(1, 1.1, 0.9, **c),
    "std_periodic": lambda k, c: k.StdPeriodic(1, 1.0, 1.3, 0.8, **c),
    "bias+mat32": lambda k, c: k.Matern32(1, 1.0, 0.8, **c) + k.Bias(1, 2.0, **c),
    "linear": lambda k, c: k.Linear(1, variances=0.7, **c),
    "brownian+linear": lambda k, c: k.Brownian(1, 0.8, **c) + k.Linear(1, variances=0.3, **c),
    "ratquad": lambda k, c: k.RatQuad(1, 1.1, 0.9, power=1.6, **c),
}


def _twins(name, X, Y, noise=0.3, **kw):
    jk, tkern = _both(KERNELS[name])
    jm = JStateSpace(X, Y, kernel=jk, noise_var=noise, **kw)
    tm = StateSpace(X, Y, kernel=tkern, noise_var=noise, device="cpu", **kw)
    raw = {k: np.asarray(v) for k, v in jm.get_raw_dict().items()}
    load_raw_params(tm, raw)
    return jm, tm


@pytest.mark.parametrize("name", list(KERNELS))
def test_nlml_gradient_and_predict_match_reference(name):
    """The sequential filter against the reference's lax.scan filter: the
    flat raw vector in the reference's order, the NLML and gradient rel
    1e-8, predict (smoother) atol 1e-8. The port's parallel filter then
    gives the sequential NLML and gradient (rel 1e-10), as the reference's
    own does."""
    X, Y = _toy(35, lo=0.3, span=4.5)  # positive times: Brownian's domain
    jm, tm = _twins(name, X, Y)
    x = np.asarray(jm.get_flat_raw())
    np.testing.assert_allclose(tm.get_flat_raw().numpy(), x, rtol=1e-14)
    assert raw_params_numpy(tm).keys() == jm.get_raw_dict().keys()
    fj, gj = jm._get_objgrad()(jm.get_flat_raw())
    f, g = tm._objective_and_grad(x)
    np.testing.assert_allclose(f, float(fj), rtol=1e-8)
    np.testing.assert_allclose(g, np.asarray(gj), rtol=1e-8, atol=1e-10 * np.abs(g).max())
    Xs = np.linspace(0.1, 5.5, 9).reshape(-1, 1)
    for a, b in zip(tm.predict(Xs), jm.predict(Xs)):
        np.testing.assert_allclose(a, b, atol=1e-8, rtol=0)
    tm.parallel = True
    fp, gp = tm._objective_and_grad(x)
    np.testing.assert_allclose(fp, f, rtol=1e-10)
    np.testing.assert_allclose(gp, g, rtol=1e-9, atol=1e-11 * np.abs(g).max())


def test_parallel_filter_matches_sequential_and_reference():
    """The chunked filter at N = 40 (C = 12 chunks of 4 steps, 4 padded) and
    at a chunk count handed in, against the sequential filter (NLML rel
    1e-10, predict atol 1e-8) and the reference's parallel filter (rel
    1e-10); a single point takes the sequential path."""
    X, Y = _toy(40)
    jm, tm = _twins("mat32", X, Y, noise=0.15, parallel=True)
    seq = StateSpace(X, Y, kernel=tk.Matern32(1, 1.3, 0.7, device="cpu"), noise_var=0.15,
                     device="cpu")
    ll = tm.log_likelihood().item()
    np.testing.assert_allclose(ll, seq.log_likelihood().item(), rtol=1e-10)
    np.testing.assert_allclose(ll, float(jm.log_likelihood()), rtol=1e-10)
    Xs = np.linspace(0.2, 4.8, 9).reshape(-1, 1)
    for a, b in zip(tm.predict(Xs), seq.predict(Xs)):
        np.testing.assert_allclose(a, b, atol=1e-8, rtol=0)
    tm.parallel_chunks = 7
    np.testing.assert_allclose(tm.log_likelihood().item(), ll, rtol=1e-10)
    one = [StateSpace(np.array([[0.7]]), np.array([[0.3]]), noise_var=0.2, parallel=p,
                      device="cpu").log_likelihood().item() for p in (False, True)]
    assert one[0] == one[1]


def test_sqrt_filter_matches_sequential_and_reference():
    """The square-root filter at N = 250 against the sequential filter (NLML
    rel 1e-8, predict atol 1e-8, the reference's own test), and at N = 60
    its NLML and gradient (through the reduced QR) against the reference's
    square-root filter, rel 1e-8."""
    g = np.random.default_rng(3)
    X = np.sort(g.uniform(0, 30, 250))
    Y = np.sin(X) + 0.3 * g.standard_normal(250)
    kern = lambda: tk.Matern52(1, lengthscale=1.5, device="cpu")
    seq = StateSpace(X, Y, kernel=kern(), noise_var=0.2, device="cpu")
    sq = StateSpace(X, Y, kernel=kern(), noise_var=0.2, stable=True, device="cpu")
    np.testing.assert_allclose(sq.log_likelihood().item(), seq.log_likelihood().item(),
                               rtol=1e-8)
    Xs = np.linspace(0, 30, 17)
    for a, b in zip(sq.predict(Xs), seq.predict(Xs)):
        np.testing.assert_allclose(a, b, atol=1e-8, rtol=0)
    X2, Y2 = _toy(60, seed=4, span=20.0)
    jm, tm = _twins("mat32", X2, Y2, noise=0.2, stable=True)
    fj, gj = jm._get_objgrad()(jm.get_flat_raw())
    f, gr = tm._objective_and_grad(np.asarray(jm.get_flat_raw()))
    np.testing.assert_allclose(f, float(fj), rtol=1e-8)
    np.testing.assert_allclose(gr, np.asarray(gj), rtol=1e-8)


def test_cpp_engine_matches_scan():
    """The C++ filter (csrc/kalman.cpp, built with g++ into _build/) against
    the sequential filter: NLML rel 1e-10, predict atol 2e-5 (the two
    smoothers invert a near-singular P_pred of the Qc = 0 Linear block in
    different orders), as the reference holds its native engine. optimize
    on an engine="cpp" model runs the differentiable filter. Skipped where
    g++ is missing, as the reference's test is (tests/test_state_space.py:
    207-230)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable")
    X, Y = _toy(60, lo=0.3, span=4.5)
    kf = lambda: (tk.Matern52(1, 1.1, 0.8, device="cpu")
                  + tk.Linear(1, variances=0.05, device="cpu"))
    m_scan = StateSpace(X, Y, kernel=kf(), noise_var=0.2, device="cpu")
    m_cpp = StateSpace(X, Y, kernel=kf(), noise_var=0.2, engine="cpp", device="cpu")
    np.testing.assert_allclose(m_cpp.log_likelihood().item(), m_scan.log_likelihood().item(),
                               rtol=1e-10)
    Xs = np.linspace(0.0, 6.0, 9).reshape(-1, 1)
    for a, b in zip(m_scan.predict(Xs), m_cpp.predict(Xs)):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)
    x0 = m_cpp.optimizer_array
    f0, g0 = m_cpp._objective_and_grad(x0)
    np.testing.assert_allclose(g0, m_scan._objective_and_grad(x0)[1], rtol=1e-12)
    res = m_cpp.optimize(max_iters=5)
    assert m_cpp.engine == "cpp" and res.f_opt < f0
    assert np.isfinite(m_cpp.objective_function().item())


def test_cpp_engine_raises_without_its_library(monkeypatch):
    """engine="cpp" is the caller's choice of the host engine: a build that
    cannot run raises, and no other engine stands in."""
    from gpy_tpu_torch.ops import _build

    def no_build(name):
        raise RuntimeError("g++ not found: the C++ state-space engine needs a C++ compiler")

    monkeypatch.setattr(_build, "load", no_build)
    X, Y = _toy(10)
    m = StateSpace(X, Y, engine="cpp", device="cpu")
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        m.log_likelihood()
    with pytest.raises(ValueError, match="engine"):
        StateSpace(X, Y, engine="fast", device="cpu")


@pytest.mark.parametrize("kw", [{}, dict(parallel=True), dict(stable=True)],
                         ids=["sequential", "parallel", "stable"])
def test_kalman_equals_dense_gp_with_duplicate_times(kw):
    """Each engine's NLML and predict against the port's dense GPRegression
    with Matern32 on 30 points, five of them repeated (dt = 0: A = I, Q =
    0); the Kalman noise is the dense inference's noise + 1e-8. NLML rel
    1e-9 (the stable filter's jittered square roots: 1e-8), the latent
    predict atol 1e-8."""
    X, Y = _toy(30)
    X = np.concatenate([X, X[:5]])
    Y = np.concatenate([Y, Y[:5] + 0.1])
    k = lambda: tk.Matern32(1, 1.2, 0.8, device="cpu")
    dense = GPRegression(X, Y, k(), noise_var=0.1, device="cpu")
    ss = StateSpace(X, Y, kernel=k(), noise_var=0.1 + 1e-8, device="cpu", **kw)
    np.testing.assert_allclose(ss.log_likelihood().item(), dense.log_likelihood().item(),
                               rtol=1e-8 if kw.get("stable") else 1e-9)
    Xs = np.linspace(0.1, 4.9, 11).reshape(-1, 1)
    for a, b in zip(ss.predict(Xs, include_likelihood=False),
                    dense.predict(Xs, include_likelihood=False)):
        np.testing.assert_allclose(a, b, atol=1e-8, rtol=0)


def test_parallel_checkgrad_and_hmc_chains():
    """The chunked filter's gradient against finite differences, and two
    HMC chains (the batched objective's rows in turn) on it."""
    X, Y = _toy(25)
    m = StateSpace(X, Y, kernel=tk.Matern52(1, device="cpu"), noise_var=0.2, parallel=True,
                   device="cpu")
    assert m.checkgrad()
    s = mcmc.HMC(m, stepsize=0.01, num_leapfrog=2).sample(num_samples=2, num_chains=2)
    assert s.shape == (2, 2, m.num_free_params) and np.isfinite(s).all()


def test_smoother_gives_nan_where_the_reference_does():
    """A predicted covariance that is not positive definite: the reference's
    Cholesky in the smoother gives NaN, and so does the port's (no raise);
    the other steps' smoothed states stay finite where the bad gain is not
    reached."""
    X, Y = _toy(6)
    jm, tm = _twins("mat32", X, Y)
    _, ms, Ps, mp, Pp, A, _ = tm._filter(tm.X, tm.Y[:, 0])
    Pp = Pp.clone()
    Pp[3] = -Pp[3]
    with torch.no_grad():
        ms_s, Ps_s = tm._smooth(ms, Ps, mp, Pp, A)
    rm, rP = jm._smooth(*(jnp.asarray(t.detach().numpy()) for t in (ms, Ps, mp, Pp, A)))
    np.testing.assert_array_equal(np.isnan(ms_s.numpy()), np.isnan(np.asarray(rm)))
    assert np.isnan(ms_s[2].numpy()).all() and np.isfinite(ms_s[3:].numpy()).all()
    fin = np.isfinite(np.asarray(rP))
    np.testing.assert_allclose(Ps_s.numpy()[fin], np.asarray(rP)[fin], rtol=1e-10, atol=1e-14)
