"""The port's host-side utilities against gpy_tpu's.

util/misc (the Gaussian helpers on a grid from -40 to 40, tails included:
rel 1e-12 against mpmath at 60 digits wherever the true value is a normal
float64, and rel 1e-12 against the reference wherever the reference itself
is that close to mpmath; the reference's own tail errors are ROADMAP C(ag);
the block, safe and chain helpers; kmm_init, conf_matrix and
common_subarrays), util/quad_integrate, optimization's schedulers and
util/parallel's divide_data (index sequences equal to the reference's),
optimize_parallel's checkpoints, and util/diagnostics and util/profiling
(timers, metrics, Chrome traces on the CPU, profile_objective,
log_compiles). float64 on the CPU.
"""
import glob
import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpy_tpu.optimization as jopt
import gpy_tpu.util.misc as jmisc
import gpy_tpu.util.parallel as jpar
import gpy_tpu.util.quad_integrate as jquad
import gpy_tpu_torch
import gpy_tpu_torch.optimization as topt
import gpy_tpu_torch.util.misc as tmisc
import gpy_tpu_torch.util.parallel as tpar
import gpy_tpu_torch.util.quad_integrate as tquad
from gpy_tpu_torch.models import GPRegression
from gpy_tpu_torch.ops import _build
from gpy_tpu_torch.util import diagnostics, profiling

GRID = np.concatenate([np.linspace(-40.0, 40.0, 801), [-38.5, -25.25, -9.99, 7.5, 39.9]])


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _mp(name, x=GRID):
    """The Gaussian helper `name` at x (GRID) at 60 digits (mpmath)."""
    import mpmath

    mpmath.mp.dps = 60
    fn = {"std_norm_pdf": mpmath.npdf, "std_norm_cdf": mpmath.ncdf,
          "logPhi": lambda v: (mpmath.log1p(-mpmath.ncdf(-v)) if v > 0
                               else mpmath.log(mpmath.ncdf(v))),
          "logPdfNormal": lambda v: mpmath.log(mpmath.npdf(v)),
          "derivLogCdfNormal": lambda v: mpmath.npdf(v) / mpmath.ncdf(v)}[name]
    return np.array([float(fn(mpmath.mpf(float(v)))) for v in x])


def _rel(a, b):
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.abs(a - b) / np.abs(b)


@pytest.mark.parametrize("name", ["std_norm_pdf", "std_norm_cdf", "logPhi", "logPdfNormal",
                                  "derivLogCdfNormal"])
def test_gaussian_helpers_on_the_grid(name):
    got = getattr(tmisc, name)(_t(GRID)).numpy()
    want = np.asarray(getattr(jmisc, name)(jnp.asarray(GRID)))
    exact = _mp(name)
    normal = np.abs(exact) >= np.finfo(np.float64).tiny
    assert np.all(_rel(got, exact)[normal] <= 1e-12)
    ref_ok = normal & (_rel(want, exact) <= 1e-12)
    assert ref_ok.sum() >= 0.7 * normal.sum()  # C(ag): where the reference is off
    assert np.all(_rel(got, want)[ref_ok] <= 1e-12)
    assert np.all(np.isfinite(got))


def test_reference_gaussian_tails_are_off():
    """ROADMAP C(ag): the reference's log Phi (jax's log_ndtr) is off where
    Phi is close to 1 (x = 8: rel error ~7e-2), and its derivLogCdfNormal
    is off in the left tail (x = -20: ~4e-9); the port's helpers are
    within 1e-12 of the true values there."""
    x = np.array([8.0, -20.0])
    exact_l, exact_d = _mp("logPhi", x), _mp("derivLogCdfNormal", x)
    ref_l = np.asarray(jmisc.logPhi(jnp.asarray(x)))
    ref_d = np.asarray(jmisc.derivLogCdfNormal(jnp.asarray(x)))
    assert _rel(ref_l[0], exact_l[0]) > 1e-2
    assert _rel(ref_d[1], exact_d[1]) > 1e-9
    assert _rel(tmisc.logPhi(_t(x)).numpy()[0], exact_l[0]) <= 1e-12
    assert _rel(tmisc.derivLogCdfNormal(_t(x)).numpy()[1], exact_d[1]) <= 1e-12


@pytest.mark.parametrize("name", ["sigmoid", "clip_exp", "safe_exp", "safe_square", "safe_cube",
                                  "safe_quad", "safe_three_times"])
def test_misc_on_the_grid(name):
    got = getattr(tmisc, name)(_t(GRID)).numpy()
    want = np.asarray(getattr(jmisc, name)(jnp.asarray(GRID)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_tails_stay_finite():
    x = _t([-40.0, -60.0, -200.0])
    assert torch.isfinite(tmisc.logPhi(x)).all() and torch.isfinite(tmisc.derivLogCdfNormal(x)).all()
    # phi/Phi ~ -x far out: the ratio of two underflowed numbers would be NaN
    np.testing.assert_allclose(tmisc.derivLogCdfNormal(x).numpy(), -x.numpy(), rtol=1e-3)


def test_inverse_cdf_and_aliases():
    p = np.concatenate([np.logspace(-300, -1, 60), np.linspace(0.05, 0.95, 19), 1 - np.logspace(-15, -1, 30)])
    np.testing.assert_allclose(tmisc.inv_std_norm_cdf(_t(p)).numpy(),
                               np.asarray(jmisc.inv_std_norm_cdf(jnp.asarray(p))), rtol=1e-12)
    assert tmisc.cdfNormal is tmisc.std_norm_cdf and tmisc.logCdfNormal is tmisc.logPhi
    x = np.random.default_rng(0).standard_normal((4, 5))
    np.testing.assert_allclose(tmisc.single_softmax(_t(x)).numpy(),
                               np.asarray(jmisc.single_softmax(jnp.asarray(x))), rtol=1e-12)


def test_chain_block_and_host_helpers():
    rng = np.random.default_rng(1)
    a = [rng.standard_normal(7) for _ in range(6)]
    for name, k in (("chain_1", 2), ("chain_2", 4), ("chain_3", 6)):
        np.testing.assert_allclose(getattr(tmisc, name)(*map(_t, a[:k])).numpy(),
                                   np.asarray(getattr(jmisc, name)(*map(jnp.asarray, a[:k]))),
                                   rtol=1e-12)
    A = rng.standard_normal((5, 6))
    blocks = tmisc.unblock(_t(A), [2, 3], [4, 2])
    np.testing.assert_array_equal(tmisc.block(blocks).numpy(), A)
    B = rng.standard_normal((6, 3))
    prod = tmisc.block_dot(blocks, tmisc.unblock(_t(B), [4, 2], [3]))
    np.testing.assert_allclose(tmisc.block(prod).numpy(), A @ B, rtol=1e-12)
    np.testing.assert_array_equal(tmisc.linear_grid(3, 9), jmisc.linear_grid(3, 9))
    X = rng.standard_normal((30, 2))
    np.testing.assert_array_equal(tmisc.kmm_init(_t(X), 5, seed=3), jmisc.kmm_init(X, 5, seed=3))
    p, y = rng.random(20), (rng.random(20) > 0.5).astype(float)
    Mt, at = tmisc.conf_matrix(_t(p), y)
    Mj, aj = jmisc.conf_matrix(p, y)
    np.testing.assert_array_equal(Mt, Mj)
    assert at == aj
    Z = rng.integers(0, 2, (8, 3)).astype(float)
    for axis in (0, 1):
        assert tmisc.common_subarrays(_t(Z), axis) == jmisc.common_subarrays(Z, axis)
    np.testing.assert_array_equal(tmisc.param_to_array(_t(A)), A)


def test_quadgk():
    f = lambda x: x ** 2 * torch.exp(-x)  # noqa: E731
    got = tquad.quadgk(f, 0.0, 3.0, device="cpu").item()
    want = float(jquad.quadgk(lambda x: x ** 2 * jnp.exp(-x), 0.0, 3.0))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(got, 2.0 - 17.0 * np.exp(-3.0), rtol=1e-12)
    dens = lambda x: torch.exp(-0.5 * x ** 2) / np.sqrt(2 * np.pi)  # noqa: E731
    gi = tquad.quadgk_int(dens, device="cpu").item()
    np.testing.assert_allclose(gi, float(jquad.quadgk_int(
        lambda x: jnp.exp(-0.5 * x ** 2) / np.sqrt(2 * np.pi))), rtol=1e-12)
    np.testing.assert_allclose(gi, 1.0, rtol=1e-6)
    x, w = tquad.gk_nodes(-1.0, 2.0, 3, device="cpu")
    xr, wr = jquad.gk_nodes(-1.0, 2.0, 3)
    np.testing.assert_array_equal(x.numpy(), np.asarray(xr))
    np.testing.assert_array_equal(w.numpy(), np.asarray(wr))


@pytest.mark.parametrize("batchsize", [1, 3])
def test_schedulers_give_the_reference_sequences(batchsize):
    rng = np.random.default_rng(2)
    Y = rng.standard_normal((12, 7))
    Y[rng.random(Y.shape) < 0.3] = np.nan
    tm = SimpleNamespace(Y=_t(Y))
    jm = SimpleNamespace(Y=Y)
    ts, js = topt.SparseGPStochastics(tm, batchsize), jopt.SparseGPStochastics(jm, batchsize)
    for _ in range(4):
        assert [list(d) for d in ts.d] == [list(d) for d in js.d]
        assert list(ts.current_dim) == list(js.current_dim)
        ts.do_stochastics()
        js.do_stochastics()
    ts.reset()
    js.reset()
    assert [list(d) for d in ts.d] == [list(d) for d in js.d]
    assert topt.SparseGPMissing(tm).d == jopt.SparseGPMissing(jm).d


@pytest.mark.parametrize("n,size", [(10, 3), (7, 7), (100, 6), (3, 5)])
def test_divide_data(n, size):
    for rank in range(size):
        a, b, idx = tpar.divide_data(n, rank, size)
        ra, rb, ridx = jpar.divide_data(n, rank, size)
        assert (a, b) == (ra, rb)
        np.testing.assert_array_equal(idx, ridx)


def _small_gp():
    rng = np.random.default_rng(3)
    X = rng.random((25, 1)) * 4
    return GPRegression(X, np.sin(X) + 0.1 * rng.standard_normal((25, 1)), device="cpu")


def test_optimize_parallel_checkpoints(tmp_path):
    m = _small_gp()
    tpar.optimize_parallel(m, max_iters=6, interval=3, outpath=str(tmp_path), name="gp",
                           messages=False)
    m2 = gpy_tpu_torch.load(str(tmp_path / "gp_checkpoint"), device="cpu")
    np.testing.assert_array_equal(m2.get_flat_raw().numpy(), m.get_flat_raw().numpy())


def test_optimize_parallel_raises_when_a_save_fails(tmp_path):
    m = _small_gp()
    calls = []

    def fail(path, **kw):
        calls.append(path)
        raise OSError("disk full")

    m.save_model = fail
    with pytest.raises(OSError, match="disk full"):
        tpar.optimize_parallel(m, max_iters=6, interval=3, outpath=str(tmp_path), messages=False)
    assert len(calls) == 1


def test_step_timers_and_metrics():
    t = diagnostics.StepTimer(skip_first=1)
    for i in range(4):
        with t.step(sync_on=[torch.zeros(2), {"a": 1.0}]):
            torch.ones(50).sum()
        t.mark_output(torch.zeros(1))
    s = t.summary()
    assert s["steps"] == 4 and 0 < s["best_s"] <= s["median_s"] <= s["p90_s"]
    p = profiling.StepTimer()
    for _ in range(3):
        with p.step() as st:
            st.sync_target = torch.ones(3)
    assert p.summary()["n"] == 3 and p.summary()["min_ms"] > 0
    assert profiling.StepTimer().summary() == {"n": 0}
    mt = diagnostics.Metrics()
    mt.record_many(loss=3.0, acc=0.5)
    mt.record("loss", 1.0)
    assert mt.history("loss") == [3.0, 1.0] and mt.last("acc") == 0.5 and mt.last("x") is None
    assert mt.summary()["loss"] == {"count": 2, "last": 1.0, "mean": 2.0, "min": 1.0, "max": 3.0}


@pytest.mark.parametrize("which", ["profiling", "diagnostics"])
def test_trace_writes_a_chrome_trace_and_passes_exceptions(tmp_path, which):
    m = _small_gp()

    def region(d):
        return profiling.trace(d) if which == "profiling" else diagnostics.trace("step", d)

    with region(str(tmp_path / "ok")):
        with profiling.annotate("nlml"):
            m.objective_function()
    (path,) = glob.glob(str(tmp_path / "ok" / "*.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "nlml" in names
    with pytest.raises(KeyError, match="boom"):
        with region(str(tmp_path / "bad")):
            raise KeyError("boom")
    assert glob.glob(str(tmp_path / "bad" / "*.json")) == []


def test_profile_objective(tmp_path):
    m = _small_gp()
    x0 = m.get_flat_raw().clone()
    s = profiling.profile_objective(m, n_calls=3, logdir=str(tmp_path))
    assert s["n"] == 3 and s["min_ms"] > 0
    assert torch.equal(m.get_flat_raw(), x0)
    assert len(glob.glob(str(tmp_path / "*.json"))) == 1


def test_log_compiles_logs_the_builds_and_loads(monkeypatch):
    monkeypatch.setattr(_build, "_libs", {})
    with diagnostics.log_compiles() as events:
        _build.load("kalman")
    assert any("libkalman.so" in e for e in events)
    before = len(events)
    monkeypatch.setattr(_build, "_libs", {})
    _build.load("kalman")  # outside the region: not logged
    assert len(events) == before
    with diagnostics.log_compiles(enabled=False) as off:
        monkeypatch.setattr(_build, "_libs", {})
        _build.load("kalman")
    assert off == []
