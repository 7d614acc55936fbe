"""The SVGP slice: gpy_tpu_torch.models.SVGP against gpy_tpu's SVGP.

Twin models are built from the same numpy arrays, gpy_tpu on the CPU at
float64 (tests/conftest.py) and the port on the CPU at float64; the port's
raw parameters are carried from the reference's get_raw_dict() and compared
first. Then the ELBO parts, the gradient, predict, the round-robin batches,
full-batch fit trajectories (natural-gradient and plain, whitened or not),
and the collapsed-bound oracles of tests/test_svgp.py against the port's own
SparseGPRegression. Minibatch draws differ between torch and jax.random, so
the minibatch fit is held to its own determinism and to a rising ELBO.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpy_tpu.inference.svgp as jsvgp
import gpy_tpu.kern as gk
import gpy_tpu.util.choleskies as jchol
from gpy_tpu.core.svgp import SVGP as JSVGP
from gpy_tpu.likelihoods import Gaussian as JGaussian
import gpy_tpu_torch.inference.svgp as tsvgp
import gpy_tpu_torch.util.choleskies as tchol
from gpy_tpu_torch.kern import RBF
from gpy_tpu_torch.likelihoods import Gaussian, Likelihood
from gpy_tpu_torch.models import SVGP, SparseGPRegression
from gpy_tpu_torch.util.convert import load_raw_params, raw_params_numpy

N, M, DIN, DOUT = 40, 8, 3, 2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.random((N, DIN)) * 3.0
    Y = np.hstack([np.sin(2.0 * X[:, :1]), np.cos(X[:, 1:2])]) + 0.1 * rng.standard_normal((N, DOUT))
    Z = X[rng.permutation(N)[:M]] + 0.05 * rng.standard_normal((M, DIN))
    ls = 0.7 + 0.6 * rng.random(DIN)
    return X, Y, Z, ls, rng


def _perturbed_q(jm, rng):
    """A q(u) away from the prior, written into the reference."""
    L0 = np.asarray(jchol.flat_to_triang(jnp.asarray(np.asarray(jm.q_u_chol)), M))
    L = 0.6 * L0 + np.tril(0.05 * rng.standard_normal(L0.shape))
    idx = np.arange(M)
    L[:, idx, idx] = np.abs(L[:, idx, idx]) + 0.05
    jm.q_u_chol.set_value(np.asarray(jchol.triang_to_flat(jnp.asarray(L))))
    jm.q_u_mean.set_value(0.3 * rng.standard_normal((M, DOUT)))


def _twins(batchsize=None, perturb=True):
    X, Y, Z, ls, rng = _data()
    jm = JSVGP(X, Y, Z, gk.RBF(DIN, variance=1.3, lengthscale=ls, ARD=True),
               JGaussian(variance=0.2), batchsize=batchsize)
    tm = SVGP(X, Y, Z, RBF(DIN, variance=1.3, lengthscale=ls, ARD=True, device="cpu"),
              Gaussian(variance=0.2, device="cpu"), batchsize=batchsize, device="cpu")
    # both start q(u) at the prior, from the same numpy Cholesky
    _assert_raw_close(tm, jm, rtol=1e-12)
    if perturb:
        _perturbed_q(jm, rng)
    load_raw_params(tm, {k: np.asarray(v) for k, v in jm.get_raw_dict().items()})
    _assert_raw_close(tm, jm, rtol=0)
    return jm, tm


def _assert_raw_close(tm, jm, rtol):
    ref = {k: np.asarray(v) for k, v in jm.get_raw_dict().items()}
    got = raw_params_numpy(tm)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=rtol * np.abs(ref[k]).max(),
                                   err_msg=k)


def _close(a, b, rtol, what=""):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-300),
                               err_msg=what)


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


# --- (a) the packing --------------------------------------------------------
def test_choleskies_round_trip_and_packing_match_reference():
    rng = np.random.default_rng(3)
    flat = rng.standard_normal((tchol.num_flat(M), 3))
    L = tchol.flat_to_triang(_t(flat), M)
    assert tuple(L.shape) == (3, M, M)
    assert torch.equal(L, torch.tril(L))
    np.testing.assert_array_equal(tchol.triang_to_flat(L).numpy(), flat)
    np.testing.assert_array_equal(L.numpy(), np.asarray(jchol.flat_to_triang(jnp.asarray(flat), M)))
    np.testing.assert_array_equal(tchol.triang_to_flat(L).numpy(),
                                  np.asarray(jchol.triang_to_flat(jnp.asarray(L.numpy()))))
    rows, cols = tchol.indices(M)
    np.testing.assert_array_equal(rows, jchol.indices(M)[0])
    np.testing.assert_array_equal(cols, jchol.indices(M)[1])
    assert tchol.num_flat(M) == jchol.num_flat(M) == M * (M + 1) // 2


# --- (b) the ELBO parts -------------------------------------------------------
def _parts_args(jm):
    X, Y = np.asarray(jm.X), np.asarray(jm.Y)
    Z = np.asarray(jm.Z)
    m = np.asarray(jm.q_u_mean)
    flat = np.asarray(jm.q_u_chol)
    L = np.asarray(jchol.flat_to_triang(jnp.asarray(flat), M))
    return X, Y, Z, m, flat, L


@pytest.mark.parametrize("form", ["flat", "L", "S", "S_white"])
def test_elbo_parts_match_reference(form):
    jm, tm = _twins()
    X, Y, Z, m, flat, L = _parts_args(jm)
    S = L @ np.swapaxes(L, 1, 2)
    logdetS = 2.0 * np.sum(np.log(np.abs(np.diagonal(L, axis1=1, axis2=2))))
    args = {"flat": (m, flat), "L": (m, L), "S": (m, S, logdetS), "S_white": (m, S, logdetS)}[form]
    name = {"flat": "svgp_elbo_parts", "L": "svgp_elbo_parts_L", "S": "svgp_elbo_parts_S",
            "S_white": "svgp_elbo_parts_S_white"}[form]
    ref = getattr(jsvgp, name)(jm.kern, jnp.asarray(X), jnp.asarray(Z), jm.likelihood,
                               jnp.asarray(Y), *[jnp.asarray(a) for a in args], None, 1.3, None)
    got = getattr(tsvgp, name)(tm.kern, tm.X, tm.Z.values, tm.likelihood, tm.Y,
                               *[_t(a) for a in args], None, 1.3)
    for part, a, b in zip(("datafit", "kl"), got, ref):
        _close(a.detach().numpy(), b, 1e-10, f"{name} {part}")


def test_q_f_marginals_and_kl_match_reference():
    jm, tm = _twins()
    X, Y, Z, m, flat, L = _parts_args(jm)
    for fn in ("q_f_marginals", "q_f_marginals_white"):
        ref = getattr(jsvgp, fn)(jm.kern, jnp.asarray(X), jnp.asarray(Z), jnp.asarray(m),
                                 jnp.asarray(L))
        got = getattr(tsvgp, fn)(tm.kern, tm.X, tm.Z.values, _t(m), _t(L))
        for a, b, what in zip(got, ref, ("mu", "var", "Lmm", "Kmm")):
            _close(a.detach().numpy(), b, 1e-10, f"{fn} {what}")
    _close(tsvgp.kl_qu_pu(_t(m), _t(L), got[2]).detach().numpy(),
           jsvgp.kl_qu_pu(jnp.asarray(m), jnp.asarray(L), ref[2]), 1e-10)
    _close(tsvgp.kl_qu_pu_white(_t(m), _t(L)).numpy(),
           jsvgp.kl_qu_pu_white(jnp.asarray(m), jnp.asarray(L)), 1e-10)


# --- (c) the objective and its gradient -------------------------------------
def test_elbo_and_flat_gradient_match_reference():
    jm, tm = _twins()
    _close(tm.log_likelihood().item(), float(jm.log_likelihood()), 1e-10, "ELBO")
    _close(tm.objective_function().item(), float(jm.objective_function()), 1e-10, "objective")
    _close(tm.objective_function_gradients(), np.asarray(jm.objective_function_gradients()),
           1e-8, "flat gradient")
    assert tm.checkgrad()


def test_bind_raw_dict_differentiates_and_restores():
    _, tm = _twins()
    before = {k: v.clone() for k, v in tm.get_raw_dict().items()}
    leaves = {k: v.clone().requires_grad_(True) for k, v in before.items()
              if k not in ("q_u_mean", "q_u_chol")}
    with tm.bind_raw_dict(leaves):
        ll = tm.log_likelihood()
    grads = torch.autograd.grad(-ll - tm.log_prior(), list(leaves.values()))
    flat_g = tm.objective_function_gradients()
    offs = 0
    for path, mod, n in tm._free_entries():
        size = mod._parameters[n].numel()
        if path in leaves:
            g = grads[list(leaves).index(path)]
            np.testing.assert_allclose(g.reshape(-1).numpy(), flat_g[offs:offs + size], rtol=1e-12)
        offs += size
    for path, mod, n in tm.named_params():
        assert isinstance(mod._parameters[n], torch.nn.Parameter), path
        assert torch.equal(mod._parameters[n].detach(), before[path]), path


def test_bind_raw_dict_binds_tie_followers():
    _, tm = _twins()
    tm.tie("kern.variance", "likelihood.variance")
    t = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    with tm.bind_raw_dict({"kern.variance": t}):
        a, b = tm.kern.variance.values, tm.likelihood.variance.values
    assert torch.equal(a, b)
    g = torch.autograd.grad(a + b, t)[0]
    np.testing.assert_allclose(g.item(), 2.0 / (1.0 + np.exp(-0.7)), rtol=1e-14)
    assert tm.likelihood.variance.raw is tm.kern.variance.raw


# --- (d) predict --------------------------------------------------------------
@pytest.mark.parametrize("full_cov", [False, True])
def test_predict_matches_reference(full_cov):
    jm, tm = _twins()
    Xs = np.random.default_rng(9).random((12, DIN)) * 3.0
    for include_likelihood in (True, False):
        mu_r, var_r = jm.predict(Xs, full_cov=full_cov, include_likelihood=include_likelihood)
        mu, var = tm.predict(Xs, full_cov=full_cov, include_likelihood=include_likelihood)
        _close(mu, mu_r, 1e-9, "mean")
        _close(var, var_r, 1e-9, "variance")


# --- (e) the round-robin minibatch API ---------------------------------------
def test_new_batch_and_stochastic_grad_match_reference():
    jm, tm = _twins(batchsize=15)
    for _ in range(3):  # 40 rows in 15s: the third batch wraps around
        Xr, Yr = jm.new_batch()
        Xb, Yb = tm.new_batch()
        np.testing.assert_array_equal(Xb.numpy(), np.asarray(Xr))
        np.testing.assert_array_equal(Yb.numpy(), np.asarray(Yr))
    for _ in range(2):
        _close(tm.stochastic_grad(), jm.stochastic_grad(), 1e-8, "stochastic_grad")
    assert tm._batch_start == jm.__dict__["_batch_start"]


# --- (f) full-batch fit trajectories ----------------------------------------
@pytest.mark.parametrize("use_natgrad", [True, False], ids=["natgrad", "plain"])
@pytest.mark.parametrize("whiten", [False, True], ids=["unwhitened", "whitened"])
def test_full_batch_fit_matches_reference(use_natgrad, whiten):
    jm, tm = _twins()
    kw = dict(iters=20, batchsize=N, step_size=1e-2, natgrad_step_size=0.1,
              use_natgrad=use_natgrad, whiten=whiten, seed=0)
    tr_r = np.asarray(jm.fit(**kw))
    tr = tm.fit(**kw)
    assert tr.shape == (20,) and np.isfinite(tr).all()
    _close(tr, tr_r, 1e-7, "trace")
    _assert_raw_close(tm, jm, rtol=1e-7)


# --- (g) the collapsed-bound oracles ------------------------------------------
def _toy(n, seed):
    rng = np.random.default_rng(seed)
    X = np.linspace(0, 5, n).reshape(n, 1)
    return X, np.sin(X) + 0.2 * rng.standard_normal((n, 1))


def test_natgrad_single_step_reaches_collapsed_bound():
    """tests/test_svgp.py:70-86: with a Gaussian likelihood and lr = 1, one
    natural-gradient step lands on the optimal q(u), whose ELBO is the
    collapsed VarDTC bound."""
    X, Y = _toy(20, 11)
    Z = X[::3].copy()
    m = SVGP(X, Y, Z.copy(), RBF(1, device="cpu"), Gaussian(variance=0.1, device="cpu"),
             device="cpu")
    before = m.log_likelihood().item()
    m.fit(iters=1, batchsize=20, step_size=0.0, natgrad_step_size=1.0, seed=0)
    mid = m.log_likelihood().item()
    m.fit(iters=1, batchsize=20, step_size=0.0, natgrad_step_size=1.0, seed=1)
    after = m.log_likelihood().item()
    assert mid > before
    assert abs(after - mid) < 1e-5 * max(1.0, abs(mid))
    collapsed = SparseGPRegression(X, Y, Z=Z.copy(), noise_var=0.1, device="cpu")
    assert after == pytest.approx(collapsed.log_likelihood().item(), abs=1e-4)


@pytest.mark.parametrize("whiten", [False, True], ids=["unwhitened", "whitened"])
def test_natgrad_fit_reaches_collapsed_bound_ill_conditioned(whiten):
    """tests/test_svgp.py:198-215: M=20 at 0.25 spacing (cond(Kmm) ~ 1e16),
    fixed hyperparameters; natural gradients reach the collapsed bound in
    both parameterizations."""
    X, Y = _toy(120, 12)
    Z = X[::6].copy()
    sp = SparseGPRegression(X, Y, kernel=RBF(1, device="cpu"), Z=Z.copy(), device="cpu")
    sp.likelihood.variance.set_value(0.2)
    collapsed = sp.log_likelihood().item()
    m = SVGP(X, Y, Z.copy(), RBF(1, device="cpu"), Gaussian(variance=0.2, device="cpu"),
             device="cpu")
    m.fit(iters=400, batchsize=120, step_size=0.0, use_natgrad=True, natgrad_step_size=0.5,
          whiten=whiten, seed=0)
    assert m.log_likelihood().item() == pytest.approx(collapsed, abs=1e-5)


# --- (h) minibatch fits ---------------------------------------------------------
@pytest.mark.parametrize("batch_mode", ["gather", "shuffle_slice"])
def test_minibatch_fit_raises_elbo_and_is_deterministic(batch_mode):
    X, Y = _toy(60, 13)

    def run(seed):
        m = SVGP(X, Y, X[::6].copy(), RBF(1, device="cpu"), Gaussian(variance=0.5, device="cpu"),
                 batchsize=15, device="cpu")
        e0 = m.log_likelihood().item()
        tr = m.fit(iters=200, batchsize=15, step_size=5e-2, natgrad_step_size=0.2,
                   batch_mode=batch_mode, seed=seed)
        return m, e0, tr

    m, e0, tr = run(0)
    assert tr.shape == (200,) and np.isfinite(tr).all()
    assert m.log_likelihood().item() > e0
    mu, _ = m.predict(X)
    assert np.sqrt(np.mean((mu - Y) ** 2)) < 0.4
    assert np.array_equal(run(0)[2], tr)
    assert not np.array_equal(run(1)[2], tr)


def test_optimize_with_freezing_z_matches_reference():
    jm, tm = _twins()
    jm.optimizeWithFreezingZ(iters_fixed=5, iters_free=5)
    tm.optimizeWithFreezingZ(iters_fixed=5, iters_free=5)
    assert not tm.Z.spec.fixed
    _assert_raw_close(tm, jm, rtol=1e-5)


# --- (i) what is not ported -------------------------------------------------------
class _Bernoulliish(Likelihood):
    def logpdf_link(self, link_f, y, Y_metadata=None):
        return y * link_f - torch.log1p(torch.exp(link_f))


def test_non_gaussian_likelihood_raises_naming_the_roadmap():
    """The Gauss-Hermite engine is ported (A9): a likelihood that defines
    only logpdf_link now gives SVGP a finite ELBO and trains; uncertain
    inputs for classification build a finite bound (A12)."""
    from gpy_tpu_torch.models.sparse_gp_classification import (
        SparseGPClassificationUncertainInput)

    X, Y, Z, ls, _ = _data()
    m = SVGP(X, (Y > 0).astype(float), Z, RBF(DIN, device="cpu"), _Bernoulliish(device="cpu"),
             device="cpu")
    assert np.isfinite(m.log_likelihood().item())
    assert np.isfinite(m.fit(iters=2, batchsize=N)).all()
    # uncertain inputs for classification are ported (A12) as the reference
    # has them: the input variance does not enter the bound (ROADMAP C(o))
    mu = SparseGPClassificationUncertainInput(X, 0.1 * np.ones_like(X), (Y[:, :1] > 0) * 1.0,
                                              device="cpu")
    assert np.isfinite(mu.log_likelihood().item())
