"""Multi-output regression: gpy_tpu_torch's Coregionalize, IndependentOutputs,
Hierarchical, MixedNoise, util.multioutput (build_XY, index_to_slices, ICM,
LCM, Private), GPCoregionalizedRegression, SparseGPCoregionalizedRegression
and GPOffsetRegression against gpy_tpu's.

Twin models are built from the same numpy arrays on the CPU at float64, with
numpy's global generator seeded alike before each (Coregionalize draws its
default W from it), and their raw dicts compared before anything else. Then
the NLML (rel 1e-9), the flat gradient (max abs error 1e-7 of its largest
entry) and predictions with Y_metadata (1e-8). Then the reference's own
oracles on the port, and two more: the sparse model with Z = X is the dense
one but for Kmm's jitter, and ICM with W = 0 is independent GPs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import jitter_gap_bound
import gpy_tpu.kern as gk
import gpy_tpu.likelihoods as jl
import gpy_tpu.models as jmod
from gpy_tpu.util import multioutput as jmo
import gpy_tpu_torch.kern as tk
import gpy_tpu_torch.likelihoods as tl
from gpy_tpu_torch.models import (GPCoregionalizedRegression, GPOffsetRegression, GPRegression,
                                  SparseGPCoregionalizedRegression)
from gpy_tpu_torch.util import multioutput as tmo
from gpy_tpu_torch.util.convert import load_raw_params, raw_params_numpy

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _outputs(sizes=(14, 11, 9), seed=0):
    """Per-output (X_i, Y_i): x ~ 5 U[0, 1) sorted, y = sin(x + i) + 0.1 eps."""
    rng = np.random.default_rng(seed)
    Xl = [np.sort(rng.random((n, 1)) * 5, 0) for n in sizes]
    Yl = [np.sin(X + i) + 0.1 * rng.standard_normal(X.shape) for i, X in enumerate(Xl)]
    return Xl, Yl


def _check_raw(jm, tm):
    ref = {k: np.asarray(v) for k, v in jm.get_raw_dict().items()}
    got = raw_params_numpy(tm)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-14, err_msg=k)


def _reference_objective(jm):
    """The reference's objective (-log likelihood, no priors here) and its
    gradient at its parameters, by its jitted program: its eager
    log_likelihood compiles op by op."""
    f, g = jm._objective_and_grad(jnp.asarray(jm.optimizer_array))
    return float(f), np.asarray(g)


def _check_objective(jm, tm):
    f_ref, g_ref = _reference_objective(jm)
    np.testing.assert_allclose(tm.log_likelihood().item(), -f_ref, rtol=1e-9)
    g = tm.objective_function_gradients()
    assert g.shape == g_ref.shape
    assert np.max(np.abs(g - g_ref)) <= 1e-7 * np.max(np.abs(g_ref))


def _close(a, b):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=1e-8, atol=1e-8 * np.abs(b).max())


def _check_predictions(jm, tm, Xs, Y_metadata):
    for a, b in zip(tm.predict(Xs, Y_metadata=Y_metadata), jm.predict(Xs, Y_metadata=Y_metadata)):
        _close(a, b)
    for a, b in zip(tm.predict_quantiles(Xs, (5.0, 50.0, 97.5), Y_metadata=Y_metadata),
                    jm.predict_quantiles(Xs, (5.0, 50.0, 97.5), Y_metadata=Y_metadata)):
        _close(a, b)


def _new_points(P, n=6):
    """n new points of each of P outputs, with the index column, and their
    Y_metadata."""
    xs = np.linspace(0.3, 4.7, n).reshape(-1, 1)
    Xs, _, idx = tmo.build_XY([xs] * P)
    return Xs, {"output_index": idx}


def _load_from_reference(jm, tm):
    """The reference's raw dict after a seeded randomize, carried by
    load_raw_params: the NLMLs agree."""
    jm.randomize(np.random.default_rng(7))
    load_raw_params(tm, {k: np.asarray(v) for k, v in jm.get_raw_dict().items()})
    np.testing.assert_allclose(tm.log_likelihood().item(), -_reference_objective(jm)[0],
                               rtol=1e-9)


# --- kernels -------------------------------------------------------------------
def _index_X(n, P, seed):
    """(n, 2) inputs: x, and an output index in [0, P) with fractions and
    negative zeros, which truncate toward zero."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, P, n) + 0.7 * rng.random(n)
    idx[0] = -0.4  # truncates to 0, as jnp.asarray(x, int32) does
    return np.column_stack([rng.standard_normal(n), idx])


def test_coregionalize_matches_reference():
    P, rank = 3, 2
    np.random.seed(5)
    jk = gk.Coregionalize(1, output_dim=P, rank=rank, active_dims=[1])
    np.random.seed(5)
    tk_ = tk.Coregionalize(1, output_dim=P, rank=rank, active_dims=[1], **CPU)
    np.testing.assert_allclose(tk_.W.numpy(), np.asarray(jk.W), rtol=1e-15)
    X, X2 = _index_X(9, P, 1), _index_X(5, P, 2)
    Xt, X2t = torch.tensor(X), torch.tensor(X2)
    for a, b in ((tk_.K(Xt), jk.K(jnp.asarray(X))),
                 (tk_.K(Xt, X2t), jk.K(jnp.asarray(X), jnp.asarray(X2))),
                 (tk_.Kdiag(Xt), jk.Kdiag(jnp.asarray(X)))):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-14, atol=1e-15)
    # the reference's oracle (tests/test_kernels.py:122-129): K = B[ix][:, ix]
    ix = np.trunc(X[:, 1]).astype(int)
    B = tk_.B.detach().numpy()
    np.testing.assert_allclose(tk_.K(Xt).detach().numpy(), B[ix][:, ix], atol=1e-14)
    assert np.linalg.eigvalsh(B[ix][:, ix]).min() > -1e-10
    # the gradient of sum(G * K) with respect to W and kappa's raw values
    G = np.random.default_rng(3).standard_normal((9, 5))
    g_ref = jnp.asarray(G)

    def ref_loss(raw):
        return jnp.sum(g_ref * jk.with_raw_dict(raw).K(jnp.asarray(X), jnp.asarray(X2)))

    import jax
    raw_ref = {k: jnp.asarray(v) for k, v in jk.get_raw_dict().items()}
    grads_ref = jax.grad(ref_loss)(raw_ref)
    Xg = Xt.clone().requires_grad_(True)
    loss = torch.sum(torch.tensor(G) * tk_.K(Xg, X2t))
    grads = torch.autograd.grad(loss, [tk_.W.raw, tk_.kappa.raw, Xg], allow_unused=True)
    for got, key in zip(grads[:2], ("W", "kappa")):
        np.testing.assert_allclose(got.numpy(), np.asarray(grads_ref[key]), rtol=1e-12, atol=1e-13)
    assert grads[2] is None  # the index carries no gradient


@pytest.mark.parametrize("several", [False, True], ids=["one_kernel", "kernel_per_output"])
def test_independent_outputs_matches_reference(several):
    P = 2 if several else 3
    jks = [gk.RBF(1, variance=1.0 + j, lengthscale=0.7) for j in range(P if several else 1)]
    tks = [tk.RBF(1, variance=1.0 + j, lengthscale=0.7, **CPU) for j in range(len(jks))]
    jk = gk.IndependentOutputs(jks if several else jks[0])
    tk_ = tk.IndependentOutputs(tks if several else tks[0], **CPU)
    X = np.column_stack([np.linspace(0, 3, 8), [0, 0, 0, 1, 1, 1, P - 1, 0.5]])
    X2 = np.column_stack([np.linspace(1, 2, 4), [1, 0, 1, 0]])
    for a, b in ((tk_.K(torch.tensor(X)), jk.K(jnp.asarray(X))),
                 (tk_.K(torch.tensor(X), torch.tensor(X2)), jk.K(jnp.asarray(X), jnp.asarray(X2))),
                 (tk_.Kdiag(torch.tensor(X)), jk.Kdiag(jnp.asarray(X)))):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-14, atol=1e-15)
    # the reference's oracle (tests/test_kernels.py:141-146): no cross blocks
    K = tk_.K(torch.tensor(X)).detach().numpy()
    assert np.all(K[:3, 3:6] == 0) and np.all(K[3:6, :3] == 0)
    assert np.linalg.eigvalsh(K).min() > -1e-10


def test_hierarchical_matches_reference():
    jk = gk.Hierarchical([gk.RBF(1, variance=1.1), gk.RBF(1, variance=0.4, lengthscale=0.5),
                          gk.Matern32(1, variance=0.2)])
    tk_ = tk.Hierarchical([tk.RBF(1, variance=1.1, **CPU),
                           tk.RBF(1, variance=0.4, lengthscale=0.5, **CPU),
                           tk.Matern32(1, variance=0.2, **CPU)], **CPU)
    X = np.column_stack([np.linspace(0, 3, 7), [0, 0, 1, 1, 2, -1, 0], [0, 1, 0, 1, 1, 0, -1.5]])
    X2 = X[::2] + np.array([0.1, 0, 0])
    for a, b in ((tk_.K(torch.tensor(X)), jk.K(jnp.asarray(X))),
                 (tk_.K(torch.tensor(X), torch.tensor(X2)), jk.K(jnp.asarray(X), jnp.asarray(X2))),
                 (tk_.Kdiag(torch.tensor(X)), jk.Kdiag(jnp.asarray(X)))):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-14, atol=1e-15)
    assert [p for p, _, _ in tk_.named_params()] == list(jk.get_raw_dict())


# --- likelihoods and builders ----------------------------------------------------
def test_mixed_noise_matches_reference():
    variances = (0.1, 0.5, 2.0)
    jlik = jl.MixedNoise([jl.Gaussian(variance=v) for v in variances])
    tlik = tl.MixedNoise([tl.Gaussian(variance=v, **CPU) for v in variances], **CPU)
    assert list(raw_params_numpy(tlik)) == list(jlik.get_raw_dict())
    rng = np.random.default_rng(2)
    idx = np.array([0, 2, 1, 1, 0, 2, 2]).reshape(-1, 1)
    md = {"output_index": idx}
    mu, var, y = (rng.standard_normal((7, 1)), rng.random((7, 1)), rng.standard_normal((7, 1)))
    t = [torch.tensor(a) for a in (mu, var, y)]
    pairs = [(tlik.gaussian_variance(md), jlik.gaussian_variance(md)),
             (tlik.noise_diagonal(7, md), jlik.noise_diagonal(7, md)),
             (tlik.logpdf(t[0], t[2], md), jlik.logpdf(jnp.asarray(mu), jnp.asarray(y), md)),
             (tlik.conditional_mean(t[0]), jlik.conditional_mean(jnp.asarray(mu)))]
    pairs += list(zip(tlik.predictive_values(t[0], t[1], Y_metadata=md),
                      jlik.predictive_values(jnp.asarray(mu), jnp.asarray(var), Y_metadata=md)))
    pairs += list(zip(tlik.predictive_quantiles(t[0], t[1], (2.5, 97.5), Y_metadata=md),
                      jlik.predictive_quantiles(jnp.asarray(mu), jnp.asarray(var), (2.5, 97.5),
                                                Y_metadata=md)))
    for a, b in pairs:
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-13)
    # samples by moments: each row's draws around f with its output's variance
    f = torch.zeros((7, 4000), dtype=torch.float64)
    s = tlik.samples_given_f(torch.Generator().manual_seed(0), f, md).detach().numpy()
    np.testing.assert_allclose(s.var(axis=1), np.asarray(variances)[idx[:, 0]], rtol=0.1)


def test_build_XY_and_index_to_slices_match_reference():
    Xl, Yl = _outputs((3, 2, 4))
    for a, b in zip(tmo.build_XY(Xl, Yl), jmo.build_XY(Xl, Yl)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tmo.build_XY(Xl, index=[2, 0, 1]), jmo.build_XY(Xl, index=[2, 0, 1])):
        assert (a is None and b is None) or np.array_equal(a, b)
    for index in ([0, 0, 1, 1, 1, 0, 2, 2], [], [1, 1, 0]):
        assert tmo.index_to_slices(index) == jmo.index_to_slices(index)


def test_icm_lcm_private_match_reference():
    X = _index_X(10, 3, 4)
    np.random.seed(2)
    jks = [jmo.ICM(1, 3, gk.RBF(1), W_rank=2),
           jmo.LCM(1, 3, [gk.RBF(1, lengthscale=0.5), gk.Matern32(1)]),
           jmo.Private(1, 3, gk.RBF(1), 1)]
    np.random.seed(2)
    tks = [tmo.ICM(1, 3, tk.RBF(1, **CPU), W_rank=2),
           tmo.LCM(1, 3, [tk.RBF(1, lengthscale=0.5, **CPU), tk.Matern32(1, **CPU)]),
           tmo.Private(1, 3, tk.RBF(1, **CPU), 1)]
    for jk, tk_ in zip(jks, tks):
        assert tk_.name == jk.name
        _check_raw(jk, tk_)
        assert tk_.num_free_params == jk.num_free_params
        np.testing.assert_allclose(tk_.K(torch.tensor(X)).detach().numpy(),
                                   np.asarray(jk.K(jnp.asarray(X))), rtol=1e-13, atol=1e-15)
    coreg = tks[2].parts[1]
    assert coreg.W.spec.fixed and np.all(coreg.W.numpy() == 0)
    np.testing.assert_allclose(coreg.kappa.numpy(), [0.0, 1e-2, 0.0], atol=1e-15)
    # a known deviation (ROADMAP C(d)): the port raises before it changes
    # the kernel, where the reference sets kernel.input_dim first
    k2 = tk.RBF(2, **CPU)
    with pytest.raises(ValueError):
        tmo.ICM(1, 2, k2)
    assert k2.input_dim == 2


def test_builders_place_parts_on_the_model_device_and_dtype():
    """Sub-likelihoods and sub-kernels made inside a constructor (the default
    ICM, build_likelihood) take the model's dtype; ICM takes its kernel's."""
    Xl, Yl = _outputs((5, 4))
    m = GPCoregionalizedRegression(Xl, Yl, device="cpu", dtype=torch.float32)
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    assert m.log_likelihood().dtype == torch.float32
    K = tmo.ICM(1, 2, tk.RBF(1, device="cpu", dtype=torch.float32))
    assert {p.dtype for p in K.parameters()} == {torch.float32}


# --- GPCoregionalizedRegression ------------------------------------------------
@pytest.fixture(scope="module")
def gpcr_twins():
    Xl, Yl = _outputs()
    np.random.seed(11)
    jm = jmod.GPCoregionalizedRegression(Xl, Yl, W_rank=2)
    np.random.seed(11)
    tm = GPCoregionalizedRegression(Xl, Yl, W_rank=2, **CPU)
    _check_raw(jm, tm)
    return jm, tm


def test_gpcr_matches_reference(gpcr_twins):
    jm, tm = gpcr_twins
    _check_objective(jm, tm)
    Xs, md = _new_points(3)
    _check_predictions(jm, tm, Xs, md)


def test_gpcr_load_raw_params(gpcr_twins):
    _load_from_reference(*gpcr_twins)


def test_gpcr_with_lcm_matches_reference():
    Xl, Yl = _outputs((8, 6))
    np.random.seed(4)
    jk = jmo.LCM(1, 2, [gk.RBF(1), gk.Matern52(1, lengthscale=2.0)])
    jm = jmod.GPCoregionalizedRegression(Xl, Yl, kernel=jk)
    np.random.seed(4)
    tk_ = tmo.LCM(1, 2, [tk.RBF(1, **CPU), tk.Matern52(1, lengthscale=2.0, **CPU)])
    tm = GPCoregionalizedRegression(Xl, Yl, kernel=tk_, **CPU)
    _check_raw(jm, tm)
    _check_objective(jm, tm)


def test_gpcr_fits_two_outputs():
    """The reference's zoo oracle (tests/test_models_zoo.py:57-73)."""
    rng = np.random.default_rng(13)
    n = 20
    X1 = np.linspace(0, 5, n).reshape(-1, 1)
    X2 = np.linspace(0, 5, n - 5).reshape(-1, 1)
    Y1 = np.sin(X1) + 0.05 * rng.standard_normal((n, 1))
    Y2 = 2.0 * np.sin(X2) + 0.05 * rng.standard_normal((n - 5, 1))
    np.random.seed(0)
    m = GPCoregionalizedRegression([X1, X2], [Y1, Y2], **CPU)
    assert m.checkgrad()
    m.optimize(max_iters=150)
    Xs = np.hstack([X1, np.ones((n, 1))])
    mu, var = m.predict(Xs, Y_metadata={"output_index": np.ones((n, 1), dtype=int)})
    assert np.sqrt(np.mean((mu - 2.0 * np.sin(X1)) ** 2)) < 0.5 and np.all(var > 0)


def test_icm_with_zero_W_is_independent_gps():
    """W = 0 makes B = diag(kappa): the NLML is the sum of one GPRegression
    per output, each with RBF variance v * kappa_i and its own noise."""
    Xl, Yl = _outputs()
    kappa, noise = np.array([0.7, 1.3, 0.4]), np.array([0.05, 0.2, 0.1])
    kern = tmo.ICM(1, 3, tk.RBF(1, variance=1.5, lengthscale=0.8, **CPU), W=np.zeros((3, 1)),
                   kappa=kappa)
    liks = [tl.Gaussian(variance=s, **CPU) for s in noise]
    m = GPCoregionalizedRegression(Xl, Yl, kernel=kern, likelihoods_list=liks, **CPU)
    total = sum(GPRegression(X, Y, tk.RBF(1, variance=1.5 * k, lengthscale=0.8, **CPU),
                             noise_var=s, **CPU).log_likelihood().item()
                for X, Y, k, s in zip(Xl, Yl, kappa, noise))
    np.testing.assert_allclose(m.log_likelihood().item(), total, rtol=1e-10)


# --- SparseGPCoregionalizedRegression ------------------------------------------
@pytest.fixture(scope="module")
def sparse_twins():
    Xl, Yl = _outputs()
    np.random.seed(12)
    jm = jmod.SparseGPCoregionalizedRegression(Xl, Yl, num_inducing=8)
    np.random.seed(12)
    tm = SparseGPCoregionalizedRegression(Xl, Yl, num_inducing=8, **CPU)
    _check_raw(jm, tm)  # Z included: the same permutation of X's rows
    return jm, tm


def test_sparse_gpcr_matches_reference(sparse_twins):
    jm, tm = sparse_twins
    _check_objective(jm, tm)
    Xs, md = _new_points(3)
    _check_predictions(jm, tm, Xs, md)


def test_sparse_gpcr_load_raw_params(sparse_twins):
    _load_from_reference(*sparse_twins)


def test_sparse_gpcr_checkgrad_with_Z_fixed():
    """The reference's zoo oracle (tests/test_models_zoo.py:76-90); Z's
    index column has an exactly zero gradient."""
    rng = np.random.default_rng(13)
    X = np.linspace(0, 5, 18).reshape(-1, 1)
    Yl = [np.sin(X) + 0.05 * rng.standard_normal((18, 1)),
          np.cos(X) + 0.05 * rng.standard_normal((18, 1))]
    np.random.seed(1)
    m = SparseGPCoregionalizedRegression([X, X], Yl, num_inducing=8, **CPU)
    assert np.isfinite(m.log_likelihood().item())
    gZ = torch.autograd.grad(m.log_likelihood(), m.Z.raw)[0]
    assert torch.equal(gZ[:, 1], torch.zeros(8, dtype=torch.float64))
    assert gZ[:, 0].abs().max() > 0
    m.Z.fix()
    assert m.checkgrad()


def test_sparse_gpcr_with_Z_equal_X_is_the_dense_model():
    """With Z = X the collapsed bound is the exact log marginal but for
    Kmm's 1e-6 jitter: below it, by less than the jitter's bound."""
    Xl = [X[:6] for X in _outputs()[0]]
    Yl = [Y[:6] for Y in _outputs()[1]]
    np.random.seed(9)
    dense = GPCoregionalizedRegression(Xl, Yl, **CPU)
    np.random.seed(9)
    sparse = SparseGPCoregionalizedRegression(Xl, Yl, Z_list=Xl, **CPU)
    gap = dense.log_likelihood().item() - sparse.log_likelihood().item()
    noise = [lik.variance.numpy() for lik in dense.likelihood.likelihoods_list]
    assert 0.0 <= gap <= jitter_gap_bound(np.vstack(Yl), noise)


# --- GPOffsetRegression ------------------------------------------------------------
def _offset_data(n=12, offset=0.7):
    x = np.linspace(0, 5, n).reshape(-1, 1)
    X = np.vstack([np.hstack([x, np.zeros((n, 1))]), np.hstack([x, np.ones((n, 1))]),
                   np.hstack([x[::2], 2 * np.ones((n // 2, 1))])])
    Y = np.vstack([np.sin(x), np.sin(x + offset), np.sin(x[::2] - 0.4)])
    return X, Y


@pytest.fixture(scope="module")
def offset_twins():
    X, Y = _offset_data()
    jm = jmod.GPOffsetRegression(X, Y, noise_var=0.05)
    tm = GPOffsetRegression(X, Y, noise_var=0.05, **CPU)
    jm.offset = np.array([0.3, -0.2])
    tm.offset = np.array([0.3, -0.2])
    _check_raw(jm, tm)
    return jm, tm


def test_offset_regression_matches_reference(offset_twins):
    jm, tm = offset_twins
    _check_objective(jm, tm)
    X, _ = _offset_data()
    for a, b in zip(tm.predict(X[::3] + np.array([0.05, 0.0])),
                    jm.predict(X[::3] + np.array([0.05, 0.0]))):
        _close(a, b)


def test_offset_regression_load_raw_params(offset_twins):
    _load_from_reference(*offset_twins)


def test_offset_regression_recovers_the_offset():
    """The reference's zoo oracle (tests/test_models_zoo.py:98-110)."""
    n = 20
    x = np.linspace(0, 5, n).reshape(-1, 1)
    X = np.vstack([np.hstack([x, np.zeros((n, 1))]), np.hstack([x, np.ones((n, 1))])])
    Y = np.vstack([np.sin(x), np.sin(x + 0.7)])
    m = GPOffsetRegression(X, Y, noise_var=0.01, **CPU)
    assert m.checkgrad()
    m.optimize(max_iters=200)
    assert abs(abs(float(m.offset.numpy().reshape(-1)[0])) - 0.7) < 0.25
