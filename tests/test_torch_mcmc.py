"""The batched exact-GP path: gpy_tpu_torch.mcmc, the batched objective and
the optimizers on it, against gpy_tpu at float64 on the CPU.

N = 300 puts the batched factorization on the blocked factorization (the plain twin
of kernel B2 here); the reference's vmap rule takes its blocked recursion
on the CPU. torch and JAX draw different random numbers, so a proposal is
compared with the reference's own draws handed to the port's
deterministic inner function; whole runs are compared by their statistics,
as tests/test_gplvm_mcmc.py checks the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpy_tpu
import gpy_tpu.mcmc as jmcmc
from gpy_tpu.models import GPRegression as JGPRegression
from gpy_tpu_torch import mcmc
from gpy_tpu_torch.core import priors
from gpy_tpu_torch.core.model import value_and_grad
from gpy_tpu_torch.inference import IterativeGaussianInference
from gpy_tpu_torch.kern import RBF
from gpy_tpu_torch.models import GPRegression
from gpy_tpu_torch.ops import block_chol as bc


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.random((n, 2)) * 4.0
    Y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((n, 1))
    return X, Y


def _twins(n=300, with_priors=True):
    X, Y = _data(n)
    jm = JGPRegression(X, Y, noise_var=0.1)
    tm = GPRegression(X, Y, RBF(2, device="cpu"), noise_var=0.1, device="cpu")
    if with_priors:
        for path, (a, b) in (("kern.variance", (2.0, 2.0)), ("kern.lengthscale", (2.0, 1.0))):
            mod, name = path.split(".")
            getattr(getattr(jm, mod), name).set_prior(gpy_tpu.priors.Gamma(a, b))
            getattr(getattr(tm, mod), name).set_prior(priors.Gamma(a, b))
    return jm, tm


def _rows(tm, C, seed, scale=0.2):
    x0 = tm.get_flat_raw().numpy()
    return x0[None, :] + scale * np.random.default_rng(seed).standard_normal((C, x0.size))


@pytest.mark.parametrize("jac", [False, True], ids=["plain", "jacobian"])
def test_batched_logp_and_grad_match_reference_vmap(jac):
    """C = 4 raw vectors: the batched logp and gradient against
    jax.vmap(jax.value_and_grad(hmc._logp)), rel 1e-9 (float64; the two
    factorizations differ in summation order only)."""
    jm, tm = _twins()
    flats = _rows(tm, 4, 1)
    hj, ht = jmcmc.HMC(jm, jacobian_correction=jac), mcmc.HMC(tm, jacobian_correction=jac)
    x_before = tm.get_flat_raw().clone()
    vr, gr = jax.jit(jax.vmap(jax.value_and_grad(hj._logp)))(jnp.asarray(flats))
    before = bc.launches
    v, g = value_and_grad(ht._logp, torch.as_tensor(flats))
    np.testing.assert_allclose(v.numpy(), np.asarray(vr), rtol=1e-9)
    np.testing.assert_allclose(g.numpy(), np.asarray(gr), rtol=1e-9, atol=1e-12)
    assert bc.launches == before == 0  # CPU tensors run the twin
    # each row against the unbatched path
    for c in range(4):
        vc, gc = value_and_grad(ht._logp, torch.as_tensor(flats[c]))
        np.testing.assert_allclose(vc.item(), v[c].item(), rtol=1e-12)
        np.testing.assert_allclose(gc.numpy(), g[c].numpy(), rtol=1e-10, atol=1e-12)
    assert torch.equal(tm.get_flat_raw(), x_before)  # evaluation leaves the parameters


def test_batched_objective_above_the_explicit_inverse_switch():
    """N = 1100 > EXPLICIT_INV_MAX_N: the batched objective takes a batched
    jitchol (torch.linalg, ladder per model) and matches each row's
    unbatched objective and gradient at float64."""
    X, Y = _data(1100)
    m = GPRegression(X, Y, RBF(2, device="cpu"), noise_var=0.1, device="cpu")
    flats = torch.as_tensor(_rows(m, 2, 3))
    v, g = m._batched_objective_and_grad(flats)
    for c in range(2):
        vc, gc = m._objective_and_grad(flats[c].numpy())
        np.testing.assert_allclose(v[c].item(), vc, rtol=1e-11)
        np.testing.assert_allclose(g[c].numpy(), gc, rtol=1e-8, atol=1e-10)


def _reference_draws(hj, keys, P):
    """The reference's p0 and uniform for each chain's key, drawn as its
    kernel draws them (gpy_tpu/mcmc/__init__.py:106-107, 135)."""
    p0, log_u = [], []
    for key in keys:
        k1, k2 = jax.random.split(key)
        p0.append(np.asarray(hj.M_chol @ jax.random.normal(k1, (P,), dtype=jnp.float64)))
        log_u.append(float(jnp.log(jax.random.uniform(k2, dtype=jnp.float64))))
    return torch.as_tensor(np.stack(p0)), torch.as_tensor(np.array(log_u))


@pytest.mark.parametrize("kind", ["HMC", "HMC_shortcut"])
def test_one_proposal_matches_reference(kind):
    """One proposal of four chains with the reference's draws: the same
    next state and acceptance probability (rel 1e-8), through the batched
    objective. A mass matrix other than I; HMC_shortcut with a threshold
    that freezes some trajectories and not others."""
    jm, tm = _twins()
    M = np.diag([1.0, 2.0, 0.5])
    kw = dict(M=M, stepsize=0.1, num_leapfrog=5)
    if kind == "HMC_shortcut":
        kw["Hstd_th"] = (1e-4, 0.02)
    hj, ht = getattr(jmcmc, kind)(jm, **kw), getattr(mcmc, kind)(tm, **kw)
    flats = _rows(tm, 4, 2, scale=0.1)
    keys = jax.random.split(jax.random.PRNGKey(7), 4)
    # a step per chain, as adaptation leaves them: from accepted to rejected
    eps = np.array([0.005, 0.02, 0.05, 0.08])
    kernel = hj._hmc_kernel(hj._logp)
    xr, ar = jax.jit(jax.vmap(kernel))(jnp.asarray(flats), keys, jnp.asarray(eps))
    p0, log_u = _reference_draws(hj, keys, 3)
    x, a = ht._proposal(torch.as_tensor(flats), p0, log_u, torch.as_tensor(eps))
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-8)
    np.testing.assert_allclose(a.numpy(), np.asarray(ar), rtol=1e-8, atol=1e-12)
    moved = np.any(x.numpy() != flats, axis=1)
    assert moved.any() and (a.numpy() < 1.0).any()
    if kind == "HMC_shortcut":
        assert (a.numpy() == 0.0).any()  # a frozen trajectory


# --- the reference's statistical and shape tests (tests/test_gplvm_mcmc.py) --

def test_hmc_posterior_concentrates():
    """tests/test_gplvm_mcmc.py:85-98 at fewer steps (150 samples after 50
    adaptation steps, 10 leapfrog steps)."""
    rng = np.random.default_rng(21)
    n = 40
    X = np.linspace(0, 5, n).reshape(-1, 1)
    Y = np.sin(X) + 0.15 * rng.standard_normal((n, 1))
    m = GPRegression(X, Y, device="cpu")
    m.kern.variance.set_prior(priors.Gamma(2.0, 2.0))
    m.kern.lengthscale.set_prior(priors.Gamma(2.0, 2.0))
    m.likelihood.variance.set_prior(priors.Gamma(2.0, 20.0))
    m.optimize(max_iters=100)
    hmc = mcmc.HMC(m, stepsize=2e-2, num_leapfrog=10)
    s = hmc.sample(num_samples=150, adapt_steps=50, seed=0)
    assert s.shape == (150, 3)
    assert 0.005 < np.median(s[:, -1]) < 0.1
    assert hmc._accept_rate > 0.5


def test_hmc_multichain_shapes():
    rng = np.random.default_rng(22)
    n = 20
    X = np.linspace(0, 5, n).reshape(-1, 1)
    Y = np.sin(X) + 0.1 * rng.standard_normal((n, 1))
    m = GPRegression(X, Y, device="cpu")
    x0 = m.get_flat_raw().clone()
    hmc = mcmc.HMC(m, stepsize=1e-2, num_leapfrog=5)
    s = hmc.sample(num_samples=50, num_chains=4, adapt_steps=20, seed=1)
    assert s.shape == (4, 50, 3)
    assert np.all(np.isfinite(s))
    assert torch.equal(m.get_flat_raw(), x0)  # sampling leaves the model as it was
    # one seed, one run
    np.testing.assert_array_equal(s, hmc.sample(num_samples=50, num_chains=4, adapt_steps=20,
                                                seed=1))


def test_mh_sampler():
    rng = np.random.default_rng(23)
    n = 25
    X = np.linspace(0, 5, n).reshape(-1, 1)
    Y = np.sin(X) + 0.15 * rng.standard_normal((n, 1))
    m = GPRegression(X, Y, device="cpu")
    m.optimize(max_iters=50)
    mh = mcmc.Metropolis_Hastings(m, cov=0.005 * np.eye(3))
    s = mh.sample(Ntotal=2000, Nburn=500, Nthin=5, seed=0)
    assert s.shape == (300, 3)
    assert np.all(np.isfinite(s))
    assert 0.002 < np.median(s[:, -1]) < 0.2


def test_hmc_shortcut():
    rng = np.random.default_rng(24)
    n = 20
    X = np.linspace(0, 5, n).reshape(-1, 1)
    Y = np.sin(X) + 0.1 * rng.standard_normal((n, 1))
    m = GPRegression(X, Y, device="cpu")
    hmc = mcmc.HMC_shortcut(m, stepsize=1e-2, num_leapfrog=5)
    s = hmc.sample(num_samples=50, seed=3)
    assert s.shape == (50, 3)
    assert np.all(np.isfinite(s))
    s4 = hmc.sample(num_samples=10, num_chains=4, seed=3)
    assert s4.shape == (4, 10, 3) and np.all(np.isfinite(s4))


def test_mass_matrix_follows_the_free_parameters():
    m = GPRegression(*_data(20), RBF(2, device="cpu"), device="cpu")
    hmc = mcmc.HMC(m, num_leapfrog=2)
    m.kern.variance.fix()
    assert hmc.sample(num_samples=3, seed=0).shape == (3, 2)
    assert hmc.M.shape == (2, 2)
    h2 = mcmc.HMC(m, M=np.eye(2), num_leapfrog=2)
    m.kern.variance.unfix()
    with pytest.raises(ValueError, match="mass matrix"):
        h2.sample(num_samples=2)
    with pytest.raises(TypeError, match="DeviceMesh"):
        hmc.sample(num_samples=2, mesh=object())


# --- optimizers on the batched objective -----------------------------------

def _restart_twins():
    """tests/test_module.py:143-157's model."""
    rng = np.random.default_rng(0)
    X = np.linspace(0, 5, 50).reshape(-1, 1)
    Y = np.sin(3 * X) + 0.1 * rng.standard_normal((50, 1))
    return JGPRegression(X, Y), GPRegression(X, Y, device="cpu")


def test_adam_matches_reference():
    """optimize(optimizer="adam"): torch.optim.Adam against optax.adam, 300
    steps at float64 from one start; the update is the same formula with
    rounding in another order (rel 1e-6 after 300 steps)."""
    jm, tm = _restart_twins()
    rr = jm.optimize(optimizer="adam", max_iters=300, step_size=0.03)
    rt = tm.optimize(optimizer="adam", max_iters=300, step_size=0.03)
    np.testing.assert_allclose(rt.x_opt, np.asarray(rr.x_opt), rtol=1e-6)
    np.testing.assert_allclose(rt.f_opt, rr.f_opt, rtol=1e-8)
    np.testing.assert_allclose(tm.get_flat_raw().numpy(), jm.get_flat_raw(), rtol=1e-6)


def test_parallel_restarts_match_reference():
    """optimize_restarts(parallel=True, num_restarts=4, seed=1): the same
    inits from one numpy seed, the same four end objectives and the same
    restart kept; and the reference test's bound against L-BFGS-B."""
    jm, tm = _restart_twins()
    kw = dict(num_restarts=4, parallel=True, seed=1, max_iters=300, step_size=0.03,
              verbose=False)
    rr, rt = jm.optimize_restarts(**kw), tm.optimize_restarts(**kw)
    assert len(rt) == 4
    np.testing.assert_allclose([r.f_opt for r in rt], [r.f_opt for r in rr], rtol=1e-6)
    np.testing.assert_allclose(tm.get_flat_raw().numpy(), jm.get_flat_raw(), rtol=1e-5)
    m2 = GPRegression(tm.X.numpy(), tm.Y.numpy(), device="cpu")
    m2.optimize()
    assert tm.objective_function().item() < m2.objective_function().item() + 2.0
    with pytest.raises(ValueError, match="optax"):
        tm.optimize_restarts(parallel=True, optimizer="lbfgsb")
    rms = tm.optimize_restarts(parallel=True, optimizer="rmsprop", num_restarts=2, max_iters=5,
                               verbose=False)
    assert len(rms) == 2 and all(np.isfinite(r.f_opt) for r in rms)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tm.optimize_restarts(parallel=True, mesh=object())


def test_sequential_restarts_match_reference():
    """L-BFGS-B restarts from randomize(rng) in the reference's draw order:
    the kept objective within 1e-6."""
    jm, tm = _restart_twins()
    rr = jm.optimize_restarts(num_restarts=3, seed=4, verbose=False)
    rt = tm.optimize_restarts(num_restarts=3, seed=4, verbose=False)
    assert len(rt) == 3
    np.testing.assert_allclose(min(r.f_opt for r in rt), min(r.f_opt for r in rr),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tm.objective_function().item(), float(jm.objective_function()),
                               rtol=1e-6, atol=1e-6)


def _against_rows(m, rows):
    """The batched objective and gradient against each row's unbatched
    evaluation (rel 1e-10: the same arithmetic); the parameters are left as
    they were."""
    x_before = m.get_flat_raw().clone()
    v, g = m._batched_objective_and_grad(rows)
    assert v.shape == (rows.shape[0],) and g.shape == rows.shape
    for c in range(rows.shape[0]):
        vc, gc = value_and_grad(m._flat_objective, rows[c])
        np.testing.assert_allclose(v[c].item(), vc.item(), rtol=1e-10)
        np.testing.assert_allclose(g[c].numpy(), gc.numpy(), rtol=1e-8,
                                   atol=1e-10 * gc.abs().max().item())
    assert torch.equal(m.get_flat_raw(), x_before)


def _chains_and_restarts_run(m):
    s = mcmc.HMC(m, stepsize=0.01, num_leapfrog=2).sample(num_samples=2, num_chains=2)
    assert s.shape == (2, 2, m.num_free_params) and np.isfinite(s).all()
    rs = m.optimize_restarts(parallel=True, num_restarts=2, max_iters=3, seed=0, verbose=False)
    assert len(rs) == 2 and all(np.isfinite(r.f_opt) for r in rs)


def _hand_jax_probes(inf, n):
    """gpy_tpu's Rademacher probes (inference/iterative.py:379-380) into the
    port: torch and JAX draw different numbers from one seed."""
    Z = np.asarray(jax.random.rademacher(jax.random.PRNGKey(inf.seed), (n, inf.n_probes),
                                         dtype=jnp.float64))
    inf._rademacher = lambda N, dtype, device: torch.tensor(Z, dtype=dtype, device=device)


def test_batched_objective_needs_a_batched_inference():
    """It no longer does: an inference without a stacked batched form, the
    iterative one here, has its rows evaluated one after the other, each on
    the inference's one probe draw, as the reference's vmap computes them.
    The rows equal the unbatched evaluations and, with gpy_tpu's probes
    handed in, jax.vmap(jax.value_and_grad) of the reference's objective
    (rel 1e-9); two HMC chains and two parallel restarts run."""
    from gpy_tpu.inference.iterative import IterativeGaussianInference as JIterative

    X, Y = _data(30)
    opts = dict(max_cg=30, n_probes=2, seed=0)
    inf = IterativeGaussianInference(**opts)
    _hand_jax_probes(inf, 30)
    m = GPRegression(X, Y, RBF(2, device="cpu"), noise_var=0.1, device="cpu",
                     inference_method=inf)
    jm = JGPRegression(X, Y, noise_var=0.1, inference_method=JIterative(**opts))
    rows = torch.as_tensor(_rows(m, 3, seed=2, scale=0.1))
    _against_rows(m, rows)
    vr, gr = jax.jit(jax.vmap(jax.value_and_grad(jm._flat_objective)))(jnp.asarray(rows.numpy()))
    v, g = m._batched_objective_and_grad(rows)
    np.testing.assert_allclose(v.numpy(), np.asarray(vr), rtol=1e-9)
    np.testing.assert_allclose(g.numpy(), np.asarray(gr), rtol=1e-7,
                               atol=1e-9 * np.abs(np.asarray(gr)).max())
    _chains_and_restarts_run(m)


def _rowwise(name):
    from gpy_tpu_torch.kern import Matern32
    from gpy_tpu_torch.models import GPMultioutRegression, GPMultioutRegressionMD, StateSpace
    from gpy_tpu_torch.models import TPRegression

    X, Y = _data(20)
    if name == "tp":
        return TPRegression(X, Y, deg_free=4.0, device="cpu")
    if name == "state_space":
        return StateSpace(X[:, 0], Y, kernel=Matern32(1, device="cpu"), noise_var=0.1,
                          parallel=True, device="cpu")
    Ym = np.sin(X[:, :1] + np.arange(3)[None, :])
    np.random.seed(0)
    if name == "lvmogp":
        return GPMultioutRegression(X, Ym, 2, num_inducing=(6, 3), init="rand", device="cpu")
    idx = np.repeat(np.arange(3), 20)
    return GPMultioutRegressionMD(np.tile(X, (3, 1)), Ym.T.reshape(-1, 1), idx, 2,
                                  num_inducing=(6, 3), init="rand", device="cpu")


@pytest.mark.parametrize("name", ["tp", "lvmogp", "lvmogp_md", "state_space"])
def test_models_on_the_base_batched_objective_evaluate_rows_in_turn(name):
    """TPRegression, GPMultioutRegression(MD) and StateSpace have no stacked
    bound: Model._batched_objective evaluates their rows one after the
    other (the reference vmaps _flat_objective over any model), equal to
    the unbatched evaluations; two HMC chains and two parallel restarts
    run on each."""
    m = _rowwise(name)
    _against_rows(m, torch.as_tensor(_rows(m, 2, seed=3, scale=0.05)))
    _chains_and_restarts_run(m)


def test_bind_flat_raw_ties_and_restores():
    """Tied followers take the leader's slice; the Parameters come back on
    exit, also when the block raises."""
    from gpy_tpu_torch.kern import Add

    X, Y = _data(12)
    m = GPRegression(X, Y, Add([RBF(2, device="cpu", name="a"), RBF(2, device="cpu", name="b")]),
                     device="cpu")
    m.tie("kern.parts#0.variance", "kern.parts#1.variance")
    params = [mod._parameters[n] for _, mod, n in m.named_params()]
    flat = torch.tensor([0.3, -0.2, 0.4, 0.1], dtype=torch.float64, requires_grad=True)
    with m.bind_flat_raw(flat):
        a, b = m.kern.parts
        assert a.variance.raw is b.variance.raw
        obj = m.objective_function()
    g = torch.autograd.grad(obj, flat)[0]
    np.testing.assert_allclose(g.numpy(), m._objective_and_grad(flat.detach().numpy())[1],
                               rtol=1e-10)
    m.set_flat_raw(np.zeros(4))
    with pytest.raises(RuntimeError, match="inside"):
        with m.bind_flat_raw(flat):
            raise RuntimeError("inside")
    after = [mod._parameters[n] for _, mod, n in m.named_params()]
    assert all(p is q for p, q in zip(params, after))
    assert all(isinstance(p, torch.nn.Parameter) for p in params)
    np.testing.assert_array_equal(m.get_flat_raw().numpy(), np.zeros(4))
