"""The batched form of the sparse bounds (SparseGP._batched_objective): C
models' operands stacked and factored at once, for HMC chains and
optimize_restarts(parallel=True) on sparse and latent-variable models.

Held at float64 on the CPU against C unbatched evaluations (rel 1e-10: the
same arithmetic, batched) and against gpy_tpu's own vmapped objective on a
small SparseGPRegression (N=60, M=8; rel 1e-9), whose HMC chains and
parallel restarts the reference runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpy_tpu.mcmc as jmcmc
from gpy_tpu.models.sparse_gp_regression import SparseGPRegression as JSparseGPRegression
import gpy_tpu_torch.likelihoods as tl
import gpy_tpu_torch.models as T
from gpy_tpu_torch import mcmc
from gpy_tpu_torch.core import priors
from gpy_tpu_torch.core.model import value_and_grad
from gpy_tpu_torch.core.sparse_gp import SparseGP
from gpy_tpu_torch.inference import (DTC, EPDTC, FITC, PEP, Laplace, VarDTC,
                                     VarDTC_minibatch)
from gpy_tpu_torch.kern import RBF

jax.config.update("jax_enable_x64", True)

C = 3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _data(n=60, seed=0):
    g = np.random.default_rng(seed)
    X = g.random((n, 2)) * 4.0
    Y = np.sin(X[:, :1]) + 0.1 * g.standard_normal((n, 1))
    return X, Y


def _rows(m, c=C, seed=1, scale=0.2):
    x0 = m.get_flat_raw().numpy()
    return torch.as_tensor(x0[None, :] + scale * np.random.default_rng(seed)
                           .standard_normal((c, x0.size)))


def _against_rows(m, rows, rtol=1e-10):
    """The batched objective and gradient against each row's unbatched
    evaluation; the parameters are left as they were."""
    x_before = m.get_flat_raw().clone()
    v, g = m._batched_objective_and_grad(rows)
    assert v.shape == (rows.shape[0],) and g.shape == rows.shape
    for c in range(rows.shape[0]):
        vc, gc = value_and_grad(m._flat_objective, rows[c])
        np.testing.assert_allclose(v[c].item(), vc.item(), rtol=rtol)
        np.testing.assert_allclose(g[c].numpy(), gc.numpy(), rtol=1e-8,
                                   atol=1e-10 * gc.abs().max().item())
    assert torch.equal(m.get_flat_raw(), x_before)


INFERENCES = {"vardtc": VarDTC, "fitc": FITC, "dtc": DTC, "pep": lambda: PEP(0.5),
              "vardtc_minibatch": lambda: VarDTC_minibatch(batchsize=23)}


@pytest.mark.parametrize("name", list(INFERENCES))
def test_sparse_regression_batched_matches_unbatched(name):
    X, Y = _data()
    m = T.SparseGPRegression(X, Y, num_inducing=8, infer=INFERENCES[name](), noise_var=0.1,
                             device="cpu")
    m.kern.lengthscale.set_prior(priors.Gamma(2.0, 1.0))
    _against_rows(m, _rows(m))


def test_uncertain_inputs_and_latent_models_batched_match_unbatched():
    """VarDTC under a q(X): SparseGPRegression with X_variance and
    BayesianGPLVM (its KL in the objective) at N = 520, the streamed psi2;
    SSGPLVM; MRD and BayesianGPLVMMiniBatch evaluate their rows one after
    the other."""
    X, Y = _data(520)
    m = T.SparseGPRegression(X, Y, num_inducing=6, X_variance=np.full_like(X, 0.05),
                             device="cpu")
    _against_rows(m, _rows(m, 2))
    g = np.random.default_rng(2)
    Yl = g.standard_normal((25, 2)) @ g.standard_normal((2, 4))
    for tm in (T.BayesianGPLVM(Yl, 2, num_inducing=4, device="cpu"),
               T.SSGPLVM(Yl, 2, num_inducing=4, device="cpu"),
               T.MRD([Yl[:, :2], Yl[:, 2:]], 2, num_inducing=4, device="cpu")):
        _against_rows(tm, _rows(tm, 2, scale=0.05))
    Yn = Yl.copy()
    Yn[0, 1] = np.nan
    tm = T.BayesianGPLVMMiniBatch(Yn, 2, num_inducing=4, device="cpu")
    _against_rows(tm, _rows(tm, 2, scale=0.05))


def _rowwise_model(name):
    X, Y = _data(30)
    if name == "svgp":
        return T.SVGP(X, Y, X[::5].copy(), RBF(2, device="cpu"),
                      tl.Gaussian(variance=0.1, device="cpu"), device="cpu")
    Yc = (Y > 0).astype(float)
    if name == "epdtc":
        return SparseGP(X, Yc, X[::5].copy(), RBF(2, device="cpu"), tl.Bernoulli(device="cpu"),
                        inference_method=EPDTC(), device="cpu")
    if name == "ep":
        return T.GPClassification(X, Yc, device="cpu")
    return T.GPClassification(X, Yc, inference_method=Laplace(), device="cpu")


@pytest.mark.parametrize("name", ["svgp", "epdtc", "ep", "laplace"])
def test_models_without_a_batched_bound_evaluate_rows_in_turn(name):
    """SVGP's ELBO, EPDTC, and EP and Laplace on a dense GP have no stacked
    form: their C rows are evaluated one after the other, equal to the
    unbatched evaluation, and HMC runs two chains on them."""
    m = _rowwise_model(name)
    _against_rows(m, _rows(m, 2, scale=0.05))
    s = mcmc.HMC(m, stepsize=0.01, num_leapfrog=2).sample(num_samples=2, num_chains=2)
    assert s.shape == (2, 2, m.num_free_params) and np.isfinite(s).all()


def _twins():
    X, Y = _data()
    jm = JSparseGPRegression(X, Y, num_inducing=8, noise_var=0.1)
    tm = T.SparseGPRegression(X, Y, num_inducing=8, noise_var=0.1, device="cpu")
    return jm, tm


def test_batched_logp_matches_reference_vmap():
    """HMC's logp and its gradient at C = 3 states through the batched
    bound, against jax.vmap(jax.value_and_grad(hmc._logp)) of the
    reference, with and without the Jacobian correction."""
    jm, tm = _twins()
    flats = _rows(tm)
    for jac in (False, True):
        hj = jmcmc.HMC(jm, jacobian_correction=jac)
        ht = mcmc.HMC(tm, jacobian_correction=jac)
        vr, gr = jax.jit(jax.vmap(jax.value_and_grad(hj._logp)))(jnp.asarray(flats.numpy()))
        v, g = value_and_grad(ht._logp, flats)
        np.testing.assert_allclose(v.numpy(), np.asarray(vr), rtol=1e-9)
        np.testing.assert_allclose(g.numpy(), np.asarray(gr), rtol=1e-8,
                                   atol=1e-10 * np.abs(np.asarray(gr)).max())


def test_hmc_chains_and_parallel_restarts_run(monkeypatch):
    """HMC.sample(num_chains=2) and optimize_restarts(parallel=True) on a
    sparse model, where the port used to raise; the restarts against the
    reference's (the same inits from one numpy seed), end objectives rel
    1e-6. One chain keeps the unbatched objective."""
    jm, tm = _twins()
    s = mcmc.HMC(tm, stepsize=0.02, num_leapfrog=3).sample(num_samples=4, num_chains=2)
    assert s.shape == (2, 4, tm.num_free_params) and np.isfinite(s).all()
    kw = dict(num_restarts=3, parallel=True, seed=1, max_iters=40, step_size=0.03,
              verbose=False)
    rr, rt = jm.optimize_restarts(**kw), tm.optimize_restarts(**kw)
    np.testing.assert_allclose([r.f_opt for r in rt], [r.f_opt for r in rr], rtol=1e-6)
    np.testing.assert_allclose(tm.get_flat_raw().numpy(), np.asarray(jm.get_flat_raw()),
                               rtol=1e-5, atol=1e-8)

    def no_batch(flats):
        raise AssertionError("one chain took the batched objective")

    monkeypatch.setattr(tm, "_batched_objective", no_batch)
    s1 = mcmc.HMC(tm, stepsize=0.02, num_leapfrog=2).sample(num_samples=2, num_chains=1)
    assert s1.shape == (2, tm.num_free_params)
