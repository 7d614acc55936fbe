"""GPVariationalGaussianApproximation with VarGauss (Opper-Archambeau)
against gpy_tpu, float64 on the CPU: the ELBO, its gradient and predict
with a Bernoulli likelihood (Gauss-Hermite expectations) and a Gaussian one
(closed form), at the default start and at random variational parameters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpy_tpu.kern as gk
import gpy_tpu.likelihoods as jl
import gpy_tpu.models as J
import gpy_tpu_torch.likelihoods as tl
import gpy_tpu_torch.models as T
from gpy_tpu_torch.core.model import value_and_grad
from gpy_tpu_torch.inference import VarGauss
from gpy_tpu_torch.kern import RBF

jax.config.update("jax_enable_x64", True)

C = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _models(lik, n=25, perturb=True):
    rng = np.random.default_rng(7)
    X = np.sort(rng.random(n) * 4).reshape(-1, 1)
    f = np.sin(2 * X)
    if lik == "bernoulli":
        Y = (f + 0.3 * rng.standard_normal((n, 1)) > 0).astype(float)
        jlik, tlik = jl.Bernoulli(), tl.Bernoulli(**C)
    else:
        Y = f + 0.1 * rng.standard_normal((n, 1))
        jlik, tlik = jl.Gaussian(variance=0.05), tl.Gaussian(variance=0.05, **C)
    jm = J.GPVariationalGaussianApproximation(X, Y, gk.RBF(1), jlik)
    tm = T.GPVariationalGaussianApproximation(X, Y, RBF(1, **C), tlik, **C)
    if perturb:
        raw = {k: np.asarray(v) + 0.4 * rng.standard_normal(np.shape(v))
               for k, v in jm.get_raw_dict().items()}
        jm.set_raw_dict({k: jnp.asarray(v) for k, v in raw.items()})
        tm.set_raw_dict(raw)
    return jm, tm, X, Y


@pytest.mark.parametrize("lik,perturb", [("bernoulli", False), ("bernoulli", True),
                                         ("gaussian", True)])
def test_elbo_gradient_and_predict(lik, perturb):
    """Raw parameters by the same names (alpha, lam, then the kernel's and
    the likelihood's); ELBO rel 1e-10, gradient rel 1e-8; predict (the
    likelihood's predictive mean and variance) and the latent predict rel
    1e-8."""
    jm, tm, X, Y = _models(lik, perturb=perturb)
    assert list(tm.get_raw_dict()) == list(jm.get_raw_dict())
    f, g = jm._objective_and_grad(jm.get_flat_raw())
    ft, gt = tm._objective_and_grad(tm.get_flat_raw())
    np.testing.assert_allclose(ft, float(f), rtol=1e-10)
    np.testing.assert_allclose(gt, np.asarray(g), rtol=1e-8, atol=1e-10 * np.abs(g).max())
    Xs = np.linspace(-0.5, 4.5, 9).reshape(-1, 1)
    for kw in ({}, {"include_likelihood": False}):
        for a, b in zip(tm.predict(Xs, **kw), jm.predict(Xs, **kw)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-8, atol=1e-13)


def test_posterior_is_the_variational_gaussian():
    """At the training inputs the posterior mean is K alpha and the
    covariance (K^-1 + diag(lam))^-1, as the Woodbury form claims."""
    _, tm, X, _ = _models("bernoulli")
    post = tm.posterior
    K = tm.kern.K(tm.X).detach() + 1e-8 * torch.eye(tm.num_data, dtype=torch.float64)
    lam = tm.lam.values.detach()[:, 0]
    np.testing.assert_allclose(post.mean.numpy(), (K @ tm.alpha.values.detach()).numpy(),
                               rtol=1e-10)
    Sigma = torch.linalg.inv(torch.linalg.inv(K) + torch.diag(lam))
    np.testing.assert_allclose(post.covariance.numpy(), Sigma.numpy(), rtol=1e-7, atol=1e-9)


def test_batched_rows_in_turn():
    """VarGauss has no batched form: rows are evaluated one after the other
    and each equals the objective at its row."""
    assert not hasattr(VarGauss(), "noisy_gram")
    _, tm, *_ = _models("bernoulli", n=12)
    x0 = tm.get_flat_raw()
    rows = x0[None] + 0.1 * torch.as_tensor(
        np.random.default_rng(8).standard_normal((2, x0.numel())))
    v, g = tm._batched_objective_and_grad(rows)
    for c in range(2):
        vc, gc = value_and_grad(tm._flat_objective, rows[c])
        np.testing.assert_allclose(v[c].item(), vc.item(), rtol=1e-12)
        np.testing.assert_allclose(g[c].numpy(), gc.numpy(), rtol=1e-10, atol=1e-12)


def test_optimize_fits():
    """A short L-BFGS-B run raises the ELBO and classifies the training set
    (tests/test_models_zoo.py:113-121's check)."""
    _, tm, X, Y = _models("bernoulli", perturb=False)
    f0 = tm._objective_and_grad(tm.get_flat_raw())[0]
    tm.optimize(max_iters=100)
    assert tm._objective_and_grad(tm.get_flat_raw())[0] < f0
    p, _ = tm.predict(X)
    assert np.mean((p > 0.5) == (Y > 0.5)) > 0.7


def test_defaults_to_cuda():
    """Without device= the model asks for the card and raises where there is
    none."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    X = np.linspace(0, 1, 5).reshape(-1, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        T.GPVariationalGaussianApproximation(X, (X > 0.5).astype(float), RBF(1, **C),
                                             tl.Bernoulli(**C))
