"""The stationary families of gpy_tpu_torch.kern against gpy_tpu's, at float64.

ExpQuad, Exponential, OU, Matern32 and Matern52: K (square and rectangular),
Kdiag and the autograd gradient of a scalar of K with respect to the
variance, the lengthscale (ARD and scalar) and the inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpy_tpu.kern as gk
import gpy_tpu_torch.kern as tk

FAMILIES = ["ExpQuad", "Exponential", "OU", "Matern32", "Matern52"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(D, seed):
    rng = np.random.default_rng(seed)
    X = rng.random((30, D)) * 3.0
    X2 = rng.random((20, D)) * 3.0
    ls = 0.6 + rng.random(D)
    W = rng.standard_normal((30, 30))
    return X, X2, ls, W


def _pair(name, D, ls, ARD):
    ls = ls if ARD else float(ls[0])
    jk = getattr(gk, name)(D, variance=1.4, lengthscale=ls, ARD=ARD)
    tkern = getattr(tk, name)(D, variance=1.4, lengthscale=ls, ARD=ARD, device="cpu",
                              dtype=torch.float64)
    return jk, tkern


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("D", [3, 12])
def test_K_and_Kdiag_match_reference(name, D):
    X, X2, ls, _ = _inputs(D, 10 + D)
    jk, tkern = _pair(name, D, ls, ARD=True)
    Xt, X2t = torch.tensor(X), torch.tensor(X2)
    np.testing.assert_allclose(tkern.K(Xt).detach().numpy(), np.asarray(jk.K(jnp.asarray(X))),
                               rtol=1e-10)
    np.testing.assert_allclose(tkern.K(Xt, X2t).detach().numpy(),
                               np.asarray(jk.K(jnp.asarray(X), jnp.asarray(X2))), rtol=1e-10)
    np.testing.assert_allclose(tkern.Kdiag(Xt).detach().numpy(),
                               np.asarray(jk.Kdiag(jnp.asarray(X))), rtol=1e-12)
    assert tkern.name == jk.name
    # the square Gram's diagonal is exactly the variance
    assert torch.equal(torch.diagonal(tkern.K(Xt)), torch.full((30,), 1.4, dtype=torch.float64))


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("ARD", [True, False])
def test_gradients_match_reference(name, ARD):
    """d/d(variance, lengthscale, X) of sum(W * tanh(K)) against jax.grad
    through the reference kernel; the Gram's r = 0 diagonal must give a zero
    (not NaN) input gradient on both sides."""
    D = 3
    X, _, ls, W = _inputs(D, 20)
    jk, tkern = _pair(name, D, ls, ARD)
    ls0 = ls if ARD else float(ls[0])

    def f_ref(x, v, l):
        k = getattr(gk, name)(D, variance=1.4, lengthscale=ls0, ARD=ARD)
        k2 = k.with_raw_dict({"variance": jnp.log(jnp.expm1(v)),
                              "lengthscale": jnp.log(jnp.expm1(l))})
        return jnp.sum(jnp.asarray(W) * jnp.tanh(k2.K(x)))

    ref = jax.grad(f_ref, argnums=(0, 1, 2))(jnp.asarray(X), jnp.asarray(1.4),
                                             jnp.asarray(ls0))
    x = torch.tensor(X, requires_grad=True)
    loss = torch.sum(torch.tensor(W) * torch.tanh(tkern.K(x)))
    gx, gv, gl = torch.autograd.grad(loss, [x, tkern.variance.raw, tkern.lengthscale.raw])
    # the raw (Logexp) parameters' gradient, mapped back to the constrained value
    v_val, l_val = tkern.variance.values.detach(), tkern.lengthscale.values.detach()
    gv = gv / torch.sigmoid(torch.log(torch.expm1(v_val)))
    gl = gl / torch.sigmoid(torch.log(torch.expm1(l_val)))
    for got, want in zip((gx, gv, gl), ref):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)
