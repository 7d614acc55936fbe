"""The discriminative GPLVM priors of gpy_tpu_torch (core/priors.py DGPLVM,
DGPLVM_Lamda, DGPLVM_T, DGPLVM_KFDA) against gpy_tpu's, on the cases of
tests/test_dgplvm_priors.py: lnpdf (rel 1e-12) and its gradient with
respect to the latent points against jax.grad (rel 1e-10), float64 on the
CPU; and the prior on a GPLVM's latent X in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpy_tpu
import gpy_tpu.core.priors as jp
import gpy_tpu_torch.core.priors as tp
import gpy_tpu_torch.kern as tk
import gpy_tpu_torch.models as T

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _make_labels(N, C, rng):
    labels = rng.integers(0, C, N)
    labels[:C] = np.arange(C)
    onehot = np.zeros((N, C))
    onehot[np.arange(N), labels] = 1
    return onehot


def _case(name):
    """(x, reference prior, port prior), the reference test's cases."""
    if name == "dgplvm":
        rng = np.random.default_rng(0)
        N, Q = 20, 3
        x = rng.normal(size=(N, Q))
        lbl = _make_labels(N, 3, rng)
        return x, jp.DGPLVM(2.5, lbl, (N, Q)), tp.DGPLVM(2.5, lbl, (N, Q))
    if name in ("lamda", "t"):
        rng = np.random.default_rng(1)
        N, Q = 15, 4
        x = rng.normal(size=(N, Q))
        lbl = _make_labels(N, 2, rng)
        lam = rng.random(Q) + 0.5
        if name == "lamda":
            return (x, jp.DGPLVM_Lamda(1.7, lbl, (N, Q), lam),
                    tp.DGPLVM_Lamda(1.7, lbl, (N, Q), lam))
        vec = rng.normal(size=(Q, 2))
        return x, jp.DGPLVM_T(1.7, lbl, (N, Q), vec), tp.DGPLVM_T(1.7, lbl, (N, Q), vec)
    if name == "kfda_sorted":
        rng = np.random.default_rng(2)
        N0, N1, Q = 7, 9, 3
        x = rng.normal(size=(N0 + N1, Q))
        lbl = np.zeros((N0 + N1, 2))
        lbl[:N0, 0] = 1
        lbl[N0:, 1] = 1
        return (x, jp.DGPLVM_KFDA(0.05, 2.0, lbl, gpy_tpu.kern.RBF(Q, variance=1.3,
                                                                     lengthscale=0.8),
                                  (N0 + N1, Q)),
                tp.DGPLVM_KFDA(0.05, 2.0, lbl, tk.RBF(Q, variance=1.3, lengthscale=0.8,
                                                      device="cpu"), (N0 + N1, Q)))
    rng = np.random.default_rng(3)
    N, Q = 10, 2
    x = rng.normal(size=(N, Q))
    lbl = _make_labels(N, 2, rng)
    if name == "dgplvm_grad":
        return x, jp.DGPLVM(1.0, lbl, (N, Q)), tp.DGPLVM(1.0, lbl, (N, Q))
    return (x, jp.DGPLVM_KFDA(0.1, 1.0, lbl, gpy_tpu.kern.RBF(Q), (N, Q)),
            tp.DGPLVM_KFDA(0.1, 1.0, lbl, tk.RBF(Q, device="cpu"), (N, Q)))


@pytest.mark.parametrize("name", ["dgplvm", "lamda", "t", "kfda_sorted", "dgplvm_grad",
                                  "kfda_grad"])
def test_lnpdf_and_gradient_match_reference(name):
    x, jprior, tprior = _case(name)
    ref_v, ref_g = jax.jit(jax.value_and_grad(jprior.lnpdf))(jnp.asarray(x.ravel()))
    xt = torch.tensor(x.ravel(), requires_grad=True)
    v = tprior.lnpdf(xt)
    g = torch.autograd.grad(v, xt)[0]
    assert v.ndim == 0
    np.testing.assert_allclose(v.item(), float(ref_v), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), rtol=1e-10,
                               atol=1e-12 * np.abs(np.asarray(ref_g)).max())


def test_prior_on_gplvm_latent_matches_reference():
    """tests/test_dgplvm_priors.py's GPLVM case: the prior shifts the
    objective by -lnpdf, in both packages alike (rel 1e-10)."""
    rng = np.random.default_rng(4)
    N, Q = 16, 2
    lbl = _make_labels(N, 2, rng)
    Y = rng.normal(size=(N, 3)) + 2.0 * lbl[:, :1]
    jm = gpy_tpu.models.GPLVM(Y, Q)
    tm = T.GPLVM(Y, Q, device="cpu")
    jm.latent_X.set_prior(jp.DGPLVM(1.0, lbl, (N, Q)))
    tm.latent_X.set_prior(tp.DGPLVM(1.0, lbl, (N, Q)))
    vr, gr = jm._objective_and_grad(jm.get_flat_raw())  # one jitted program
    v, g = tm._objective_and_grad(tm.get_flat_raw())
    np.testing.assert_allclose(v, float(vr), rtol=1e-10)
    np.testing.assert_allclose(g, np.asarray(gr), rtol=1e-8, atol=1e-10)
