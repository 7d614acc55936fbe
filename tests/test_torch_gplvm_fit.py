"""Latent-variable models in motion and the reference faults of their slice:
Adam trajectories of BayesianGPLVM and infer_newX against gpy_tpu, the
spike-and-slab bound on the streamed route (ROADMAP C(m)), and
SparseGPClassificationUncertainInput's unused input variance (C(o)).
float64 on the CPU, twins from the same numpy arrays.
"""
import jax
import numpy as np
import pytest
import torch

import gpy_tpu.models as J
import gpy_tpu_torch.models as T
from gpy_tpu_torch.kern.psi_comp import STREAM_MIN_N

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _Y(n, d, seed=0):
    g = np.random.default_rng(seed)
    return g.standard_normal((n, 3)) @ g.standard_normal((3, d)) + 0.1 * g.standard_normal((n, d))


def test_bgplvm_adam_trajectory_matches_reference():
    """Five Adam steps (torch.optim.Adam against optax.adam, the same
    update rule): the raw vector and the objective, rel 1e-8."""
    Y = _Y(30, 5)
    jm = J.BayesianGPLVM(Y, 2, num_inducing=5)
    tm = T.BayesianGPLVM(Y, 2, num_inducing=5, device="cpu")
    rr = jm.optimize(optimizer="adam", max_iters=5, step_size=0.05)
    rt = tm.optimize(optimizer="adam", max_iters=5, step_size=0.05)
    np.testing.assert_allclose(tm.get_flat_raw().numpy(), np.asarray(jm.get_flat_raw()),
                               rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(rt.f_opt, float(rr.f_opt), rtol=1e-10)
    np.testing.assert_allclose(tm.objective_function().item(), float(jm.objective_function()),
                               rtol=1e-10)


def test_bgplvm_infer_newX_matches_reference():
    """infer_newX(variational=True) at 20 Adam steps from the nearest
    training point's q(X) mean: q(X*) and the returned value, rel 1e-8."""
    Y = _Y(30, 5)
    jm = J.BayesianGPLVM(Y, 2, num_inducing=5)
    tm = T.BayesianGPLVM(Y, 2, num_inducing=5, device="cpu")
    Ynew = _Y(4, 5, seed=1)
    qr, vr = jm.infer_newX(Ynew, optimize_iters=20, lr=0.05)
    qt, vt = tm.infer_newX(Ynew, optimize_iters=20, lr=0.05)
    np.testing.assert_allclose(qt.mean.numpy(), np.asarray(qr.mean), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(qt.variance.numpy(), np.asarray(qr.variance), rtol=1e-8)
    np.testing.assert_allclose(vt, vr, rtol=1e-10)
    with pytest.raises(NotImplementedError, match="A6"):
        tm.infer_newX(Ynew, variational=False)


def test_ssgplvm_streamed_route_keeps_gamma():
    """Fault C(m): at N >= 512 the reference streams the Gaussian psi2 for a
    spike-and-slab q(X). The port's bound at N = 520 equals the reference's
    on its psi2n route (its RBF's _psicomp cleared on the instance, which
    takes gamma into account), rel 1e-10, and the reference's streamed bound
    differs from it."""
    Y = _Y(520, 5)
    jm = J.SSGPLVM(Y, 2, num_inducing=6)
    tm = T.SSGPLVM(Y, 2, num_inducing=6, device="cpu")
    assert tm.num_data >= STREAM_MIN_N
    streamed = float(jax.jit(jm.log_likelihood)())
    jm.kern.__dict__["_psicomp"] = None
    ref = float(jax.jit(jm.log_likelihood)())
    got = tm.log_likelihood().item()
    np.testing.assert_allclose(got, ref, rtol=1e-10)
    assert abs(streamed - ref) > 1e-3 * abs(ref)


def test_classification_uncertain_input_variance_is_unused():
    """Fault C(o): X_variance never enters the bound of
    SparseGPClassificationUncertainInput, in either package; qX is in the
    raw dict with zero gradient."""
    g = np.random.default_rng(2)
    X = g.standard_normal((40, 2))
    Y = (X[:, :1] > 0).astype(float)
    vals = []
    for xv in (0.01, 4.0):
        jm = J.SparseGPClassificationUncertainInput(X, xv * np.ones_like(X), Y, num_inducing=6)
        tm = T.SparseGPClassificationUncertainInput(X, xv * np.ones_like(X), Y, num_inducing=6,
                                                    device="cpu")
        ref = float(jax.jit(jm.log_likelihood)())
        np.testing.assert_allclose(tm.log_likelihood().item(), ref, rtol=1e-10)
        vals.append(ref)
        paths = [p for p, _, _ in tm._free_entries()]
        assert paths[-2:] == ["qX.mean", "qX.variance"]
        g_flat = tm.objective_function_gradients()
        n_q = 2 * X.size
        assert np.all(g_flat[-n_q:] == 0.0) and np.any(g_flat[:-n_q] != 0.0)
    plain = T.SparseGPClassification(X, Y, num_inducing=6, device="cpu")
    np.testing.assert_allclose(vals[0], vals[1], rtol=1e-12)
    np.testing.assert_allclose(plain.log_likelihood().item(), vals[0], rtol=1e-12)
