"""The latent-variable models of gpy_tpu_torch against gpy_tpu's:
BayesianGPLVM, GPLVM, BCGPLVM, SparseGPLVM, DPBayesianGPLVM, MRD, SSGPLVM,
SSMRD, SparseGPMiniBatch, BayesianGPLVMMiniBatch, SparseGPRegression with
X_variance and SparseGPClassificationUncertainInput.

Twin models are built from the same numpy arrays on the CPU at float64 (the
same numpy seed where a constructor draws from np.random); their raw dicts
must agree before anything is compared. Then the objective (rel 1e-10), the
gradient by raw-dict name (rel 1e-8 of the largest entry: the same
arithmetic in another order) and predictions (rel 1e-9).
"""
import jax
import numpy as np
import pytest
import torch

import gpy_tpu.models as J
from gpy_tpu.core.priors import DGPLVM as JDGPLVM
from gpy_tpu.core.variational import NormalPosterior as JNormalPosterior
import gpy_tpu_torch.models as T
from gpy_tpu_torch.core.priors import DGPLVM
from gpy_tpu_torch.core.variational import NormalPosterior
from gpy_tpu_torch.kern import RBF
from gpy_tpu_torch.likelihoods import Gaussian
from gpy_tpu_torch.util.convert import raw_params_numpy

jax.config.update("jax_enable_x64", True)

N, D, Q, M = 30, 5, 2, 5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _Y(n=N, seed=0):
    g = np.random.default_rng(seed)
    return g.standard_normal((n, 3)) @ g.standard_normal((3, D)) + 0.1 * g.standard_normal((n, D))


def _labels(n=N):
    lbl = np.zeros((n, 2))
    lbl[np.arange(n) % 2 == 0, 0] = 1
    lbl[np.arange(n) % 2 == 1, 1] = 1
    return lbl


def objective_by_name(m, torch_model=True):
    """(objective, {raw-dict path: its gradient}) over the flat vector's
    entries; the reference's from its jitted objective (one compile)."""
    if torch_model:
        v, g = m._objective_and_grad(m.get_flat_raw())
        sizes = [(p, mod._parameters[n].shape) for p, mod, n in m._free_entries()]
    else:
        v, g = m._objective_and_grad(m.get_flat_raw())
        v, g = float(v), np.asarray(g)
        sizes = [(p, mod._raw[n].shape) for p, mod, n in m._free_entries()]
    out, i = {}, 0
    for path, shp in sizes:
        k = int(np.prod(shp))
        out[path] = g[i:i + k].reshape(shp)
        i += k
    return v, out


def check_twins(jm, tm, rtol=1e-10, grad_rtol=1e-8, rename=None):
    """Raw dicts equal, then the objective and the gradient by name."""
    ref = {k: np.asarray(v) for k, v in jm.get_raw_dict().items()}
    got = raw_params_numpy(tm)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-13, atol=1e-15, err_msg=k)
    (vj, gj), (vt, gt) = objective_by_name(jm, False), objective_by_name(tm)
    np.testing.assert_allclose(vt, vj, rtol=rtol)
    scale = max(np.abs(v).max() for v in gj.values())
    for k, v in gt.items():
        kr = (rename or {}).get(k, k)
        np.testing.assert_allclose(v, gj[kr], rtol=grad_rtol, atol=grad_rtol * scale, err_msg=k)
    return gj, gt


def _build(name):
    Y = _Y()
    c = dict(device="cpu")
    if name == "bgplvm":
        return J.BayesianGPLVM(Y, Q, num_inducing=M), T.BayesianGPLVM(Y, Q, num_inducing=M, **c)
    if name == "gplvm":
        return J.GPLVM(Y, Q), T.GPLVM(Y, Q, **c)
    if name == "sparse_gplvm":
        return J.SparseGPLVM(Y, Q, num_inducing=M), T.SparseGPLVM(Y, Q, num_inducing=M, **c)
    if name == "bcgplvm":
        np.random.seed(3)
        jm = J.BCGPLVM(Y, Q)
        np.random.seed(3)
        return jm, T.BCGPLVM(Y, Q, **c)
    if name == "dp_bgplvm":
        lbl = _labels()
        return (J.DPBayesianGPLVM(Y, Q, JDGPLVM(2.0, lbl, (N, Q)), num_inducing=M),
                T.DPBayesianGPLVM(Y, Q, DGPLVM(2.0, lbl, (N, Q)), num_inducing=M, **c))
    if name == "ssgplvm":
        return J.SSGPLVM(Y, Q, num_inducing=M), T.SSGPLVM(Y, Q, num_inducing=M, **c)
    Yn = Y.copy()
    Yn[np.random.default_rng(7).random(Y.shape) < 0.15] = np.nan
    if name == "bgplvm_minibatch_nan":
        return (J.BayesianGPLVMMiniBatch(Yn, Q, num_inducing=M),
                T.BayesianGPLVMMiniBatch(Yn, Q, num_inducing=M, **c))
    X = np.random.default_rng(8).standard_normal((N, Q))
    Z = X[:M].copy()
    if name == "sparse_gp_minibatch_nan":
        import gpy_tpu.kern as gk
        import gpy_tpu.likelihoods as gl

        return (J.SparseGPMiniBatch(X, Yn, Z, gk.RBF(Q, ARD=True), gl.Gaussian(variance=0.3)),
                T.SparseGPMiniBatch(X, Yn, Z, RBF(Q, ARD=True, **c), Gaussian(variance=0.3, **c),
                                    **c))
    if name == "sparse_gpr_x_variance":
        Xv = 0.05 + 0.2 * np.random.default_rng(9).random((N, Q))
        return (J.SparseGPRegression(X, Y, num_inducing=M, X_variance=Xv, noise_var=0.2),
                T.SparseGPRegression(X, Y, num_inducing=M, X_variance=Xv, noise_var=0.2, **c))
    raise KeyError(name)


def _reference_predict(jm, Xs, under_qX):
    """The reference's posterior and prediction in one jitted program: its
    eager missing-data posterior compiles op by op (~6 s). under_qX: the
    inference under the model's q(X), where the reference's own predict
    builds the posterior at the PCA start X instead (ROADMAP C(p))."""
    Z = jax.numpy.asarray(jm.Z)

    def predict(Xs):
        post = jm.inference_method.inference(jm.kern, jm.X, Z, jm.likelihood, jm.Y_normalized,
                                             None, None, **({"qX": jm.qX} if under_qX else {}))[0]
        return jm.likelihood.predictive_values(*post._raw_predict(jm.kern, Xs, Z))

    return jax.jit(predict)(jax.numpy.asarray(Xs))


# models whose reference predict ignores q(X) (ROADMAP C(p))
Q_POSTERIOR_FAULT = ("ssgplvm", "bgplvm_minibatch_nan")
MODELS = ["bgplvm", "gplvm", "sparse_gplvm", "bcgplvm", "dp_bgplvm", "ssgplvm",
          "bgplvm_minibatch_nan", "sparse_gp_minibatch_nan", "sparse_gpr_x_variance"]


@pytest.mark.parametrize("name", MODELS)
def test_objective_gradient_and_predict_match_reference(name):
    """Z, q(X) (mean, variance, gamma), the latent X or the mapping's
    weights, the kernel and the noise: every raw-dict entry's gradient."""
    jm, tm = _build(name)
    check_twins(jm, tm)
    Xs = np.random.default_rng(11).standard_normal((6, Q))
    if "minibatch" in name or name in Q_POSTERIOR_FAULT:
        mu_r, var_r = _reference_predict(jm, Xs, name in Q_POSTERIOR_FAULT)
        if name == "ssgplvm":
            assert np.abs(np.asarray(jm.predict(Xs)[0]) - np.asarray(mu_r)).max() > 1e-3
    else:
        mu_r, var_r = jm.predict(Xs)
    mu, var = tm.predict(Xs)
    np.testing.assert_allclose(mu, np.asarray(mu_r), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(var, np.asarray(var_r), rtol=1e-9, atol=1e-11)


def test_bgplvm_predicts_at_uncertain_inputs():
    """predict at a q(X*) (the psi-statistics branch of the posterior)."""
    jm, tm = _build("bgplvm")
    g = np.random.default_rng(12)
    mu_s, S_s = g.standard_normal((4, Q)), 0.1 + 0.3 * g.random((4, Q))
    mu_r, var_r = jm.predict(JNormalPosterior(mu_s, S_s))
    mu, var = tm.predict(NormalPosterior(mu_s, S_s, device="cpu"))
    np.testing.assert_allclose(mu, np.asarray(mu_r), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(var, np.asarray(var_r), rtol=1e-9, atol=1e-11)


def test_mrd_by_name_and_the_reference_dead_entries():
    """MRD over two views. The port lists the shared kernel once (kern.*);
    the reference lists it at kern.* and again at view_kernels#0.*, and its
    gradient stands at the second (ROADMAP C(n)); its kern.* and the base
    likelihood's entries have zero gradient, as the port's base likelihood."""
    Y = _Y()
    jm = J.MRD([Y[:, :2], Y[:, 2:]], Q, num_inducing=M)
    tm = T.MRD([Y[:, :2], Y[:, 2:]], Q, num_inducing=M, device="cpu")
    rename = {"kern.variance": "view_kernels#0.variance",
              "kern.lengthscale": "view_kernels#0.lengthscale"}
    gj, gt = check_twins(jm, tm, rename=rename)
    assert jm.get_flat_raw().shape[0] - tm.get_flat_raw().shape[0] == 1 + Q
    for k in ("kern.variance", "kern.lengthscale", "likelihood.variance"):
        assert np.all(gj[k] == 0.0), k
    assert np.all(gt["likelihood.variance"] == 0.0)
    assert "view_kernels#0.variance" not in gt
    assert tm.kern is tm.view_kernels[0]
    assert [s.shape for s in tm.scales()] == [(Q,), (Q,)]


def test_ssmrd_container():
    Y = _Y()
    jm = J.SSMRD([Y[:, :2], Y[:, 2:]], Q, num_inducing=M)
    tm = T.SSMRD([Y[:, :2], Y[:, 2:]], Q, num_inducing=M, device="cpu")
    ref = sum(float(jax.jit(m.log_likelihood)()) for m in jm.models)
    np.testing.assert_allclose(tm.log_likelihood(), ref, rtol=1e-10)
    assert [m.name for m in tm.models] == [m.name for m in jm.models]

