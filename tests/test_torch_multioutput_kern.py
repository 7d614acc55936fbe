"""Derivative observations and heterogeneous outputs: gpy_tpu_torch's DiffKern,
MultioutputKern, MultioutputDerivativeKern and MultioutputGP against gpy_tpu's.

On the CPU at float64. The kernels are compared on their own (K, Kdiag,
cross_K both ways, rel 1e-12), for several base kernels. MultioutputGP with
Gaussian outputs is compared with the reference's model on its raw dict,
its log_likelihood (rel 1e-9) and, since the reference's traced objective
and posterior drop the cross covariances of a shared base kernel (ROADMAP
C(k)), with the joint model built from the reference's own MultioutputKern
and exact inference for the gradient (max abs error 1e-7 of its largest
entry) and predictions (1e-8). MultioutputGP with [Gaussian, Bernoulli]
takes EP: NLML, gradient, predictions and the count of sweeps, which must
be equal. Then the reference's oracles (finite differences, var(f') =
v/l^2, the fit of f and f').
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpy_tpu.kern as gk
import gpy_tpu.likelihoods as jl
from gpy_tpu.inference.exact import ExactGaussianInference as JExact
from gpy_tpu.kern.multioutput_kern import DiffKern as JDiffKern
from gpy_tpu.kern.multioutput_kern import MultioutputKern as JMultioutputKern
from gpy_tpu.models.multioutput_gp import MultioutputGP as JMultioutputGP
import gpy_tpu_torch.kern as tk
import gpy_tpu_torch.likelihoods as tl
from gpy_tpu_torch.models import MultioutputGP
from gpy_tpu_torch.util import multioutput as tmo
from gpy_tpu_torch.util.convert import load_raw_params, raw_params_numpy

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(t):
    return t.detach().numpy()


# --- DiffKern, MultioutputKern -------------------------------------------------------
BASES = {
    "RBF": (lambda: gk.RBF(1, variance=1.4, lengthscale=0.8),
            lambda: tk.RBF(1, variance=1.4, lengthscale=0.8, **CPU), 0),
    "RBF_ARD_dim1": (lambda: gk.RBF(2, variance=0.9, lengthscale=[0.7, 1.3], ARD=True),
                     lambda: tk.RBF(2, variance=0.9, lengthscale=[0.7, 1.3], ARD=True, **CPU), 1),
    "Matern52": (lambda: gk.Matern52(1, variance=1.2, lengthscale=0.6),
                 lambda: tk.Matern52(1, variance=1.2, lengthscale=0.6, **CPU), 0),
    "RatQuad": (lambda: gk.RatQuad(1, lengthscale=0.9, power=1.5),
                lambda: tk.RatQuad(1, lengthscale=0.9, power=1.5, **CPU), 0),
    "RBF_plus_Linear": (lambda: gk.RBF(1) + gk.Linear(1, variances=0.3),
                        lambda: tk.RBF(1, **CPU) + tk.Linear(1, variances=0.3, **CPU), 0),
}


def _kern_values(k, X, X2):
    """K(X), K(X, X2) and Kdiag(X) of a kernel of either package; the
    reference's under one jax.jit (its eager vmaps compile op by op)."""
    if isinstance(k, tk.Kern):
        X, X2 = torch.tensor(X), torch.tensor(X2)
        return [_np(v) for v in (k.K(X), k.K(X, X2), k.Kdiag(X))]
    return [np.asarray(v) for v in jax.jit(lambda a, b: (k.K(a), k.K(a, b), k.Kdiag(a)))(
        jnp.asarray(X), jnp.asarray(X2))]


@pytest.mark.parametrize("base", list(BASES))
def test_diffkern_matches_reference(base):
    """K, K(X, X2), Kdiag and cross_K both ways. The inputs are multiples of
    1/8, on which the reference's matmul-form distance of two equal points
    is exactly 0 (ROADMAP C(l)); one pair of rows coincides."""
    make_j, make_t, d = BASES[base]
    jd, td = JDiffKern(make_j(), d), tk.DiffKern(make_t(), d, **CPU)
    rng = np.random.default_rng(3)
    D = jd.input_dim
    X, X2 = (np.round(8 * rng.standard_normal((n, D))) / 8 for n in (6, 4))
    X[2] = X2[1]
    Xt, X2t = torch.tensor(X), torch.tensor(X2)
    got = _kern_values(td, X, X2) + [_np(td.cross_K(Xt, X2t, base_first=b)) for b in (True, False)]
    ref = _kern_values(jd, X, X2) + [np.asarray(v) for v in jax.jit(lambda a, c: (
        jd.cross_K(a, c, base_first=True), jd.cross_K(a, c, base_first=False)))(
        jnp.asarray(X), jnp.asarray(X2))]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-13)


def test_diffkern_matches_finite_differences():
    """The reference's oracle (tests/test_multioutput_missing.py:23-38)."""
    base = tk.RBF(1, variance=1.4, lengthscale=0.8, **CPU)
    dk = tk.DiffKern(base, 0, **CPU)
    rng = np.random.default_rng(31)
    X, X2 = torch.tensor(rng.standard_normal((4, 1))), torch.tensor(rng.standard_normal((3, 1)))
    eps = 1e-5
    C = _np(dk.cross_K(X, X2, base_first=False))
    fd = _np(base.K(X + eps, X2) - base.K(X - eps, X2)) / (2 * eps)
    np.testing.assert_allclose(C, fd, rtol=1e-5, atol=1e-7)
    C2 = _np(dk.cross_K(X, X2, base_first=True))
    fd2 = _np(base.K(X, X2 + eps) - base.K(X, X2 - eps)) / (2 * eps)
    np.testing.assert_allclose(C2, fd2, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(dk.Kdiag(X)), 1.4 / 0.8**2, rtol=1e-12)
    # the parameters' gradient flows through the derivative covariances
    g = torch.autograd.grad(dk.K(X).sum(), [base.variance.raw, base.lengthscale.raw])
    assert all(torch.isfinite(t) and t != 0 for t in g)


def _stacked(n1=5, n2=4):
    X1 = np.linspace(0, 4, n1).reshape(-1, 1)
    X2 = np.linspace(0.1, 3.9, n2).reshape(-1, 1)
    return X1, X2, tmo.build_XY([X1, X2])[0]


@pytest.mark.parametrize("cls", ["MultioutputKern", "MultioutputDerivativeKern"])
def test_multioutput_kern_matches_reference(cls):
    jb, tb = gk.RBF(1, variance=1.3, lengthscale=0.9), tk.RBF(1, variance=1.3, lengthscale=0.9,
                                                              **CPU)
    jk = JMultioutputKern([jb, JDiffKern(jb, 0), gk.Matern32(1)])
    tk_ = getattr(tk, cls)([tb, tk.DiffKern(tb, 0, **CPU), tk.Matern32(1, **CPU)], **CPU)
    X = tmo.build_XY([np.linspace(0, 4, 5).reshape(-1, 1)] * 3)[0]
    X2 = X[::2] + np.array([0.05, 0.0])
    for a, b in zip(_kern_values(tk_, X, X2), _kern_values(jk, X, X2)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-13)
    K = _np(tk_.K(torch.tensor(X)))
    assert np.abs(K[:5, 5:10]).max() > 0.1  # f and f' covary
    assert np.all(K[:10, 10:] == 0)  # the third output is independent


# --- MultioutputGP, Gaussian outputs --------------------------------------------------
def _derivative_twins(noise=(1e-2, 2e-2)):
    X1, X2, _ = _stacked(9, 7)
    Yl = [np.sin(X1), np.cos(X2)]
    jb = gk.RBF(1, variance=1.3, lengthscale=0.9)
    jm = JMultioutputGP([X1, X2], Yl, [jb, JDiffKern(jb, 0)],
                        [jl.Gaussian(variance=s) for s in noise])
    tb = tk.RBF(1, variance=1.3, lengthscale=0.9, **CPU)
    tm = MultioutputGP([X1, X2], Yl, [tb, tk.DiffKern(tb, 0, **CPU)],
                       [tl.Gaussian(variance=s, **CPU) for s in noise], **CPU)
    return jm, tm


def _joint_reference(jm, Xs):
    """The joint model from the reference's own pieces, with the shared base
    one object (no functional copy of the model): the negative log marginal
    and its gradient in [raw variance, raw lengthscale, raw noises], and
    the predictive mean and variance at Xs (with its index column)."""
    X, Y, md = jnp.asarray(jm.X), jnp.asarray(jm.Y), jm.Y_metadata
    noise_paths = [f"likelihoods_list#{j}.variance" for j in range(2)]
    md_s = {"output_index": Xs[:, -1:].astype(int)}

    def model(theta):
        b = jm.kern.parts[0].with_raw_dict({"variance": theta[0], "lengthscale": theta[1]})
        lik = jm.likelihood.with_raw_dict(dict(zip(noise_paths, theta[2:])))
        return JMultioutputKern([b, JDiffKern(b, 0)]), lik

    def nlml(theta):
        kern, lik = model(theta)
        return -JExact().inference(kern, X, lik, Y, None, md)[1]

    def predict(theta, Xs):
        kern, lik = model(theta)
        post = JExact().inference(kern, X, lik, Y, None, md)[0]
        mu, var = post._raw_predict(kern, Xs, X, False)
        return lik.predictive_values(mu, var, False, md_s)

    raw = jm.get_raw_dict()
    theta = jnp.stack([raw["kern.parts#0.variance"], raw["kern.parts#0.lengthscale"]]
                      + [raw[f"likelihood.{p}"] for p in noise_paths])
    f, g = jax.jit(jax.value_and_grad(nlml))(theta)
    mu, var = jax.jit(predict)(theta, jnp.asarray(Xs))
    return np.asarray(theta), float(f), np.asarray(g), (np.asarray(mu), np.asarray(var))


@pytest.fixture(scope="module")
def derivative_twins():
    jm, tm = _derivative_twins()
    ref = {k: np.asarray(v) for k, v in jm.get_raw_dict().items()}
    got = raw_params_numpy(tm)
    assert list(got) == list(ref)  # the shared base at both of its paths
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-14, err_msg=k)
    return jm, tm


def test_multioutput_gp_matches_the_joint_reference(derivative_twins):
    jm, tm = derivative_twins
    ll_ref = float(jax.jit(jm.log_likelihood)())  # the model itself: the joint covariance
    np.testing.assert_allclose(tm.log_likelihood().item(), ll_ref, rtol=1e-9)
    xs = np.linspace(0.2, 3.8, 5).reshape(-1, 1)
    Xs = tmo.build_XY([xs, xs])[0]
    theta, f_ref, g_ref, pred_ref = _joint_reference(jm, Xs)
    # the shared base stands once in the flat vector: its variance and
    # lengthscale, then the two noises
    np.testing.assert_allclose(tm.optimizer_array, theta, rtol=1e-14)
    np.testing.assert_allclose(tm.objective_function().item(), f_ref, rtol=1e-9)
    g = tm.objective_function_gradients()
    assert np.max(np.abs(g - g_ref)) <= 1e-7 * np.max(np.abs(g_ref))
    for a, b in zip(tm.predict(Xs), pred_ref):
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8 * np.abs(b).max())
    # the reference's traced objective is another function (ROADMAP C(k)):
    # it drops the f-f' blocks, so it is not -log_likelihood()
    f_traced = float(jm._objective_and_grad(jnp.asarray(jm.optimizer_array))[0])
    assert abs(f_traced + ll_ref) > 1.0


def test_multioutput_gp_load_raw_params(derivative_twins):
    jm, tm = derivative_twins
    jm.randomize(np.random.default_rng(7))
    # randomize draws each path on its own: the shared base's two paths
    # differ, and the model evaluates the last written (parts#1.base_kern)
    raw = {k: np.asarray(v) for k, v in jm.get_raw_dict().items()}
    for p in ("variance", "lengthscale"):
        raw[f"kern.parts#0.{p}"] = raw[f"kern.parts#1.base_kern.{p}"]
    jm.set_raw_dict({k: jnp.asarray(v) for k, v in raw.items()})
    load_raw_params(tm, raw)
    np.testing.assert_allclose(tm.log_likelihood().item(), float(jax.jit(jm.log_likelihood)()),
                               rtol=1e-9)


def test_multioutput_gp_fits_f_and_its_derivative():
    """The reference's oracle (tests/test_multioutput_missing.py:41-61)."""
    X1 = np.linspace(0, 4, 9).reshape(-1, 1)
    X2 = np.linspace(0, 4, 7).reshape(-1, 1)
    base = tk.RBF(1, **CPU)
    m = MultioutputGP([X1, X2], [np.sin(X1), np.cos(X2)], [base, tk.DiffKern(base, 0, **CPU)],
                      [tl.Gaussian(variance=1e-4, **CPU), tl.Gaussian(variance=1e-4, **CPU)],
                      **CPU)
    assert np.isfinite(m.log_likelihood().item())
    assert m.checkgrad()
    m.optimize(max_iters=100)
    Xs = np.linspace(0.2, 3.8, 8).reshape(-1, 1)
    mu, _ = m.predict(tmo.build_XY([Xs], index=[0])[0])
    assert np.sqrt(np.mean((mu - np.sin(Xs)) ** 2)) < 0.05
    mud, _ = m.predict(tmo.build_XY([Xs], index=[1])[0])
    assert np.sqrt(np.mean((mud - np.cos(Xs)) ** 2)) < 0.1


# --- MultioutputGP, [Gaussian, Bernoulli] under EP ----------------------------------------
@pytest.fixture(scope="module")
def ep_twins():
    rng = np.random.default_rng(1)
    X1 = np.linspace(0, 4, 12).reshape(-1, 1)
    Xc = np.sort(rng.random((10, 1)) * 4, 0)
    Yl = [np.sin(X1) + 0.1 * rng.standard_normal(X1.shape), (np.sin(2 * Xc) > 0).astype(float)]
    jm = JMultioutputGP([X1, Xc], Yl, [gk.RBF(1), gk.RBF(1, lengthscale=0.7)],
                        [jl.Gaussian(variance=0.1), jl.Bernoulli()])
    tm = MultioutputGP([X1, Xc], Yl, [tk.RBF(1, **CPU), tk.RBF(1, lengthscale=0.7, **CPU)],
                       [tl.Gaussian(variance=0.1, **CPU), tl.Bernoulli(**CPU)], **CPU)
    assert list(raw_params_numpy(tm)) == list(jm.get_raw_dict())
    return jm, tm


def test_multioutput_gp_ep_matches_reference(ep_twins):
    jm, tm = ep_twins
    assert type(tm.inference_method).__name__ == "EP"
    # no kernel is shared here: the reference's jitted objective is its model's
    f_ref, g_ref = (np.asarray(v) for v in jm._objective_and_grad(jnp.asarray(jm.optimizer_array)))
    np.testing.assert_allclose(tm.log_likelihood().item(), -f_ref, rtol=1e-9)
    X, Y, md = jnp.asarray(jm.X), jnp.asarray(jm.Y), jm.Y_metadata
    K = jax.jit(lambda a: jm.kern.K(a) + 1e-8 * jnp.eye(a.shape[0], dtype=a.dtype))(X)
    sweeps_ref = int(jm.inference_method._converge_sites(K, jm.likelihood, Y, md)[2])
    assert tm.inference_method.last_sweeps == sweeps_ref < tm.inference_method.max_iters
    g = tm.objective_function_gradients()
    assert np.max(np.abs(g - g_ref)) <= 1e-7 * np.max(np.abs(g_ref))
    xs = np.linspace(0.2, 3.8, 5).reshape(-1, 1)
    Xs = tmo.build_XY([xs, xs])[0]

    def predict(xnew):  # the reference's predict, under one jax.jit
        post = jm.inference_method.inference(jm.kern, X, jm.likelihood, Y, None, md)[0]
        mu, var = post._raw_predict(jm.kern, xnew, X, False)
        return jm.likelihood.predictive_values(mu, var, False,
                                               {"output_index": Xs[:, -1:].astype(int)})

    for a, b in zip(tm.predict(Xs), jax.jit(predict)(jnp.asarray(Xs))):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-8 * np.abs(b).max())


def test_multioutput_gp_ep_load_raw_params(ep_twins):
    jm, tm = ep_twins
    jm.randomize(np.random.default_rng(7))
    load_raw_params(tm, {k: np.asarray(v) for k, v in jm.get_raw_dict().items()})
    f_ref = float(jm._objective_and_grad(jnp.asarray(jm.optimizer_array))[0])
    np.testing.assert_allclose(tm.log_likelihood().item(), -f_ref, rtol=1e-9)
