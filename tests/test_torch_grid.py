"""The Kronecker and grid GPs (GPKroneckerGaussianRegression, GPRegressionGrid,
GaussianGridInference) against gpy_tpu and against the port's dense
GPRegression on the product kernel, float64 on the CPU.

At the reference's own test shapes (12 x 10; 6 x 5 x 4) the NLML, the
gradient and predict agree with gpy_tpu. At bench.py's long-tail shapes
(32 x 24; 16 x 12 x 10) the NLML still does, but the reference's gradient,
which differentiates through eigh, does not (ROADMAP C(w)): there the port's
gradient is held to the dense GP's, and one test shows the reference's
departing from it.
"""
import jax
import numpy as np
import pytest
import torch

import gpy_tpu.kern as gk
import gpy_tpu.models as J
import gpy_tpu_torch.kern as tk
import gpy_tpu_torch.models as T
from gpy_tpu_torch.core.model import value_and_grad
from gpy_tpu_torch.inference import GaussianGridInference

jax.config.update("jax_enable_x64", True)

C = dict(device="cpu", dtype=torch.float64)
DENSE_JITTER = 1e-8  # exact inference adds it to the noise (inference/exact.py)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _kron_data(n1, n2, seed=0):
    """bench.py:793-797's Kronecker data at n1 x n2."""
    rng = np.random.default_rng(seed)
    X1 = np.linspace(0, 3, n1).reshape(-1, 1)
    X2 = np.linspace(0, 2, n2).reshape(-1, 1)
    Y = np.sin(X1) @ np.cos(X2).T + 0.05 * rng.standard_normal((n1, n2))
    return X1, X2, Y


def _grid_data(ns, hi=3.0, seed=0):
    """bench.py:802-806's grid data on linspace(0, hi) axes."""
    rng = np.random.default_rng(seed)
    return [np.linspace(0, hi, n).reshape(-1, 1) for n in ns], rng.standard_normal(ns)


def _kron(X1, X2, Y, noise=0.05):
    jm = J.GPKroneckerGaussianRegression(X1, X2, Y, gk.RBF(1), gk.RBF(1), noise_var=noise)
    tm = T.GPKroneckerGaussianRegression(X1, X2, Y, tk.RBF(1, **C), tk.RBF(1, **C),
                                         noise_var=noise, **C)
    return jm, tm


def _grid(Xs, Y, noise=0.5):
    return J.GPRegressionGrid(Xs, Y, noise_var=noise), T.GPRegressionGrid(Xs, Y, noise_var=noise,
                                                                           **C)


def _close(got, ref, rel):
    got, ref = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
    assert np.max(np.abs(got - ref)) <= rel * np.max(np.abs(ref)), (got, ref)


def _against_reference(jm, tm, rel_grad=1e-8):
    assert list(tm.get_raw_dict()) == list(jm.get_raw_dict())
    f, g = jm._objective_and_grad(jm.get_flat_raw())
    ft, gt = tm._objective_and_grad(tm.get_flat_raw())
    np.testing.assert_allclose(ft, float(f), rtol=1e-10)
    if rel_grad is not None:
        _close(gt, g, rel_grad)
    return g, gt


def _dense(axes, Y, noise):
    """GPRegression on the product of one RBF per axis over every grid point,
    with the noise less the jitter exact inference adds."""
    pts = np.stack(np.meshgrid(*[a[:, 0] for a in axes], indexing="ij"), -1).reshape(-1, len(axes))
    k = tk.RBF(1, active_dims=[0], **C)
    for d in range(1, len(axes)):
        k = k * tk.RBF(1, active_dims=[d], **C)
    return T.GPRegression(pts, np.asarray(Y).reshape(-1, 1), k, noise_var=noise - DENSE_JITTER,
                          **C), pts


def _noise_scale(m, path):
    """d value / d raw of the Logexp parameter at `path` (softplus' = sigmoid)."""
    return torch.sigmoid(m.get_raw_dict()[path]).item()


def _against_dense(tm, noise_path, axes, Y, noise):
    """The port's NLML and gradient against the dense GP's: the kernel
    gradients by raw parameter, the noise's with respect to its value."""
    md, _ = _dense(axes, Y, noise)
    ft, gt = tm._objective_and_grad(tm.get_flat_raw())
    fd, gd = md._objective_and_grad(md.get_flat_raw())
    np.testing.assert_allclose(ft, fd, rtol=1e-10)
    # flat orders: [noise, axis kernels...] and [axis kernels..., noise]
    noise_t = gt[0] / _noise_scale(tm, noise_path)
    noise_d = gd[-1] / _noise_scale(md, "likelihood.variance")
    _close(np.append(gt[1:], noise_t), np.append(gd[:-1], noise_d), 1e-8)
    return gd


def test_kronecker_against_reference_at_its_shape():
    """12 x 10 (tests/test_models_zoo.py:134-141): NLML rel 1e-10,
    gradient and predict rel 1e-8, the raw parameters by the same names."""
    X1, X2, Y = _kron_data(12, 10)
    jm, tm = _kron(X1, X2, Y)
    _against_reference(jm, tm)
    X1s, X2s = np.linspace(-0.2, 3.3, 7).reshape(-1, 1), np.linspace(0.1, 2.4, 5).reshape(-1, 1)
    for a, b in zip(tm.predict(X1s, X2s), jm.predict(X1s, X2s)):
        assert a.shape == (7, 5)
        _close(a, b, 1e-8)


def test_grid_against_reference_at_its_shape():
    """6 x 5 x 4 on linspace(0, 2) (tests/test_models_zoo.py:159-166)."""
    Xs, Y = _grid_data((6, 5, 4), hi=2.0)
    jm, tm = _grid(Xs, Y)
    _against_reference(jm, tm)
    new = [np.linspace(0.1, 2.2, n).reshape(-1, 1) for n in (3, 4, 2)]
    for a, b in zip(tm.predict(new), jm.predict(new)):
        assert a.shape == (3, 4, 2)
        _close(a, b, 1e-8)


@pytest.mark.parametrize("shape", [(32, 24), (16, 12, 10)], ids=["kron_32x24", "grid_16x12x10"])
def test_nlml_against_reference_at_bench_shapes(shape):
    """bench.py's long-tail shapes: the NLML agrees with the reference's (rel
    1e-10); its gradient does not (next test)."""
    if len(shape) == 2:
        jm, tm = _kron(*_kron_data(*shape))
    else:
        jm, tm = _grid(*_grid_data(shape))
    _against_reference(jm, tm, rel_grad=None)


def test_kronecker_gradient_equals_dense_at_bench_shape():
    """32 x 24, noise 0.05, RBF(1) x RBF(1): the port's NLML and gradient
    are the dense GP's on the 768 points (rel 1e-10, 1e-8); predict over a
    new grid is the dense model's latent predict plus the noise."""
    X1, X2, Y = _kron_data(32, 24)
    _, tm = _kron(X1, X2, Y, noise=0.05 + DENSE_JITTER)
    _against_dense(tm, "noise_var", [X1, X2], Y, 0.05 + DENSE_JITTER)
    X1s, X2s = np.linspace(0, 3, 8).reshape(-1, 1), np.linspace(0, 2, 6).reshape(-1, 1)
    mu, var = tm.predict(X1s, X2s)
    md, _ = _dense([X1, X2], Y, 0.05 + DENSE_JITTER)
    pts = np.stack(np.meshgrid(X1s[:, 0], X2s[:, 0], indexing="ij"), -1).reshape(-1, 2)
    mud, vard = md.predict(pts, include_likelihood=False)
    _close(mu.reshape(-1), mud[:, 0], 1e-8)
    _close(var.reshape(-1), vard[:, 0] + 0.05 + DENSE_JITTER, 1e-8)


def test_grid_gradient_equals_dense_at_bench_shape():
    """16 x 12 x 10 on linspace(0, 3), noise 0.5: the dense GP on the 1920
    points (rel 1e-10 NLML, 1e-8 gradient)."""
    Xs, Y = _grid_data((16, 12, 10))
    tm = T.GPRegressionGrid(Xs, Y, noise_var=0.5 + DENSE_JITTER, **C)
    _against_dense(tm, "noise_var", Xs, Y, 0.5 + DENSE_JITTER)


def test_reference_gradient_departs_from_dense_at_bench_shape():
    """ROADMAP C(w): at 32 x 24 the reference's jax.grad through eigh reads a
    kernel gradient more than 10% off the dense GP's (kern1.variance -7.29
    against 5.73), while its noise gradient, which does not pass through
    eigh, agrees; the port's agrees everywhere (test above)."""
    X1, X2, Y = _kron_data(32, 24)
    jm, tm = _kron(X1, X2, Y)
    g, gt = _against_reference(jm, tm, rel_grad=None)
    g = np.asarray(g)
    np.testing.assert_allclose(g[0], gt[0], rtol=1e-8)
    assert np.max(np.abs(g[1:] - gt[1:]) / np.abs(gt[1:])) > 0.1


def test_batched_rows_equal_unbatched():
    """HMC chains and parallel restarts: each row of the batched objective
    is the model's objective at that row (rows evaluated in turn)."""
    for m in (_kron(*_kron_data(12, 10))[1], _grid(*_grid_data((6, 5, 4)))[1]):
        x0 = m.get_flat_raw()
        rows = x0[None] + 0.05 * torch.as_tensor(
            np.random.default_rng(1).standard_normal((2, x0.numel())))
        v, g = m._batched_objective_and_grad(rows)
        for c in range(2):
            vc, gc = value_and_grad(m._flat_objective, rows[c])
            np.testing.assert_allclose(v[c].item(), vc.item(), rtol=1e-12)
            np.testing.assert_allclose(g[c].numpy(), gc.numpy(), rtol=1e-10, atol=1e-12)


def test_grid_inference_one_axis_is_the_exact_gp():
    """With one axis the grid log marginal is the exact GP's (the w_d sum
    over no other axis), gradient included."""
    rng = np.random.default_rng(3)
    X = np.linspace(0, 2, 9).reshape(-1, 1)
    Y = rng.standard_normal(9)
    k = tk.RBF(1, **C)
    noise = torch.tensor(0.3, dtype=torch.float64, requires_grad=True)
    _, lm = GaussianGridInference().inference([k], [torch.tensor(X)], noise, torch.tensor(Y))
    grads = torch.autograd.grad(lm, [noise, k._parameters["variance"]])
    md = T.GPRegression(X, Y.reshape(-1, 1), tk.RBF(1, **C), noise_var=0.3 - DENSE_JITTER, **C)
    ll = md.log_likelihood()
    gd = torch.autograd.grad(ll, [md.likelihood._parameters["variance"],
                                  md.kern._parameters["variance"]])
    np.testing.assert_allclose(lm.item(), ll.item(), rtol=1e-12)
    np.testing.assert_allclose(grads[0].item(),
                               gd[0].item() / _noise_scale(md, "likelihood.variance"), rtol=1e-9)
    np.testing.assert_allclose(grads[1].item(), gd[1].item(), rtol=1e-9)


@pytest.mark.parametrize("kind", ["kronecker", "grid"])
def test_defaults_to_cuda(kind):
    """Without device= the grid models ask for the card and raise where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    X1, X2, Y = _kron_data(4, 3)
    with pytest.raises(RuntimeError, match="cuda"):
        if kind == "kronecker":
            T.GPKroneckerGaussianRegression(X1, X2, Y, tk.RBF(1, **C), tk.RBF(1, **C))
        else:
            T.GPRegressionGrid([X1, X2], Y)
