"""WarpedGP and InputWarpedGP, and their warping functions (TanhFunction,
LogFunction, IdentityFunction, KumarWarping), against gpy_tpu, float64 on
the CPU, twins built from the same numpy arrays at the same raw parameters.

WarpedGP's objective carries the Jacobian sum log f'(Y) on every path: two
rows through the batched objective (HMC chains, parallel restarts) are held
to unbatched evaluation, and to the reference's objective at those rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpy_tpu.kern as gk
import gpy_tpu.models as J
from gpy_tpu.util import input_warping_functions as jiw
from gpy_tpu.util import warping_functions as jw
import gpy_tpu_torch.models as T
from gpy_tpu_torch.core.model import value_and_grad
from gpy_tpu_torch.kern import RBF
from gpy_tpu_torch.util import input_warping_functions as tiw
from gpy_tpu_torch.util import warping_functions as tw

jax.config.update("jax_enable_x64", True)

C = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _set_raw(jmod, tmod, seed):
    """Random raw values written into both twins (the same dict)."""
    rng = np.random.default_rng(seed)
    raw = {k: np.asarray(v) + 0.3 * rng.standard_normal(np.shape(v))
           for k, v in jmod.get_raw_dict().items()}
    tmod.set_raw_dict(raw)
    return jmod.with_raw_dict({k: jnp.asarray(v) for k, v in raw.items()})


@pytest.mark.parametrize("name", ["TanhFunction", "LogFunction", "IdentityFunction"])
def test_warping_function(name):
    """f, fgrad_y (the closed form and the generic autograd one) and f_inv
    (100 Newton steps) against the reference, rel 1e-12; f_inv inverts f."""
    jf, tf = getattr(jw, name)(), getattr(tw, name)(**C)
    if name == "TanhFunction":
        jf = _set_raw(jf, tf, 0)
    rng = np.random.default_rng(1)
    y = rng.random((7, 1)) * 3 + (0.2 if name == "LogFunction" else -1.0)
    yt = torch.tensor(y)
    for meth in ("f", "fgrad_y"):
        np.testing.assert_allclose(getattr(tf, meth)(yt).detach().numpy(),
                                   np.asarray(getattr(jf, meth)(jnp.asarray(y))), rtol=1e-12)
    generic = tw.WarpingFunction.fgrad_y(tf, yt)
    np.testing.assert_allclose(generic.detach().numpy(), tf.fgrad_y(yt).detach().numpy(),
                               rtol=1e-12)
    z = tf.f(yt).detach()
    yi = tf.f_inv(z)
    np.testing.assert_allclose(yi.detach().numpy(), np.asarray(jf.f_inv(jnp.asarray(z.numpy()))),
                               rtol=1e-12)
    np.testing.assert_allclose(yi.detach().numpy(), y, rtol=1e-10)


def test_kumar_warping():
    """KumarWarping on a subset of the columns, at random a, b: rel 1e-12,
    the unwarped column untouched."""
    X = np.random.default_rng(2).random((9, 3)) * 4
    jf = jiw.KumarWarping(X, warping_indices=[0, 2])
    tf = tiw.KumarWarping(X, warping_indices=[0, 2], **C)
    jf = _set_raw(jf, tf, 3)
    Xn = np.random.default_rng(4).random((5, 3)) * 4
    out = tf.f(torch.tensor(Xn)).detach().numpy()
    np.testing.assert_allclose(out, np.asarray(jf.f(jnp.asarray(Xn))), rtol=1e-12)
    np.testing.assert_array_equal(out[:, 1], Xn[:, 1])


def _data(seed=13, n=30):
    rng = np.random.default_rng(seed)
    X = rng.random((n, 2)) * 4
    Y = np.exp(np.sin(X[:, :1]) + 0.1 * rng.standard_normal((n, 1)))
    return X, Y, rng.random((6, 2)) * 4


def _models(kind):
    X, Y, Xs = _data()
    if kind == "warped":
        jm = J.WarpedGP(X, Y, kernel=gk.RBF(2, ARD=True))
        tm = T.WarpedGP(X, Y, kernel=RBF(2, ARD=True, **C), **C)
    else:
        jm = J.InputWarpedGP(X, Y, kernel=gk.RBF(2, ARD=True))
        tm = T.InputWarpedGP(X, Y, kernel=RBF(2, ARD=True, **C), **C)
    rng = np.random.default_rng(5)
    raw = {k: np.asarray(v) + 0.2 * rng.standard_normal(np.shape(v))
           for k, v in jm.get_raw_dict().items()}
    jm.set_raw_dict({k: jnp.asarray(v) for k, v in raw.items()})
    tm.set_raw_dict(raw)
    return jm, tm, X, Y, Xs


@pytest.mark.parametrize("kind", ["warped", "input_warped"])
def test_objective_and_predict(kind):
    """NLML (with the Jacobian for WarpedGP) rel 1e-10, gradient rel 1e-8,
    the raw parameters by the same names in the same order (kernel,
    likelihood, warping function); predict rel 1e-8 (WarpedGP: the
    Gauss-Hermite mean and the median with its delta-method variance, with
    and without the noise), predict_quantiles and log_predictive_density."""
    jm, tm, X, Y, Xs = _models(kind)
    assert list(tm.get_raw_dict()) == list(jm.get_raw_dict())
    f, g = jm._objective_and_grad(jm.get_flat_raw())
    ft, gt = tm._objective_and_grad(tm.get_flat_raw())
    np.testing.assert_allclose(ft, float(f), rtol=1e-10)
    np.testing.assert_allclose(gt, np.asarray(g), rtol=1e-8, atol=1e-10)
    kws = ([{}, {"median": True}, {"include_likelihood": False}]
           if kind == "warped" else [{}, {"include_likelihood": False}])
    for kw in kws:
        for a, b in zip(tm.predict(Xs, **kw), jm.predict(Xs, **kw)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-8, atol=1e-12, err_msg=str(kw))
    for a, b in zip(tm.predict_quantiles(Xs), jm.predict_quantiles(Xs)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-8)
    ys = np.exp(np.sin(Xs[:, :1]))
    np.testing.assert_allclose(tm.log_predictive_density(Xs, ys),
                               np.asarray(jm.log_predictive_density(Xs, ys)), rtol=1e-8)


@pytest.mark.parametrize("kind", ["warped", "input_warped"])
def test_batched_rows_equal_unbatched(kind):
    """Two rows through the batched objective (one stacked factorization)
    equal _flat_objective at each row, value rel 1e-12 and gradient rel
    1e-10, and the reference's objective there: no row sees the unwarped Y
    or X."""
    jm, tm, *_ = _models(kind)
    x0 = tm.get_flat_raw()
    rows = x0[None] + 0.1 * torch.as_tensor(
        np.random.default_rng(6).standard_normal((2, x0.numel())))
    v, g = tm._batched_objective_and_grad(rows)
    for c in range(2):
        vc, gc = value_and_grad(tm._flat_objective, rows[c])
        np.testing.assert_allclose(v[c].item(), vc.item(), rtol=1e-12)
        np.testing.assert_allclose(g[c].numpy(), gc.numpy(), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(
            v[c].item(), float(jm._objective_and_grad(jnp.asarray(rows[c].numpy()))[0]),
            rtol=1e-10)


def test_input_warped_predict_warps_new_inputs():
    """Predicting at the training inputs is predicting at their warped
    values through the plain GP posterior (tests/test_predict_fold.py:127
    guards the same in the reference)."""
    _, tm, X, *_ = _models("input_warped")
    mu, var = tm.predict(X)
    with torch.no_grad():
        Xw = tm.warping_function.f(tm.X)
        mu2, var2 = tm.posterior._raw_predict(tm.kern, Xw, Xw)
    np.testing.assert_allclose(mu, mu2.numpy(), rtol=1e-12)
    np.testing.assert_allclose(var, var2.numpy() + tm.likelihood.variance.numpy(), rtol=1e-12)


@pytest.mark.parametrize("make", [
    lambda X, Y: T.WarpedGP(X, Y), lambda X, Y: T.InputWarpedGP(X, Y),
    lambda X, Y: tw.TanhFunction(), lambda X, Y: tiw.KumarWarping(X)],
    ids=["WarpedGP", "InputWarpedGP", "TanhFunction", "KumarWarping"])
def test_defaults_to_cuda(make):
    """Without device= the models and warping functions ask for the card,
    and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    X, Y, _ = _data()
    with pytest.raises(RuntimeError, match="cuda"):
        make(X, Y)
