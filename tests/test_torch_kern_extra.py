"""The kernels that sparse regression combines with RBF -- Cosine,
ExpQuadCosine, Sinc, RatQuad, the linear family (Linear, LinearFull,
TruncLinear, TruncLinear_inf) and the rest of the static ones (Fixed,
WhiteHeteroscedastic, Precomputed) -- against gpy_tpu's, at float64.

For each: K (square and rectangular), Kdiag, and the autograd gradient of a
scalar of the square K (whose diagonal is the r = 0 of the stationary
families) with respect to every raw parameter and to the inputs, against
jax.grad through the reference kernel at the same raw values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpy_tpu.kern as gk
import gpy_tpu_torch.kern as tk

D = 3
LS = 0.6 + np.random.default_rng(21).random(D)
COV = np.random.default_rng(22).standard_normal((8, 8))
COV = COV @ COV.T + 0.5 * np.eye(8)


def _rng(name, ARD):
    return np.random.default_rng([sum(map(ord, name)), int(ARD)])


def _args(name, ARD):
    """(constructor positional args, keyword args) shared by both packages."""
    rng = _rng(name, ARD)
    if name in ("Cosine", "ExpQuadCosine", "Sinc", "RatQuad"):
        kw = dict(variance=1.4, lengthscale=LS if ARD else float(LS[0]), ARD=ARD)
        kw.update({"ExpQuadCosine": dict(period=1.7), "RatQuad": dict(power=1.3)}.get(name, {}))
        return (D,), kw
    if name in ("Linear", "TruncLinear"):
        kw = dict(variances=0.5 + rng.random(D) if ARD else 0.8, ARD=ARD)
        if name == "TruncLinear":
            kw["delta"] = 0.2 + 0.5 * rng.random(D) if ARD else 0.4
        return (D,), kw
    return {
        "LinearFull": ((D,), dict(rank=2, W=rng.standard_normal((D, 2)),
                                  kappa=0.3 + rng.random(D))),
        "TruncLinear_inf": ((D, (0.2, 1.9)), dict(variances=0.5 + rng.random(D), ARD=True)),
        "Fixed": ((D, COV), dict(variance=1.3)),
        "WhiteHeteroscedastic": ((D,), dict(num_data=8, variance=0.4)),
        "Precomputed": ((1, COV), dict(variance=1.3)),
    }[name]


CASES = ([(n, ard) for n in ("Cosine", "ExpQuadCosine", "Sinc", "RatQuad", "Linear",
                             "TruncLinear") for ard in (True, False)]
         + [(n, True) for n in ("LinearFull", "TruncLinear_inf", "Fixed",
                                "WhiteHeteroscedastic", "Precomputed")])
# kernels whose value does not depend on the input values
STATIC = ("Fixed", "WhiteHeteroscedastic", "Precomputed")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(name, rng):
    if name == "Precomputed":
        return (np.arange(8, dtype=float)[::-1].reshape(-1, 1).copy(),
                np.array([[1.0], [4.0], [6.0]]))
    X = rng.random((8, D)) * 2.0
    X[3] = X[1]  # coincident points off the diagonal too
    return X, rng.random((5, D)) * 2.0


@pytest.mark.parametrize("name,ARD", CASES, ids=[f"{n}-{'ARD' if a else 'iso'}" for n, a in CASES])
def test_kernel_matches_reference(name, ARD):
    args, kw = _args(name, ARD)
    jk = getattr(gk, name)(*args, **kw)
    tkern = getattr(tk, name)(*args, device="cpu", dtype=torch.float64, **kw)
    assert tkern.name == jk.name
    raw_ref = {k: np.asarray(v) for k, v in jk.get_raw_dict().items()}
    raw = {k: v.detach().numpy() for k, v in tkern.get_raw_dict().items()}
    assert list(raw) == list(raw_ref)
    for k in raw_ref:  # the two Logexp inverses may differ in the last bit
        np.testing.assert_allclose(raw[k], raw_ref[k], rtol=1e-13, err_msg=k)
    tkern.set_raw_dict(raw_ref)

    rng = _rng(name, ARD)
    X, X2 = _inputs(name, rng)
    Xt, X2t = torch.tensor(X), torch.tensor(X2)
    np.testing.assert_allclose(tkern.K(Xt).detach().numpy(), np.asarray(jk.K(jnp.asarray(X))),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tkern.K(Xt, X2t).detach().numpy(),
                               np.asarray(jk.K(jnp.asarray(X), jnp.asarray(X2))),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tkern.Kdiag(Xt).detach().numpy(),
                               np.asarray(jk.Kdiag(jnp.asarray(X))), rtol=1e-12, atol=1e-14)

    # d/d(raw parameters, X) of sum(G * tanh(K(X))): the square K, its
    # diagonal at r = 0 (and rows 1 and 3 coincident) included
    G = rng.standard_normal((8, 8))

    def f_ref(r, x):
        return jnp.sum(jnp.asarray(G) * jnp.tanh(jk.with_raw_dict(r).K(x)))

    ref_r, ref_x = jax.grad(f_ref, argnums=(0, 1))({k: jnp.asarray(v) for k, v in raw_ref.items()},
                                                   jnp.asarray(X))
    x = torch.tensor(X, requires_grad=name not in STATIC)
    leaves = [tkern._parameters[k] for k in raw]
    loss = torch.sum(torch.tensor(G) * torch.tanh(tkern.K(x)))
    grads = torch.autograd.grad(loss, leaves + ([x] if x.requires_grad else []))
    for k, g in zip(raw, grads):
        assert torch.isfinite(g).all(), k
        np.testing.assert_allclose(g.numpy(), np.asarray(ref_r[k]), rtol=1e-10,
                                   atol=1e-12 * max(1.0, np.abs(np.asarray(ref_r[k])).max()),
                                   err_msg=k)
    if x.requires_grad:
        assert torch.isfinite(grads[-1]).all()
        np.testing.assert_allclose(grads[-1].numpy(), np.asarray(ref_x), rtol=1e-10,
                                   atol=1e-12 * max(1.0, np.abs(np.asarray(ref_x)).max()))


def test_linear_psi_statistics_wait_for_a12():
    """A12 ported the Linear kernel's psi statistics: psi0, psi1 and psi2n
    under a q(X) against the reference's closed forms, rel 1e-12 (the full
    comparison is in tests/test_torch_psi_stats.py)."""
    from gpy_tpu.core.variational import NormalPosterior as JNormalPosterior
    from gpy_tpu_torch.core.variational import NormalPosterior

    g = np.random.default_rng(3)
    mu, S, Z = g.standard_normal((7, 2)), 0.1 + g.random((7, 2)), g.standard_normal((3, 2))
    k = tk.Linear(2, variances=[0.4, 1.3], ARD=True, device="cpu")
    kr = gk.Linear(2, variances=[0.4, 1.3], ARD=True)
    q, qr = NormalPosterior(mu, S, device="cpu"), JNormalPosterior(mu, S)
    for f, fr in ((k.psi0, kr.psi0), (k.psi1, kr.psi1), (k.psi2n, kr.psi2n)):
        np.testing.assert_allclose(f(torch.tensor(Z), q).detach().numpy(),
                                   np.asarray(fr(jnp.asarray(Z), qr)), rtol=1e-12)


def test_sum_with_rbf_in_a_sparse_model():
    """RBF + Linear + Bias, the sum a sparse-regression user builds, in
    SparseGPRegression against the reference: bound and gradient rel 1e-8."""
    from gpy_tpu.models.sparse_gp_regression import SparseGPRegression as JSparse
    from gpy_tpu_torch.models import SparseGPRegression

    g = np.random.default_rng(4)
    X = g.random((40, D)) * 3.0
    Y = np.sin(X[:, :1]) + 0.2 * X[:, 1:2] + 0.1 * g.standard_normal((40, 1))
    jm = JSparse(X, Y, kernel=gk.RBF(D, ARD=True) + gk.Linear(D, ARD=True) + gk.Bias(D),
                 num_inducing=8, noise_var=0.1)
    tkern = (tk.RBF(D, ARD=True, device="cpu") + tk.Linear(D, ARD=True, device="cpu")
             + tk.Bias(D, device="cpu"))
    tm = SparseGPRegression(X, Y, kernel=tkern, num_inducing=8, noise_var=0.1, device="cpu")
    np.testing.assert_allclose(tm.log_likelihood().item(), float(jm.log_likelihood()), rtol=1e-8)
    g_ref = np.asarray(jm.objective_function_gradients())
    np.testing.assert_allclose(tm.objective_function_gradients(), g_ref, rtol=1e-8,
                               atol=1e-8 * np.abs(g_ref).max())
