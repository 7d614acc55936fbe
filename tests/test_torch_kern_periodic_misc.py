"""The periodic kernels (StdPeriodic, PeriodicExponential, PeriodicMatern32,
PeriodicMatern52) and the miscellaneous ones (MLP, Poly, Brownian, Spline)
against gpy_tpu's, at float64.

For each: K (square and rectangular), Kdiag, and the autograd gradient of a
scalar of the square K (its diagonal, and two coincident rows, included)
with respect to every raw parameter and to the inputs, against jax.grad
through the reference kernel at the same raw values; rel 1e-12 for K, 1e-10
for the gradients, as tests/test_torch_kern_extra.py holds the others.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpy_tpu.kern as gk
import gpy_tpu_torch.kern as tk

jax.config.update("jax_enable_x64", True)


def _case(name, ARD):
    """(input_dim, constructor positional args, keyword args), shared."""
    D = 1 if name in ("Brownian", "Spline") else 2
    kw = {
        "StdPeriodic": dict(variance=1.3, period=[1.1, 1.7] if ARD else 1.4,
                            lengthscale=[0.6, 0.9] if ARD else 0.8, ARD1=ARD, ARD2=ARD),
        "PeriodicExponential": dict(variance=1.2, lengthscale=0.7, period=1.9),
        "PeriodicMatern32": dict(variance=0.9, lengthscale=1.1, period=2.3),
        "PeriodicMatern52": dict(variance=1.4, lengthscale=0.8, period=1.6),
        "MLP": dict(variance=1.1, weight_variance=[0.7, 1.6] if ARD else 0.9,
                    bias_variance=0.4, ARD=ARD),
        "Poly": dict(variance=0.8, scale=0.6, bias=1.3, order=3.0),
        "Brownian": dict(variance=1.7),
        "Spline": dict(variance=1.2, c=0.7),
    }[name]
    return D, kw


CASES = [("StdPeriodic", True), ("StdPeriodic", False), ("PeriodicExponential", False),
         ("PeriodicMatern32", False), ("PeriodicMatern52", False), ("MLP", True),
         ("MLP", False), ("Poly", False), ("Brownian", False), ("Spline", False)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(name, D, rng):
    if name == "Brownian":  # both signs: the kernel is 0 across zero
        X = np.array([-1.3, -0.4, 0.2, 0.9, 0.2, 1.7, 2.4, -2.2]).reshape(-1, 1)
        return X, np.array([[-0.7], [0.5], [1.9]])
    X = rng.random((8, D)) * 3.0 - 1.0
    if not name.startswith("Periodic"):
        X[4] = X[2]  # coincident points off the diagonal too (see below for the others)
    return X, rng.random((5, D)) * 3.0 - 1.0


@pytest.mark.parametrize("name,ARD", CASES, ids=[f"{n}-{'ARD' if a else 'iso'}" for n, a in CASES])
def test_kernel_matches_reference(name, ARD):
    D, kw = _case(name, ARD)
    jk = getattr(gk, name)(D, **kw)
    tkern = getattr(tk, name)(D, device="cpu", dtype=torch.float64, **kw)
    assert tkern.name == jk.name
    raw_ref = {k: np.asarray(v) for k, v in jk.get_raw_dict().items()}
    raw = {k: v.detach().numpy() for k, v in tkern.get_raw_dict().items()}
    assert list(raw) == list(raw_ref)
    for k in raw_ref:  # the two Logexp inverses may differ in the last bit
        np.testing.assert_allclose(raw[k], raw_ref[k], rtol=1e-13, err_msg=k)
    tkern.set_raw_dict(raw_ref)

    rng = np.random.default_rng([sum(map(ord, name)), int(ARD)])
    X, X2 = _inputs(name, D, rng)
    Xt, X2t = torch.tensor(X), torch.tensor(X2)
    np.testing.assert_allclose(tkern.K(Xt).detach().numpy(), np.asarray(jk.K(jnp.asarray(X))),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tkern.K(Xt, X2t).detach().numpy(),
                               np.asarray(jk.K(jnp.asarray(X), jnp.asarray(X2))),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tkern.Kdiag(Xt).detach().numpy(),
                               np.asarray(jk.Kdiag(jnp.asarray(X))), rtol=1e-12, atol=1e-14)

    G = rng.standard_normal((8, 8))

    def f_ref(r, x):
        return jnp.sum(jnp.asarray(G) * jnp.tanh(jk.with_raw_dict(r).K(x)))

    ref_r, ref_x = jax.grad(f_ref, argnums=(0, 1))({k: jnp.asarray(v) for k, v in raw_ref.items()},
                                                   jnp.asarray(X))
    x = torch.tensor(X, requires_grad=True)
    leaves = [tkern._parameters[k] for k in raw]
    loss = torch.sum(torch.tensor(G) * torch.tanh(tkern.K(x)))
    grads = torch.autograd.grad(loss, leaves + [x])
    for k, g, ref in zip(list(raw) + ["X"], grads, [ref_r[k] for k in raw] + [ref_x]):
        assert torch.isfinite(g).all(), k
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=1e-10,
                                   atol=1e-12 * max(1.0, np.abs(np.asarray(ref)).max()), err_msg=k)


@pytest.mark.parametrize("name", ["PeriodicExponential", "PeriodicMatern32",
                                  "PeriodicMatern52"])
def test_warped_periodic_is_exact_at_coincident_points(name):
    """At coincident points K is exactly its diagonal value, the variance,
    and its gradient is
    the same as without them: the port takes r2 from the embeddings'
    differences. The reference's expansion |u|^2 + |u'|^2 - 2 u.u' leaves
    ~1e-16 there (ROADMAP C(v)), so the comparison above keeps its
    coincident points on the diagonal."""
    D, kw = _case(name, False)
    k = getattr(tk, name)(D, device="cpu", dtype=torch.float64, **kw)
    X = np.random.default_rng(5).random((4, D))
    x = torch.tensor(np.concatenate([X, X[:2]]), requires_grad=True)
    K = k.K(x)
    assert K[0, 4].item() == K[0, 0].item() == k.variance.values.item()
    assert K[1, 5].item() == K[1, 1].item()
    # each duplicate pair adds its own row and column: the gradient of the
    # whole sum at x[0] is that of the distinct points' sum, doubled, at X[0]
    g = torch.autograd.grad(K.sum(), x)[0]
    x4 = torch.tensor(X, requires_grad=True)
    w = torch.tensor([2.0, 2.0, 1.0, 1.0], dtype=torch.float64)
    g4 = torch.autograd.grad((w[:, None] * k.K(x4) * w[None, :]).sum(), x4)[0]
    np.testing.assert_allclose(g[0].numpy(), g4[0].numpy() / 2.0, rtol=1e-12)


def test_constructors_refuse_what_the_reference_asserts():
    """Brownian and Spline are 1-D and Poly's order is at least 1: the
    reference asserts, the port raises ValueError."""
    for make in (lambda: tk.Brownian(2, device="cpu"), lambda: tk.Spline(2, device="cpu"),
                 lambda: tk.Poly(1, order=0.5, device="cpu")):
        with pytest.raises(ValueError):
            make()
