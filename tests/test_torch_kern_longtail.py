"""The long tail's kernels (the basis-function family, the integral
kernels, Symmetric, SplitKern, DEtime, GridRBF) and the finite-difference
checkers against gpy_tpu, float64 on the CPU.

For each kernel: K (square and rectangular), Kdiag, and the autograd
gradient of a scalar of the square K with respect to every raw parameter
and to the inputs, against jax.grad through the reference kernel at the
same raw values (rel 1e-12 for K, 1e-10 for the gradients, as
tests/test_torch_kern_periodic_misc.py holds the others). The reference's
Integral.Kdiag is zero (ROADMAP C(x)); the port's is the diagonal of K.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpy_tpu.kern as gk
import gpy_tpu.models as J
import gpy_tpu_torch.kern as tk
import gpy_tpu_torch.models as T

jax.config.update("jax_enable_x64", True)

C = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(name):
    """(reference kernel, port kernel, input columns) of one case."""
    def both(cls, *a, **kw):
        return getattr(gk, cls)(*a, **kw), getattr(tk, cls)(*a, **kw, **C)

    if name == "PolynomialBasisFuncKernel":
        return both(name, 1, 3, variance=0.7) + (1,)
    if name in ("LinearSlopeBasisFuncKernel", "DomainKernel"):
        return both(name, 1, 1.0, 2.5, variance=1.3) + (1,)
    if name == "ChangePointBasisFuncKernel":
        return both(name, 1, 1.7, variance=0.9) + (1,)
    if name == "LogisticBasisFuncKernel":
        return both(name, 1, [1.0, 2.5], variance=1.2, slope=2.0) + (1,)
    if name == "Integral_Limits":
        return both(name, 2, variances=1.3, lengthscale=0.7) + (2,)
    if name == "Integral":
        return both(name, 1, variances=1.1, lengthscale=0.8) + (1,)
    if name == "Multidimensional_Integral_Limits":
        return both(name, 4, variances=0.9, lengthscale=[0.6, 1.4]) + (4,)
    if name.startswith("Symmetric"):
        kind = name.split("-")[1]
        A = np.array([[-1.0, 0.0], [0.0, 1.0]])
        return (gk.Symmetric(gk.RBF(2, ARD=True), A, kind),
                tk.Symmetric(tk.RBF(2, ARD=True, **C), A, kind), 2)
    if name == "SplitKern":
        return (gk.SplitKern(gk.RBF(1, variance=0.8, lengthscale=0.6), 1.2),
                tk.SplitKern(tk.RBF(1, variance=0.8, lengthscale=0.6, **C), 1.2), 2)
    if name == "DEtime":
        return both(name, Xd=1.5) + (2,)
    if name == "GridRBF":
        return both(name, 2, variance=1.4, lengthscale=[0.7, 1.3], ARD=True) + (2,)
    raise KeyError(name)


CASES = ["PolynomialBasisFuncKernel", "LinearSlopeBasisFuncKernel", "ChangePointBasisFuncKernel",
         "DomainKernel", "LogisticBasisFuncKernel", "Integral_Limits", "Integral",
         "Multidimensional_Integral_Limits", "Symmetric-even", "Symmetric-odd", "SplitKern",
         "DEtime", "GridRBF"]


def _inputs(name, D, rng):
    if name.startswith("Integral_Limits") or name.startswith("Multi"):
        s = rng.random((8, D // 2)) * 2
        X = np.empty((8, D))
        X[:, 0::2], X[:, 1::2] = s + 0.2 + rng.random((8, D // 2)), s  # [t, s] pairs, t > s
        return X, rng.random((5, D)) * 3
    if name in ("SplitKern", "DEtime"):
        x = rng.random((8, 1)) * 3
        return np.hstack([x, (np.arange(8) % 2)[:, None]]), np.hstack(
            [rng.random((5, 1)) * 3, (np.arange(5) % 2)[:, None]])
    return rng.random((8, D)) * 3 - (0.5 if name.startswith("Symmetric") else 0.0), \
        rng.random((5, D)) * 3


@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_reference(name):
    jk, tkern, D = _pair(name)
    assert tkern.name == jk.name
    raw_ref = {k: np.asarray(v) for k, v in jk.get_raw_dict().items()}
    raw = {k: v.detach().numpy() for k, v in tkern.get_raw_dict().items()}
    assert list(raw) == list(raw_ref)
    for k in raw_ref:
        np.testing.assert_allclose(raw[k], raw_ref[k], rtol=1e-13, err_msg=k)
    rng = np.random.default_rng(sum(map(ord, name)))
    raw_ref = {k: v + 0.2 * rng.standard_normal(v.shape) for k, v in raw_ref.items()}
    tkern.set_raw_dict(raw_ref)
    jk = jk.with_raw_dict({k: jnp.asarray(v) for k, v in raw_ref.items()})

    X, X2 = _inputs(name, D, rng)
    Xt, X2t = torch.tensor(X), torch.tensor(X2)
    K = tkern.K(Xt).detach().numpy()
    np.testing.assert_allclose(K, np.asarray(jk.K(jnp.asarray(X))), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tkern.K(Xt, X2t).detach().numpy(),
                               np.asarray(jk.K(jnp.asarray(X), jnp.asarray(X2))),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tkern.Kdiag(Xt).detach().numpy(), np.diag(K), rtol=1e-12,
                               atol=1e-14)
    if name != "Integral":  # C(x): see test_integral_kdiag_is_the_diagonal
        np.testing.assert_allclose(tkern.Kdiag(Xt).detach().numpy(),
                                   np.asarray(jk.Kdiag(jnp.asarray(X))), rtol=1e-12, atol=1e-14)

    G = rng.standard_normal((8, 8))
    wrt_x = name not in ("SplitKern", "DEtime")  # the index column is not an input

    def f_ref(r, x):
        return jnp.sum(jnp.asarray(G) * jnp.tanh(jk.with_raw_dict(r).K(x)))

    ref_r, ref_x = jax.grad(f_ref, argnums=(0, 1))({k: jnp.asarray(v) for k, v in raw_ref.items()},
                                                   jnp.asarray(X))
    x = torch.tensor(X, requires_grad=True)
    leaves = _leaves(tkern, raw)
    loss = torch.sum(torch.tensor(G) * torch.tanh(tkern.K(x)))
    grads = torch.autograd.grad(loss, leaves + [x], allow_unused=True)
    names = list(raw) + (["X"] if wrt_x else [])
    refs = [ref_r[k] for k in raw] + ([ref_x] if wrt_x else [])
    for k, g, ref in zip(names, grads, refs):
        g = torch.zeros_like(x) if g is None else g
        assert torch.isfinite(g).all(), k
        ref = np.asarray(ref)
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-10,
                                   atol=1e-12 * max(1.0, np.abs(ref).max()), err_msg=k)


def _leaves(kern, raw):
    params = {path: mod._parameters[n] for path, mod, n in kern.named_params()}
    return [params[k] for k in raw]


def test_integral_kdiag_is_the_diagonal():
    """ROADMAP C(x): for X = linspace(0, 3, 5) the port's Integral.Kdiag is
    diag(K) = [0, 0.515, 1.674, 2.989, 4.317]; the reference's reads a
    second column its X lacks, which JAX clamps to the first, so t = s and
    its diagonal is 0."""
    X = np.linspace(0, 3, 5).reshape(-1, 1)
    jk, tkern = gk.Integral(1), tk.Integral(1, **C)
    K = tkern.K(torch.tensor(X)).detach().numpy()
    np.testing.assert_allclose(K, np.asarray(jk.K(jnp.asarray(X))), rtol=1e-12, atol=1e-14)
    kd = tkern.Kdiag(torch.tensor(X)).detach().numpy()
    np.testing.assert_allclose(kd, np.diag(K), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(kd, [0.0, 0.515, 1.674, 2.989, 4.317], atol=1e-3)
    np.testing.assert_array_equal(np.asarray(jk.Kdiag(jnp.asarray(X))), np.zeros(5))


def test_basis_func_posterior_inf_and_dtype():
    """posterior_inf (the weights' mean and covariance) of a
    LinearSlopeBasisFuncKernel in a GPRegression against the reference's,
    rel 1e-8; the step features keep X's dtype (float32 here)."""
    rng = np.random.default_rng(9)
    X = np.sort(rng.random((20, 1)) * 4, axis=0)
    Y = np.clip(X, 1.0, 3.0) + 0.05 * rng.standard_normal((20, 1))
    jm = J.GPRegression(X, Y, gk.LinearSlopeBasisFuncKernel(1, 1.0, 3.0), noise_var=0.01)
    tm = T.GPRegression(X, Y, tk.LinearSlopeBasisFuncKernel(1, 1.0, 3.0, **C), noise_var=0.01,
                        **C)
    for a, b in zip(tm.kern.posterior_inf(tm.X, tm.posterior),
                    jm.kern.posterior_inf(jnp.asarray(X), jm.posterior)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-8)
    for cls, args in ((tk.ChangePointBasisFuncKernel, (1.5,)), (tk.DomainKernel, (1.0, 2.0))):
        k = cls(1, *args, device="cpu", dtype=torch.float32)
        x32 = torch.tensor(X, dtype=torch.float32)
        assert k.phi(x32).dtype == torch.float32 and k.K(x32).dtype == torch.float32
    with pytest.raises(NotImplementedError):
        tk.BasisFuncKernel(1, **C).K(torch.tensor(X))


def test_split_and_grid_names():
    """DiffGenomeKern is DEtime (gpy_tpu/kern/__init__.py:55-56); SplitKern's
    within-domain block is its base kernel's K; GridRBF is the RBF."""
    assert tk.DiffGenomeKern is tk.DEtime
    k = tk.DEtime(Xd=1.0, **C)
    x = np.linspace(0, 2, 6).reshape(-1, 1)
    X = np.vstack([np.hstack([x, np.zeros((6, 1))]), np.hstack([x, np.ones((6, 1))])])
    K = k.K(torch.tensor(X)).detach().numpy()
    np.testing.assert_allclose(K, K.T, atol=1e-14)
    np.testing.assert_allclose(K[:6, :6], k.base_kern.K(torch.tensor(x)).detach().numpy(),
                               rtol=1e-14)
    g = tk.GridRBF(1, **C)
    np.testing.assert_array_equal(g.K(torch.tensor(x)).detach().numpy(),
                                  tk.RBF(1, **C).K(torch.tensor(x)).detach().numpy())


def test_checkers():
    """tests/test_module.py:121-140's cases: a right gradient, Hessian and
    third derivative pass, a wrong gradient fails; callables returning
    torch tensors are read back to numpy."""
    def f(x):
        return np.sum(np.sin(x) * x**2)

    def df(x):
        return np.cos(x) * x**2 + 2 * x * np.sin(x)

    assert T.GradientChecker(f, df, np.array([0.3, -1.2, 2.0])).checkgrad()
    assert not T.GradientChecker(f, lambda x: np.cos(x) * x**2, np.array([0.3, -1.2])).checkgrad()

    def ddf(x):
        return np.diag(-np.sin(x) * x**2 + 4 * x * np.cos(x) + 2 * np.sin(x))

    assert T.HessianChecker(f, df, ddf, np.array([0.4, 1.1])).checkgrad()

    def dddf3(x):
        T3 = np.zeros((x.size,) * 3)
        for i in range(x.size):
            T3[i, i, i] = 24 * x[i]
        return T3

    assert T.SkewChecker(lambda x: 4 * x**3, lambda x: np.diag(12 * x**2), dddf3,
                         np.array([0.5, -0.8])).checkgrad()
    ft = lambda x: torch.sum(torch.sin(torch.tensor(x)) * torch.tensor(x) ** 2)  # noqa: E731
    dft = lambda x: torch.tensor(df(x))  # noqa: E731
    assert T.GradientChecker(ft, dft, torch.tensor([0.3, -1.2, 2.0])).checkgrad()


@pytest.mark.parametrize("make", [
    lambda: tk.PolynomialBasisFuncKernel(1, 2), lambda: tk.LinearSlopeBasisFuncKernel(1, 0., 1.),
    lambda: tk.Integral(1), lambda: tk.Multidimensional_Integral_Limits(4),
    lambda: tk.DEtime(), lambda: tk.GridRBF(1)],
    ids=["Polynomial", "LinearSlope", "Integral", "MultiIntegral", "DEtime", "GridRBF"])
def test_defaults_to_cuda(make):
    """Without device= the kernels ask for the card and raise where there
    is none."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        make()
