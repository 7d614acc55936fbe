"""The symbolic kernel (kern/symbolic.py) and likelihood
(likelihoods/symbolic.py) against gpy_tpu and against the port's
closed-form twins (RBF, Gaussian, StudentT), float64 on the CPU; the cases
of tests/test_kernels.py:268-310 and tests/test_symbolic_likelihood.py.

sympy prints numeric sub-expressions such as sqrt(2) or loggamma(5/2) as
calls on Python numbers, which torch's functions refuse; the port makes
them Floats first, and the expressions that carry them are held here.
"""
import copy
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import sympy
import torch

import gpy_tpu.kern as gk
import gpy_tpu.likelihoods as gl
import gpy_tpu.models as J
import gpy_tpu_torch.kern as tk
import gpy_tpu_torch.likelihoods as tl
import gpy_tpu_torch.models as T
from gpy_tpu.core.gp import GP as J_GP
from gpy_tpu.inference.laplace import Laplace as J_Laplace
from gpy_tpu_torch.core.gp import GP
from gpy_tpu_torch.inference.laplace import Laplace

jax.config.update("jax_enable_x64", True)

C = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


x, z, variance, lengthscale = sympy.symbols("x z variance lengthscale")
RBF_EXPR = variance * sympy.exp(-(x - z) ** 2 / (2 * lengthscale ** 2))
PARAMS = {"variance": 1.3, "lengthscale": 0.7}


def _data(n=20, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 1))
    return X, np.sin(2 * X) + 0.05 * rng.standard_normal((n, 1))


def test_symbolic_kernel_is_rbf():
    sk = tk.Symbolic(1, k=RBF_EXPR, parameters=PARAMS, **C)
    rk = tk.RBF(1, variance=1.3, lengthscale=0.7, **C)
    X = torch.tensor(_data()[0])
    np.testing.assert_allclose(sk.K(X).detach(), rk.K(X).detach(), rtol=1e-12)
    np.testing.assert_allclose(sk.K(X, X[:7]).detach(), rk.K(X, X[:7]).detach(), rtol=1e-12)
    np.testing.assert_allclose(sk.Kdiag(X).detach(), rk.Kdiag(X).detach(), rtol=1e-12)
    dK = torch.ones(20, 20, **C)
    np.testing.assert_allclose(sk.gradients_X(dK, X), rk.gradients_X(dK, X), rtol=1e-10, atol=1e-14)
    X, Y = _data()
    ms = T.GPRegression(X, Y, tk.Symbolic(1, k=RBF_EXPR, parameters=PARAMS, **C), **C)
    mr = T.GPRegression(X, Y, tk.RBF(1, variance=1.3, lengthscale=0.7, **C), **C)
    x0 = ms.optimizer_array
    np.testing.assert_allclose(x0, mr.optimizer_array[[1, 0, 2]], rtol=1e-15)  # sorted names
    f, g = ms._objective_and_grad(x0)
    fr, gr = mr._objective_and_grad(mr.optimizer_array)
    assert f == pytest.approx(fr, rel=1e-12)
    np.testing.assert_allclose(g, gr[[1, 0, 2]], rtol=1e-10)


def test_symbolic_kernel_model_against_the_reference_and_trains():
    X, Y = _data()
    m = T.GPRegression(X, Y, tk.Symbolic(1, k=RBF_EXPR, **C), **C)
    mr = J.GPRegression(X, Y, kernel=gk.Symbolic(1, k=RBF_EXPR))
    x0 = m.optimizer_array
    np.testing.assert_allclose(x0, np.asarray(mr.get_flat_raw()), rtol=1e-12)
    f, g = m._objective_and_grad(x0)
    fr, gr = mr._objective_and_grad(jnp.asarray(x0))
    assert f == pytest.approx(float(fr), rel=1e-12)
    np.testing.assert_allclose(g, np.asarray(gr), rtol=1e-10)
    assert m.checkgrad()
    m.optimize()
    assert m._objective_and_grad(m.optimizer_array)[0] < f


def test_symbolic_kernel_2d_and_bias_against_the_reference():
    x0, x1, z0, z1, a = sympy.symbols("x_0 x_1 z_0 z_1 a")
    k2 = sympy.exp(-a * ((x0 - z0) ** 2 + (x1 - z1) ** 2))
    sp = tk.Symbolic(2, k=k2, parameters={"a": 0.6}, **C) + tk.Bias(2, variance=0.2, **C)
    sr = gk.Symbolic(2, k=k2, parameters={"a": 0.6}) + gk.Bias(2, variance=0.2)
    X2 = np.random.default_rng(2).standard_normal((15, 2))
    K2 = sp.K(torch.tensor(X2)).detach().numpy()
    assert K2.shape == (15, 15)
    np.testing.assert_allclose(K2, np.asarray(sr.K(jnp.asarray(X2))), rtol=1e-12)
    np.testing.assert_allclose(K2, K2.T, atol=1e-12)
    assert np.linalg.eigvalsh(K2).min() > -1e-10
    np.testing.assert_allclose(sp.Kdiag(torch.tensor(X2)).detach(), np.diag(K2), rtol=1e-12)
    with pytest.raises(ValueError):
        tk.Symbolic(2, k=sympy.exp(-(x - z) ** 2), **C)


def test_numeric_constants_in_the_expression():
    """sqrt(2), log(2) and loggamma(5/2) reach torch as floats; an
    expression free of the inputs broadcasts to (N, M)."""
    v, l = sympy.symbols("v l")
    expr = (sympy.sqrt(2) * v * sympy.exp(-(x - z) ** 2 / (2 * l ** 2)) * sympy.log(2)
            + sympy.loggamma(sympy.Rational(5, 2)) ** 2)
    sk = tk.Symbolic(1, k=expr, parameters={"v": 0.9, "l": 1.1}, **C)
    sr = gk.Symbolic(1, k=expr, parameters={"v": 0.9, "l": 1.1})
    X = _data(8)[0]
    d = X - X.T
    want = (np.sqrt(2) * 0.9 * np.exp(-d ** 2 / 2.42) * np.log(2)
            + float(sympy.loggamma(sympy.Rational(5, 2))) ** 2)
    K = sk.K(torch.tensor(X)).detach().numpy()
    np.testing.assert_allclose(K, want, rtol=1e-14)
    np.testing.assert_allclose(K, np.asarray(sr.K(jnp.asarray(X))), rtol=1e-14)
    const = tk.Symbolic(1, k=v * sympy.sqrt(sympy.pi) + 0 * x, parameters={"v": 2.0}, **C)
    Kc = const.K(torch.tensor(X), torch.tensor(X[:3]))
    assert Kc.shape == (8, 3) and Kc.dtype == torch.float64
    np.testing.assert_allclose(Kc.detach(), 2.0 * np.sqrt(np.pi), rtol=1e-15)
    assert const.Kdiag(torch.tensor(X)).shape == (8,)


def _sym_gaussian(pkg, **kw):
    f, y = sympy.symbols("f y")
    s = sympy.Symbol("s", positive=True)
    cls = tl.SymbolicLikelihood if pkg == "port" else gl.SymbolicLikelihood
    return cls(-(y - f) ** 2 / (2 * s) - sympy.log(2 * sympy.pi * s) / 2, parameters={"s": 0.3},
               conditional_mean=f, conditional_variance=s, name="symgauss", **kw)


def _student_t_expr():
    """log of the Student-t density with a literal nu = 4 and scale s: its
    loggamma(5/2) is the numeric sub-expression torch refuses."""
    f, y = sympy.symbols("f y")
    s = sympy.Symbol("s", positive=True)
    nu = sympy.Integer(4)
    return (sympy.loggamma((nu + 1) / 2) - sympy.loggamma(nu / 2) - sympy.log(nu * sympy.pi * s) / 2
            - (nu + 1) / 2 * sympy.log(1 + (y - f) ** 2 / (nu * s)))


def test_symbolic_gaussian_against_the_closed_form_and_the_reference():
    with torch.no_grad():
        lik = _sym_gaussian("port", **C)
        ref = tl.Gaussian(variance=0.3, **C)
        jref = _sym_gaussian("ref")
        rng = np.random.default_rng(0)
        F, Y, m = (torch.tensor(rng.standard_normal((6, 1))) for _ in range(3))
        v = torch.tensor(0.2 + 0.3 * rng.random((6, 1)))
        np.testing.assert_allclose(lik.logpdf(F, Y), ref.logpdf(F, Y), rtol=1e-12)
        np.testing.assert_allclose(lik.logpdf(F, Y), np.asarray(jref.logpdf(F.numpy(), Y.numpy())),
                                   rtol=1e-12)
        ve = lik.variational_expectations(Y, m, v)
        np.testing.assert_allclose(ve, ref.variational_expectations(Y, m, v), rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(ve, np.asarray(jref.variational_expectations(
            Y.numpy(), m.numpy(), v.numpy())), rtol=1e-12)
        lpd = lik.log_predictive_density(Y, m, v)
        np.testing.assert_allclose(lpd, ref.log_predictive_density(Y, m, v), rtol=1e-5, atol=1e-6)
        mu, var = lik.predictive_values(m, v)
        np.testing.assert_allclose(mu, m, rtol=1e-10)
        np.testing.assert_allclose(var, v + 0.3, rtol=1e-10)


def test_symbolic_student_t_under_laplace_is_studentt():
    """The symbolic Student-t (nu = 4) in a Laplace GP against the port's
    StudentT(deg_free=4) model and the reference's symbolic model: NLML and
    gradient."""
    rng = np.random.default_rng(1)
    X = rng.random((25, 1)) * 4
    Y = np.sin(X) + 0.1 * rng.standard_normal((25, 1))
    Y[::7] += 2.0  # outliers
    ms = GP(X, Y, tk.RBF(1, **C), tl.SymbolicLikelihood(_student_t_expr(), parameters={"s": 0.1},
                                                        **C), inference_method=Laplace(), **C)
    mt = GP(X, Y, tk.RBF(1, **C), tl.StudentT(deg_free=4.0, sigma2=0.1, **C),
            inference_method=Laplace(), **C)
    mr = J_GP(X, Y, gk.RBF(1), gl.SymbolicLikelihood(_student_t_expr(), parameters={"s": 0.1}),
              inference_method=J_Laplace())
    x0 = ms.optimizer_array
    np.testing.assert_allclose(x0, mt.optimizer_array, rtol=1e-15)
    f, g = ms._objective_and_grad(x0)
    ft, gt = mt._objective_and_grad(x0)
    fr, gr = mr._objective_and_grad(jnp.asarray(x0))
    assert f == pytest.approx(ft, rel=1e-10) and f == pytest.approx(float(fr), rel=1e-10)
    np.testing.assert_allclose(g, gt, rtol=1e-10)
    np.testing.assert_allclose(g, np.asarray(gr), rtol=1e-9)
    ms.optimize(max_iters=10)
    assert ms._objective_and_grad(ms.optimizer_array)[0] < f


def test_pickle_and_copy_round_trips():
    lik = _sym_gaussian("port", **C)
    sk = tk.Symbolic(1, k=RBF_EXPR, parameters=PARAMS, **C)
    F, Y = torch.tensor([[0.3], [-0.4]], **C), torch.tensor([[0.1], [0.2]], **C)
    X = torch.tensor(_data(5)[0])
    for clone in (lambda o: pickle.loads(pickle.dumps(o)), copy.deepcopy):
        l2, k2 = clone(lik), clone(sk)
        np.testing.assert_array_equal(l2.logpdf(F, Y).detach(), lik.logpdf(F, Y).detach())
        np.testing.assert_array_equal(l2.conditional_variance(F).detach(),
                                      lik.conditional_variance(F).detach())
        np.testing.assert_array_equal(k2.K(X).detach(), sk.K(X).detach())
        k2.variance = 2.0
        assert float(k2.K(X)[0, 0]) == pytest.approx(2.0) and float(sk.K(X)[0, 0]) == pytest.approx(1.3)


def test_a_singular_laplace_system_gives_nan_for_the_optimizer():
    """A non-log-concave likelihood's Newton system I + W K can be singular at
    a wild optimizer step: the LU solve returns inf/NaN, as the reference's
    jnp.linalg.solve does, and the optimizer backs off (an exception would
    end the fit)."""
    from gpy_tpu_torch.util.linalg import solve_lu_safe

    A = torch.tensor([[1.0, 2.0], [2.0, 4.0]], **C)
    x = solve_lu_safe(A, torch.ones(2, 1, **C))
    assert not torch.isfinite(x).all()
    np.testing.assert_allclose(solve_lu_safe(A + torch.eye(2, **C), torch.ones(2, 1, **C)),
                               np.linalg.solve(A.numpy() + np.eye(2), np.ones((2, 1))), rtol=1e-14)
