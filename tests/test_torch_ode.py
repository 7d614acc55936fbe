"""The latent-force and ODE kernels (EQ_ODE1, EQ_ODE2, ODE_UY, ODE_UYC,
ODE_st, ODE_t) against gpy_tpu, float64 on the CPU, and against numerical
integration of their defining integrals (the oracles of
tests/test_ode_kernels.py).

The reference's EQ_ODE kernels read the index column with numpy, so a
traced X fails (ROADMAP C(ad)): its models are evaluated here by one jitted
function of the raw vector in which the inputs stay numpy arrays, the
reference's own kernel, inference and model code at the same raw values
(compiled once a module: the reference's Faddeeva scan is costly to
compile). K blocks, Kdiag, NLML and gradients are held at rel 1e-9 (they
read 1e-16-1e-15, the critically damped EQ_ODE2 too).
Where the reference cannot run (optimize, C(ad); ODE_UY's gradient at long
range, C(ab)) the port is held to central differences of its own NLML.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import dblquad, quad

import gpy_tpu.kern as gk
import gpy_tpu.models as J
import gpy_tpu_torch.kern as tk
import gpy_tpu_torch.models as T
from gpy_tpu_torch.kern import eq_ode1 as t_eq_ode1
from gpy_tpu_torch.kern.eq_ode2 import _upsilon

jax.config.update("jax_enable_x64", True)

C = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rows(times, indices):
    return np.vstack([np.stack([times, np.full_like(times, i)], 1) for i in indices])


XF = _rows(np.linspace(0.1, 2.0, 5), [0, 1])  # outputs 0, 1
XU = _rows(np.linspace(0.2, 1.8, 3), [2, 3])  # forces 0, 1
YF = np.sin(2.0 * XF[:, :1]) + 0.3 * XF[:, 1:]
W0 = np.array([[1.0, 0.3], [0.5, -0.8]])
LS0 = [0.8, 1.3]
# (C, B): underdamped, overdamped (both outputs), critically damped
REGIMES = {"underdamped": ([1.0, 1.0], [3.0, 3.0]), "overdamped": ([6.5, 2.4], [6.3, 1.2]),
           "critical": ([4.0, 4.0], [4.0, 4.0])}


def _weights(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


def _blocks(k, XF, XU):
    return (k.K(XF, XU), k.K(XU, XF), k.K(XU), k.K(XU, XU[[5, 4, 3, 2, 1, 0]]), k.Kdiag(XF),
            k.Kdiag(XU))


def _ref_jitted(m_ref, blocks_fn, objective_fn, shapes):
    """jit(value_and_grad) of objective + sum(w_i * block_i) in the model's
    raw vector, with the objective and the blocks as aux: one compile."""
    R = [jnp.asarray(r) for r in _weights(shapes)]

    def f(flat):
        mod = m_ref.with_flat_raw(flat)
        bl = blocks_fn(mod.kern, XF, XU)
        obj = objective_fn(mod)
        return obj + sum(jnp.sum(r * b) for r, b in zip(R, bl)), (obj, bl)

    return jax.jit(jax.value_and_grad(f, has_aux=True))


def _port_eval(m, flat, blocks_fn, shapes):
    """(objective, blocks, gradient of objective + sum(w_i * block_i))."""
    R = [torch.tensor(r) for r in _weights(shapes)]
    x = torch.tensor(flat, requires_grad=True)
    with m.bind_flat_raw(x):
        bl = blocks_fn(m.kern, torch.tensor(XF), torch.tensor(XU))
        obj = m.objective_function()
        s = obj + sum(torch.sum(r * b) for r, b in zip(R, bl))
    g = torch.autograd.grad(s, x)[0]
    return float(obj), [b.detach().numpy() for b in bl], g.numpy()


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def _hold(port, ref, rel, free=None):
    """port = (objective, blocks, gradient); ref = the jitted reference's
    ((value, (objective, blocks)), gradient)."""
    obj, bl, g = port
    (_, (robj, rbl)), rg = ref
    free = slice(None) if free is None else free
    assert abs(obj - float(robj)) <= rel * abs(float(robj))
    for b, rb in zip(bl, rbl):
        assert _rel(b, rb) <= rel
    assert _rel(g[free], np.asarray(rg)[free]) <= rel


# --- EQ_ODE2 ------------------------------------------------------------------

EQ2_SHAPES = [(10, 6), (6, 6), (6,)]


@pytest.fixture(scope="module")
def eq2():
    m_ref = J.GPRegression(XF, YF, gk.EQ_ODE2(output_dim=2, rank=2, W=W0, lengthscale=LS0),
                           noise_var=0.1)
    m = T.GPRegression(XF, YF, tk.EQ_ODE2(output_dim=2, rank=2, W=W0, lengthscale=LS0, **C),
                       noise_var=0.1, **C)
    np.testing.assert_allclose(m.optimizer_array, np.asarray(m_ref.optimizer_array), rtol=1e-12)
    blocks = lambda k, XF, XU: (k.K(XF, XU), k.K(XU), k.Kdiag(XU))

    def objective(mod):
        return -mod.inference_method.marginal_likelihood(mod.kern, XF, mod.likelihood,
                                                         jnp.asarray(YF))

    return m, blocks, _ref_jitted(m_ref, blocks, objective, EQ2_SHAPES)


@pytest.mark.parametrize("regime", list(REGIMES))
def test_eq_ode2_blocks_nlml_and_gradient(eq2, regime):
    """Kfu, Kuu and the forces' Kdiag, the GPRegression NLML (through Kff),
    and the gradient of the NLML plus a weighted sum of the blocks, in each
    damping regime; Kuf is Kfu'. Kff itself enters through the NLML: each
    block of the reference's costs its compile ~5 s more."""
    m, blocks, ref = eq2
    Cv, Bv = REGIMES[regime]
    m.kern.C, m.kern.B = Cv, Bv
    flat = m.optimizer_array
    _hold(_port_eval(m, flat, blocks, EQ2_SHAPES), ref(jnp.asarray(flat)), 1e-9)
    Xf, Xu = torch.tensor(XF), torch.tensor(XU)
    with torch.no_grad():
        assert torch.equal(m.kern.K(Xu, Xf), m.kern.K(Xf, Xu).T)


def test_eq_ode2_kdiag_per_force_sums_to_the_diagonal():
    """The port's Kdiag is the row sum of Kdiag_per_force, O(N 40 R); the
    reference takes diag(Kff), O(N^2 40 R): tests/test_ode_kernels.py:185-200."""
    k = tk.EQ_ODE2(2, output_dim=2, rank=2, **C)
    t = torch.linspace(0.3, 3.0, 6, **C)
    d = torch.tensor([0, 0, 0, 1, 1, 1])
    pf = k.Kdiag_per_force(t, d)
    assert pf.shape == (6, 2)
    np.testing.assert_allclose(pf.sum(1).detach().numpy(),
                               torch.diagonal(k._Kff(t, d, t, d)).detach().numpy(), atol=1e-10)


def test_eq_ode2_gp_optimizes_and_reads_its_index_once():
    """C(ad): the reference's optimize() raises TracerArrayConversionError;
    the port's runs, and reads X's index column once for all evaluations."""
    m = T.GPRegression(XF, YF, tk.EQ_ODE2(output_dim=2, rank=2, W=W0, lengthscale=LS0, **C),
                       noise_var=0.1, **C)
    before = t_eq_ode1.index_reads
    nlml0 = -float(m.log_likelihood())
    m.optimize(max_iters=3)
    assert -float(m.log_likelihood()) < nlml0
    assert t_eq_ode1.index_reads - before == 1
    mu, var = m.predict(XF[:4])
    assert np.isfinite(mu).all() and (var > 0).all()


def test_eq_ode2_against_quadrature():
    """tests/test_ode_kernels.py:110-135: Kfu and Kff of an underdamped and
    Kfu of an overdamped output against scipy's quad and dblquad."""
    Cd, Bd, l, w = 0.9, 2.0, 0.6, 0.8
    k = tk.EQ_ODE2(output_dim=1, rank=1, W=np.array([[w]]), lengthscale=[l], C=[Cd], B=[Bd], **C)
    al, om = Cd / 2, np.sqrt(Bd - Cd ** 2 / 4)
    G = lambda s: np.exp(-al * s) * np.sin(om * s) / om
    x = lambda *r: torch.tensor([r], **C)
    got = float(k.K(x(1.5, 0.0), x(1.0, 1.0))[0, 0])
    want, _ = quad(lambda tau: G(1.5 - tau) * np.exp(-((tau - 1.0) ** 2) / l ** 2), 0, 1.5)
    assert got == pytest.approx(w * want, rel=1e-7)
    got = float(k.K(x(1.2, 0.0), x(0.5, 0.0))[0, 0])
    want, _ = dblquad(lambda a, b: G(1.2 - a) * G(0.5 - b) * np.exp(-((a - b) ** 2) / l ** 2),
                      0, 0.5, 0, 1.2)
    assert got == pytest.approx(w * w * want, rel=1e-6)
    k = tk.EQ_ODE2(output_dim=1, rank=1, W=np.array([[w]]), lengthscale=[l], C=[3.0], B=[1.0], **C)
    al, omi = 1.5, np.sqrt(3.0 ** 2 / 4 - 1.0)
    G = lambda s: np.exp(-al * s) * np.sinh(omi * s) / omi
    got = float(k.K(x(1.0, 0.0), x(0.6, 1.0))[0, 0])
    want, _ = quad(lambda tau: G(1.0 - tau) * np.exp(-((tau - 0.6) ** 2) / l ** 2), 0, 1.0)
    assert got == pytest.approx(w * want, rel=1e-7)


def test_upsilon_and_nystrom_gap_in_every_damping_regime():
    """tests/test_ode_kernels.py:211-245: the branch-stable Upsilon against
    the trapezoid rule, and Kff - Kfu Kuu^-1 Kuf positive semidefinite."""
    for gamma, t, tp, l in [(1.0 + 2.0j, 2.0, 0.7, 0.8), (5.35 + 0j, 2.0, 0.7, 2.3),
                            (0.9 + 0j, 3.0, 2.5, 1.5), (7.0 + 0j, 1.5, 1.2, 3.0)]:
        tau = np.linspace(0.0, t, 40001)
        num = np.trapezoid(np.exp(-gamma * (t - tau)) * np.exp(-((tau - tp) ** 2) / l ** 2), tau)
        r = lambda v: torch.tensor(v, dtype=torch.float64)
        ana = complex(_upsilon(torch.tensor(gamma, dtype=torch.complex128), r(t), r(tp), r(l)))
        assert abs(ana - num) / abs(num) < 1e-6

    k = tk.EQ_ODE2(2, output_dim=2, rank=1, **C)
    t = torch.linspace(0.1, 4, 12, **C)
    d = torch.zeros(12, dtype=torch.long)
    tz = torch.linspace(0.1, 4, 8, **C)
    q = torch.zeros(8, dtype=torch.long)
    for Cv, Bv, Wv, ls in [([1.0, 1.0], [3.0, 3.0], [[1.0], [0.5]], [0.8]),
                           ([6.5, 2.4], [6.3, 1.2], [[6.4], [5.1]], [2.3]),
                           ([4.0, 4.0], [4.0, 4.0], [[1.0], [1.0]], [1.0])]:
        k.C, k.B, k.W, k.lengthscale = Cv, Bv, Wv, ls
        with torch.no_grad():
            Kfu = k._Kfu(t, d, tz, q)
            S = k._Kff(t, d, t, d) - Kfu @ torch.linalg.solve(
                k._Kuu(tz, q) + 1e-9 * torch.eye(8, **C), Kfu.T)
        assert float(torch.linalg.eigvalsh(0.5 * (S + S.T)).min()) > -1e-8


# --- EQ_ODE1 ------------------------------------------------------------------

EQ1_SHAPES = [(10, 6), (6, 10), (6, 6), (6, 6), (10,), (6,)]


@pytest.fixture(scope="module")
def eq1():
    kw = dict(output_dim=2, rank=2, W=W0, lengthscale=LS0, decay=[1.3, 0.7])
    m_ref = J.SparseGPRegression(XF, YF, Z=XU, kernel=gk.EQ_ODE1(**kw), noise_var=0.1)
    m = T.SparseGPRegression(XF, YF, Z=XU, kernel=tk.EQ_ODE1(**kw, **C), noise_var=0.1, **C)
    np.testing.assert_allclose(m.optimizer_array, np.asarray(m_ref.optimizer_array), rtol=1e-12)
    def objective(mod):  # Z as the numpy array: the gradient has no Z part
        return -mod.inference_method.marginal_likelihood(mod.kern, XF, XU, mod.likelihood,
                                                         jnp.asarray(YF))

    return m, _ref_jitted(m_ref, _blocks, objective, EQ1_SHAPES)


def test_eq_ode1_blocks_bound_and_gradient(eq1):
    """Kfu, Kuf, Kuu, the force-force cross block, Kdiag, and the VarDTC
    bound and its gradient (but Z's, which the reference cannot take: its
    Z is read with numpy) of a SparseGPRegression; the f-f block raises."""
    m, ref = eq1
    flat = m.optimizer_array
    _hold(_port_eval(m, flat, _blocks, EQ1_SHAPES), ref(jnp.asarray(flat)), 1e-9,
          free=np.r_[XU.size:flat.size])
    with pytest.raises(NotImplementedError):
        m.kern.K(torch.tensor(XF, **C))


def test_eq_ode1_sparse_gp_optimizes_and_its_z_gradient_is_central_differences():
    kw = dict(output_dim=2, rank=2, W=W0, lengthscale=LS0, decay=[1.3, 0.7])
    m = T.SparseGPRegression(XF, YF, Z=XU, kernel=tk.EQ_ODE1(**kw, **C), noise_var=0.1, **C)
    x0 = m.optimizer_array
    f0, g = m._objective_and_grad(x0)
    h = 1e-6
    for i in range(0, XU.size, 2):  # Z's time column; its index column has gradient 0
        xp, xm = x0.copy(), x0.copy()
        xp[i] += h
        xm[i] -= h
        fd = (m._objective_and_grad(xp)[0] - m._objective_and_grad(xm)[0]) / (2 * h)
        assert g[i] == pytest.approx(fd, rel=1e-5, abs=1e-8)
        assert g[i + 1] == 0.0
    m.set_flat_raw(x0)
    m.optimize(max_iters=3)
    assert m._objective_and_grad(m.optimizer_array)[0] < f0


def test_eq_ode1_against_quadrature_and_finite_at_t0():
    """tests/test_ode_kernels.py:12-31; and at t = 0, where the block is 0,
    a finite gradient."""
    B, l, w = 1.3, 0.6, 0.8
    k = tk.EQ_ODE1(output_dim=1, rank=1, W=np.array([[w]]), lengthscale=[l], decay=[B], **C)
    x = lambda *r: torch.tensor([r], **C)
    for t, z in [(0.5, 0.3), (1.5, 1.0), (2.0, 0.2), (0.8, 1.5)]:
        got = float(k.K(x(t, 0.0), x(z, 1.0))[0, 0])
        want, _ = quad(lambda tau: np.exp(-B * (t - tau)) * np.exp(-((tau - z) ** 2) / l ** 2), 0, t)
        assert got == pytest.approx(w * want, rel=1e-6)
    for t in [0.4, 1.2, 2.5]:
        got = float(k.Kdiag(x(t, 0.0))[0])
        want, _ = dblquad(lambda a, b: np.exp(-B * (2 * t - a - b)) * np.exp(-((a - b) ** 2) / l ** 2),
                          0, t, 0, t)
        assert got == pytest.approx(w * w * want, rel=1e-6)
    Xf = torch.tensor([[0.0, 0.0], [0.7, 0.0]], **C, requires_grad=True)
    Xu = torch.tensor([[0.0, 1.0], [0.4, 1.0]], **C)
    out = k.K(Xf, Xu).sum() + k.Kdiag(Xf).sum()
    grads = torch.autograd.grad(out, [Xf] + [p for p in k.parameters()])
    assert all(torch.isfinite(g).all() for g in grads)
    assert float(k.K(Xf, Xu)[0].abs().max()) == 0.0 and float(k.Kdiag(Xf)[0]) == 0.0


# --- ODE_UY, ODE_UYC, ODE_st, ODE_t -------------------------------------------

def _uy_inputs(cols):
    rng = np.random.default_rng(0)
    t = np.sort(rng.random(5)).reshape(-1, 1) * 3
    if cols == 3:
        x = rng.random((5, 1))
        X = np.vstack([np.hstack([t, x, np.zeros_like(t)]), np.hstack([t, x, np.ones_like(t)])])
    else:
        X = np.vstack([np.hstack([t, np.zeros_like(t)]), np.hstack([t, np.ones_like(t)])])
    return X, X[[1, 7, 3, 8]] + 0.05  # square and rectangular cases


UY_CASES = {
    "ODE_UY": (dict(variance_U=1.0, variance_Y=0.8, lengthscale_U=1.2, lengthscale_Y=0.7), 2),
    "ODE_UYC": (dict(ubias=0.7, lengthscale_Y=0.6), 2),
    "ODE_st": (dict(a=0.8, b=1.2, c=0.9), 3),
    "ODE_t": (dict(a=0.7, c=1.1, ubias=0.4), 2),
}


@pytest.mark.parametrize("name", list(UY_CASES))
def test_ode_uy_family_against_the_reference(name):
    kw, cols = UY_CASES[name]
    kr = getattr(gk, name)(cols, **kw)
    kp = getattr(tk, name)(cols, **kw, **C)
    assert [p for p, *_ in kp.named_params()] == [p for p, *_ in kr.named_params()]
    assert kp.name == kr.name
    X, X2 = _uy_inputs(cols)
    R1, R2, R3 = _weights([(10, 10), (10, 4), (10,)], seed=1)

    def ref(flat):
        k = kr.with_flat_raw(flat)
        bl = (k.K(X), k.K(X, X2), k.Kdiag(X))
        return sum(jnp.sum(r * b) for r, b in zip((R1, R2, R3), bl)), bl

    flat = kp.get_flat_raw().numpy()
    np.testing.assert_allclose(flat, np.asarray(kr.get_flat_raw()), rtol=1e-12)
    (_, (rK, rK2, rKd)), g_ref = jax.jit(jax.value_and_grad(ref, has_aux=True))(jnp.asarray(flat))
    x = torch.tensor(flat, requires_grad=True)
    with kp.bind_flat_raw(x):
        Xt, X2t = torch.tensor(X), torch.tensor(X2)
        K, K2, Kd = kp.K(Xt), kp.K(Xt, X2t), kp.Kdiag(Xt)
        s = (torch.tensor(R1) * K).sum() + (torch.tensor(R2) * K2).sum() + (torch.tensor(R3) * Kd).sum()
    g = torch.autograd.grad(s, x)[0].numpy()
    assert _rel(K.detach().numpy(), rK) <= 1e-12
    assert _rel(K2.detach().numpy(), rK2) <= 1e-12
    assert _rel(Kd.detach().numpy(), rKd) <= 1e-12
    assert _rel(g, g_ref) <= 1e-9


def _uy_gp(pkg, T_end, seed=0):
    """GPRegression over ODE_UY, 40 U rows (sin t) and 40 Y rows (the
    first-order response) on linspace(0, T_end)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, T_end, 40)[:, None]
    y = (np.sin(t) - np.cos(t)) / 2 + np.exp(-t) / 2
    X = np.vstack([np.hstack([t, np.zeros_like(t)]), np.hstack([t, np.ones_like(t)])])
    Y = np.vstack([np.sin(t), y]) + 0.05 * rng.standard_normal((80, 1))
    if pkg == "ref":
        return J.GPRegression(X, Y, gk.ODE_UY(2), noise_var=0.1)
    return T.GPRegression(X, Y, tk.ODE_UY(2, **C), noise_var=0.1, **C)


def test_ode_uy_gradient_finite_at_long_range():
    """C(ab): at T = 1000 the reference's kernel gradient is NaN (the
    unselected cross form overflows); the port's is finite and equals
    central differences of its NLML. At T = 10 the two agree."""
    for T_end in (10.0, 1000.0):
        m, mr = _uy_gp("port", T_end), _uy_gp("ref", T_end)
        x = m.optimizer_array
        f, g = m._objective_and_grad(x)
        f_ref, g_ref = mr._objective_and_grad(jnp.asarray(x))
        g_ref = np.asarray(g_ref)
        assert f == pytest.approx(float(f_ref), rel=1e-12)
        assert np.isfinite(g).all()
        if T_end == 10.0:
            assert _rel(g, g_ref) <= 1e-9
            continue
        assert np.isnan(g_ref[:4]).all() and np.isfinite(g_ref[4])
        h = 1e-5
        fd = np.array([(m._objective_and_grad(x + h * e)[0] - m._objective_and_grad(x - h * e)[0])
                       / (2 * h) for e in np.eye(x.size)])
        assert _rel(g, fd) <= 1e-6


def test_new_modules_default_to_cuda_and_raise_without_a_card(monkeypatch):
    import sympy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, z = sympy.symbols("x z")
    f, y = sympy.symbols("f y")
    makers = [lambda: tk.EQ_ODE1(output_dim=2), lambda: tk.EQ_ODE2(output_dim=2),
              lambda: tk.ODE_UY(2), lambda: tk.ODE_UYC(2), lambda: tk.ODE_st(3), lambda: tk.ODE_t(2),
              lambda: tk.Symbolic(1, k=sympy.exp(-(x - z) ** 2)),
              lambda: __import__("gpy_tpu_torch.likelihoods", fromlist=["x"]).SymbolicLikelihood(
                  -(y - f) ** 2),
              lambda: T.IBPLFM(XF, YF, output_dim=2, rank=2, num_inducing=4)]
    for make in makers:
        with pytest.raises(RuntimeError, match="cuda"):
            make()
