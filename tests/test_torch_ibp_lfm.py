"""IBPLFM (models/ibp_lfm.py) against gpy_tpu, float64 on the CPU, at the
shape of tests/test_ode_kernels.py:185-208 (2 outputs x 15 times, rank 2,
6 inducing times).

NLML and the gradient of every free parameter (the EQ_ODE2 parameters,
the noise, Z, gamma, tau) against the reference's jitted objective at two
points (rel 1e-10 / 1e-9). The posterior is the gated bound's (ROADMAP
C(ae): the reference's is ungated VarDTC's and its predict raises), held
to the gated Woodbury terms built in numpy from the reference's Kuu and
Kfu. Two rows through the batched objective equal unbatched evaluation:
the gated bound with the IBP term, not VarDTC's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpy_tpu.models.ibp_lfm import IBPLFM as J_IBPLFM
from gpy_tpu_torch.core.model import value_and_grad
from gpy_tpu_torch.inference.var_dtc import VarDTC
from gpy_tpu_torch.models import IBPLFM, SparseGPRegression
from gpy_tpu_torch.models.ibp_lfm import _GatedVarDTC

jax.config.update("jax_enable_x64", True)

C = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _data():
    rng = np.random.default_rng(3)
    ts = np.linspace(0.2, 3.0, 15)
    X = np.vstack([np.stack([ts, np.full_like(ts, d)], 1) for d in range(2)])
    return X, rng.standard_normal((30, 1))


@pytest.fixture(scope="module")
def pair():
    X, Y = _data()
    m_ref = J_IBPLFM(X, Y, input_dim=2, output_dim=2, rank=2, num_inducing=6)
    m = IBPLFM(X, Y, input_dim=2, output_dim=2, rank=2, num_inducing=6, **C)
    return m, m_ref


def test_parameters_match_the_reference(pair):
    m, m_ref = pair
    assert [p for p, *_ in m.named_params()] == [p for p, *_ in m_ref.named_params()]
    np.testing.assert_allclose(m.optimizer_array, np.asarray(m_ref.get_flat_raw()), rtol=1e-12)
    np.testing.assert_allclose(m.Z.numpy(), np.asarray(m_ref.Z))
    np.testing.assert_allclose(m.gates, np.asarray(m_ref.gamma), rtol=1e-12)


def test_nlml_and_gradient_against_the_reference(pair):
    m, m_ref = pair
    x0 = m.optimizer_array
    x1 = x0 + 0.1 * np.random.default_rng(0).standard_normal(x0.size)
    for x in (x0, x1):
        f_ref, g_ref = m_ref._objective_and_grad(jnp.asarray(x))
        f, g = m._objective_and_grad(x)
        g_ref = np.asarray(g_ref)
        assert f == pytest.approx(float(f_ref), rel=1e-10)
        assert np.max(np.abs(g - g_ref)) <= 1e-9 * np.max(np.abs(g_ref))
        # every block of the vector moves the bound
        for path, sl in _slices(m).items():
            if path != "Z":
                assert np.abs(g[sl]).max() > 0, path
    m.set_flat_raw(x0)


def _slices(m):
    out, i = {}, 0
    for path, mod, n in m._free_entries():
        k = mod._parameters[n].numel()
        out[path] = slice(i, i + k)
        i += k
    return out


def test_posterior_and_predict_are_the_gated_bounds(pair):
    """wv = L^-T LB^-T c and wi = L^-T (I - B^-1) L^-1 of the gated psi
    statistics, from the reference's Kuu and Kfu in numpy; predict's mean
    K(Z, X*)' wv and latent variance Kdiag(X*) - diag(K' wi K)."""
    m, m_ref = pair
    X, Y = _data()
    k = m_ref.kern
    t, tz = jnp.asarray(X[:, 0]), jnp.asarray(np.asarray(m_ref.Z)[:, 0])
    d, q = m_ref._X_didx, m_ref._Z_qidx
    Kuu = np.asarray(k._Kuu(tz, jnp.asarray(q))) + 1e-6 * np.eye(6)
    Kfu = np.asarray(k._Kfu(t, jnp.asarray(d), tz, jnp.asarray(q)))
    g = np.asarray(m_ref.gamma)
    w = 1.0 / float(m_ref.likelihood.variance)
    psi1 = g[d][:, q] * Kfu
    psi2 = sum((Kfu[d == o].T @ Kfu[d == o]) * w
               * (np.outer(g[o], g[o]) - np.diag(g[o] ** 2) + np.diag(g[o]))[q][:, q]
               for o in range(2))
    L = np.linalg.cholesky(Kuu)
    Li = np.linalg.inv(L)
    B = np.eye(6) + Li @ psi2 @ Li.T
    LB = np.linalg.cholesky(0.5 * (B + B.T))
    c = np.linalg.solve(LB, Li @ (psi1.T @ (w * Y)))
    wv = Li.T @ np.linalg.solve(LB.T, c)
    wi = Li.T @ (np.eye(6) - np.linalg.inv(B)) @ Li
    post = m.posterior
    np.testing.assert_allclose(post.woodbury_vector.numpy(), wv, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(post.woodbury_inv.numpy(), wi, rtol=1e-9, atol=1e-12)
    rows = [0, 4, 15, 29]
    mu, var = m.predict(X[rows], include_likelihood=False)
    Kx = Kfu[rows].T
    np.testing.assert_allclose(mu[:, 0], Kx.T @ wv[:, 0], rtol=1e-9)
    kdiag = m.kern.Kdiag(torch.tensor(X[rows])).detach().numpy()
    np.testing.assert_allclose(var[:, 0], kdiag - np.sum(Kx * (wi @ Kx), 0), rtol=1e-9)


def test_gated_operands_at_unit_gates_are_vardtcs():
    """At gamma = 1 every gate is open: psi0 sums diag(Kff) (the per-force
    diagonal summed), psi1 is Kfu and psi2 Kfu' W Kfu; the gated bound is
    VarDTC's over EQ_ODE2."""
    X, Y = _data()
    m = IBPLFM(X, Y, input_dim=2, output_dim=2, rank=2, num_inducing=6, **C)
    args = list(m._bound_args())
    args[-1].gates = torch.ones(2, 2, **C)
    gated = _GatedVarDTC().operands(*args)
    plain = VarDTC().operands(*args[:-1])
    with torch.no_grad():
        Kmn, Wv = plain["Kmn"], plain["W"]
        np.testing.assert_allclose(gated["psi0_sum"], plain["psi0_sum"], rtol=1e-12)
        np.testing.assert_allclose(gated["psi1WY"], Kmn @ (Wv[:, None] * m.Y), rtol=1e-12)
        np.testing.assert_allclose(gated["Psi2W"], (Kmn * Wv) @ Kmn.T, rtol=1e-12)
        sp = SparseGPRegression(X, Y, Z=m.Z.numpy(), kernel=m.kern,
                                noise_var=float(m.likelihood.variance), **C)
        bound = VarDTC().batched_log_marginal(gated, m.Y)
        assert float(bound) == pytest.approx(float(sp.log_likelihood()), rel=1e-12)


def test_batched_rows_are_the_gated_bound(pair):
    m, _ = pair
    x0 = m.get_flat_raw()
    rows = x0[None] + 0.05 * torch.as_tensor(
        np.random.default_rng(1).standard_normal((2, x0.numel())), **C)
    v, g = m._batched_objective_and_grad(rows)
    for c in range(2):
        vc, gc = value_and_grad(m._flat_objective, rows[c])
        assert float(v[c]) == pytest.approx(float(vc), rel=1e-10)
        assert float((g[c] - gc).abs().max()) <= 1e-10 * float(gc.abs().max())
    with m.bind_flat_raw(rows[0]):  # not VarDTC's ungated bound, nor without the IBP term
        ungated = -VarDTC().marginal_likelihood(*m._bound_args()[:-1])
    assert abs(float(v[0]) - float(ungated)) > 1e-3 * abs(float(ungated))


def test_checkgrad_optimize_and_gates():
    """tests/test_ode_kernels.py:160-182 at a shorter fit: the bound rises
    and the driven output keeps the larger gate."""
    rng = np.random.default_rng(5)
    t = np.linspace(0.1, 4, 25)
    X = np.vstack([np.stack([t, np.zeros_like(t)], 1), np.stack([t, np.ones_like(t)], 1)])
    Y = np.concatenate([np.sin(1.5 * t) * 0.8, 0.05 * rng.standard_normal(25)]).reshape(-1, 1)
    m = IBPLFM(X, Y, input_dim=2, output_dim=2, rank=2, num_inducing=12, **C)
    ll0 = float(m.log_likelihood())
    assert m.checkgrad(step=1e-5)
    m.optimize(max_iters=40)
    assert float(m.log_likelihood()) > ll0
    g = m.gates
    assert g.shape == (2, 2) and g[0].max() > g[1].min()
