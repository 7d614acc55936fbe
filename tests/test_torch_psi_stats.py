"""The psi statistics of gpy_tpu_torch (kern/psi_comp.py, ops/psi2.py and
the kernels' psi hooks) against gpy_tpu's, and the streamed psi2 against
the summed psi2n.

Both packages build the same kernels and the same q(X) from numpy arrays at
float64 on the CPU; psi0, psi1 and psi2n are compared entry by entry
(rel 1e-10 for the closed forms: the same arithmetic in another order), and
the gradient of a fixed random functional of them with respect to Z and
q(X) against jax.grad (rel 1e-9).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpy_tpu.kern as gk
from gpy_tpu.core.variational import NormalPosterior as JNormalPosterior
from gpy_tpu.core.variational import SpikeAndSlabPosterior as JSpikeAndSlabPosterior
import gpy_tpu_torch.kern as tk
from gpy_tpu_torch.core.variational import NormalPosterior, SpikeAndSlabPosterior
from gpy_tpu_torch.kern.psi_comp import STREAM_MIN_N, psi2_weighted
from gpy_tpu_torch.ops import psi2 as tpsi2

jax.config.update("jax_enable_x64", True)

N, M, Q = 9, 4, 3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _q(n=N, q=Q, seed=0, ss=False):
    g = np.random.default_rng(seed)
    mu = g.standard_normal((n, q))
    S = 0.1 + 0.5 * g.random((n, q))
    Z = 1.3 * g.standard_normal((M, q))
    gam = 0.05 + 0.9 * g.random((n, q)) if ss else None
    return mu, S, Z, gam


def _posteriors(mu, S, gam):
    if gam is None:
        return JNormalPosterior(mu, S), NormalPosterior(mu, S, device="cpu")
    return JSpikeAndSlabPosterior(mu, S, gam), SpikeAndSlabPosterior(mu, S, gam, device="cpu")


def _kernels(name):
    """(reference kernel, port kernel) with equal constrained values."""
    c = dict(device="cpu")
    if name == "rbf_iso":
        return (gk.RBF(Q, variance=1.3, lengthscale=0.9),
                tk.RBF(Q, variance=1.3, lengthscale=0.9, **c))
    if name == "rbf_ard_dims":
        ls = [0.7, 1.6]
        return (gk.RBF(2, variance=0.8, lengthscale=ls, ARD=True, active_dims=[0, 2]),
                tk.RBF(2, variance=0.8, lengthscale=ls, ARD=True, active_dims=[0, 2], **c))
    if name == "linear_ard_dims":
        v = [0.5, 1.7]
        return (gk.Linear(2, variances=v, ARD=True, active_dims=[1, 2]),
                tk.Linear(2, variances=v, ARD=True, active_dims=[1, 2], **c))
    if name == "linear_iso":
        return gk.Linear(Q, variances=0.6), tk.Linear(Q, variances=0.6, **c)
    if name == "bias":
        return gk.Bias(Q, variance=0.7), tk.Bias(Q, variance=0.7, **c)
    if name == "white":
        return gk.White(Q, variance=0.4), tk.White(Q, variance=0.4, **c)
    if name == "matern32":  # no closed form: the base class's quadrature
        return (gk.Matern32(Q, variance=1.1, lengthscale=1.4),
                tk.Matern32(Q, variance=1.1, lengthscale=1.4, **c))
    ja, ta = zip(*[_kernels(p) for p in name.split("+")])
    return gk.Add(list(ja)), tk.Add(list(ta))


def _compare(jk, tkern, ss=False, rtol=1e-10):
    mu, S, Z, gam = _q(ss=ss)
    jq, tq = _posteriors(mu, S, gam)
    Zt = torch.tensor(Z)
    for stat in ("psi0", "psi1", "psi2n"):
        ref = np.asarray(getattr(jk, stat)(jnp.asarray(Z), jq))
        got = getattr(tkern, stat)(Zt, tq).detach().numpy()
        assert got.shape == ref.shape, stat
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max(),
                                   err_msg=stat)
    return mu, S, Z, gam


CLOSED = ["rbf_iso", "rbf_ard_dims", "linear_ard_dims", "linear_iso", "bias", "white"]


@pytest.mark.parametrize("name", CLOSED)
def test_closed_forms_match_reference(name):
    _compare(*_kernels(name))


@pytest.mark.parametrize("name", ["rbf_ard_dims", "linear_ard_dims", "rbf_iso"])
def test_spike_and_slab_forms_match_reference(name):
    _compare(*_kernels(name), ss=True)


@pytest.mark.parametrize("name", ["rbf_iso+rbf_ard_dims", "rbf_ard_dims+linear_ard_dims",
                                  "linear_iso+linear_ard_dims", "rbf_iso+bias+white",
                                  "linear_ard_dims+rbf_iso"])
def test_add_exact_cross_terms_match_reference(name):
    _compare(*_kernels(name))


def test_add_disjoint_dims_under_spike_and_slab():
    jk = gk.Add([gk.RBF(1, active_dims=[0]), gk.Linear(2, active_dims=[1, 2])])
    tkern = tk.Add([tk.RBF(1, active_dims=[0], device="cpu"),
                    tk.Linear(2, active_dims=[1, 2], device="cpu")])
    _compare(jk, tkern, ss=True)


@pytest.mark.parametrize("name", ["matern32", "rbf_iso+matern32"])
def test_quadrature_fallback_matches_reference(name):
    """The Gauss-Hermite fallback (degree 5 at Q = 3: 125 nodes in one Gram
    call) and Add's quadrature cross term at Q <= 3."""
    _compare(*_kernels(name), rtol=1e-9)


def _functional(stats, seed=5):
    g = np.random.default_rng(seed)
    return [g.standard_normal(s.shape) for s in stats]


@pytest.mark.parametrize("ss", [False, True], ids=["gauss", "spike_slab"])
def test_gradients_match_reference(ss):
    """d/d(Z, mu, S[, gamma]) of sum_k <C_k, psi_k> for RBF-ARD + Linear on
    overlapping dims, against jax.grad through the reference's raw leaves."""
    jk, tkern = _kernels("rbf_ard_dims+linear_ard_dims" if not ss else "rbf_ard_dims")
    mu, S, Z, gam = _q(ss=ss)
    jq, tq = _posteriors(mu, S, gam)
    names = ["mean", "variance"] + (["gamma"] if ss else [])
    ref_stats = [np.asarray(getattr(jk, s)(jnp.asarray(Z), jq)) for s in ("psi0", "psi1", "psi2n")]
    C = _functional(ref_stats)

    def jf(Zj, raws):
        q = jq.with_raw_dict(raws)
        return sum(jnp.sum(jnp.asarray(c) * getattr(jk, s)(Zj, q))
                   for c, s in zip(C, ("psi0", "psi1", "psi2n")))

    raws = {k: jnp.asarray(v) for k, v in jq.get_raw_dict().items()}
    gZ, graw = jax.jit(jax.grad(jf, argnums=(0, 1)))(jnp.asarray(Z), raws)
    Zt = torch.tensor(Z, requires_grad=True)
    val = sum(torch.sum(torch.tensor(c) * getattr(tkern, s)(Zt, tq))
              for c, s in zip(C, ("psi0", "psi1", "psi2n")))
    leaves = [tq._parameters[n] for n in names]
    grads = torch.autograd.grad(val, [Zt] + leaves)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gZ), rtol=1e-9, atol=1e-12)
    for n, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(graw[n]), rtol=1e-9, atol=1e-12,
                                   err_msg=n)


def _stream_case(ss, n=520, m=4, q=2, seed=3):
    g = np.random.default_rng(seed)
    mu = torch.tensor(g.standard_normal((n, q)), requires_grad=True)
    S = torch.tensor(0.1 + g.random((n, q)), requires_grad=True)
    Z = torch.tensor(g.standard_normal((m, q)), requires_grad=True)
    W = torch.tensor(0.5 + g.random(n))
    gam = torch.tensor(0.1 + 0.8 * g.random((n, q)), requires_grad=True) if ss else None
    k = tk.RBF(q, variance=1.2, lengthscale=[0.8, 1.3], ARD=True, device="cpu")
    return k, mu, S, Z, W, gam


@pytest.mark.parametrize("ss", [False, True], ids=["gauss", "spike_slab"])
def test_streamed_psi2_matches_summed_psi2n(ss):
    """N = 520 (two full blocks of 256 and a padded third): the streamed
    sum_n W_n psi2_n against the summed (N, M, M) psi2n of the closed form,
    value and gradient (Z, mu, S, gamma, the kernel), rel 1e-12."""
    k, mu, S, Z, W, gam = _stream_case(ss)
    assert mu.shape[0] >= STREAM_MIN_N
    q = SimpleNamespace(mean=mu, variance=S)
    if ss:
        q.gamma = gam
    leaves = [Z, mu, S] + ([gam] if ss else []) + [k.variance.raw, k.lengthscale.raw]
    got = psi2_weighted(k, Z, q, W)
    ref = torch.einsum("n,nmk->mk", W, k.psi2n(Z, q))
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(), rtol=1e-12)
    C = torch.tensor(np.random.default_rng(1).standard_normal(got.shape))
    g_got = torch.autograd.grad(torch.sum(C * got), leaves)
    g_ref = torch.autograd.grad(torch.sum(C * ref), leaves)
    for a, b in zip(g_got, g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-11, atol=1e-13)


def test_checkpointed_blocks_match_the_unchecked_loop():
    """Gradients through torch.utils.checkpoint equal those of the same
    block loop without it (the reference's jax.checkpoint is a pure
    rematerialization), at N = 520."""
    k, mu, S, Z, W, _ = _stream_case(False)
    v, ls = k.variance.values, k.lengthscale.values
    leaves = [Z, mu, S, k.variance.raw, k.lengthscale.raw]
    got = tpsi2.rbf_psi2_weighted(v, ls, Z, mu, S, W)
    l2 = ls**2
    pad = (-520) % 256
    mup = torch.cat([mu, torch.zeros(pad, 2, dtype=mu.dtype)])
    Sp = torch.cat([S, torch.ones(pad, 2, dtype=S.dtype)])
    Wp = torch.cat([W, torch.zeros(pad, dtype=W.dtype)])
    ref = sum(tpsi2._block_psi2(v, l2, mup[s:s + 256], Sp[s:s + 256], Wp[s:s + 256], Z)
              for s in range(0, 520 + pad, 256))
    assert torch.equal(got, ref)
    g_got = torch.autograd.grad(got.sum(), leaves, retain_graph=True)
    for a, b in zip(g_got, torch.autograd.grad(ref.sum(), leaves)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("ss", [False, True], ids=["gauss", "spike_slab"])
def test_blocked_psi1_matches_the_closed_form(ss, monkeypatch):
    """RBF's psi1 in checkpointed row blocks (taken above PSI1_BLOCK_ELEMS
    (N, M, Q) elements; here forced, 100 rows a block at N = 520, a short
    last block) against the closed form at once: value and gradient, rel
    1e-13."""
    from gpy_tpu_torch.kern import psi_comp

    k, mu, S, Z, _, gam = _stream_case(ss)
    q = SimpleNamespace(mean=mu, variance=S)
    if ss:
        q.gamma = gam
    leaves = [Z, mu, S] + ([gam] if ss else []) + [k.variance.raw, k.lengthscale.raw]
    ref = k.psi1(Z, q)
    monkeypatch.setattr(psi_comp, "PSI1_BLOCK_ELEMS", 100 * 4 * 2)
    got = k.psi1(Z, q)
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(), rtol=1e-13)
    C = torch.tensor(np.random.default_rng(2).standard_normal(got.shape))
    for a, b in zip(torch.autograd.grad(torch.sum(C * got), leaves),
                    torch.autograd.grad(torch.sum(C * ref), leaves)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-14)
