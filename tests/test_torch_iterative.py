"""Iterative exact-GP inference (CG + SLQ): gpy_tpu_torch against gpy_tpu.

The solvers are compared on the same arrays at float64. Twin GPRegression
models are built from the same numpy arrays, with gpy_tpu's jax.random
probes handed to the port (torch and JAX draw different numbers from one
seed), and compared in NLML, flat gradient index by index and predictions
for the materialized (fast_grad), blockwise, preconditioned, fused and
bfloat16-Gram paths. The data (N=300, D=3 over [0, 10)^3, lengthscale 1,
noise 0.1) lets 64 CG steps converge, so a difference in the last bits of
K is not amplified by an unconverged solve.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpy_tpu.inference.iterative as jit_mod
import gpy_tpu.kern as gk
from gpy_tpu.models import GPRegression as JGPRegression
from gpy_tpu.ops.pivoted_chol import woodbury_inverse_apply as j_woodbury
import gpy_tpu_torch.inference.iterative as tit
import gpy_tpu_torch.kern as tk
from gpy_tpu_torch.models import GPRegression
from gpy_tpu_torch.ops import gram_matvec_fused as tf
from gpy_tpu_torch.ops.pivoted_chol import woodbury_inverse_apply as t_woodbury

N, D, P, MAX_CG = 300, 3, 6, 64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a))


# --- solvers on the same arrays ---------------------------------------------

def _spd(n=200, seed=0, lengthscale=0.4, noise=1.0):
    """An RBF Gram plus noise. At the default short lengthscale K is well
    conditioned (kappa ~ 3), so CG's steps are not sensitive to the two
    frameworks' product rounding."""
    rng = np.random.default_rng(seed)
    X = rng.random((n, 2)) * 6.0
    k = gk.RBF(2, variance=1.1, lengthscale=lengthscale)
    K = np.asarray(k.K(jnp.asarray(X))) + noise * np.eye(n)
    return K, rng.standard_normal((n, 3)), X


def test_cg_batched_matches_reference():
    K, B, _ = _spd()
    ref = jit_mod.cg_batched(lambda V: jnp.asarray(K) @ V, jnp.asarray(B), maxiter=12)
    got = tit.cg_batched(lambda V: _t(K) @ V, _t(B), maxiter=12)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-9, atol=1e-12)


def test_pcg_batched_matches_reference():
    K, B, _ = _spd(seed=1)
    rng = np.random.default_rng(2)
    L = np.linalg.cholesky(K - 0.9 * np.eye(200))[:, :20]  # a rank-20 part
    noise = 0.1 + 0.01 * rng.random(200)
    ref = jit_mod.pcg_batched(lambda V: jnp.asarray(K) @ V,
                              j_woodbury(jnp.asarray(L), jnp.asarray(noise)),
                              jnp.asarray(B), maxiter=12)
    got = tit.pcg_batched(lambda V: _t(K) @ V, t_woodbury(_t(L), _t(noise)), _t(B), maxiter=12)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-9, atol=1e-12)


def test_slq_logdet_matches_reference_and_truth():
    K, _, _ = _spd(seed=3, lengthscale=1.3, noise=0.1)
    Z = np.asarray(jax.random.rademacher(jax.random.PRNGKey(0), (200, 64), dtype=jnp.float64))
    _, a, b, _ = jit_mod.cg_batched(lambda V: jnp.asarray(K) @ V, jnp.asarray(Z), maxiter=80)
    zn = np.sum(Z * Z, 0)
    ref = float(jit_mod._slq_logdet(a, b, jnp.asarray(zn), 200, 64))
    got = float(tit._slq_logdet(_t(a), _t(b), _t(zn), 200, 64))
    np.testing.assert_allclose(got, ref, rtol=1e-11)
    assert got == pytest.approx(np.linalg.slogdet(K)[1], rel=0.05)  # probe noise


# --- twin models ------------------------------------------------------------

# name -> (kernel, IterativeGaussianInference options, tolerance[, predict
# points[, input dimensions, lengthscale]]). float64 paths agree to 1e-7;
# "fused" runs float32 kernels on both sides (Pallas in interpret mode, the
# port's plain twin) inside float64 models, whose CG differs in float32
# rounding of each product (readings: NLML 6e-10, gradient 4.5e-7,
# predictions 3e-7); "fused_predict40" predicts at 40 points, so the
# predict's CG has R = 40 right-hand sides (B5's wide kernel on the card);
# "fused_d12" is the fused model on 12 input dimensions (an ARD RBF from
# lengthscale 3.0, the card's D=12 path at N=300), where the reference forms
# r2 by the expansion |x|^2 + |x'|^2 - 2 x.x' in float32 and the port's twin
# by direct differences on centred inputs: the two round r2 differently by
# ~1e-7 of |x|^2, which moves each product's float32 K by as much as the
# products' own rounding (readings: NLML 9.1e-9, gradient 1.0e-7, mean
# 1.3e-6 of its largest entry, variance 1.2e-8; 1e-5 is ~8x the largest,
# the "fused" case's limit); "bf16" stores a bfloat16
# Gram on both sides, where one entry rounding the other way would move the
# NLML ~1e-7.
CASES = {
    "materialized_fast_grad": ("RBF", dict(materialize=True), 1e-7),
    "blockwise_matern32": ("Matern32", dict(materialize=False), 1e-7),
    "precond_rank16": ("RBF", dict(materialize=True, precond_rank=16), 1e-7),
    "fused": ("RBF", dict(materialize=False, fused=True, fused_accum="exact"), 1e-5),
    "fused_predict40": ("RBF", dict(materialize=False, fused=True, fused_accum="f32x3"), 1e-5,
                        40),
    "fused_d12": ("RBF", dict(materialize=False, fused=True, fused_accum="exact"), 1e-5, 7,
                  12, 3.0),
    "bf16_gram": ("RBF", dict(materialize=True, gram_dtype="bfloat16"), 1e-6),
}


def _data(seed=0, n_pred=7, d=D):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 10, (N, d))
    Y = np.sin(X[:, :1]) + 0.1 * rng.standard_normal((N, 1))
    Xs = rng.uniform(0, 10, (7, d))
    return X, Y, Xs if n_pred == 7 else np.vstack([Xs, rng.uniform(0, 10, (n_pred - 7, d))])


def _hand_jax_probes(inf, rank):
    """gpy_tpu's draws (iterative.py:379-380, 443-445) into the port."""
    key = jax.random.PRNGKey(inf.seed)
    Z = np.asarray(jax.random.rademacher(key, (N, P), dtype=jnp.float64))
    ku, kw = jax.random.split(key)
    U = np.asarray(jax.random.normal(ku, (rank, P), dtype=jnp.float64))
    Wn = np.asarray(jax.random.normal(kw, (N, P), dtype=jnp.float64))
    inf._rademacher = lambda n, dtype, device: torch.tensor(Z, dtype=dtype, device=device)
    inf._normals = lambda n, dtype, device: (torch.tensor(U, dtype=dtype, device=device),
                                             torch.tensor(Wn, dtype=dtype, device=device))


@pytest.fixture(scope="module", params=list(CASES))
def twin_run(request):
    torch.set_num_threads(1)
    kname, opts, tol, n_pred, d, ls = (CASES[request.param] + (7, D, None))[:6]
    opts = dict(max_cg=MAX_CG, n_probes=P, block=128, seed=0, **opts)
    X, Y, Xs = _data(n_pred=n_pred, d=d)
    jm = JGPRegression(X, Y, getattr(gk, kname)(d, ARD=True, lengthscale=ls), noise_var=0.1,
                       inference_method=jit_mod.IterativeGaussianInference(**opts))
    tinf = tit.IterativeGaussianInference(**opts)
    _hand_jax_probes(tinf, opts.get("precond_rank", 0))
    tm = GPRegression(X, Y, getattr(tk, kname)(d, ARD=True, lengthscale=ls, device="cpu"),
                      noise_var=0.1, inference_method=tinf, device="cpu")
    orig = jit_mod.IterativeGaussianInference._effective_fused
    if opts.get("fused"):  # gpy_tpu engages fused on a TPU only: force it
        # (tests/test_iterative.py:211-221); the port runs the plain twins
        jit_mod.IterativeGaussianInference._effective_fused = (
            lambda self, kern, n, dtype=None: self.fused)
    try:
        fj, gj = jm._get_objgrad()(jm.get_flat_raw())
        pj = jm.predict(Xs)
    finally:
        jit_mod.IterativeGaussianInference._effective_fused = orig
    before = tf.matvec_launches, tf.moments_launches
    ft, gt = tm._objective_and_grad(tm.get_flat_raw())
    pt = tm.predict(Xs)
    assert (tf.matvec_launches, tf.moments_launches) == before  # CPU: plain twins only
    return {"tol": tol, "j": (float(fj), np.asarray(gj), pj), "t": (ft, gt, pt), "tm": tm,
            "D": d, "Xs": Xs[:7]}


def test_twin_nlml(twin_run):
    ft, fj = twin_run["t"][0], twin_run["j"][0]
    np.testing.assert_allclose(ft, fj, rtol=twin_run["tol"])


def test_twin_gradient_index_by_index(twin_run):
    gt, gj = twin_run["t"][1], twin_run["j"][1]
    assert gt.shape == gj.shape == (twin_run["D"] + 2,)
    assert np.max(np.abs(gt - gj)) <= twin_run["tol"] * np.max(np.abs(gj))


def test_twin_predictions(twin_run):
    (mu_t, var_t), (mu_j, var_j) = twin_run["t"][2], twin_run["j"][2]
    tol = twin_run["tol"]
    np.testing.assert_allclose(mu_t, np.asarray(mu_j), rtol=0, atol=tol * np.max(np.abs(mu_j)))
    np.testing.assert_allclose(var_t, np.asarray(var_j), rtol=tol)


def test_posterior_holds_no_graph_and_full_cov_matches_its_diagonal(twin_run):
    """GP._raw_predict drives IterativePosterior._raw_predict unchanged: the
    posterior is built under no_grad, and the full covariance's diagonal is
    the marginal variance (the same CG solve)."""
    tm = twin_run["tm"]
    assert not tm.posterior.woodbury_vector.requires_grad
    Xs = twin_run["Xs"]
    _, var = tm.predict_noiseless(Xs)
    _, cov = tm.predict_noiseless(Xs, full_cov=True)
    assert cov.shape == (7, 7)
    np.testing.assert_allclose(np.diagonal(cov), var[:, 0], rtol=1e-10)
    # symmetric up to the CG solve's residual (the reference does not
    # symmetrize either)
    np.testing.assert_allclose(cov, cov.T, rtol=0, atol=1e-6 * np.max(np.abs(cov)))


def test_fused_model_uses_the_fused_posterior():
    inf = tit.IterativeGaussianInference(max_cg=8, n_probes=2, fused=True)
    X, Y, _ = _data()
    m = GPRegression(X[:50], Y[:50], tk.Matern52(D, device="cpu"), noise_var=0.1,
                     inference_method=inf, device="cpu")
    assert m.posterior.fused
    assert not tit.IterativeGaussianInference()._effective_fused(m.kern, 50, torch.float32)
    # past the materialization cap "auto" goes fused, for float32 only
    auto = tit.IterativeGaussianInference(materialize_max_n=10)
    assert auto._effective_fused(m.kern, 50, torch.float32)
    assert not auto._effective_fused(m.kern, 50, torch.float64)


def test_optimize_lowers_the_nlml():
    X, Y, _ = _data(seed=4)
    m = GPRegression(X[:200], Y[:200], tk.RBF(D, ARD=True, device="cpu"), noise_var=0.5,
                     inference_method=tit.IterativeGaussianInference(max_cg=48, n_probes=8,
                                                                     block=128),
                     device="cpu")
    f0 = m.objective_function().item()
    res = m.optimize(max_iters=10)
    assert res.f_opt < f0
    mu, _ = m.predict(X[:40])
    assert np.corrcoef(mu.ravel(), Y[:40, 0])[0, 1] > 0.8
