"""gpy_tpu_torch.ops.gram_matvec and ops.gram_matvec_fused (kernels B5 and
B6) against gpy_tpu.

On the CPU the fused functions run their plain twins; the CUDA kernels are
held against those twins on the card by chip_smoke.py. Here the twins are
held against gpy_tpu's Pallas kernels run in interpret mode, as
tests/test_pallas_gram_matvec.py runs them, and the blockwise and
materialized products against gpy_tpu's at float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpy_tpu.kern as gk
import gpy_tpu.ops.gram_matvec as jgm
import gpy_tpu.ops.pallas_gram_matvec as jpgm
import gpy_tpu_torch.kern as tk
import gpy_tpu_torch.ops.gram_matvec as tgm
import gpy_tpu_torch.ops.gram_matvec_fused as tf

FAMILY = {"RBF": 0, "Matern32": 1, "Matern52": 2, "Exponential": 3}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a))


def _kern_pair(name, D, ls, variance=0.9):
    return (getattr(gk, name)(D, variance=variance, lengthscale=ls, ARD=True),
            getattr(tk, name)(D, variance=variance, lengthscale=ls, ARD=True, device="cpu",
                              dtype=torch.float64))


# --- blockwise and materialized products (float64) --------------------------

@pytest.mark.parametrize("name,vector", [("Matern52", False), ("RBF", True)])
def test_gram_matvec_matches_reference(name, vector):
    rng = np.random.default_rng(1)
    X = rng.random((300, 3)) * 5.0
    V = rng.standard_normal(300) if vector else rng.standard_normal((300, 4))
    noise = 0.1 + 0.05 * rng.random(300)
    jk, tkern = _kern_pair(name, 3, [1.1, 0.8, 1.3])
    # block 128 does not divide N: the ragged last block
    ref = jgm.gram_matvec(jk, jnp.asarray(X), jnp.asarray(V), noise=jnp.asarray(noise), block=128)
    got = tgm.gram_matvec(tkern, _t(X), _t(V), noise=_t(noise), block=128)
    assert got.shape == V.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-10, atol=1e-12)


def test_gram_matvec_gradient_holds_one_tile_and_matches_dense():
    """Autograd through the checkpointed blocks equals autograd through the
    dense K at float64."""
    rng = np.random.default_rng(2)
    X = rng.random((200, 3)) * 4.0
    U = _t(rng.standard_normal((200, 3)))
    _, tkern = _kern_pair("Matern32", 3, [1.0, 0.7, 1.2])
    noise = torch.full((200,), 0.2, dtype=torch.float64, requires_grad=True)
    params = [tkern.variance.raw, tkern.lengthscale.raw, noise]
    got = torch.autograd.grad(torch.sum(U * tgm.gram_matvec(tkern, _t(X), U, noise, block=64)),
                              params)
    dense = (tkern.K(_t(X)) + torch.diag(noise)) @ U
    want = torch.autograd.grad(torch.sum(U * dense), params)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10)


@pytest.mark.parametrize("symmetric", [False, True], ids=["row_strip", "symmetric"])
@pytest.mark.parametrize("out_dtype", [None, "bfloat16"])
def test_gram_materialize_matches_reference(symmetric, out_dtype):
    rng = np.random.default_rng(5)
    X = rng.random((700, 3)) * 5  # 700 % 256 != 0: padding rows and columns
    noise = 0.1 + 0.01 * rng.random(700)
    jk, tkern = _kern_pair("RBF", 3, [1.0, 1.2, 0.9], variance=1.0)
    Kj, Pj = jgm.gram_materialize(jk, jnp.asarray(X), noise=jnp.asarray(noise), block=256,
                                  symmetric=symmetric, out_dtype=out_dtype)
    with torch.no_grad():
        Kt, Pt = tgm.gram_materialize(tkern, _t(X), noise=_t(noise), block=256,
                                      symmetric=symmetric, out_dtype=out_dtype)
        Kr, _ = tgm.gram_materialize(tkern, _t(X), noise=_t(noise), block=256,
                                     out_dtype=out_dtype)
    assert Pt == Pj == 768
    assert str(Kt.dtype).replace("torch.", "") == str(Kj.dtype)
    Kj32 = np.asarray(Kj.astype(jnp.float32) if out_dtype else Kj)
    Kt32 = Kt.to(torch.float32 if out_dtype else torch.float64).numpy()
    if out_dtype:  # a bfloat16 rounding may land one ulp apart
        np.testing.assert_allclose(Kt32, Kj32, rtol=2 ** -7, atol=0)
    else:
        np.testing.assert_allclose(Kt32, Kj32, rtol=1e-12, atol=1e-14)
    assert np.all(Kt32[700:] == 0) and np.all(Kt32[:, 700:] == 0)
    assert torch.equal(Kt, Kr)  # the symmetric build equals the row-strip build


# --- B5: the fused matvec's plain twin against the Pallas kernel ------------

def _fused_inputs(N, D, R, seed, M=None):
    rng = np.random.default_rng(seed)
    X = (rng.random((N, D)) * 3.0).astype(np.float32)
    X2 = None if M is None else (rng.random((M, D)) * 3.0).astype(np.float32)
    V = rng.standard_normal((N if M is None else M, R)).astype(np.float32)
    ls = (0.6 + rng.random(D)).astype(np.float32) * np.sqrt(D / 3.0)
    return X, X2, V, ls


# float32 agreement of the twin with the Pallas kernel for each accum mode:
# "exact" is a float32 product on both sides; the reference's "f32x3" and
# "fast" are its documented error classes (tests/test_pallas_gram_matvec.py)
ACCUM_TOL = {"exact": 2e-5, "f32x3": 3e-4, "fast": 3e-2}


def _rel(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("accum", ["exact", "f32x3", "fast"])
@pytest.mark.parametrize("name", list(FAMILY))
def test_fused_twin_matches_pallas_kernel(name, accum):
    X, _, V, ls = _fused_inputs(600, 3, 5, seed=FAMILY[name])
    noise = np.full(600, 0.2, np.float32)
    ref = np.asarray(jpgm.stationary_gram_matvec_fused(
        jnp.asarray(X), jnp.asarray(V), 1.3, jnp.asarray(ls), family=FAMILY[name],
        noise=jnp.asarray(noise), interpret=True, accum=accum))
    got = tf.stationary_gram_matvec_fused(_t(X), _t(V), 1.3, _t(ls), family=FAMILY[name],
                                          noise=_t(noise), accum=accum)
    assert got.dtype == torch.float32 and got.shape == (600, 5)
    assert _rel(got.numpy(), ref) < ACCUM_TOL[accum]


@pytest.mark.parametrize("name", list(FAMILY))
def test_fused_twin_matches_pallas_kernel_wide_inputs(name):
    """D = 12: the reference forms r2 by the expansion above D = 8, the
    port's twin by direct differences on centred inputs; they agree to
    float32 rounding of |x|^2."""
    X, _, V, ls = _fused_inputs(520, 12, 9, seed=30 + FAMILY[name])
    kw = dict(family=FAMILY[name], accum="exact")
    ref = np.asarray(jpgm.stationary_gram_matvec_fused(
        jnp.asarray(X), jnp.asarray(V), 0.7, jnp.asarray(ls), interpret=True, **kw))
    got = tf.stationary_gram_matvec_fused(_t(X), _t(V), 0.7, _t(ls), **kw)
    assert _rel(got.numpy(), ref) < ACCUM_TOL["exact"]


def test_fused_twin_rectangular_slab():
    X, X2, V, ls = _fused_inputs(520, 3, 5, seed=6, M=1030)
    jk = gk.RBF(3, variance=1.2, lengthscale=ls, ARD=True)
    tkern = tk.RBF(3, variance=1.2, lengthscale=ls, ARD=True, device="cpu", dtype=torch.float32)
    ref = np.asarray(jpgm.kern_gram_matvec_fused(jk, jnp.asarray(X), jnp.asarray(V),
                                                 X2=jnp.asarray(X2), interpret=True))
    got = tf.kern_gram_matvec_fused(tkern, _t(X), _t(V), X2=_t(X2))
    assert got.shape == (520, 5)
    assert _rel(got.numpy(), ref) < ACCUM_TOL["exact"]
    with pytest.raises(ValueError, match="rectangular"):
        tf.kern_gram_matvec_fused(tkern, _t(X), _t(V), X2=_t(X2), noise=torch.ones(520))


def test_fused_twin_ragged_vector():
    X, _, V, ls = _fused_inputs(700, 2, 1, seed=1)
    v = V[:, 0]
    ref = np.asarray(jpgm.rbf_gram_matvec_fused(jnp.asarray(X), jnp.asarray(v), 1.0, 0.7,
                                                interpret=True))
    got = tf.rbf_gram_matvec_fused(_t(X), _t(v), 1.0, 0.7)
    assert got.shape == (700,)
    assert _rel(got.numpy(), ref) < ACCUM_TOL["exact"]


def test_centring_leaves_the_plain_product():
    """Above D = 8 the wrapper subtracts the columns' mean from both sides
    (where the kernel forms r2 by the expansion): in float64 the plain
    product on centred inputs is the uncentred one to 1e-12, far from the
    origin too; a square Gram's two sides stay one tensor; below D = 9 the
    inputs pass unchanged."""
    g = np.random.default_rng(21)
    Xs = torch.tensor(g.random((300, 12)) * 4.0 + 50.0)
    X2s = torch.tensor(g.random((250, 12)) * 4.0 + 50.0)
    V = torch.tensor(g.standard_normal((250, 9)))
    v = torch.tensor([1.3], dtype=torch.float64)
    Xc, X2c = tf._centred(Xs, X2s)
    assert float(X2c.mean(0).abs().max()) < 1e-12 and float(X2c.abs().max()) < 4.0
    for fam in FAMILY.values():
        ref = tf.stationary_gram_matvec_plain(Xs, X2s, V, v, fam)
        got = tf.stationary_gram_matvec_plain(Xc, X2c, V, v, fam)
        assert float((got - ref).abs().max() / ref.abs().max()) < 1e-12
    Xq, Xr = tf._centred(Xs, Xs)
    assert Xq is Xr
    X8 = Xs[:, :8]
    assert all(a is X8 for a in tf._centred(X8, X8))


def test_wrapper_centres_wide_inputs_on_the_cpu():
    """The wrapper's CPU path at D = 12 computes the plain twin on the
    centred float32 inputs, square and rectangular, and agrees with the
    uncentred product to float32 rounding."""
    X, _, V, ls = _fused_inputs(300, 12, 9, seed=22)
    _, X2, V2, _ = _fused_inputs(300, 12, 9, seed=25, M=280)
    X, X2 = X.astype(np.float64) + 20.0, X2.astype(np.float64) + 20.0
    got = tf.stationary_gram_matvec_fused(_t(X), _t(V), 0.8, _t(ls))
    Xs = _t(X) / _t(ls)
    Xc = (Xs - Xs.mean(0)).to(torch.float32)
    v = torch.tensor([0.8], dtype=torch.float32)
    assert torch.equal(got, tf.stationary_gram_matvec_plain(Xc, Xc, _t(V), v, 0, 0))
    plain = tf.stationary_gram_matvec_plain(Xs, Xs, _t(V).double(), v.double(), 0)
    assert _rel(got.double().numpy(), plain.numpy()) < 1e-5
    got = tf.stationary_gram_matvec_fused(_t(X), _t(V2), 0.8, _t(ls), X2=_t(X2))
    X2s = _t(X2) / _t(ls)
    mu = X2s.mean(0)
    ref = tf.stationary_gram_matvec_plain((Xs - mu).to(torch.float32),
                                          (X2s - mu).to(torch.float32), _t(V2), v, 0)
    assert torch.equal(got, ref)


def test_diag_offset_sets_the_diagonal_exactly():
    """diag_offset = i0 says the rows are X2's rows i0.. (a row slab of the
    square Gram): the plain twin sets r2 = 0 there, as the kernel does, so
    K_ii is exactly v even where the rows differ a little from the columns;
    elsewhere nothing changes. A slab through the wrapper equals
    the square product's rows, and a square Gram's offset can only be 0."""
    g = np.random.default_rng(23)
    X2s = torch.tensor(g.random((200, 12)), dtype=torch.float32)
    Xs = X2s[60:110] * (1 + 1e-3)   # rows 60..109, moved a little
    E = torch.zeros(200, 50)
    E[60 + torch.arange(50), torch.arange(50)] = 1.0   # out[r, c] = K(r, 60 + c)
    v = torch.tensor([1.3])
    for fam in FAMILY.values():
        out = tf.stationary_gram_matvec_plain(Xs, X2s, E, v, fam, diag_offset=60)
        assert torch.equal(torch.diagonal(out), v.expand(50))
        bare = tf.stationary_gram_matvec_plain(Xs, X2s, E, v, fam)
        assert not torch.equal(torch.diagonal(bare), v.expand(50))
        off = ~torch.eye(50, dtype=torch.bool)
        assert torch.equal(out[off], bare[off])
    X, _, V, ls = _fused_inputs(240, 12, 9, seed=24)
    kern = tk.RBF(12, variance=1.1, lengthscale=ls, ARD=True, device="cpu",
                  dtype=torch.float32)
    full = tf.kern_gram_matvec_fused(kern, _t(X), _t(V))
    for i0 in (0, 60, 180):
        slab = tf.kern_gram_matvec_fused(kern, _t(X[i0:i0 + 60]), _t(V), X2=_t(X),
                                         diag_offset=i0)
        assert torch.equal(slab, full[i0:i0 + 60])
    with pytest.raises(ValueError, match="diag_offset"):
        tf.stationary_gram_matvec_fused(_t(X), _t(V), 1.0, 1.0, diag_offset=3)


# --- B6: the differentiable form's backward against the reference VJP -------

@pytest.mark.parametrize("case", [(600, 3, 4, True), (600, 3, 4, False), (256, 12, 9, True),
                                  (256, 4, 17, True)],
                         ids=["ARD", "scalar_ls", "chunk_d12_r9", "chunk_d4_r17"])
@pytest.mark.parametrize("name", list(FAMILY))
def test_fused_diff_vjp_matches_reference(name, case):
    """jax.vjp of stationary_gram_matvec_fused_diff (B6 in interpret mode)
    against torch autograd of the port's (B6's plain twin): dV, dvariance,
    dlengthscale, dnoise, and dX = 0. float32 kernels on both sides: the
    tolerances are float32 sums of ~N^2 terms. (N, D, R, ARD): D = 3, R = 4
    with ARD and scalar lengthscales, and the domain of the card's mma
    kernel (D > 8 or R > 16) at D = 12, R = 9 (the reference's forward
    forms r2 by the expansion there) and D = 4, R = 17."""
    N, D, R, ARD = case
    rng = np.random.default_rng(40 + FAMILY[name] + (0 if D == 3 else D + R))
    X = rng.random((N, D)) * 3.0
    V = rng.standard_normal((N, R))
    G = rng.standard_normal((N, R))
    noise = 0.1 + 0.05 * rng.random(N)
    ls = ((np.array([0.9, 1.2, 0.7]) if D == 3 else np.sqrt(D / 3.0) * (0.7 + 0.6 * rng.random(D)))
          if ARD else np.asarray(1.1))
    fam = FAMILY[name]

    def f(X_, V_, v_, l_, n_):
        return jpgm.stationary_gram_matvec_fused_diff(X_, V_, v_, l_, n_, fam, "exact")

    y_ref, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (X, V, 0.8, ls, noise)))
    dX_r, dV_r, dv_r, dl_r, dn_r = vjp(jnp.asarray(G))

    leaves = [_t(a).requires_grad_(True) for a in (X, V, 0.8, ls, noise)]
    y = tf.stationary_gram_matvec_fused_diff(*leaves, family=fam, accum="exact")
    dX, dV, dv, dl, dn = torch.autograd.grad(y, leaves, grad_outputs=_t(G))
    assert _rel(y.detach().numpy(), np.asarray(y_ref)) < 2e-5
    assert torch.equal(dX, torch.zeros_like(dX))
    assert np.all(np.asarray(dX_r) == 0)
    assert _rel(dV.numpy(), np.asarray(dV_r)) < 2e-5
    assert dv.shape == () and dl.shape == ls.shape
    np.testing.assert_allclose(dv.numpy(), np.asarray(dv_r), rtol=1e-4)
    np.testing.assert_allclose(dl.numpy(), np.asarray(dl_r), rtol=1e-4)
    np.testing.assert_allclose(dn.numpy(), np.asarray(dn_r), rtol=1e-12)


def test_fused_diff_skips_dV_for_a_detached_V(monkeypatch):
    """The surrogate's V is detached: the backward then runs the moments
    only, not a second matvec."""
    calls = []
    real = tf._matvec
    monkeypatch.setattr(tf, "_matvec", lambda *a: calls.append(1) or real(*a))
    X = torch.rand(50, 2, dtype=torch.float64)
    v = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    ls = torch.tensor([0.5, 0.7], dtype=torch.float64, requires_grad=True)
    y = tf.stationary_gram_matvec_fused_diff(X, torch.rand(50, 3, dtype=torch.float64), v, ls,
                                             torch.full((50,), 0.1, dtype=torch.float64))
    torch.autograd.grad(y.sum(), [v, ls])
    assert len(calls) == 1


def test_cuda_wrapper_copies_unaligned_views():
    """B5 copies X2 and V tiles 16 bytes at a time: a view whose data is
    not 16-byte aligned reaches it as an aligned copy, an aligned tensor as
    itself."""
    base = torch.arange(10 * 9, dtype=torch.float32).reshape(10, 9)
    view = base[1:]  # 36 bytes past an aligned allocation
    assert view.data_ptr() % 16 != 0
    got = tf._aligned16(view)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous() and torch.equal(got, view)
    assert tf._aligned16(base) is base
