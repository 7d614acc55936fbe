"""The batched block Cholesky (kernels B2/B3 and B4), its blocked routines
and the batched rules of util/linalg against gpy_tpu.

On the CPU the port runs the kernels' plain twins. The reference runs its
Pallas kernels in interpret mode, as tests/test_ops.py does, in float32
(pallas_chol.py casts to it); the batched rules are compared at float64.
The interpret-mode compiles dominate this file's time (one per batch
shape, ~6 s each, ~13 s for the slab-interleaved C = 16 kernel), so the
blocked routines reuse the C = 2 shape and block 256 goes through version 1, whose
kernel is a loop and compiles in a fraction of a second.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpy_tpu.util.linalg as jla
from gpy_tpu.ops.pallas_chol import (pallas_batched_chol_inv, pallas_batched_chol_inv_ll,
                                     pallas_block_chol, pallas_block_chol_inv)
from gpy_tpu_torch.ops import block_chol as bc
from gpy_tpu_torch.ops import blocked_linalg as bl
from gpy_tpu_torch.util import linalg as tla


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _spd(C, n, seed, rank=40, dtype=np.float32):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((C, n, rank))
    return (G @ np.swapaxes(G, 1, 2) + n * np.eye(n)).astype(dtype)


def _f32(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def _f64(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


# float32 factors of these matrices (entries ~10, pivots ~11) differ by
# the order of ~128 rounded rank-1 updates: ~1e-6 absolute. 2e-5 leaves
# room and still catches a wrong column (errors of order 1).
F32_ATOL = 2e-5


@pytest.mark.parametrize("C", [1, 8, 16], ids=["C1", "C8", "C16_slabs"])
def test_block_chol_twin_matches_pallas_kernel(C):
    """C = 16 reaches the reference's slab-interleaved B3 kernel."""
    A = _spd(C, 128, C)
    L = bc.block_chol_plain(_f32(A))
    Lr = np.asarray(pallas_block_chol(jnp.asarray(A), interpret=True))
    np.testing.assert_allclose(L.numpy(), Lr, atol=F32_ATOL, rtol=0)
    assert torch.equal(L, torch.tril(L))
    assert torch.equal(bc.block_chol(_f32(A)), L)  # a CPU tensor takes the twin
    assert bc.launches == 0


def test_block_chol_inv_twin_matches_pallas_kernel():
    A = _spd(2, 128, 5)
    L, Li = bc.block_chol_inv_plain(_f32(A))
    Lr, Lir = pallas_block_chol_inv(jnp.asarray(A), interpret=True)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lr), atol=F32_ATOL, rtol=0)
    # L^-1 entries are ~0.1 here: ~1e-8 rounding
    np.testing.assert_allclose(Li.numpy(), np.asarray(Lir), atol=1e-6, rtol=0)
    eye = np.eye(128)
    assert np.abs(Li.double().numpy() @ L.double().numpy() - eye).max() < 1e-6
    assert bc.inv_launches == 0


# (name, port routine, reference routine)
BLOCKED_ROUTINES = [
    ("ll_128", lambda K: bc.batched_chol_inv_ll(K),
     lambda K: pallas_batched_chol_inv_ll(K, interpret=True)),
    ("v2_128", lambda K: bc.batched_chol_inv(K, version=2),
     lambda K: pallas_batched_chol_inv(K, interpret=True, version=2)),
    ("v1_128", lambda K: bc.batched_chol_inv(K, version=1),
     lambda K: pallas_batched_chol_inv(K, interpret=True, version=1)),
    ("v1_256", lambda K: bc.batched_chol_inv(K, version=1, block=256),
     lambda K: pallas_batched_chol_inv(K, interpret=True, version=1, block=256)),
]


@pytest.mark.parametrize("name,port,ref", BLOCKED_ROUTINES,
                         ids=[r[0] for r in BLOCKED_ROUTINES])
def test_blocked_routines_match_pallas_ones(name, port, ref):
    """(2, 300, 300): n padded to 384 (block 128) or 512 (block 256)."""
    K = _spd(2, 300, 3, rank=24)
    L, Li = port(_f32(K))
    Lr, Lir = ref(jnp.asarray(K))
    assert L.shape == Li.shape == (2, 300, 300)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lr), atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(Li.numpy(), np.asarray(Lir), atol=1e-6, rtol=0)
    L64 = np.linalg.cholesky(K.astype(np.float64))
    np.testing.assert_allclose(L.numpy(), L64, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("routine", ["ll", "v2"])
def test_block_256_nests_the_block_128_routine(routine):
    """block=256 factors each 256 diagonal block with the 128 routine: the
    same function as block 128, held at float64 against torch.linalg."""
    K = _f64(_spd(2, 300, 4, rank=24))
    f = bc.batched_chol_inv_ll if routine == "ll" else bc.batched_chol_inv
    L, Li = f(K, block=256)
    L128, Li128 = f(K)
    Lr = torch.linalg.cholesky(K)
    torch.testing.assert_close(L, Lr, rtol=0, atol=1e-12)
    torch.testing.assert_close(L, L128, rtol=0, atol=1e-12)
    torch.testing.assert_close(Li, Li128, rtol=0, atol=1e-14)


def test_rec_block_chol_inv_and_leading_dims():
    """rec_block_chol_inv on an identity-padded (2, 2, 256, 256) batch, the
    reference's rec_pallas_chol_inv contract, against torch.linalg."""
    K = _f64(_spd(4, 256, 6).reshape(2, 2, 256, 256))
    L, Li = bc.rec_block_chol_inv(K)
    Lr = torch.linalg.cholesky(K)
    torch.testing.assert_close(L, Lr, rtol=0, atol=1e-12)
    eye = torch.eye(256, dtype=torch.float64)
    assert float((Li @ L - eye).abs().max()) < 1e-13
    L2, _ = bc.batched_chol_inv_ll(K)  # leading dims kept
    assert L2.shape == K.shape
    torch.testing.assert_close(L2, Lr, rtol=0, atol=1e-12)


@pytest.mark.parametrize("C", [1, 2, 8, 32, 64])
def test_block_chol_twin_sweep_against_float64(C):
    """The gate's range (C <= 64): every element against torch.linalg."""
    A = _spd(C, 128, 100 + C, dtype=np.float64)
    L = bc.block_chol_plain(_f64(A))
    torch.testing.assert_close(L, torch.linalg.cholesky(_f64(A)), rtol=0, atol=1e-12)


@pytest.mark.parametrize("inverse", [False, True], ids=["block_chol", "block_chol_inv"])
def test_nan_isolation(inverse):
    """One non-SPD element of 8 comes out NaN; the other seven are
    bit-equal to a clean run of the batch, through the blocked
    factorization too."""
    A = _f32(_spd(8, 128, 9))
    bad = A.clone()
    bad[3, 10, 10] = -5.0
    fn = bc.block_chol_inv_plain if inverse else bc.block_chol_plain
    clean, dirty = fn(A), fn(bad)
    for got, ref in (zip(clean, dirty) if inverse else ((clean, dirty),)):
        assert torch.isnan(ref[3]).any() and torch.isfinite(ref[3, :10, :10]).all()
        for c in (0, 1, 2, 4, 5, 6, 7):
            assert torch.equal(got[c], ref[c])
    K = _f32(_spd(8, 300, 10, rank=24))
    Kb = K.clone()
    Kb[5, 200, 200] = -1.0
    (L, Li), (Lb, Lib) = bc.batched_chol_inv_ll(K), bc.batched_chol_inv_ll(Kb)
    assert torch.isnan(Lb[5]).any() and torch.isnan(Lib[5]).any()
    for c in (0, 1, 2, 3, 4, 6, 7):
        assert torch.equal(L[c], Lb[c]) and torch.equal(Li[c], Lib[c])


def _rank_deficient(n=128, rank=100, seed=78):
    """M M' with M = [L1; R] (n x rank), L1 the factor of a well-conditioned
    SPD matrix: the Schur complement after `rank` columns is 0 up to
    rounding, so entry [rank, rank] less 1 (still ~ +rank) turns pivot
    `rank` to -1 only through the updates of the columns before it."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((rank, 40))
    L1 = np.linalg.cholesky(G @ G.T + rank * np.eye(rank))
    M = np.vstack([L1, rng.standard_normal((n - rank, rank))])
    A = M @ M.T
    A[rank, rank] -= 1.0
    return A


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("col", [10, 16, 120, 100],
                         ids=["first_panel", "panel_boundary", "last_panel", "after_updates"])
def test_bad_pivot_first_nan_column(col, dtype):
    """The contract chip_smoke.py holds B2/B3 to against this twin: a bad
    pivot at column `col` of element 3 makes exactly the lower-triangle
    entries of columns >= col NaN, leaves the columns before it as in a
    clean run and the other elements bit-equal. (The reference's 8-wide
    panels put NaN from the first column of the pivot's panel on.)"""
    A = _spd(8, 128, 77, dtype=dtype)
    bad = A.copy()
    if col == 100:
        bad[3] = _rank_deficient()
    else:
        bad[3, col, col] = -5.0
    as_t = _f32 if dtype == np.float32 else _f64
    clean, L = bc.block_chol_plain(as_t(A)), bc.block_chol_plain(as_t(bad))
    lower = torch.tril(torch.ones(128, 128, dtype=torch.bool))
    assert torch.equal(torch.isnan(L[3]), lower & (torch.arange(128) >= col)[None, :])
    if col != 100:
        assert torch.equal(L[3, :, :col], clean[3, :, :col])
    for c in (0, 1, 2, 4, 5, 6, 7):
        assert torch.equal(L[c], clean[c])


def test_tri_inv_doubling_matches_reference():
    from gpy_tpu.ops.blocked_linalg import tri_inv_doubling

    L = np.linalg.cholesky(_spd(3, 128, 11, dtype=np.float64))
    got = bl.tri_inv_doubling(_f64(L))
    np.testing.assert_allclose(got.numpy(), np.asarray(tri_inv_doubling(jnp.asarray(L))),
                               rtol=1e-10, atol=1e-15)
    eye = torch.eye(128, dtype=torch.float64).expand(3, -1, -1)
    torch.testing.assert_close(got @ _f64(L), eye, rtol=0, atol=1e-13)


def test_rec_chol_inv_matches_reference():
    """The route for a batch above 64, at a small batch: float64 against
    the reference's recursion."""
    from gpy_tpu.ops.blocked_linalg import rec_chol_inv

    K = _spd(3, 600, 12, dtype=np.float64)
    L, Li = bl.rec_chol_inv(_f64(K))
    Lr, Lir = rec_chol_inv(jnp.asarray(K))
    np.testing.assert_allclose(L.numpy(), np.asarray(Lr), rtol=0, atol=1e-12)
    np.testing.assert_allclose(Li.numpy(), np.asarray(Lir), rtol=0, atol=1e-14)


def _indefinite_batch(n=300, seed=13):
    """Four SPD matrices, the third with one eigenvalue -3e-5 x its mean
    diagonal: the ladder's rungs 1e-6 and 1e-5 fail and 1e-4 succeeds, far
    from the boundary for either factorization."""
    rng = np.random.default_rng(seed)
    out = []
    for c in range(4):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        lam = 1.0 + rng.random(n)
        if c == 2:
            lam[7] = -3e-5 * lam.mean()
        out.append((Q * lam) @ Q.T)
    K = np.stack(out)
    return 0.5 * (K + np.swapaxes(K, 1, 2))


@pytest.mark.parametrize("n", [300, 200], ids=["block_routine", "torch_linalg"])
def test_batched_jitter_ladder_per_element(n):
    """jitchol_and_inv of a (4, n, n) batch with one indefinite element
    against the reference's jax.vmap(jitchol_and_inv) at float64: only the
    third element is jittered (1e-4 x its mean diagonal), the others are
    the clean factors. n = 300 runs the blocked factorization (B2's twin), n = 200
    torch.linalg."""
    K = _indefinite_batch(n)
    L, Li = tla.jitchol_and_inv(_f64(K))
    Lr, Lir = jax.vmap(jla.jitchol_and_inv)(jnp.asarray(K))
    assert np.isfinite(np.asarray(Lr)).all() and torch.isfinite(L).all()
    np.testing.assert_allclose(L.numpy(), np.asarray(Lr), rtol=0, atol=1e-9)
    np.testing.assert_allclose(Li.numpy(), np.asarray(Lir), rtol=0, atol=1e-6)
    Kj = K[2] + 1e-4 * np.mean(np.diag(K[2])) * np.eye(n)
    np.testing.assert_allclose(L[2].numpy(), np.linalg.cholesky(Kj), rtol=0, atol=1e-9)
    for c in (0, 1, 3):
        np.testing.assert_allclose(L[c].numpy(), np.linalg.cholesky(K[c]), rtol=0, atol=1e-12)
    # the unbatched ladder picks the same rung for the indefinite element
    L2, jit = tla.chol_jitter_used(_f64(K[2]))
    assert jit.item() == pytest.approx(1e-4 * np.mean(np.diag(K[2])), rel=1e-12)
    # and a batched jitchol ladders per element as well
    Lb, jits = tla.chol_jitter_used(_f64(K))
    assert jits[0].item() == jits[1].item() == jits[3].item() == 0.0
    assert jits[2].item() == pytest.approx(jit.item(), rel=1e-12)
    torch.testing.assert_close(Lb[2], L2, rtol=0, atol=0)


@pytest.mark.parametrize("n", [300, 64], ids=["block_routine", "torch_linalg"])
def test_batched_chol_and_inv_backward_matches_unbatched(n):
    """The matmul-only backward broadcasts over the batch: gradients of a
    (3, n, n) call equal the three unbatched calls' at float64."""
    K = _f64(_spd(3, n, 14, rank=20, dtype=np.float64))
    rng = np.random.default_rng(15)
    W1, W2 = _f64(rng.standard_normal((2, 3, n, n)))
    for fn in (tla.chol_and_inv, tla.jitchol_and_inv):
        Kb = K.clone().requires_grad_(True)
        L, Li = fn(Kb)
        g = torch.autograd.grad(torch.sum(W1 * L) + torch.sum(W2 * Li), Kb)[0]
        for c in range(3):
            Kc = K[c].clone().requires_grad_(True)
            Lc, Lic = fn(Kc)
            gc = torch.autograd.grad(torch.sum(W1[c] * Lc) + torch.sum(W2[c] * Lic), Kc)[0]
            torch.testing.assert_close(L[c].detach(), Lc.detach(), rtol=0, atol=1e-11)
            torch.testing.assert_close(g[c], gc, rtol=1e-9, atol=1e-12)


def test_batched_rules_route_by_size_and_batch(monkeypatch):
    """n > 256 and a batch of at most 64 take the blocked factorization; a larger
    batch the recursion; n <= 256 torch.linalg (gpy_tpu/util/linalg.py:
    151-174)."""
    calls = []
    monkeypatch.setattr(tla, "batched_chol_inv_ll",
                        lambda K: calls.append("ll") or bl.rec_chol_inv(K))
    monkeypatch.setattr(tla, "rec_chol_inv",
                        lambda K: calls.append("rec") or bl.chol_inv_native(K))
    eye = torch.eye(300, dtype=torch.float64)
    tla._batched_chol_inv(eye.expand(64, 300, 300))
    tla._batched_chol_inv(eye.expand(65, 300, 300))
    tla._batched_chol_inv(torch.eye(256, dtype=torch.float64).expand(2, 256, 256))
    assert calls == ["ll", "rec"]
