"""B4's kernel (`block_chol_inv_kernel` in gpy_tpu_torch/csrc/block_chol.cu)
emulated in torch ops on the CPU: B2's blocked factor (16-column panels: the
diagonal block with 1 / sqrt on the pivot chain, the rows below it against
the block, the trailing update), then the inverse by row panels in the
kernel's packed tile, L below the diagonal and X^T on and above it with
1 / L[k, k] beside: (a) a forward substitution down each column's 16
entries of the panel, each entry scaled by its pivot's reciprocal (where
the twin divides), (b) a rank-16 update of the rows below. Held against the
plain twin `block_chol_inv_plain` (and a float64 inverse), the emulation
catches a wrong panel order, mask or packing before the card does (the
kernel itself runs only on the card)."""
import numpy as np
import pytest
import torch

from chip_smoke import CHOL_INV_TOL, CHOL_RESID_TOL, CHOL_TOL, NAN_PIVOTS, NAN_RANK
from gpy_tpu_torch.ops import block_chol as bc

N, NB = 128, 16  # the kernel's block edge and panel width


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def spd(C, seed, dtype, n=N, rank=40):
    """C SPD (n, n) matrices G G' + n I from a numpy seed (chip_smoke's
    chol_inputs, on the CPU)."""
    G = np.random.default_rng(seed).standard_normal((C, n, rank))
    return torch.as_tensor(G @ np.swapaxes(G, 1, 2) + n * np.eye(n)).to(dtype)


def rank_deficient(dtype, n=N, rank=NAN_RANK, seed=78):
    """M M' with M = [L1; R] (n x rank): pivot `rank` turns negative only
    through the updates of the columns before it (chip_smoke's
    rank_deficient_block, from a numpy seed)."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((rank, 40))
    L1 = np.linalg.cholesky(G @ G.T + rank * np.eye(rank))
    M = np.vstack([L1, rng.standard_normal((n - rank, rank))])
    A = M @ M.T
    A[rank, rank] -= 1.0
    return torch.as_tensor(A).to(dtype)


def factor_tile(A):
    """`factor_tile`: the tile after B2's blocked factor, L in its lower
    triangle (what lies above the diagonal is never read)."""
    s = torch.tril(A)
    for q0 in range(0, N, NB):
        e = q0 + NB
        # (a) the diagonal block, row i a lane; the pivot chain in 1 / sqrt
        D = s[:, q0:e, q0:e].clone()
        dinv, mine = torch.empty_like(D[:, 0]), torch.empty_like(D[:, 0])
        for k in range(NB):
            piv = D[:, k, k].clone()
            mine[:, k] = piv
            dinv[:, k] = torch.rsqrt(piv)
            D[:, :, k] = D[:, :, k] * dinv[:, k, None]
            D[:, :, k + 1:] -= D[:, :, k, None] * D[:, None, k + 1:, k]
        D = torch.tril(D, -1) + torch.diag_embed(torch.sqrt(mine))
        s[:, q0:e, q0:e] = D
        # (b) the rows below against it
        X = s[:, e:, q0:e].clone()
        for k in range(NB):
            X[:, :, k] = X[:, :, k] * dinv[:, k, None]
            X[:, :, k + 1:] -= X[:, :, k, None] * D[:, None, k + 1:, k]
        s[:, e:, q0:e] = X
        # (c) the trailing lower triangle, in column order
        for k in range(NB):
            s[:, e:, e:] -= X[:, :, k, None] * X[:, None, :, k]
    return torch.tril(s)


def inverse_tile(L):
    """The inverse by row panels in the packed tile: s holds L strictly
    below the diagonal and X^T (the identity to start) on and above it,
    rdiag the IEEE reciprocals of L's diagonal, pt the panel's rows of X."""
    C = L.shape[0]
    rdiag = 1.0 / torch.diagonal(L, dim1=1, dim2=2)
    s = torch.tril(L, -1) + torch.eye(N, dtype=L.dtype)
    pt = torch.zeros((C, NB, N), dtype=L.dtype)
    for q0 in range(0, N, NB):
        w = q0 + NB
        # (a) column j < w: x[k] = X[q0 + k, j] = X^T[j, q0 + k]; L lies
        # where q0 + k < j, so those entries start (and are stored) as 0
        above = (q0 + torch.arange(NB))[None, :] < torch.arange(w)[:, None]
        x = s[:, :w, q0:w].masked_fill(above, 0.0)
        for k in range(NB):
            x[:, :, k] = x[:, :, k] * rdiag[:, q0 + k, None]
            x[:, :, k + 1:] -= s[:, None, q0 + k + 1:w, q0 + k] * x[:, :, k, None]
        pt[:, :, :w] = x.masked_fill(above, 0.0).transpose(1, 2)
        s[:, :w, q0:w] = torch.where(above, s[:, :w, q0:w], x)
        # (b) rows i >= w: X^T[j, i] -= L[i, q0 + k] X[q0 + k, j], k in order
        for k in range(NB):
            s[:, :w, w:] -= pt[:, k, :w, None] * s[:, None, w:, q0 + k]
    return torch.triu(s).transpose(1, 2)  # X, zeros above the diagonal


def block_chol_inv_tile(A):
    L = factor_tile(A)
    return L, inverse_tile(L)


DTYPES = [torch.float32, torch.float64]
DTYPE_IDS = ["f32", "f64"]


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("seed", [3, 11])
def test_emulation_matches_twin_and_float64(seed, dtype):
    """The kernel's order against the twin within chip_smoke's limits, and
    L^-1 against a float64 torch.linalg inverse of the float64 factor."""
    name = str(dtype).replace("torch.", "")
    A = spd(4, seed, dtype)
    L, Li = block_chol_inv_tile(A)
    Lp, Lip = bc.block_chol_inv_plain(A)
    assert float((L - Lp).abs().max()) <= CHOL_TOL[name]
    assert float((Li - Lip).abs().max()) <= CHOL_INV_TOL[name]
    assert torch.equal(L, torch.tril(L)) and torch.equal(Li, torch.tril(Li))
    eye = torch.eye(N, dtype=torch.float64)
    assert float((Li.double() @ L.double() - eye).abs().max()) <= CHOL_RESID_TOL[name]
    Li64 = torch.linalg.solve_triangular(torch.linalg.cholesky(A.double()), eye, upper=False)
    assert float((Li.double() - Li64).abs().max()) <= CHOL_INV_TOL[name]


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("col", NAN_PIVOTS + (NAN_RANK,),
                         ids=["first_panel", "panel_boundary", "last_panel", "after_updates"])
def test_emulation_nan_pattern_is_the_twins(col, dtype):
    """A bad pivot in element 1 of 3: L's and L^-1's NaN entries are the
    twin's (L^-1's rows from the pivot on, lower triangle only), nothing
    but zeros above either diagonal, the other elements finite."""
    A = spd(3, 77, dtype)
    if col == NAN_RANK:
        A[1] = rank_deficient(dtype)
    else:
        A[1, col, col] = -5.0
    for got, ref in zip(block_chol_inv_tile(A), bc.block_chol_inv_plain(A)):
        assert torch.equal(got.isnan(), ref.isnan())
        assert bool((torch.triu(got, 1) == 0).all())
        assert torch.isfinite(got[0]).all() and torch.isfinite(got[2]).all()
    lower = torch.tril(torch.ones(N, N, dtype=torch.bool))
    rows = (torch.arange(N) >= col)[:, None]
    assert torch.equal(ref[1].isnan(), lower & rows)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("bad", [None, 16], ids=["spd", "bad_pivot_16"])
def test_twin_inverse_is_lower_triangular(bad, dtype):
    """block_chol_inv_plain returns exact zeros above L^-1's diagonal, for a
    bad block too (its NaN rows stop at the diagonal)."""
    A = spd(2, 5, dtype)
    if bad is not None:
        A[0, bad, bad] = -5.0
    _, Li = bc.block_chol_inv_plain(A)
    assert bool((torch.triu(Li, 1) == 0).all())
    assert torch.isfinite(Li[1]).all()
    assert torch.isnan(Li[0]).any() == (bad is not None)
