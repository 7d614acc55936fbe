"""B6's mma kernel (`gram_moments_mma_kernel` in
gpy_tpu_torch/csrc/gram_matvec_fused.cu, D > 8 or R > 16) emulated in torch
ops on the CPU, in float32: W' = v G V' in 3xTF32 (each operand split into
a TF32 hi, rounded to nearest, and lo = x - hi, of which the tensor cores
read the top 19 bits; lo.lo dropped), the family's constant folded into the
coordinates, q_e formed once and read by r2' and the moments, each thread's
float32 sums over a tile's 32 entries in the kernel's order, the warp's
lanes added in the kernel's butterfly, then float64. Held against the
float64 plain twin on signed G and V, the emulation catches a dropped lo
term or a wrong fold before the card does (the kernel runs only there)."""
import numpy as np
import pytest
import torch

from chip_smoke import FUSED_BWD_TOL_50K
from gpy_tpu_torch.ops import gram_matvec_fused as tf
from test_torch_moments_tile import FAMILY, coord_scales, fma32, inputs, moments_scale, weights
from test_torch_tf32_split import tf32_round, tf32_trunc

ROWS, COLS = 128, 64   # a block's rows (8 warps of 16); a column tile


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def w_3xtf32(A, B, drop_lo=False):
    """split_tf32 and mma.sync's 3xTF32: W' = A B' as lo.hi + hi.lo + hi.hi
    with hi = tf32(x) rounded and lo = x - hi truncated to TF32 (the bits
    the tensor cores read), the products exact and summed in float64,
    rounded once to float32; `drop_lo` keeps hi.hi only."""
    ah, bh = tf32_round(A), tf32_round(B)
    al, bl = tf32_trunc(A - ah), tf32_trunc(B - bh)
    ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
    w = ah @ bh.T
    if not drop_lo:
        w = w + (al @ bh.T + ah @ bl.T)
    return w.float()


def butterfly(a):
    """flush8's sum over a warp's 32 lanes (lane 4 g + t; the last two axes
    g and t) in float32: g with g + 4, + 2, + 1 (lane bits 4, 3, 2), then t
    with t + 2, + 1."""
    for axis in (-2, -1):
        while a.shape[axis] > 1:
            h = a.shape[axis] // 2
            a = a.narrow(axis, 0, h) + a.narrow(axis, h, h)
    return a.squeeze(-1).squeeze(-1)


def emulate(Xs, G, V, v, family, drop_lo=False, scale=None):
    """The (D+1,) float64 moments as the mma kernel forms them.

    Rows are padded to whole blocks and columns to whole tiles (zero G and
    V add 0). Row i is row g (+ 8 on the warp's second half) of warp w of
    block B; column j is column 2t + h of step s of tile T. A thread
    (lane 4 g + t) sums its 32 entries of a tile (steps, then h, then the
    half) in float32; flush8 adds the 32 lanes; tiles and warps in
    float64. `scale` replaces moments_scale (a wrong fold)."""
    N, D = Xs.shape
    c = coord_scales()[family]
    Np, Mp = -(-N // ROWS) * ROWS, -(-N // COLS) * COLS
    pad = lambda a, n: torch.cat([a, a.new_zeros((n - a.shape[0],) + a.shape[1:])])
    x = Xs * c                                        # __fmul_rn(scale, x)
    xr, xc = pad(x, Np), pad(x, Mp)
    w = w_3xtf32(pad(v * G, Np), pad(V, Mp), drop_lo)  # v G rounded once, then split
    diff = xr[:, None, :] - xc[None, :, :]
    dq = diff * diff                                  # q_e, float32
    r2 = dq[..., 0]
    for e in range(1, D):
        r2 = r2 + dq[..., e]
    wk, wn = weights(family, r2, w)
    # rows (B, w, half, g) and columns (T, s, t, h) to (B, w, T, g, t, s, h, half)
    nB, nT = Np // ROWS, Mp // COLS
    order = lambda a: a.reshape(nB, 8, 2, 8, nT, 8, 4, 2, *a.shape[2:]).permute(
        0, 1, 4, 3, 6, 5, 7, 2, *range(8, a.dim() + 6)).reshape(
        nB, 8, nT, 8, 4, 32, *a.shape[2:])
    wk, wn, dq = order(wk), order(wn), order(dq)
    s0 = torch.zeros(wk.shape[:5], dtype=torch.float32)
    mt = torch.zeros(dq.shape[:5] + (D,), dtype=torch.float32)
    for i in range(32):  # the thread's order in a tile
        s0 = s0 + wk[..., i]
        mt = fma32(wn[..., i, None].expand_as(mt), dq[..., i, :], mt)
    m = butterfly(mt.movedim(-1, 2))                  # (B, w, D, T) after the lanes
    mom = torch.cat([s0.double().sum().reshape(1), m.double().sum(dim=(0, 1, 3))])
    mscale = moments_scale(family, c) if scale is None else scale
    return torch.cat([mom[:1] / float(v), mom[1:] * mscale])


def rel_err_vs_plain(family, D, R, **kw):
    Xs, G, V, v = inputs(700, D, R, seed=90 + 3 * D + R + family)
    ref = tf.gram_moments_plain(Xs.double(), G.double(), V.double(),
                                torch.tensor(float(v), dtype=torch.float64), family)
    got = emulate(Xs, G, V, v, family, **kw)
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("D,R", [(12, 9), (4, 17), (20, 9)])
@pytest.mark.parametrize("name", list(FAMILY))
def test_emulated_mma_kernel_holds_the_float64_twin(name, D, R):
    """At N=700 (a ragged block and tile), on signed G and V, the emulated
    arithmetic is within FUSED_BWD_TOL_50K of the float64 plain twin,
    relative to max|ref| over the D + 1 moments: one pass (D = 12, DMAX 12;
    D = 4 at R = 17, three k-steps) and D = 20, which the kernel takes in
    two passes with the same arithmetic an entry. (At N=320 the signed sums
    cancel to max|ref| ~ 35, where Exponential at D = 12 reads 1.8e-6 with
    W exact as well: float32's own rounding, not the split.)"""
    assert rel_err_vs_plain(FAMILY[name], D, R) <= FUSED_BWD_TOL_50K


@pytest.mark.parametrize("name,D,R,kw", [
    ("RBF", 12, 9, {"drop_lo": True}), ("Matern32", 4, 17, {"drop_lo": True}),
    ("RBF", 12, 9, {"scale": 0.5}),
    ("Exponential", 12, 9, {"scale": 0.5 / float(np.float32(1.4426950408889634))**2})])
def test_emulation_tells_a_dropped_lo_or_wrong_fold_apart(name, D, R, kw):
    """W from hi.hi alone (one TF32 pass), RBF's fold not undone, and
    Exponential's 1/r' undone as c^2 and not c: each misses the twin by far
    more than the limit, so the test above would catch it."""
    assert rel_err_vs_plain(FAMILY[name], D, R, **kw) > 100 * FUSED_BWD_TOL_50K
