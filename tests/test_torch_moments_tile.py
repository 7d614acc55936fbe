"""B6's register-tile kernel (`gram_moments_tile_kernel` in
gpy_tpu_torch/csrc/gram_matvec_fused.cu) emulated in torch ops on the CPU,
in float32: the family's constant folded into the coordinates, each
family's two weights in the folded variables, q_e reused by r2' and the
moments, each thread's float32 sums of a tile added into float64, and the
folded constant undone once at the end. Held against the float64 plain
twin, the emulation catches a wrong fold or -dK/dr2 before the card does
(the kernel itself runs only on the card)."""
import math
import os
import re

import numpy as np
import pytest
import torch

from chip_smoke import FUSED_BWD_TOL_50K
from gpy_tpu_torch.ops import gram_matvec_fused as tf

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "gpy_tpu_torch", "csrc", "gram_matvec_fused.cu")
FAMILY = {"RBF": 0, "Matern32": 1, "Matern52": 2, "Exponential": 3}
ROWS, COLS = 128, 128          # a block's rows; a column tile at R <= 9
LN2 = np.float32(math.log(2.0))
LN2_SQ_3 = np.float32(np.float32(LN2 * LN2) / np.float32(3.0))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def coord_scales():
    """kCoordScale<0..3> as the kernel's source spells them."""
    src = open(SRC).read()
    block = src[src.index("constexpr float kCoordScale"):]
    vals = re.findall(r"([0-9]+\.[0-9]+)f", block[:block.index(";")])
    assert len(vals) == 4
    return [np.float32(float(v)) for v in vals]


def moments_scale(family, c):
    """moments_scale<FAM>: f / c^2 (f = 1/2, 3/2, 5/6), Exponential 1 / (2 c)."""
    c = float(c)
    return (0.5 / c**2, 1.5 / c**2, (5.0 / 6.0) / c**2, 0.5 / c)[family]


def fma32(a, b, c):
    """fmaf: a * b + c rounded to float32 once (the float32 product is exact
    in float64)."""
    return (a.double() * b.double() + c.double()).float()


def weights(family, r2, w, drop_p=False):
    """moment_weights: (wk, wn) from the folded r2' and w = v W, with torch's
    float32 exp2, sqrt and rsqrt in place of the SFU's approximations.
    `drop_p` leaves Matern52's (1 + s) out of wn (a wrong -dK/dr2)."""
    if family == 0:
        we = w * torch.exp2(-r2)
        return we, we
    if family == 3:
        x = r2 + np.float32(1e-30)
        rs = torch.rsqrt(x)
        wk = w * torch.exp2(-(x * rs))
        return wk, wk * rs
    r = torch.sqrt(r2 + np.float32(1e-30))
    we = w * torch.exp2(-r)
    p = fma32(r, torch.full_like(r, LN2), torch.ones_like(r))
    if family == 1:
        return we * p, we
    poly = fma32(r, fma32(r, torch.full_like(r, LN2_SQ_3), torch.full_like(r, LN2)),
                 torch.ones_like(r))
    return we * poly, (we if drop_p else we * p)


def emulate(Xs, G, V, v, family, drop_p=False, scale=None):
    """The (D+1,) float64 moments as the register-tile kernel forms them.

    Rows and columns are padded to whole blocks and tiles (zero G and V rows
    add 0). A thread of block B, warp w and lane (g, t) owns rows
    128 B + 16 w + g and + 8, and in tile T the columns 128 T + 8 s + t and
    + 4 (s = 0..15); it sums its 64 entries of a tile in float32 in the
    kernel's order (s, then column half, then row) and the tile sums in
    float64. `scale` replaces moments_scale (a wrong fold)."""
    N, D = Xs.shape
    c = coord_scales()[family]
    Np, Mp = -(-N // ROWS) * ROWS, -(-N // COLS) * COLS
    pad = lambda a, n: torch.cat([a, a.new_zeros((n - a.shape[0],) + a.shape[1:])])
    x = pad(Xs * c, max(Np, Mp))                     # __fmul_rn(scale, x)
    gv = pad(v * G, Np)                              # v G, once a row
    Vp = pad(V, Mp)
    nT = Mp // COLS
    mom = torch.zeros(D + 1, dtype=torch.float64)
    for b0 in range(0, Np, ROWS):
        diff = x[b0:b0 + ROWS, None, :] - x[None, :Mp, :]
        dq = diff * diff                             # q_e, float32
        r2 = dq[..., 0]
        for e in range(1, D):
            r2 = r2 + dq[..., e]
        rows = gv[b0:b0 + ROWS]
        w = rows[:, None, 0] * Vp[None, :, 0]
        for k in range(1, G.shape[1]):
            w = fma32(rows[:, None, k].expand_as(w), Vp[None, :, k].expand_as(w), w)
        wk, wn = weights(family, r2, w, drop_p)
        # rows (warp, row, g), columns (T, s, half, t); one thread's order (s, half, row)
        order = lambda a: a.reshape(8, 2, 8, nT, 16, 2, 4, *a.shape[2:]).permute(
            4, 5, 1, 0, 2, 3, 6, *range(7, a.dim() + 5)).reshape(64, 8, 8, nT, 4, *a.shape[2:])
        wk, wn, dq = order(wk), order(wn), order(dq)
        s0 = torch.zeros(wk.shape[1:], dtype=torch.float32)
        mt = torch.zeros(dq.shape[1:], dtype=torch.float32)
        for i in range(64):
            s0 = s0 + wk[i]
            mt = fma32(wn[i, ..., None].expand_as(dq[i]), dq[i], mt)
        mom[0] += s0.double().sum()
        mom[1:] += mt.double().sum(dim=(0, 1, 2, 3))
    mscale = moments_scale(family, c) if scale is None else scale
    return torch.cat([mom[:1] / float(v), mom[1:] * mscale])


def inputs(N, D, R, seed):
    """chip_smoke.fused_inputs' distributions, scaled: X ~ U[0, 4) / ls,
    G and V standard normal, v = 1.3."""
    g = np.random.default_rng(seed)
    X = g.random((N, D)) * 4.0
    V = g.standard_normal((N, R))
    ls = math.sqrt(D) * (0.7 + 0.6 * g.random(D))
    G = g.standard_normal((N, R))
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    return (f32(X) / f32(ls)).contiguous(), f32(G), f32(V), np.float32(1.3)


def rel_err_vs_plain(family, D, **kw):
    Xs, G, V, v = inputs(2000, D, 9, seed=70 + 3 * D + family)
    ref = tf.gram_moments_plain(Xs.double(), G.double(), V.double(),
                                torch.tensor(float(v), dtype=torch.float64), family)
    got = emulate(Xs, G, V, v, family, **kw)
    return float((got - ref).abs().max() / ref.abs().max())


def test_coord_scales_fold_each_family_constant():
    """The kernel's constants: c^2 = log2(e) / 2 for RBF, sqrt(3) log2(e),
    sqrt(5) log2(e) and log2(e), to float32's rounding."""
    log2e = 1.0 / math.log(2.0)
    want = [math.sqrt(log2e / 2.0), math.sqrt(3.0) * log2e, math.sqrt(5.0) * log2e, log2e]
    for got, w in zip(coord_scales(), want):
        assert abs(float(got) - w) <= 2.0**-24 * w


@pytest.mark.parametrize("D", [1, 4, 8])
@pytest.mark.parametrize("name", list(FAMILY))
def test_emulated_tile_kernel_holds_the_float64_twin(name, D):
    """At N=2000 (ragged: padded to 2048), R=9, the emulated arithmetic is
    within FUSED_BWD_TOL_50K of the float64 plain twin, relative to
    max|ref| over the D + 1 moments."""
    assert rel_err_vs_plain(FAMILY[name], D) <= FUSED_BWD_TOL_50K


@pytest.mark.parametrize("name,kw", [("Matern52", {"drop_p": True}),
                                     ("RBF", {"scale": 0.5}),
                                     ("Exponential", {"scale": 0.5 / float(np.float32(1.4426950408889634))**2})])
def test_emulation_tells_a_wrong_weight_or_fold_apart(name, kw):
    """Matern52's wn without (1 + s), RBF's fold not undone, Exponential's
    1/r' undone as c^2 and not c: each misses the twin by far more than the
    limit, so the test above would catch it."""
    assert rel_err_vs_plain(FAMILY[name], 4, **kw) > 100 * FUSED_BWD_TOL_50K
