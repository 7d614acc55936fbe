"""B5's 3xTF32 contraction, emulated in torch ops on the CPU: the TF32
rounding of cvt.rna.tf32.f32 and the 3-pass product against float64, beside
one TF32 pass. For R <= 16 the kernel contracts in float32 FFMA in every
mode (a 3xTF32 contraction there was measured and not shipped: PERF.md,
the B5 findings); for R > 16 its tensor-core kernel contracts in 3xTF32,
each tile of kWideDepth columns into a fresh sum promoted into a float32
running sum, the order emulated here. This is also the record of why no
mode takes one pass."""
import os
import re

import numpy as np
import pytest
import torch

from chip_smoke import FUSED_FWD_TOL
from gpy_tpu_torch.ops import gram_matvec_fused as tf

FAMILY = {"RBF": 0, "Matern32": 1, "Matern52": 2, "Exponential": 3}
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "gpy_tpu_torch", "csrc", "gram_matvec_fused.cu")
# the tensor-core kernel's tile depth: its fresh sums' length before promotion
WIDE_DEPTH = int(re.search(r"constexpr int kWideDepth = (\d+);", open(SRC).read()).group(1))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def tf32_round(x):
    """cvt.rna.tf32.f32: float32 x rounded to TF32's 10-bit mantissa, to
    nearest with ties away from zero (the low 13 bits)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32x3_matmul(A, B):
    """A @ B with each float32 operand split into hi = tf32(x) and lo =
    tf32(x - hi), and lo@hi + hi@lo + hi@hi summed in float32 (a product of
    two TF32 values is exact in float32)."""
    A, B = A.to(torch.float32), B.to(torch.float32)
    Ah, Bh = tf32_round(A), tf32_round(B)
    Al, Bl = tf32_round(A - Ah), tf32_round(B - Bh)
    return Al @ Bh + Ah @ Bl + Ah @ Bh


def test_tf32_round_is_nearest_ties_away_on_the_low_13_bits():
    half_ulp = 2.0 ** -11  # half of TF32's ulp at 1
    x = torch.tensor([1 + half_ulp, -(1 + half_ulp), 1 + half_ulp - 2.0 ** -23,
                      1 + 3 * half_ulp, 0.0, -0.0, 3.0, float("inf")], dtype=torch.float32)
    want = [1 + 2 * half_ulp, -(1 + 2 * half_ulp), 1.0, 1 + 4 * half_ulp, 0.0, -0.0, 3.0,
            float("inf")]
    got = tf32_round(x)
    assert got.tolist() == want
    assert bool(torch.signbit(got[5]))
    rng = np.random.default_rng(0)
    y = torch.tensor(rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096),
                     dtype=torch.float32)
    r = tf32_round(y)
    assert torch.all(r.view(torch.int32) & 0x1FFF == 0)
    assert torch.all((r - y).abs() <= 2.0 ** -11 * y.abs())
    # hi + lo, lo = tf32(y - hi), carries y to ~22 bits: what 3xTF32 keeps
    lo = tf32_round(y - r)
    assert torch.all((r.double() + lo.double() - y.double()).abs()
                     <= 2.0 ** -21 * y.double().abs())


@pytest.mark.parametrize("name", list(FAMILY))
def test_tf32x3_product_holds_the_fused_limit_and_one_pass_does_not(name):
    """At N=2048, D=4, R=9 the 3-pass product is within FUSED_FWD_TOL of
    float64 (relative to max|ref|) and at least 10x closer than one TF32
    pass, which is not."""
    rng = np.random.default_rng(60 + FAMILY[name])
    N, D, R = 2048, 4, 9
    X = torch.tensor(rng.random((N, D)) * 4.0 / np.sqrt(D), dtype=torch.float32)
    V = torch.tensor(rng.standard_normal((N, R)), dtype=torch.float32)
    K = tf._k_of_r2(FAMILY[name], tf._direct_r2(X, X), 1.3)
    ref = K.double() @ V.double()
    scale = float(ref.abs().max())
    three = float((tf32x3_matmul(K, V).double() - ref).abs().max()) / scale
    one = float(((tf32_round(K) @ tf32_round(V)).double() - ref).abs().max()) / scale
    assert three <= FUSED_FWD_TOL
    assert one >= 10 * three
    assert one > FUSED_FWD_TOL


def tf32_trunc(x):
    """The TF32 value the tensor cores read from a float32 register: its
    low 13 bits dropped (toward zero)."""
    return (x.to(torch.float32).contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def promoted_tf32x3_matmul(A, B, depth=WIDE_DEPTH):
    """A @ B in the tensor-core kernel's order: both operands split once into
    hi = tf32(x) (to nearest, ties away) and lo = x - hi, of which the tensor
    cores read the truncated TF32 value, and per tile of `depth` columns of A
    (rows of B) a fresh float32 sum lo@hi + hi@lo + hi@hi, added once into a
    float32 running sum."""
    A, B = A.to(torch.float32), B.to(torch.float32)
    Ah, Bh = tf32_round(A), tf32_round(B)
    Al, Bl = tf32_trunc(A - Ah), tf32_trunc(B - Bh)
    run = torch.zeros((A.shape[0], B.shape[1]), dtype=torch.float32)
    for j in range(0, A.shape[1], depth):
        s = slice(j, j + depth)
        run = run + (Al[:, s] @ Bh[s] + Ah[:, s] @ Bl[s] + Ah[:, s] @ Bh[s])
    return run


@pytest.mark.parametrize("R", [17, 130, 256])
@pytest.mark.parametrize("name", list(FAMILY))
def test_promoted_tf32x3_holds_the_fused_limit_at_wide_r(name, R):
    """The wide kernel's contraction order at N=1024, D=4 (K and V split
    hi / lo, three passes a tile of WIDE_DEPTH summed in float32, each tile
    promoted into the running float32 sum) is within FUSED_FWD_TOL of
    float64, relative to max|ref|, for every family at R = 17, 130, 256."""
    rng = np.random.default_rng(70 + 4 * FAMILY[name] + R)
    N, D = 1024, 4
    X = torch.tensor(rng.random((N, D)) * 4.0 / np.sqrt(D), dtype=torch.float32)
    V = torch.tensor(rng.standard_normal((N, R)), dtype=torch.float32)
    K = tf._k_of_r2(FAMILY[name], tf._direct_r2(X, X), 1.3)
    ref = K.double() @ V.double()
    got = promoted_tf32x3_matmul(K, V)
    assert got.dtype == torch.float32 and got.shape == (N, R)
    assert float((got.double() - ref).abs().max()) / float(ref.abs().max()) <= FUSED_FWD_TOL
