"""The 3xTF32 contraction that B5's redesign measured for "f32x3" and
"fast" and did not ship (PERF.md, the B5 findings), emulated in torch ops on the CPU:
the TF32 rounding of cvt.rna.tf32.f32 and the 3-pass product against
float64, beside one TF32 pass. This is the record of why "fast" could not
take one pass: the kernel itself contracts in float32 FFMA in every mode."""
import numpy as np
import pytest
import torch

from chip_smoke import FUSED_FWD_TOL
from gpy_tpu_torch.ops import gram_matvec_fused as tf

FAMILY = {"RBF": 0, "Matern32": 1, "Matern52": 2, "Exponential": 3}


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
