"""The port's special functions (util/wofz.py, util/ln_diff_erfs.py,
util/functions.py) against scipy, mpmath and gpy_tpu, float64 on the CPU.

wofz is held to scipy.special.wofz at |z| from 0.1 to 100 in the four
quadrants wherever the value is finite (rel 1e-11), and its autograd
Function's backward (w' = -2 z w + 2i/sqrt(pi), conjugated) by gradcheck.
Two reference faults are recorded and not copied: ln_diff_erf(-6, -5)
cancels in the reference (ROADMAP C(ac)), and its differfln raises
ImportError (C(aa)).
"""
import jax
import jax.numpy as jnp
import mpmath
import numpy as np
import pytest
import scipy.special as sp
import torch

import gpy_tpu.util.functions as jf
import gpy_tpu.util.wofz as jw
from gpy_tpu.util.ln_diff_erfs import ln_diff_erf as j_ln_diff_erf
from gpy_tpu_torch.util import functions as tf
from gpy_tpu_torch.util.ln_diff_erfs import erfcx, ln_diff_erf
from gpy_tpu_torch.util.wofz import erf_complex, wofz

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _quadrant_points():
    """|z| on 25 log-spaced magnitudes from 0.1 to 100 at two angles in
    each quadrant, and on both axes."""
    mags = np.logspace(-1, 2, 25)
    angs = np.concatenate([np.pi / 2 * q + np.array([np.pi / 8, 3 * np.pi / 8])
                           for q in range(4)] + [np.pi / 2 * np.arange(4)])
    return (mags[:, None] * np.exp(1j * angs[None, :])).ravel()


def test_wofz_against_scipy_in_all_quadrants():
    z = _quadrant_points()
    ref = sp.wofz(z)
    keep = np.isfinite(ref) & (np.abs(ref) < 1e300)
    assert keep.sum() > 250 and (z[keep].imag < 0).sum() > 60
    got = wofz(torch.tensor(z[keep])).numpy()
    rel = np.abs(got - ref[keep]) / np.abs(ref[keep])
    assert rel.max() < 1e-11, (z[keep][np.argmax(rel)], rel.max())


def test_wofz_and_erf_complex_against_the_reference():
    z = _quadrant_points()
    z = z[np.abs(z) < 6.0]
    np.testing.assert_allclose(wofz(torch.tensor(z)).numpy(), np.asarray(jw.wofz(jnp.asarray(z))),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(erf_complex(torch.tensor(z)).numpy(),
                               np.asarray(jw.erf_complex(jnp.asarray(z))), rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(erf_complex(torch.tensor(z)).numpy(), sp.erf(z), rtol=1e-12)


def test_wofz_real_input_takes_its_precision():
    x = torch.linspace(-3, 3, 7, dtype=torch.float32)
    w = wofz(x)
    assert w.dtype == torch.complex64
    np.testing.assert_allclose(w.numpy(), sp.wofz(x.numpy().astype(np.float64)), rtol=1e-5)


@pytest.mark.parametrize("fn", [wofz, erf_complex], ids=["wofz", "erf_complex"])
def test_gradcheck_complex128(fn):
    rng = np.random.default_rng(0)
    z = (rng.standard_normal(12) * 2 + 1j * rng.standard_normal(12) * 2)  # both half-planes
    zt = torch.tensor(z, requires_grad=True)
    assert torch.autograd.gradcheck(fn, (zt,))


def test_erfcx_against_scipy():
    x = np.linspace(-5, 60, 301)
    np.testing.assert_allclose(erfcx(torch.tensor(x)).numpy(), sp.erfcx(x), rtol=1e-14)


def _exact_ln_diff_erf(z1, z2):
    """log(erf(z2) - erf(z1)) to 50 digits, by erfc in the tails."""
    mpmath.mp.dps = 50
    z1, z2 = mpmath.mpf(z1), mpmath.mpf(z2)
    if z1 > 0:
        return float(mpmath.log(mpmath.erfc(z1) - mpmath.erfc(z2)))
    if z2 < 0:
        return float(mpmath.log(mpmath.erfc(-z2) - mpmath.erfc(-z1)))
    return float(mpmath.log(mpmath.erf(z2) - mpmath.erf(z1)))


LN_DIFF_CASES = [(-6.0, -5.0), (-30.0, -29.5), (-2.0, -1.0), (-1.0, 2.0), (0.0, 0.5),
                 (-0.5, 0.0), (0.3, 0.4), (5.0, 6.0), (1.0, 30.0), (20.0, 20.5)]


def test_ln_diff_erf_against_mpmath():
    z1, z2 = (torch.tensor([c[i] for c in LN_DIFF_CASES], dtype=torch.float64) for i in (0, 1))
    got = ln_diff_erf(z1, z2).numpy()
    want = np.array([_exact_ln_diff_erf(a, b) for a, b in LN_DIFF_CASES])
    np.testing.assert_allclose(got, want, rtol=1e-13)


def test_ln_diff_erf_both_negative_is_not_the_references_cancellation():
    """C(ac): the reference reads -27.20090447 at (-6, -5), exact
    -27.20090354."""
    exact = np.log(sp.erfc(5.0) - sp.erfc(6.0))
    port = float(ln_diff_erf(torch.tensor(-6.0, dtype=torch.float64),
                             torch.tensor(-5.0, dtype=torch.float64)))
    ref = float(j_ln_diff_erf(jnp.asarray(-6.0), jnp.asarray(-5.0)))
    assert abs(port - exact) <= 1e-14 * abs(exact)
    assert abs(ref - exact) > 1e-8 * abs(exact)
    # where the reference does not cancel, the two agree
    a = np.array([-1.0, 0.0, 0.3, 5.0, 1.0])
    b = np.array([2.0, 0.5, 0.4, 6.0, 30.0])
    np.testing.assert_allclose(ln_diff_erf(torch.tensor(a), torch.tensor(b)).numpy(),
                               np.asarray(j_ln_diff_erf(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-13)


def test_ln_diff_erf_gradient():
    z1 = torch.tensor([-6.0, -1.0, 0.3, 5.0, 1.0], dtype=torch.float64, requires_grad=True)
    z2 = torch.tensor([-5.0, 2.0, 0.4, 6.0, 30.0], dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(ln_diff_erf, (z1, z2))


def test_differfln_works_where_the_reference_raises():
    """C(aa): the reference's differfln imports a name that does not exist."""
    x0 = torch.tensor([0.5, 2.0, -5.0], dtype=torch.float64)
    x1 = torch.tensor([-0.5, 1.0, -6.0], dtype=torch.float64)
    want = [_exact_ln_diff_erf(b, a) for a, b in zip(x0.tolist(), x1.tolist())]
    np.testing.assert_allclose(tf.differfln(x0, x1).numpy(), want, rtol=1e-13)
    with pytest.raises(ImportError):
        jf.differfln(jnp.asarray(0.5), jnp.asarray(-0.5))


SCIPY = {"logistic": sp.expit, "logisticln": sp.log_expit, "normcdf": sp.ndtr,
         "normcdfln": sp.log_ndtr, "clip_exp": lambda x: np.exp(np.clip(x, -250.0, 250.0))}


@pytest.mark.parametrize("name", sorted(SCIPY))
def test_functions_against_scipy_and_the_reference(name):
    """scipy over [-40, 40] and +-300; the reference where its jnp forms
    are accurate (|x| <= 4: jax's log_ndtr reads 1e-11-1e-1 off scipy in
    the tails, where the port's equals scipy's)."""
    x = np.concatenate([np.linspace(-40, 40, 81), [-300.0, 300.0]])
    got = getattr(tf, name)(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, SCIPY[name](x), rtol=1e-13, atol=1e-300)
    mid = np.abs(x) <= 4
    want = np.asarray(getattr(jf, name)(jnp.asarray(x[mid])))
    np.testing.assert_allclose(got[mid], want, rtol=1e-13, atol=0)
