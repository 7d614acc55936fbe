"""erfcx and the stable log of a difference of error functions.

Counterpart of gpy_tpu/util/ln_diff_erfs.py:15-51 (GPy/util/ln_diff_erfs.py
and the lnDifErf helper of GPy/kern/src/eq_ode1.py:715), used by the
latent-force kernels. erfcx is torch.special.erfcx, exact for every x and
differentiable.

One reference fault is not copied (ROADMAP C(ac)): for z1 <= 0 the
reference takes log(erf(z2) - erf(z1)) directly, which cancels when both
arguments are negative (at (-6, -5) it reads -27.20090447 where the exact
value is -27.20090354). Here that case goes through the symmetry
ln_diff_erf(z1, z2) = ln_diff_erf(-z2, -z1) to the erfcx branch.
"""
from __future__ import annotations

import torch

__all__ = ["erfcx", "ln_diff_erf"]


def erfcx(x):
    """Scaled complementary error function exp(x^2) erfc(x)."""
    return torch.special.erfcx(x)


def _tiny(dtype) -> float:
    """The floor of the logarithms' arguments: the reference's 1e-300 in
    float64, the smallest normal number in float32 (1e-300 is 0 there)."""
    return 1e-300 if dtype == torch.float64 else torch.finfo(dtype).tiny


def ln_diff_erf(z1, z2):
    """log(erf(z2) - erf(z1)) for erf(z2) > erf(z1), stable in both tails.

    For z1 > 0 the difference is erfcx(z1) - erfcx(z2) exp(z1^2 - z2^2)
    scaled by exp(-z1^2); for z2 < 0 the same of (-z2, -z1); across zero
    the plain difference, which does not cancel there. Each branch that a
    where does not select sees benign arguments (1, 2), so its overflow
    cannot reach the gradient.
    """
    z1, z2 = torch.broadcast_tensors(torch.as_tensor(z1), torch.as_tensor(z2))
    tiny = _tiny(z1.dtype)
    pos = z1 > 0.0
    neg = z2 < 0.0
    tail = pos | neg
    lo = torch.where(pos, z1, torch.where(neg, -z2, 1.0))
    hi = torch.where(pos, z2, torch.where(neg, -z1, 2.0))
    arg = erfcx(lo) - erfcx(hi) * torch.exp(lo * lo - hi * hi)
    branch_tail = -(lo * lo) + torch.log(torch.clamp_min(arg, tiny))
    m1 = torch.where(tail, 0.0, z1)
    m2 = torch.where(tail, 1.0, z2)
    branch_mid = torch.log(torch.clamp_min(torch.erf(m2) - torch.erf(m1), tiny))
    return torch.where(tail, branch_tail, branch_mid)
