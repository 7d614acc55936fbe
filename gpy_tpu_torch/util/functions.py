"""Small special-function helpers.

Counterpart of gpy_tpu/util/functions.py (GPy/util/functions.py:10-33), in
torch so that they are usable inside a differentiated loss. One reference
fault is not copied (ROADMAP C(aa)): the reference's differfln imports a
name its ln_diff_erfs module does not define and raises ImportError; here
it calls ln_diff_erf.
"""
from __future__ import annotations

import math

import torch

from .ln_diff_erfs import ln_diff_erf

_SQRT1_2 = math.sqrt(0.5)

__all__ = ["logistic", "logisticln", "normcdf", "normcdfln", "clip_exp", "differfln"]


def logistic(x):
    return 1.0 / (1.0 + torch.exp(-x))


def logisticln(x):
    """log(logistic(x)), stable for very negative x."""
    return -torch.logaddexp(torch.zeros_like(x), -x)


def normcdf(x):
    """Phi(x) as erfc(-x / sqrt 2) / 2, accurate in the lower tail, where
    torch.special.ndtr's CPU kernel returns 0 from x ~ -8.3."""
    return 0.5 * torch.special.erfc(-x * _SQRT1_2)


def normcdfln(x):
    """log Phi(x), stable in the deep tail."""
    return torch.special.log_ndtr(x)


def clip_exp(x, lower=-250.0, upper=250.0):
    return torch.exp(torch.clamp(x, lower, upper))


def differfln(x0, x1):
    """log(erf(x0) - erf(x1)) for x0 > x1."""
    return ln_diff_erf(x1, x0)
