"""The complex Faddeeva function w(z) = exp(-z^2) erfc(-iz) and complex erf.

Counterpart of gpy_tpu/util/wofz.py:31-118, needed by the second-order
latent-force kernel (GPy/kern/src/eq_ode2.py calls scipy.special.wofz).
Weideman's (1994) rational series: N = 64 coefficients computed once with
numpy at import, the polynomial evaluated in the Moebius-transformed
variable (L + iz)/(L - iz) for Im z >= 0, and the lower half-plane by the
reflection w(z) = 2 exp(-z^2) - w(-z). About 1e-13 relative in complex128.

torch computes complex128 and complex64 natively on the CPU and the card,
so the reference's real-pair arithmetic (gpy_tpu/util/cplx.py, written
because the TPU runtime has no complex types) has no counterpart here.

wofz is one autograd Function. Its forward runs the 63-step Horner chain
without a graph, and its backward is the derivative w'(z) = -2 z w(z) +
2i/sqrt(pi), from the saved z and w alone: a chain kept by autograd would
save every step's intermediate, 64 arrays of the argument's size. w is
holomorphic, so the gradient PyTorch expects is grad * conj(w'(z)).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["wofz", "erf_complex"]

_N = 64
_INV_SQRT_PI = 1.0 / math.sqrt(math.pi)


def _weideman_coeffs(N=_N):
    """Weideman (1994) 'cef' coefficients (a transcription of cef.m)."""
    M = 2 * N
    M2 = 2 * M
    k = np.arange(-M + 1, M)  # M2 - 1 points
    L = np.sqrt(N / np.sqrt(2.0))
    theta = k * np.pi / M
    t = L * np.tan(theta / 2.0)
    f = np.exp(-t * t) * (L * L + t * t)
    f = np.concatenate([[0.0], f])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / M2
    a = np.flipud(a[1:N + 1])  # descending-power coefficients
    return float(L), np.ascontiguousarray(a)


_L, _A = _weideman_coeffs()


@functools.lru_cache(maxsize=None)
def _coeffs(dtype, device):
    """The coefficients as a complex tensor on `device`, made once (a copy
    to the card)."""
    return torch.tensor(_A, dtype=dtype, device=device)


def _complex_dtype(dtype) -> torch.dtype:
    if dtype.is_complex:
        return dtype
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def _wofz_upper(z):
    """Weideman's evaluation for Im z >= 0."""
    iz = 1j * z
    den = _L - iz
    Z = (_L + iz) / den
    A = _coeffs(z.dtype, z.device)
    p = torch.full_like(Z, complex(_A[0]))
    for k in range(1, _N):
        p = torch.addcmul(A[k], p, Z)
    return 2.0 * p / (den * den) + _INV_SQRT_PI / den


def _wofz_eval(z):
    upper = z.imag >= 0
    w_up = _wofz_upper(torch.where(upper, z, -z))
    # Im z < 0: w(z) = 2 exp(-z^2) - w(-z); where the upper branch is taken
    # the unselected value may overflow, which no graph sees
    return torch.where(upper, w_up, 2.0 * torch.exp(-(z * z)) - w_up)


class _Wofz(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z):
        w = _wofz_eval(z)
        ctx.save_for_backward(z, w)
        return w

    @staticmethod
    def backward(ctx, grad):
        z, w = ctx.saved_tensors
        dw = -2.0 * z * w + 2j * _INV_SQRT_PI
        return grad * dw.conj()


def wofz(z):
    """w(z) elementwise; a real z is taken as complex of its precision."""
    z = torch.as_tensor(z)
    return _Wofz.apply(z.to(_complex_dtype(z.dtype)))


def erf_complex(z):
    """erf(z) = 1 - exp(-z^2) w(iz), taken at |Re z| and reflected (erf is
    odd) so that w is evaluated in the upper half-plane."""
    z = torch.as_tensor(z)
    z = z.to(_complex_dtype(z.dtype))
    flip = z.real < 0
    zp = torch.where(flip, -z, z)
    val = 1.0 - torch.exp(-(zp * zp)) * wofz(1j * zp)
    return torch.where(flip, -val, val)
