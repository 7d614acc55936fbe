"""The state-space model's C++ engine: a sequential Kalman filter and RTS
smoother on the host, in float64.

Counterpart of gpy_tpu/native/__init__.py:59-117. The source is
csrc/kalman.cpp, built with g++ into _build/libkalman.so at first use
(ops/_build.py) and loaded with ctypes; importing this module builds
nothing. Where g++ is missing or the build fails, `load` raises: the engine
is the caller's explicit choice and never gives way to another one.
"""
from __future__ import annotations

import ctypes

import numpy as np

from . import _build

__all__ = ["load", "kalman_filter", "rts_smoother"]

_DP = ctypes.POINTER(ctypes.c_double)
_UB = ctypes.POINTER(ctypes.c_ubyte)


def load() -> ctypes.CDLL:
    """libkalman.so with its argument types declared, built when missing."""
    lib = _build.load("kalman")
    lib.kalman_filter.restype = ctypes.c_int
    lib.kalman_filter.argtypes = [_DP, _DP, _DP, _DP, _UB, _DP, ctypes.c_double, ctypes.c_long,
                                  ctypes.c_int, _DP, _DP, _DP, _DP, _DP]
    lib.rts_smoother.restype = ctypes.c_int
    lib.rts_smoother.argtypes = [_DP, _DP, _DP, _DP, _DP, ctypes.c_long, ctypes.c_int, _DP, _DP]
    return lib


def _f64(a, shape=None):
    a = np.ascontiguousarray(a, dtype=np.float64)
    return a if shape is None else a.reshape(shape)


def _ptr(a):
    return a.ctypes.data_as(_DP)


def kalman_filter(A, Q, H, ys, mask, P0, sigma2):
    """The filter over A, Q (N-1, s, s), H (1, s) or (s,), ys (N,), mask (N,)
    bool (False: predict only), P0 (s, s). Returns (log-likelihood, ms (N, s,
    1), Ps (N, s, s), mpreds (N, s, 1), Ppreds (N, s, s)) as float64 numpy."""
    lib = load()
    ys = _f64(ys, (-1,))
    P0 = _f64(P0)
    N, s = ys.shape[0], P0.shape[0]
    A, Q = _f64(A, (N - 1, s, s)), _f64(Q, (N - 1, s, s))
    H = _f64(H, (s,))
    mask = np.ascontiguousarray(np.asarray(mask).reshape(N), dtype=np.uint8)
    ms, Ps = np.zeros((N, s)), np.zeros((N, s, s))
    mpreds, Ppreds = np.zeros((N, s)), np.zeros((N, s, s))
    ll = np.zeros(1)
    rc = lib.kalman_filter(_ptr(A), _ptr(Q), _ptr(H), _ptr(ys), mask.ctypes.data_as(_UB),
                           _ptr(P0), float(sigma2), N, s, _ptr(ms), _ptr(Ps), _ptr(mpreds),
                           _ptr(Ppreds), _ptr(ll))
    if rc != 0:
        raise RuntimeError(f"kalman_filter failed (rc={rc})")
    return float(ll[0]), ms[:, :, None], Ps, mpreds[:, :, None], Ppreds


def rts_smoother(ms, Ps, mpreds, Ppreds, A):
    """The RTS smoother over the filter's outputs; returns (ms_s (N, s, 1),
    Ps_s (N, s, s)). A predicted covariance that cannot be inverted raises."""
    lib = load()
    Ps = _f64(Ps)
    N, s = Ps.shape[0], Ps.shape[1]
    ms, mpreds = _f64(ms, (N, s)), _f64(mpreds, (N, s))
    Ppreds, A = _f64(Ppreds), _f64(A, (N - 1, s, s))
    ms_s, Ps_s = np.zeros((N, s)), np.zeros((N, s, s))
    rc = lib.rts_smoother(_ptr(ms), _ptr(Ps), _ptr(mpreds), _ptr(Ppreds), _ptr(A), N, s,
                          _ptr(ms_s), _ptr(Ps_s))
    if rc != 0:
        raise RuntimeError(f"rts_smoother failed (rc={rc})")
    return ms_s[:, :, None], Ps_s
