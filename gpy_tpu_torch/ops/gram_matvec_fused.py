"""Fused stationary Gram-matvec (kernel B5), its gradient moments (B6), their
plain twins and the differentiable form.

Counterpart of gpy_tpu/ops/pallas_gram_matvec.py, with its public names.
(K_family(X, X2) + diag(noise)) @ V is computed without storing the Gram:
on a CUDA tensor by the kernel in csrc/gram_matvec_fused.cu (one launch per
call, counted in `matvec_launches`), on a CPU tensor by
`stationary_gram_matvec_plain`, the same function in torch ops, built in
row blocks so that it never holds the whole Gram. The moments of the
backward are `gram_moments_cuda` (counted in `moments_launches`) or
`gram_moments_plain`. There is no fallback from one to the other: a CUDA
tensor launches the kernel or raises.

Like the reference, both kernels compute in float32 (X / lengthscale and V
are cast) and the wrapper adds noise * V and casts back to V's dtype. The
accum modes of the reference ("exact" 6-pass, "f32x3" 3-pass, "fast"
1-pass bf16 on the TPU's matrix unit) all run the same contraction here;
the string is still validated. B5 contracts in float32 FFMA for R <= 16
(the CG of an NLML: 1 + n_probes columns; a 3xTF32 contraction there was
measured and dropped: PERF.md, the B5 findings) and on the tensor cores for
R > 16 (a predict's n* columns): 3xTF32 (K and V split into TF32 hi and lo,
lo.hi + hi.lo + hi.hi), each 32-column tile's sum promoted once into a
float32 running sum. Both are at least as accurate as the reference's
3-pass "f32x3" and 1-pass "fast". B6 forms W = G V' in FFMA where D <= 8
and R <= 16 (its register-tile kernel) and in 3xTF32 on the tensor cores
elsewhere (its mma kernel).

r2: B5 forms it as the reference does above D = 8 (its :98-106), by the
expansion |x|^2 + |x'|^2 - 2 x.x' clamped at 0, where D > 8 and R <= 16 (on
the card with the cross term in 3xTF32 on the tensor cores; the plain twin
sums direct differences), and by direct differences everywhere else. Above
D = 8 the wrapper first subtracts the columns' per-dimension mean from both
sides (`_centred`): distances do not change, |x|^2 falls, and with it the
expansion's rounding. Deviation: the reference's diagonal carries the
expansion's cancellation residual (its :178-184); here the kernel is told
which rows are the columns' own (`diag_offset`: 0 for a square Gram, a row
slab's first row for a slab of one) and sets r2 = 0 there, so K_ii is
exactly v at every D.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["rbf_gram_matvec_fused", "stationary_gram_matvec_fused",
           "kern_gram_matvec_fused", "fused_available",
           "stationary_gram_matvec_fused_diff", "kern_gram_matvec_fused_diff",
           "stationary_gram_matvec_plain", "stationary_gram_matvec_cuda",
           "gram_moments_plain", "gram_moments_cuda",
           "matvec_launches", "moments_launches"]

# stationary families sharing the fused tile structure (the reference's :46)
_FAMILIES = {"RBF": 0, "ExpQuad": 0, "Matern32": 1, "Matern52": 2,
             "Exponential": 3, "OU": 3}
_ACCUM = ("exact", "f32x3", "fast")

# launches of each CUDA kernel since import (or since a caller reset them)
matvec_launches = 0
moments_launches = 0

_MOM_ROWS = 128          # rows a B6 block (both kernels)
_MOM_ROW = 128           # doubles of a B6 partial row (D + 1 <= 128)
_MOM_SPLITS = 4          # column splits of B6's mma kernel, at most
_MAX_GRID_Y = 65535
_WIDE_COLS = 128         # R columns per grid.y step (B5's tensor-core kernel)
_CENTRE_MIN_D = 9        # from here B5 forms r2 by the expansion (R <= 16)
_MAX_MOMENTS = 128       # D + 1, the reference's lane limit
_PLAIN_BLOCK_ENTRIES = 2**25
_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)
_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("gram_matvec_fused")
        p = ctypes.c_void_p
        lib.gram_matvec_fused_f32.argtypes = ([p] * 5 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 3
                                              + [ctypes.c_int64, p])
        lib.gram_matvec_fused_f32.restype = ctypes.c_int
        lib.gram_moments_f32.argtypes = [p] * 6 + [ctypes.c_int64] + [ctypes.c_int] * 3 + [p]
        lib.gram_moments_f32.restype = ctypes.c_int
        lib.gram_matvec_fused_error_string.argtypes = [ctypes.c_int]
        lib.gram_matvec_fused_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def fused_available(kern, device=None) -> bool:
    """True if the fused path supports this kernel on this device.

    Deviation: the reference is true on a TPU only, and elsewhere falls back
    to the blockwise path; here it is true for the _FAMILIES kernels on
    "cuda" (the kernel) and on "cpu" (its plain twin)."""
    if device is None:
        p = kern._first_param()
        device = p.device if p is not None else "cpu"
    return type(kern).__name__ in _FAMILIES and torch.device(device).type in ("cuda", "cpu")


def _check_accum(accum):
    if accum not in _ACCUM:
        # an unknown string must not fall through to some default precision
        raise ValueError(f"accum must be exact|f32x3|fast, got {accum!r}")


# --- plain twins ------------------------------------------------------------

def _direct_r2(Xa, Xb):
    r2 = (Xa[:, 0:1] - Xb[None, :, 0]) ** 2
    for d in range(1, Xa.shape[1]):
        r2 = r2 + (Xa[:, d:d + 1] - Xb[None, :, d]) ** 2
    return r2


def _k_of_r2(family, r2, v):
    """K from the squared scaled distance (the reference's _k_of_r2 :56-67)."""
    if family == 0:
        return v * torch.exp(-0.5 * r2)
    r = torch.sqrt(r2 + 1e-30)
    if family == 1:
        s = _SQRT3 * r
        return v * (1.0 + s) * torch.exp(-s)
    if family == 2:
        s = _SQRT5 * r
        return v * (1.0 + s + s * s / 3.0) * torch.exp(-s)
    return v * torch.exp(-r)


def _neg_dk_dr2(family, r2, v):
    """-dK/d(r^2) (the reference's _dk_dr2 :253-265, negated)."""
    if family == 0:
        return 0.5 * v * torch.exp(-0.5 * r2)
    r = torch.sqrt(r2 + 1e-30)
    if family == 1:
        return 1.5 * v * torch.exp(-_SQRT3 * r)
    if family == 2:
        s = _SQRT5 * r
        return (5.0 / 6.0) * v * (1.0 + s) * torch.exp(-s)
    return 0.5 * v * torch.exp(-r) / r


def _row_block(M):
    return max(1, _PLAIN_BLOCK_ENTRIES // max(M, 1))


def _r2_block(Xs, X2s, i, b, diag_offset):
    """r2 of rows [i, i + b) of Xs against X2s, 0 where row r of Xs is row
    r + diag_offset of X2s (diag_offset >= 0)."""
    r2 = _direct_r2(Xs[i:i + b], X2s)
    if diag_offset >= 0:
        rows = torch.arange(i, min(i + b, Xs.shape[0]), device=Xs.device)
        rows = rows[rows + diag_offset < X2s.shape[0]]
        r2 = r2.index_put((rows - i, rows + diag_offset), r2.new_zeros(()))
    return r2


def stationary_gram_matvec_plain(Xs, X2s, V, v, family=0, diag_offset=-1):
    """K_family(Xs, X2s) @ V in torch ops on scaled inputs, in row blocks
    of at most 2**25 Gram entries; differentiable by autograd. r2 is 0 where
    row r of Xs is row r + diag_offset of X2s (diag_offset >= 0), as the
    kernel sets it."""
    b = _row_block(X2s.shape[0])
    return torch.cat([_k_of_r2(family, _r2_block(Xs, X2s, i, b, diag_offset), v) @ V
                      for i in range(0, Xs.shape[0], b)], dim=0)


def gram_moments_plain(Xs, G, V, v, family=0):
    """(D+1,) moments of the backward on the square Gram of Xs, in torch ops
    and row blocks: [sum W K / v, sum W (-dK/dr2) dx_d^2 for each d] with
    W = G V'."""
    N, D = Xs.shape
    b = _row_block(N)
    s0 = torch.zeros((), dtype=Xs.dtype, device=Xs.device)
    mom = torch.zeros(D, dtype=Xs.dtype, device=Xs.device)
    for i in range(0, N, b):
        xa = Xs[i:i + b]
        W = G[i:i + b] @ V.T
        r2 = _direct_r2(xa, Xs)
        s0 = s0 + torch.sum(W * _k_of_r2(family, r2, v))
        Wp = W * _neg_dk_dr2(family, r2, v)
        mom = mom + torch.stack([torch.sum(Wp * (xa[:, d:d + 1] - Xs[None, :, d]) ** 2)
                                 for d in range(D)])
    return torch.cat([(s0 / v).reshape(1), mom])


# --- CUDA kernels -----------------------------------------------------------

def _check(fn, tensors, first):
    for name, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{fn}: {name} is on {t.device}, not a CUDA device")
        if t.device != first.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, {tensors[0][0]} on {first.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} is {t.dtype}, not float32")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} is not contiguous")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _aligned16(t):
    """t when its data is 16-byte aligned, else a copy (which is)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stationary_gram_matvec_cuda(Xs, X2s, V, v, family=0, diag_offset=-1):
    """The B5 kernel on scaled float32 inputs: K_family(Xs, X2s) @ V, one
    launch on the current stream. diag_offset >= 0: row r of Xs is row
    r + diag_offset of X2s (0 for a square Gram), where r2 is 0 exactly; -1:
    none. X2s and V are copied when their data is not 16-byte aligned (the
    kernel copies their tiles 16 bytes at a time)."""
    global matvec_launches
    fn = "stationary_gram_matvec_cuda"
    _check(fn, [("Xs", Xs), ("X2s", X2s), ("V", V), ("v", v)], Xs)
    if Xs.ndim != 2 or X2s.ndim != 2 or Xs.shape[1] != X2s.shape[1] or Xs.shape[1] < 1:
        raise ValueError(f"{fn}: shapes {tuple(Xs.shape)} and {tuple(X2s.shape)} are not "
                         "(N, D) and (M, D) with D >= 1")
    if V.ndim != 2 or V.shape[0] != X2s.shape[0]:
        raise ValueError(f"{fn}: V is {tuple(V.shape)}, not (M={X2s.shape[0]}, R)")
    if v.numel() != 1:
        raise ValueError(f"{fn}: v has {v.numel()} elements, not 1")
    if family not in (0, 1, 2, 3):
        raise ValueError(f"{fn}: unknown family {family!r}")
    N, D = Xs.shape
    M, R = V.shape
    if -(-R // _WIDE_COLS) > _MAX_GRID_Y or D >= 2**31:
        raise ValueError(f"{fn}: R={R} or D={D} is too large")
    if diag_offset < -1:
        raise ValueError(f"{fn}: diag_offset={diag_offset} is neither a row offset nor -1")
    out = torch.empty((N, R), dtype=torch.float32, device=Xs.device)
    if N == 0 or R == 0:
        return out
    X2s, V = _aligned16(X2s), _aligned16(V)
    lib = _lib()
    with torch.cuda.device(Xs.device):
        rc = lib.gram_matvec_fused_f32(Xs.data_ptr(), X2s.data_ptr(), v.data_ptr(), V.data_ptr(),
                                       out.data_ptr(), N, M, D, R, family, int(diag_offset),
                                       _stream(Xs))
    if rc != 0:
        raise RuntimeError(f"gram_matvec_fused kernel launch failed: "
                           f"{lib.gram_matvec_fused_error_string(rc).decode()}")
    matvec_launches += 1
    return out


def gram_moments_cuda(Xs, G, V, v, family=0):
    """The B6 kernel: (D+1,) float64 moments on the square Gram of Xs (one
    tile pass and a fixed-order reduction, on the current stream; past 64
    columns of V, or fewer where D > 64, the mma kernel adds several passes
    into the same rows). Xs and V are copied when their data is not 16-byte
    aligned (the register-tile kernel copies their tiles 16 bytes at a
    time)."""
    global moments_launches
    fn = "gram_moments_cuda"
    _check(fn, [("Xs", Xs), ("G", G), ("V", V), ("v", v)], Xs)
    if Xs.ndim != 2 or Xs.shape[1] < 1 or G.ndim != 2 or G.shape != V.shape \
            or G.shape[0] != Xs.shape[0] or G.shape[1] < 1:
        raise ValueError(f"{fn}: shapes {tuple(Xs.shape)}, {tuple(G.shape)}, {tuple(V.shape)} "
                         "are not (N, D), (N, R), (N, R) with D, R >= 1")
    if v.numel() != 1:
        raise ValueError(f"{fn}: v has {v.numel()} elements, not 1")
    if family not in (0, 1, 2, 3):
        raise ValueError(f"{fn}: unknown family {family!r}")
    N, D = Xs.shape
    R = G.shape[1]
    if D + 1 > _MAX_MOMENTS or R >= 2**31:
        raise ValueError(f"{fn}: D={D} exceeds {_MAX_MOMENTS - 1} or R={R} is too large")
    out = torch.empty(D + 1, dtype=torch.float64, device=Xs.device)
    if N == 0:
        return out.zero_()
    Xs, V = _aligned16(Xs), _aligned16(V)
    partial = torch.empty(-(-N // _MOM_ROWS) * _MOM_SPLITS * _MOM_ROW, dtype=torch.float64,
                          device=Xs.device)
    lib = _lib()
    with torch.cuda.device(Xs.device):
        rc = lib.gram_moments_f32(Xs.data_ptr(), G.data_ptr(), V.data_ptr(), v.data_ptr(),
                                  partial.data_ptr(), out.data_ptr(), N, D, R, family,
                                  _stream(Xs))
    if rc != 0:
        raise RuntimeError(f"gram_moments kernel launch failed: "
                           f"{lib.gram_matvec_fused_error_string(rc).decode()}")
    moments_launches += 1
    return out


def _matvec(Xs, X2s, V, v, family, diag_offset):
    if Xs.device.type == "cpu":
        return stationary_gram_matvec_plain(Xs, X2s, V, v, family, diag_offset)
    return stationary_gram_matvec_cuda(Xs.contiguous(), X2s.contiguous(), V.contiguous(),
                                       v.contiguous(), family, diag_offset)


def _centred(Xs, X2s):
    """Xs and X2s (the same tensor for a square Gram) less one per-dimension
    mean, the columns': distances do not change, and for D >= _CENTRE_MIN_D,
    where B5 forms r2 by the expansion, |x|^2 and the expansion's rounding
    fall. Below it the inputs are returned as they are."""
    if Xs.shape[1] < _CENTRE_MIN_D:
        return Xs, X2s
    mu = X2s.mean(dim=0)
    Xc = Xs - mu
    return Xc, (Xc if X2s is Xs else X2s - mu)


def _moments(Xs, G, V, v, family):
    if Xs.device.type == "cpu":
        return gram_moments_plain(Xs, G, V, v, family)
    return gram_moments_cuda(Xs.contiguous(), G.contiguous(), V.contiguous(),
                             v.contiguous(), family)


# --- public API (the reference's names) -------------------------------------

def _as(x, like, dtype=None):
    return torch.as_tensor(x, dtype=dtype or like.dtype, device=like.device)


def stationary_gram_matvec_fused(X, V, variance, lengthscale, family=0, noise=None,
                                 X2=None, accum="exact", diag_offset=None):
    """(K_family(scaled dist) + diag(noise)) @ V, fused (family: _FAMILIES).

    X: (N, D) rows of the product; X2: (M, D) columns (default X, the square
    Gram); V: (M, R) or (M,); lengthscale a scalar or (D,). With X2 given the
    product is the rectangular slab K(X, X2) @ V, and `noise` is refused;
    diag_offset = i0 says X is X2[i0:i0 + N] (a row slab of the square
    Gram), whose diagonal entries then take r2 = 0 as the square Gram's do.
    Not differentiable (computed under no_grad): the differentiable form is
    stationary_gram_matvec_fused_diff.
    """
    _check_accum(accum)
    if X2 is not None and noise is not None:
        raise ValueError("noise diagonal undefined for rectangular slabs")
    if X2 is None and diag_offset not in (None, 0):
        raise ValueError("diag_offset of a square Gram is 0")
    with torch.no_grad():
        V2 = V if V.ndim == 2 else V[:, None]
        ls = _as(lengthscale, X)
        Xs = X / ls
        Xs, Xc = _centred(Xs, Xs if X2 is None else X2 / ls)
        Xs = Xs.to(torch.float32)
        Xc = Xs if X2 is None else Xc.to(torch.float32)
        v = _as(variance, X, torch.float32).reshape(1)
        diag = 0 if X2 is None else (-1 if diag_offset is None else int(diag_offset))
        out = _matvec(Xs, Xc, V2.to(torch.float32), v, int(family), diag)
        if noise is not None:
            out = out + noise[:, None] * V2
        out = out.to(V2.dtype)
    return out if V.ndim == 2 else out[:, 0]


def rbf_gram_matvec_fused(X, V, variance, lengthscale, noise=None, accum="exact"):
    """RBF specialization of stationary_gram_matvec_fused."""
    return stationary_gram_matvec_fused(X, V, variance, lengthscale, family=0,
                                        noise=noise, accum=accum)


def kern_gram_matvec_fused(kern, X, V, noise=None, X2=None, accum="exact", diag_offset=None):
    """Dispatch on a kernel object (must satisfy fused_available)."""
    fam = _FAMILIES[type(kern).__name__]
    return stationary_gram_matvec_fused(
        kern._slice(X), V, kern.variance.values, kern.lengthscale.values, family=fam,
        noise=noise, X2=None if X2 is None else kern._slice(X2), accum=accum,
        diag_offset=diag_offset)


class _FusedDiffFn(torch.autograd.Function):
    """(K + diag(noise)) @ V with the reference's custom VJP (:351-381):
        dV = (K + noise) @ G     (one more B5 launch, only when V needs it)
        dvariance, dlengthscale  from the B6 moments
        dnoise_i = sum_r G_ir V_ir;  dX = 0 (X is data)."""

    @staticmethod
    def forward(ctx, X, V, variance, lengthscale, noise, family, accum):
        y = stationary_gram_matvec_fused(X, V, variance, lengthscale, family=family,
                                         noise=noise, accum=accum)
        ctx.save_for_backward(X, V, variance, lengthscale, noise)
        ctx.family = family
        ctx.accum = accum
        return y

    @staticmethod
    def backward(ctx, G):
        X, V, variance, lengthscale, noise = ctx.saved_tensors
        need = ctx.needs_input_grad
        G2 = G if G.ndim == 2 else G[:, None]
        V2 = V if V.ndim == 2 else V[:, None]
        dX = dV = dvar = dls = dnoise = None
        if need[1]:
            dV = stationary_gram_matvec_fused(X, G2, variance, lengthscale, family=ctx.family,
                                              noise=noise, accum=ctx.accum)
            dV = (dV if V.ndim == 2 else dV[:, 0]).to(V.dtype)
        if need[2] or need[3]:
            D = X.shape[1]
            ls = lengthscale.to(X.dtype)
            Xs = (X / ls).to(torch.float32)
            v = variance.detach().to(torch.float32).reshape(1)
            mom = _moments(Xs, G2.to(torch.float32), V2.to(torch.float32), v, ctx.family)
            dvar = mom[0].to(variance.dtype).reshape(variance.shape)
            ls_b = torch.broadcast_to(ls, (D,))
            dl_full = (2.0 / ls_b) * mom[1:1 + D].to(ls_b.dtype)
            if lengthscale.numel() == 1:
                dls = torch.sum(dl_full).to(lengthscale.dtype).reshape(lengthscale.shape)
            else:
                dls = dl_full.to(lengthscale.dtype)
        if need[4]:
            dnoise = torch.sum(G2 * V2, dim=1).to(noise.dtype)
        if need[0]:
            dX = torch.zeros_like(X)
        return dX, dV, dvar, dls, dnoise, None, None


def stationary_gram_matvec_fused_diff(X, V, variance, lengthscale, noise, family=0,
                                      accum="f32x3"):
    """Differentiable (K_family + diag(noise)) @ V through the fused kernels.

    Square Gram only; gradients flow to V, variance, lengthscale and noise.
    X is data (zero gradient). `noise` must be an (N,) tensor.
    """
    _check_accum(accum)
    variance = _as(variance, X)
    lengthscale = _as(lengthscale, X)
    return _FusedDiffFn.apply(X, V, variance, lengthscale, noise, int(family), accum)


def kern_gram_matvec_fused_diff(kern, X, V, noise, accum="f32x3"):
    """Differentiable dispatch on a kernel object (square Gram + noise)."""
    fam = _FAMILIES[type(kern).__name__]
    return stationary_gram_matvec_fused_diff(
        kern._slice(X), V, kern.variance.values, kern.lengthscale.values, noise, fam, accum)
