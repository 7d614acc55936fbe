"""Small math helpers on tensors.

Counterpart of gpy_tpu/util/misc.py (GPy/util/univariate_Gaussian.py,
squashers.py, functions.py, diag.py, block_matrices.py, classification.py,
subarray_and_sorting.py and misc.py). The Gaussian helpers map
jax.scipy.special onto torch.special: Phi is erfc(-x / sqrt 2) / 2
(util/functions.normcdf: torch.special.ndtr's CPU kernel loses its
relative accuracy below 0 and returns 0 from x ~ -8.3), log Phi is
log_ndtr (finite far below -40, and within 2e-13 of the true value on
both tails) and the quantile is ndtri. derivLogCdfNormal
is phi/Phi through their logs, so it grows like -x in the far left tail
instead of dividing two underflowed numbers.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .functions import normcdf as _erfc_normcdf

__all__ = [
    "std_norm_pdf", "std_norm_cdf", "logPhi", "derivLogCdfNormal", "cdfNormal",
    "sigmoid", "single_softmax", "clip_exp", "normcdf",
    "diag_view", "diag_add",
    "block", "unblock", "block_dot",
    "conf_matrix",
    "logPdfNormal", "logCdfNormal", "inv_std_norm_cdf",
    "common_subarrays",
    "safe_exp", "safe_square", "safe_cube", "safe_quad", "safe_three_times",
    "chain_1", "chain_2", "chain_3", "linear_grid", "kmm_init", "param_to_array",
    "opt_wrapper",
]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_F64_MAX = np.finfo(np.float64).max


# --- univariate Gaussian (GPy: util/univariate_Gaussian.py) ---------------
def logPdfNormal(z):
    return -0.5 * z * z - _HALF_LOG_2PI


def std_norm_pdf(x):
    # exp(-x^2/2) / sqrt(2 pi), as jax.scipy.stats.norm.pdf: its subnormal
    # tail (|x| > 37.5) survives, where exp(logPdfNormal) flushes it to 0
    return torch.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


def std_norm_cdf(x):
    return _erfc_normcdf(x)


cdfNormal = normcdf = std_norm_cdf


def logPhi(x):
    return torch.special.log_ndtr(x)


logCdfNormal = logPhi


def inv_std_norm_cdf(x):
    """Quantile of the standard normal (GPy: util/univariate_Gaussian.py:14)."""
    return torch.special.ndtri(x)


def derivLogCdfNormal(x):
    """phi(x)/Phi(x), stable in the tail."""
    return torch.exp(logPdfNormal(x) - logPhi(x))


# --- squashers (GPy: util/squashers.py) -----------------------------------
def sigmoid(x):
    return torch.sigmoid(x)


def single_softmax(x):
    return torch.softmax(x, dim=-1)


def clip_exp(x, lower=-250.0, upper=250.0):
    return torch.exp(torch.clamp(x, lower, upper))


# --- diag ops (GPy: util/diag.py) ------------------------------------------
def diag_view(A):
    return torch.diagonal(A)


def diag_add(A, d):
    from .linalg import diag_add as _da

    return _da(A, d)


# --- block matrices (GPy: util/block_matrices.py) --------------------------
def block(blocks):
    """2-D list of blocks -> dense matrix (np.block)."""
    return torch.cat([torch.cat(list(row), dim=1) for row in blocks], dim=0)


def unblock(A, row_sizes, col_sizes):
    out = []
    r0 = 0
    for r in row_sizes:
        row = []
        c0 = 0
        for c in col_sizes:
            row.append(A[r0:r0 + r, c0:c0 + c])
            c0 += c
        out.append(row)
        r0 += r
    return out


def block_dot(A_blocks, B_blocks):
    n = len(A_blocks)
    m = len(B_blocks[0])
    k = len(B_blocks)
    return [
        [sum(A_blocks[i][l] @ B_blocks[l][j] for l in range(k)) for j in range(m)]
        for i in range(n)
    ]


# --- classification metrics (GPy: util/classification.py) ------------------
def _numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def conf_matrix(p, labels, names=("+1", "-1"), threshold=0.5, show=False):
    """Binary confusion matrix from probabilities. Returns (matrix, accuracy)."""
    p = _numpy(p).reshape(-1)
    y = _numpy(labels).reshape(-1)
    pred = (p > threshold).astype(int)
    tp = int(np.sum((pred == 1) & (y == 1)))
    tn = int(np.sum((pred == 0) & (y == 0)))
    fp = int(np.sum((pred == 1) & (y == 0)))
    fn = int(np.sum((pred == 0) & (y == 1)))
    M = np.array([[tp, fn], [fp, tn]])
    acc = (tp + tn) / max(len(y), 1)
    if show:
        print(f"conf matrix {names}:\n{M}\naccuracy: {acc:.3f}")
    return M, acc


# --- subarrays (GPy: util/subarray_and_sorting.py) --------------------------
def common_subarrays(X, axis=0):
    """Map from unique rows (as tuples) to the index list where they occur."""
    X = _numpy(X)
    if axis == 1:
        X = X.T
    out = {}
    for i, row in enumerate(X):
        out.setdefault(tuple(row.tolist()), []).append(i)
    return out


# --- GPy util/misc.py parity helpers (misc.py:16-122) ------------------------
def safe_exp(f):
    """exp with clipping to avoid overflow (GPy misc.py:16)."""
    return torch.exp(torch.clamp(f, max=math.log(_F64_MAX) - 1.0))


def safe_square(f):
    clip = math.sqrt(_F64_MAX) / 2.0
    return torch.square(torch.clamp(f, -clip, clip))


def safe_cube(f):
    clip = np.cbrt(_F64_MAX) / 2.0
    return torch.clamp(f, -clip, clip) ** 3


def safe_quad(f):
    clip = _F64_MAX ** 0.25 / 2.0
    return torch.clamp(f, -clip, clip) ** 4


def safe_three_times(f):
    return 3.0 * torch.clamp(f, -_F64_MAX / 4.0, _F64_MAX / 4.0)


def chain_1(df_dg, dg_dx):
    """d/dx f(g(x)) (GPy misc.py:36; autograd makes these unnecessary
    inside the package)."""
    return df_dg * dg_dx


def chain_2(d2f_dg2, dg_dx, df_dg, d2g_dx2):
    """d2/dx2 f(g(x))."""
    return d2f_dg2 * (dg_dx**2) + df_dg * d2g_dx2


def chain_3(d3f_dg3, dg_dx, d2f_dg2, d2g_dx2, df_dg, d3g_dx3):
    """d3/dx3 f(g(x))."""
    return d3f_dg3 * (dg_dx**3) + 3.0 * d2f_dg2 * dg_dx * d2g_dx2 + df_dg * d3g_dx3


def linear_grid(D, n=100, min_max=(-100, 100)):
    """n linearly spaced points replicated over D columns (GPy misc.py:81)."""
    g = np.linspace(min_max[0], min_max[1], n)
    return np.ones((n, D)) * g[:, None]


def kmm_init(X, m=10, seed=None):
    """kmeans++-style inducing-point initialization (GPy misc.py:96):
    iteratively draw points with probability proportional to squared
    distance from the last chosen point. numpy on the host, with the
    reference's draws from one seed."""
    if m < 1:
        raise ValueError(f"kmm_init needs m >= 1, got {m}")
    X = _numpy(X)
    rng = np.random.default_rng(seed)
    sq = np.sum(X * X, axis=1)
    D = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (X @ X.T), 0.0)
    s = int(rng.permutation(X.shape[0])[0])
    chosen = [s]
    prob = D[s] / D[s].sum()
    for _ in range(m - 1):
        s = int(rng.choice(X.shape[0], p=prob))
        chosen.append(s)
        prob = D[s] / D[s].sum()
    return X[np.array(chosen)]


def param_to_array(*param):
    """GPy misc.py:125: parameters (handles or tensors) as numpy arrays."""
    arrays = [_numpy(p) for p in param]
    return arrays[0] if len(arrays) == 1 else arrays


def opt_wrapper(m, **kwargs):
    """Optimize a model and return it (GPy misc.py:72)."""
    m.optimize(**kwargs)
    return m
