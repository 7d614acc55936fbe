"""Gauss-Kronrod quadrature on [a, b] and over the real line.

Counterpart of gpy_tpu/util/quad_integrate.py (GPy/util/quad_integrate.py:
the quadgk rules that likelihood.py:312-357 uses for integrals that
Gauss-Hermite does not cover). The nodes are tensors on `device` ("cuda"
unless the caller passes "cpu") and `dtype`; `f` is a torch callable that
maps a tensor of nodes to a tensor of values.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype

__all__ = ["quadgk", "quadgk_int", "gk_nodes"]

# 15-point Gauss-Kronrod nodes/weights on [-1, 1] (standard table)
_XGK = np.array([
    -0.991455371120813, -0.949107912342759, -0.864864423359769,
    -0.741531185599394, -0.586087235467691, -0.405845151377397,
    -0.207784955007898, 0.0, 0.207784955007898, 0.405845151377397,
    0.586087235467691, 0.741531185599394, 0.864864423359769,
    0.949107912342759, 0.991455371120813,
])
_WGK = np.array([
    0.022935322010529, 0.063092092629979, 0.104790010322250,
    0.140653259715525, 0.169004726639267, 0.190350578064785,
    0.204432940075298, 0.209482141084728, 0.204432940075298,
    0.190350578064785, 0.169004726639267, 0.140653259715525,
    0.104790010322250, 0.063092092629979, 0.022935322010529,
])


def gk_nodes(a: float, b: float, levels: int = 4, device=None, dtype=None):
    """Composite GK nodes and weights on [a, b] split into 2^levels panels."""
    panels = 2 ** levels
    edges = np.linspace(a, b, panels + 1)
    xs, ws = [], []
    for i in range(panels):
        lo, hi = edges[i], edges[i + 1]
        h = 0.5 * (hi - lo)
        xs.append(h * _XGK + 0.5 * (lo + hi))
        ws.append(h * _WGK)
    kw = {"device": resolve_device(device), "dtype": resolve_dtype(dtype)}
    return torch.tensor(np.concatenate(xs), **kw), torch.tensor(np.concatenate(ws), **kw)


def quadgk(f, a: float, b: float, levels: int = 4, device=None, dtype=None):
    """Integrate f over [a, b] (f vectorized over a tensor of nodes)."""
    x, w = gk_nodes(a, b, levels, device, dtype)
    return torch.sum(w * f(x))


def quadgk_int(f, scale: float = 10.0, levels: int = 5, device=None, dtype=None):
    """Integrate f over (-inf, inf) through x = scale * tan(u)."""
    u, w = gk_nodes(-math.pi / 2 + 1e-6, math.pi / 2 - 1e-6, levels, device, dtype)
    x = scale * torch.tan(u)
    jac = scale / torch.cos(u) ** 2
    return torch.sum(w * f(x) * jac)
