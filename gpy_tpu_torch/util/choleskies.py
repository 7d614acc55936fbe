"""Packed-triangular utilities for flat Cholesky parameterizations.

Counterpart of gpy_tpu/util/choleskies.py:19-40 (GPy/util/choleskies.py).
The packing order is GPy's: the lower triangle in np.tril_indices order, so a
flat `q_u_chol` carries between the packages unchanged. Gradients through the
packing are autograd's.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["flat_to_triang", "triang_to_flat", "num_flat", "indices"]


def num_flat(M: int) -> int:
    return M * (M + 1) // 2


def indices(M: int):
    return np.tril_indices(M)


def _tril_index(M: int, device) -> tuple:
    rows, cols = np.tril_indices(M)
    return (torch.as_tensor(rows, device=device), torch.as_tensor(cols, device=device))


def flat_to_triang(flat: torch.Tensor, M: int) -> torch.Tensor:
    """(num_flat, D) -> (D, M, M) lower triangular."""
    rows, cols = _tril_index(M, flat.device)
    out = flat.new_zeros((flat.shape[1], M, M))
    out[:, rows, cols] = flat.T
    return out


def triang_to_flat(L: torch.Tensor) -> torch.Tensor:
    """(D, M, M) -> (num_flat, D)."""
    rows, cols = _tril_index(L.shape[-1], L.device)
    return L[:, rows, cols].T
