"""Input warping (the Kumaraswamy CDF) for InputWarpedGP.

Counterpart of gpy_tpu/util/input_warping_functions.py (GPy/util/
input_warping_functions.py: InputWarpingFunction, KumarWarping; Snoek et
al. 2014).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..core.module import Module
from ..core.transformations import Logexp

__all__ = ["InputWarpingFunction", "KumarWarping"]


class InputWarpingFunction(Module):
    def f(self, X):
        raise NotImplementedError


class KumarWarping(InputWarpingFunction):
    """x -> 1 - (1 - x^a)^b on each warped column, x first scaled to [0, 1]
    by Xmin - epsilon and Xmax + epsilon (the training inputs' range when not
    given) and clipped to [1e-9, 1 - 1e-9]; a and b positive, one each per
    warped column."""

    def __init__(self, X, warping_indices=None, epsilon=1e-6, Xmin=None, Xmax=None,
                 name="kumar_warping", device=None, dtype=None):
        super().__init__(name=name, device=device, dtype=dtype)
        X = np.asarray(X.cpu().numpy() if torch.is_tensor(X) else X, dtype=np.float64)
        if warping_indices is None:
            warping_indices = list(range(X.shape[1]))
        self.warping_indices = [int(i) for i in warping_indices]
        self.epsilon = float(epsilon)
        if Xmin is None:
            Xmin = X.min(0)
        if Xmax is None:
            Xmax = X.max(0)
        self.Xmin = np.asarray(Xmin, dtype=np.float64) - self.epsilon
        self.Xmax = np.asarray(Xmax, dtype=np.float64) + self.epsilon
        # the range on the device once: a copy in each call would read the host
        c = dict(dtype=resolve_dtype(dtype), device=resolve_device(device))
        self._lo = torch.tensor(self.Xmin, **c)
        self._width = torch.tensor(self.Xmax - self.Xmin, **c)
        n = len(self.warping_indices)
        self._add_param("a", np.ones(n), transform=Logexp())
        self._add_param("b", np.ones(n), transform=Logexp())

    def f(self, X):
        a, b = self.a.values, self.b.values
        cols = []
        j = 0
        for i in range(X.shape[1]):
            if i in self.warping_indices:
                x = torch.clamp((X[:, i] - self._lo[i]) / self._width[i], 1e-9, 1 - 1e-9)
                cols.append(1.0 - (1.0 - x ** a[j]) ** b[j])
                j += 1
            else:
                cols.append(X[:, i])
        return torch.stack(cols, dim=1)
