"""Kronecker-structured exact GP regression (a separable kernel over a grid).

Counterpart of gpy_tpu/models/gp_kronecker_gaussian_regression.py:26-133
(GPy/models/gp_kronecker_gaussian_regression.py:9, gp_grid_regression.py:10
and core/gp_grid.py). Both models evaluate the log marginal through
inference/grid.py: one eigendecomposition per axis and tensor rotations,
O(sum n_d^3 + N sum n_d) instead of O(N^3), with a gradient that does not
differentiate the eigenvectors (ROADMAP C(w)). They are Models, not GPs:
under HMC chains and parallel restarts their rows are evaluated one after
the other (Model._batched_objective).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..core.model import Model
from ..core.module import check_placement
from ..core.transformations import Logexp
from ..inference.grid import GaussianGridInference, rotate_axis
from ..kern import RBF

__all__ = ["GPKroneckerGaussianRegression", "GPRegressionGrid"]


class _GridModel(Model):
    """Data on the model's device, the noise parameter and the grid
    predict shared by the two models."""

    def __init__(self, name, noise_var, device, dtype):
        super().__init__(name=name, device=device, dtype=dtype)
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        self._add_param("noise_var", noise_var, transform=Logexp())

    def _as_data(self, A) -> torch.Tensor:
        A = np.asarray(A.cpu().numpy() if torch.is_tensor(A) else A, dtype=np.float64)
        return torch.tensor(A, dtype=self.dtype, device=self.device)

    def _axis_data(self, X) -> torch.Tensor:
        X = self._as_data(X)
        return X.reshape(-1, 1) if X.ndim == 1 else X

    def _grid_inference(self):
        return GaussianGridInference().inference(
            self._grid_kernels(), self._grid_axes(), self.noise_var.values, self.Y)

    def log_likelihood(self) -> torch.Tensor:
        return self._grid_inference()[1]

    def _grid_predict(self, Xnew_list):
        """Mean and variance (with the noise) over the tensor grid of the new
        per-axis points, as numpy grids. GPy: gp_grid.py."""
        kernels, axes = self._grid_kernels(), self._grid_axes()
        with torch.no_grad():
            post, _ = self._grid_inference()
            Xn = [self._axis_data(X) for X in Xnew_list]
            Ks = [k.K(x, X) for k, x, X in zip(kernels, Xn, axes)]
            mu = post.alpha
            quad = 1.0 / post.S
            for d, (Kd, (_, Q)) in enumerate(zip(Ks, post.eigs)):
                mu = rotate_axis(mu, Kd, d)
                quad = rotate_axis(quad, (Kd @ Q) ** 2, d)
            kd = None
            for d, (k, x) in enumerate(zip(kernels, Xn)):
                f = k.Kdiag(x).reshape([1] * d + [-1] + [1] * (len(Xn) - d - 1))
                kd = f if kd is None else kd * f
            var = torch.clamp(kd - quad + self.noise_var.values, min=1e-12)
        return mu.cpu().numpy(), var.cpu().numpy()


class GPKroneckerGaussianRegression(_GridModel):
    """K = K1 (x) K2 over a two-axis grid; Y is (n1, n2)."""

    def __init__(self, X1, X2, Y, kern1, kern2, noise_var=1.0, name="KGPR", device=None,
                 dtype=None):
        super().__init__(name, noise_var, device, dtype)
        self.X1 = self._as_data(X1)
        self.X2 = self._as_data(X2)
        self.Y = self._as_data(Y)
        if tuple(self.Y.shape) != (self.X1.shape[0], self.X2.shape[0]):
            raise ValueError("Y must be (n1, n2)")
        for k in (kern1, kern2):
            check_placement("kernel", k, self.device, self.dtype)
        self.kern1, self.kern2 = kern1, kern2

    def _grid_kernels(self):
        return [self.kern1, self.kern2]

    def _grid_axes(self):
        return [self.X1, self.X2]

    def predict(self, X1new, X2new):
        """Predict at all pairs of X1new x X2new: (mu, var), each an (n1*,
        n2*) numpy grid; var includes the noise."""
        return self._grid_predict([X1new, X2new])


class GPRegressionGrid(_GridModel):
    """General D-axis grid GP: K = kron_d K_d, Y over the full grid. The
    per-axis kernels default to an RBF on each axis."""

    def __init__(self, Xs_list, Y, kernels=None, noise_var=1.0, name="GridGP", device=None,
                 dtype=None):
        super().__init__(name, noise_var, device, dtype)
        self.axes = [self._axis_data(X) for X in Xs_list]
        shape = tuple(X.shape[0] for X in self.axes)
        self.Y = self._as_data(np.asarray(Y.cpu().numpy() if torch.is_tensor(Y) else Y,
                                          dtype=np.float64).reshape(shape))
        if kernels is None:
            kernels = [RBF(X.shape[1], device=device, dtype=dtype) for X in self.axes]
        for k in kernels:
            check_placement("kernel", k, self.device, self.dtype)
        self.kernels = list(kernels)

    def _grid_kernels(self):
        return self.kernels

    def _grid_axes(self):
        return self.axes

    def predict(self, Xnew_list):
        """Mean and variance (with the noise) over the tensor grid of the new
        per-axis points, as numpy grids."""
        return self._grid_predict(Xnew_list)
