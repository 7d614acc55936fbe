"""Coregionalized (multi-output) regression models.

Counterpart of gpy_tpu/models/gp_coregionalized_regression.py:28-133 (GPy/
models/gp_coregionalized_regression.py:10, sparse_gp_coregionalized_
regression.py:11, gp_heteroscedastic_regression.py:10, gp_offset_
regression.py:11). The multi-output models stack their outputs with
util.multioutput.build_XY: X gains an output-index column and
Y_metadata["output_index"] routes each row to its output's noise
(MixedNoise). Exact inference and VarDTC take that noise through
likelihood.noise_diagonal.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.gp import GP
from ..core.sparse_gp import SparseGP
from ..inference.exact import ExactGaussianInference
from ..kern import RBF
from ..likelihoods import Gaussian, HeteroscedasticGaussian
from ..util import multioutput

__all__ = ["GPCoregionalizedRegression", "SparseGPCoregionalizedRegression",
           "GPHeteroscedasticRegression", "GPOffsetRegression"]


def _coreg_parts(X_list, Y_list, kernel, likelihoods_list, W_rank, kernel_name, device,
                 dtype):
    """(X, Y, output_index, kernel, likelihood) of a coregionalized model:
    the default kernel is ICM(RBF) of rank W_rank, the likelihood MixedNoise
    over one Gaussian per output, both on `device` and `dtype`."""
    X, Y, output_index = multioutput.build_XY(X_list, Y_list)
    D = X.shape[1] - 1
    if kernel is None:
        kernel = multioutput.ICM(D, len(Y_list), RBF(D, device=device, dtype=dtype),
                                 W_rank=W_rank, name=kernel_name, device=device, dtype=dtype)
    likelihood = multioutput.build_likelihood(Y_list, output_index, likelihoods_list,
                                              device=device, dtype=dtype)
    return X, Y, output_index, kernel, likelihood


class GPCoregionalizedRegression(GP):
    """ICM/LCM multi-output regression with a MixedNoise likelihood. GPy:
    gp_coregionalized_regression.py:10. predict takes X with its index
    column and Y_metadata={"output_index": ...} for the noise."""

    def __init__(self, X_list, Y_list, kernel=None, likelihoods_list=None, name="GPCR",
                 W_rank=1, kernel_name="coreg", device=None, dtype=None):
        X, Y, output_index, kernel, likelihood = _coreg_parts(
            X_list, Y_list, kernel, likelihoods_list, W_rank, kernel_name, device, dtype)
        super().__init__(X, Y, kernel, likelihood, name=name,
                         Y_metadata={"output_index": output_index},
                         inference_method=ExactGaussianInference(), device=device, dtype=dtype)
        self.output_index = output_index


class SparseGPCoregionalizedRegression(SparseGP):
    """The sparse form, VarDTC with MixedNoise. GPy: sparse_gp_coregionalized_
    regression.py:11. The default Z is num_inducing rows of X, index column
    included, by numpy's default_rng(0) permutation as the reference draws
    them. Z's index column gets an exactly zero gradient (the index carries
    none): fix Z for a finite-difference check."""

    def __init__(self, X_list, Y_list, Z_list=None, kernel=None, likelihoods_list=None,
                 num_inducing=10, name="sparse_GPCR", W_rank=1, kernel_name="coreg",
                 device=None, dtype=None):
        X, Y, output_index, kernel, likelihood = _coreg_parts(
            X_list, Y_list, kernel, likelihoods_list, W_rank, kernel_name, device, dtype)
        if Z_list is None:
            idx = np.random.default_rng(0).permutation(X.shape[0])[:num_inducing]
            Z = X[idx].copy()
        else:
            Z, _, _ = multioutput.build_XY(Z_list)
        super().__init__(X, Y, Z, kernel, likelihood, name=name,
                         Y_metadata={"output_index": output_index}, device=device, dtype=dtype)
        self.output_index = output_index


class GPHeteroscedasticRegression(GP):
    """Exact GP regression whose likelihood learns one variance per data
    point, indexed by Y_metadata["output_index"] (default: point n has
    variance n)."""

    def __init__(self, X, Y, kernel=None, Y_metadata=None, name="GPHR", device=None,
                 dtype=None):
        N, D = np.shape(X)
        if Y_metadata is None:
            Y_metadata = {"output_index": np.arange(N).reshape(-1, 1)}
        if kernel is None:
            kernel = RBF(D, device=device, dtype=dtype)
        likelihood = HeteroscedasticGaussian(Y_metadata, device=device, dtype=dtype)
        super().__init__(X, Y, kernel, likelihood, Y_metadata=Y_metadata, name=name,
                         inference_method=ExactGaussianInference(), device=device, dtype=dtype)


class GPOffsetRegression(GP):
    """Learns one input offset per cluster: rows of cluster c see
    X[:, :-1] + delta_c, with delta_0 = 0. GPy: gp_offset_regression.py:11;
    the last column of X is the cluster index.

    The offsets reach the rows by a one-hot product, whose backward is a
    matmul, not an atomic scatter into the offsets. The objective, the
    posterior and predict all read the shifted inputs."""

    def __init__(self, X, Y, kernel=None, Y_metadata=None, normalizer=None, noise_var=1.0,
                 mean_function=None, name="GP offset regression", device=None, dtype=None):
        X = np.asarray(X, dtype=float)
        if X.shape[1] < 2:
            raise ValueError("the last column of X must be the cluster index")
        if kernel is None:
            kernel = RBF(X.shape[1] - 1, device=device, dtype=dtype)
        super().__init__(X, Y, kernel, Gaussian(variance=noise_var, device=device, dtype=dtype),
                         inference_method=ExactGaussianInference(), Y_metadata=Y_metadata,
                         normalizer=normalizer, mean_function=mean_function, name=name,
                         device=device, dtype=dtype)
        self.selected = np.asarray(X[:, -1], dtype=int)
        self._add_param("offset", np.zeros(int(self.selected.max())))
        self._onehot = self._cluster_onehot(self.selected)

    def _cluster_onehot(self, selected):
        """(N, number of clusters) one-hot rows of the cluster indices."""
        sel = torch.as_tensor(selected, device=self.device)
        C = self.offset.shape[0] + 1
        return (sel[:, None] == torch.arange(C, device=self.device)).to(self.dtype)

    def _offsets(self):
        """delta_c for c = 0..C-1, delta_0 = 0."""
        off = self.offset.values.reshape(-1)
        return torch.cat([torch.zeros(1, dtype=off.dtype, device=off.device), off])

    def _shifted_X(self):
        return self.X[:, :-1] + (self._onehot @ self._offsets())[:, None]

    def log_likelihood(self):
        return self.inference_method.marginal_likelihood(
            self.kern, self._shifted_X(), self.likelihood, self.Y_normalized, None,
            self.Y_metadata)

    def _compute_posterior(self):
        return self.inference_method.inference(
            self.kern, self._shifted_X(), self.likelihood, self.Y_normalized, None,
            self.Y_metadata)[0]

    @property
    def _predictive_variable(self):
        return self._shifted_X()

    def _raw_predict(self, Xnew, full_cov=False, kern=None):
        """Xnew carries the cluster column; its rows are shifted by their
        cluster's offset before prediction."""
        Xnew = self._as_data(Xnew)
        post = self.posterior
        with torch.no_grad():
            onehot = self._cluster_onehot(Xnew[:, -1].to(torch.int64))
            Xs = Xnew[:, :-1] + (onehot @ self._offsets())[:, None]
            return post._raw_predict(self.kern if kern is None else kern, Xs,
                                     self._predictive_variable, full_cov)
