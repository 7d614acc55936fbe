"""MultioutputGP: heterogeneous outputs and derivative observations.

Counterpart of gpy_tpu/models/multioutput_gp.py:18-45 (GPy/models/
multioutput_gp.py:24). Outputs are stacked by util.multioutput.build_XY;
the kernel is a MultioutputKern over `kernel_list`. With Gaussian
likelihoods only, the likelihood is MixedNoise under exact inference;
otherwise a MultioutputLikelihood under EP.

A kernel shared by two parts (the base kernel of [k, DiffKern(k, 0)]) is
one set of hyperparameters: its parameters stand at both paths of the raw
dict (kern.parts#0.*, kern.parts#1.base_kern.*) and once in the flat
vector, and the objective, the gradient and predict all use the joint
covariance with its cross blocks (ROADMAP C(k) for the reference's
objective, which does not).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.gp import GP
from ..inference.ep import EP
from ..inference.exact import ExactGaussianInference
from ..kern.multioutput_kern import MultioutputKern
from ..likelihoods import Gaussian
from ..likelihoods.mixed_noise import MixedNoise, MultioutputLikelihood
from ..util import multioutput

__all__ = ["MultioutputGP"]


class MultioutputGP(GP):
    def __init__(self, X_list, Y_list, kernel_list, likelihood_list=None,
                 kernel_cross_covariances=None, inference_method=None, name="multioutputgp",
                 device=None, dtype=None):
        X, Y, output_index = multioutput.build_XY(X_list, Y_list)
        kernel = MultioutputKern(kernel_list, kernel_cross_covariances, device=device,
                                 dtype=dtype)
        if likelihood_list is None:
            likelihood_list = [Gaussian(name=f"noise_{i}", device=device, dtype=dtype)
                               for i in range(len(Y_list))]
        if all(isinstance(lik, Gaussian) for lik in likelihood_list):
            likelihood = MixedNoise(likelihood_list, device=device, dtype=dtype)
            inference_method = inference_method or ExactGaussianInference()
        else:
            likelihood = MultioutputLikelihood(likelihood_list, device=device, dtype=dtype)
            inference_method = inference_method or EP()
        super().__init__(X, Y, kernel, likelihood, inference_method=inference_method,
                         Y_metadata={"output_index": output_index}, name=name, device=device,
                         dtype=dtype)
        self.output_index = output_index

    def predict(self, Xnew, full_cov=False, Y_metadata=None, **kw):
        """Xnew carries the output-index column (util.multioutput.build_XY);
        without Y_metadata the likelihood reads the index from it."""
        if Y_metadata is None:
            col = Xnew[:, -1:]
            Y_metadata = {"output_index": col.to(torch.int64) if torch.is_tensor(col)
                          else np.asarray(col).astype(int)}
        return super().predict(Xnew, full_cov=full_cov, Y_metadata=Y_metadata, **kw)
