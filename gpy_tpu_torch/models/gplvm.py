"""The GPLVM family: latent-variable models.

Counterpart of gpy_tpu/models/gplvm.py:31-307 (GPy/models/gplvm.py:11,
bcgplvm.py:11, sparse_gplvm.py:9, bayesian_gplvm.py:12, dpgplvm.py:6,
mrd.py:17, inferenceX.py). The latent X, or q(X), is one more parameter of
the tree: d NLML / dX and d bound / d(mu, S) are autograd's, through the
Grams or the psi statistics.

The defaults are the reference's numpy draws: the PCA start
(util/initialization.py), Z as the first num_inducing rows of a
default_rng(0) permutation of X, BayesianGPLVM's X_variance
0.5 + 0.01 default_rng(0).random, MRD's 0.5.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..core.gp import GP
from ..core.model import _adam
from ..core.sparse_gp import SparseGP
from ..core.transformations import Logexp
from ..core.variational import NormalPosterior
from ..inference.exact import ExactGaussianInference
from ..inference.var_dtc import VarDTC
from ..kern import RBF
from ..likelihoods import Gaussian
from ..util.initialization import initialize_latent
from .sparse_gp_regression import _default_Z

__all__ = ["GPLVM", "SparseGPLVM", "BayesianGPLVM", "MRD", "BCGPLVM", "DPBayesianGPLVM"]


class GPLVM(GP):
    """MAP GPLVM: the latent X (latent_X) is optimized with the
    hyperparameters. GPy: gplvm.py:11."""

    def __init__(self, Y, input_dim, X=None, kernel=None, init="PCA", normalizer=None,
                 name="gplvm", device=None, dtype=None):
        Y = np.asarray(Y, dtype=float)
        if X is None:
            X, _ = initialize_latent(init, input_dim, Y)
        if kernel is None:
            kernel = RBF(input_dim, ARD=input_dim > 1, device=device, dtype=dtype)
        super().__init__(X, Y, kernel, Gaussian(variance=1.0, device=device, dtype=dtype),
                         inference_method=ExactGaussianInference(), name=name,
                         normalizer=normalizer, device=device, dtype=dtype)
        self._add_param("latent_X", np.asarray(X, dtype=float))

    def _inputs(self):
        return self.latent_X.values


class BCGPLVM(GP):
    """Back-constrained GPLVM: X = mapping.f(Y), so the latent coordinates
    are a smooth function of the data and the mapping's weights are
    optimized instead of a free X. GPy: bcgplvm.py:11. The default mapping
    is an MLP with 10 hidden units, its weights from np.random.randn."""

    def __init__(self, Y, input_dim, kernel=None, mapping=None, name="bcgplvm", device=None,
                 dtype=None):
        from ..mappings import MLP

        Y = np.asarray(Y, dtype=float)
        if mapping is None:
            mapping = MLP(input_dim=Y.shape[1], output_dim=input_dim, hidden_dim=10,
                          device=device, dtype=dtype)
        else:
            if mapping.input_dim != Y.shape[1]:
                raise ValueError("mapping input dim does not match Y dimension")
            if mapping.output_dim != input_dim:
                raise ValueError("mapping output dim does not match input_dim")
        if kernel is None:
            kernel = RBF(input_dim, ARD=input_dim > 1, device=device, dtype=dtype)
        p0 = next(mapping.parameters())
        with torch.no_grad():
            X0 = mapping.f(torch.as_tensor(Y, dtype=p0.dtype, device=p0.device))
        super().__init__(X0.cpu().numpy(), Y, kernel,
                         Gaussian(variance=1.0, device=device, dtype=dtype),
                         inference_method=ExactGaussianInference(), name=name, device=device,
                         dtype=dtype)
        self.mapping = mapping

    @property
    def latent_X(self):
        return self.mapping.f(self.Y_normalized)

    def _inputs(self):
        return self.latent_X


class SparseGPLVM(SparseGP):
    """Sparse MAP GPLVM on the VarDTC bound (GPy: sparse_gplvm.py:9)."""

    def __init__(self, Y, input_dim, X=None, kernel=None, init="PCA", num_inducing=10,
                 name="sparse_gplvm", device=None, dtype=None):
        Y = np.asarray(Y, dtype=float)
        if X is None:
            X, _ = initialize_latent(init, input_dim, Y)
        if kernel is None:
            kernel = RBF(input_dim, ARD=input_dim > 1, device=device, dtype=dtype)
        super().__init__(X, Y, _default_Z(X, num_inducing), kernel,
                         Gaussian(variance=1.0, device=device, dtype=dtype), name=name,
                         device=device, dtype=dtype)
        self._add_param("latent_X", np.asarray(X, dtype=float))

    def _inputs(self):
        return self.latent_X.values


class BayesianGPLVM(SparseGP):
    """Bayesian GPLVM: a variational q(X) = NormalPosterior (qX) under the
    VarDTC psi-statistics bound; log_likelihood is the bound minus
    KL(q(X) || N(0, I)). GPy: bayesian_gplvm.py:12."""

    def __init__(self, Y, input_dim, X=None, X_variance=None, init="PCA", num_inducing=10,
                 Z=None, kernel=None, likelihood=None, name="bayesian gplvm", device=None,
                 dtype=None):
        Y = np.asarray(Y, dtype=float)
        if X is None:
            X, _ = initialize_latent(init, input_dim, Y)
        if X_variance is None:
            X_variance = 0.5 * np.ones_like(X) + 0.01 * np.random.default_rng(0).random(X.shape)
        if Z is None:
            Z = _default_Z(X, num_inducing)
        if kernel is None:
            kernel = RBF(input_dim, ARD=True, device=device, dtype=dtype)
        likelihood = likelihood or Gaussian(variance=1.0, device=device, dtype=dtype)
        super().__init__(X, Y, Z, kernel, likelihood, inference_method=VarDTC(), name=name,
                         device=device, dtype=dtype)
        self.qX = NormalPosterior(X, X_variance, device=device, dtype=dtype)

    def _bound_args(self):
        return super()._bound_args()[:-1] + (self.qX,)

    def _kl(self):
        return self.qX.KL()

    @property
    def latent_mean(self):
        return self.qX.mean.numpy()

    def infer_newX(self, Y_new, optimize_iters=200, lr=1e-2, seed=0, variational=True):
        """q(X*) for new observations Y*: gpy_tpu/models/gplvm.py:199-249
        (GPy inferenceX.py). optimize_iters Adam steps (optax.adam(lr)'s
        rule) over (mu*, raw S*) maximizing the bound minus KL, with every
        model parameter held fixed; mu* starts at the training q(X) mean of
        the nearest training Y, raw S* at 0 (S* = log 2). Returns
        (NormalPosterior q(X*), the objective's value at the last step's
        start). variational=False, the base class's MAP estimate, waits for
        ROADMAP A6 (queue A item 3)."""
        if not variational:
            raise NotImplementedError("infer_newX(variational=False), the MAP estimate of GP, "
                                      "is not ported yet (ROADMAP A6)")
        Y_new = self._as_data(np.asarray(Y_new, dtype=float))
        Q = self.qX.input_dim
        with torch.no_grad():
            d2 = torch.sum((Y_new[:, None, :] - self.Y_normalized[None]) ** 2, dim=-1)
            mu = self.qX.mean.values[torch.argmin(d2, dim=1)].clone()
        raw_S = torch.zeros((Y_new.shape[0], Q), dtype=mu.dtype, device=mu.device)
        mu.requires_grad_(True)
        raw_S.requires_grad_(True)
        opt = _adam([mu, raw_S], lr)
        softplus = Logexp().forward
        val = None
        with self.stop_gradient():
            Z = self.Z.values
            for _ in range(optimize_iters):
                S = softplus(raw_S)
                qX = SimpleNamespace(mean=mu, variance=S)
                bound = self.inference_method.marginal_likelihood(
                    self.kern, None, Z, self.likelihood, Y_new, None, None, qX)
                val = -(bound - 0.5 * torch.sum(mu**2 + S - torch.log(S) - 1.0))
                mu.grad, raw_S.grad = torch.autograd.grad(val, [mu, raw_S])
                opt.step()
        with torch.no_grad():
            qX = NormalPosterior(mu.cpu().numpy(), softplus(raw_S).cpu().numpy(),
                                 device=self.device, dtype=self.dtype)
        return qX, -val.item()


class DPBayesianGPLVM(BayesianGPLVM):
    """Bayesian GPLVM with a discriminative prior on the variational latent
    means (a core.priors.DGPLVM or any prior whose lnpdf takes the (N, Q)
    mean matrix). GPy: dpgplvm.py:6 (X_prior on X.mean)."""

    def __init__(self, Y, input_dim, X_prior, X=None, X_variance=None, init="PCA",
                 num_inducing=10, Z=None, kernel=None, likelihood=None,
                 name="dp bayesian gplvm", device=None, dtype=None):
        super().__init__(Y, input_dim, X=X, X_variance=X_variance, init=init,
                         num_inducing=num_inducing, Z=Z, kernel=kernel, likelihood=likelihood,
                         name=name, device=device, dtype=dtype)
        self.qX.mean.set_prior(X_prior)


class MRD(SparseGP):
    """Manifold Relevance Determination: views share one q(X) and Z; each
    has its own ARD kernel and noise. GPy: mrd.py:17.

    As in the reference, the base model's kernel is view 0's kernel
    (kern and view_kernels#0 are one object, listed once in the flat
    vector) and its likelihood is not in the objective; the posterior (and
    predict) is the base SparseGP's, VarDTC on view 0's Y at the PCA start
    X. The reference lists the shared kernel twice in its flat vector
    (ROADMAP C(n)).
    """

    def __init__(self, Ylist, input_dim, X=None, X_variance=None, init="PCA", num_inducing=10,
                 Z=None, kernel=None, kernels=None, name="mrd", device=None, dtype=None):
        Ylist = [np.asarray(Y, dtype=float) for Y in Ylist]
        if X is None:
            X, _ = initialize_latent(init, input_dim, np.hstack(Ylist))
        if X_variance is None:
            X_variance = 0.5 * np.ones_like(X)
        if Z is None:
            Z = _default_Z(X, num_inducing)
        if kernels is None:
            kernels = [RBF(input_dim, ARD=True, name=f"rbf_view{i}", device=device, dtype=dtype)
                       for i in range(len(Ylist))]
        super().__init__(X, Ylist[0], Z, kernels[0],
                         Gaussian(variance=1.0, device=device, dtype=dtype),
                         inference_method=VarDTC(), name=name, device=device, dtype=dtype)
        self.qX = NormalPosterior(X, X_variance, device=device, dtype=dtype)
        self.views_Y = [self._as_data(Y) for Y in Ylist]
        self.view_kernels = list(kernels)
        self.view_likelihoods = [Gaussian(variance=1.0, name=f"noise_view{i}", device=device,
                                          dtype=dtype) for i in range(len(Ylist))]

    def log_likelihood(self):
        Z = self.Z.values
        total = 0.0
        for Y, k, lik in zip(self.views_Y, self.view_kernels, self.view_likelihoods):
            total = total + self.inference_method.marginal_likelihood(k, None, Z, lik, Y, None,
                                                                      None, self.qX)
        return total - self.qX.KL()

    def scales(self):
        """Per-view ARD relevances (the MRD diagnostic)."""
        return [np.asarray(k.input_sensitivity()) for k in self.view_kernels]
