"""GP base class: data + kern + likelihood + inference, and the predict API.

Counterpart of gpy_tpu/core/gp.py:29-267 (GPy/core/gp.py). Everything runs
eagerly: gpy_tpu's jit caches have no counterpart. The posterior is cached
against the parameters' in-place version counters and the data version, so
predict after predict factors once. The samplers, log_predictive_density,
predictive_gradients and infer_newX wait; so do mean functions and output
normalizers.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..inference.ep import EP
from ..inference.exact import ExactGaussianInference
from ..likelihoods.gaussian import Gaussian
from .model import Model

__all__ = ["GP"]


class GP(Model):
    def __init__(
        self,
        X,
        Y,
        kernel,
        likelihood,
        inference_method=None,
        mean_function=None,
        name: str = "gp",
        Y_metadata: Optional[dict] = None,
        normalizer=None,
        device=None,
        dtype=None,
    ):
        if normalizer not in (None, False):
            raise NotImplementedError("output normalizers are not ported yet (ROADMAP A17)")
        if mean_function is not None:
            raise NotImplementedError("mean functions are not ported yet (ROADMAP A17)")
        super().__init__(name=name, device=device, dtype=dtype)
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        for what, mod in (("kernel", kernel), ("likelihood", likelihood)):
            for p in mod.parameters():
                if p.device != self.device or p.dtype != self.dtype:
                    raise ValueError(
                        f"{what} parameters are {p.dtype} on {p.device}, the model is "
                        f"{self.dtype} on {self.device}: build the {what} with the "
                        "model's device= and dtype=")
        self.X = self._as_data(X)
        Y = self._as_data(Y)
        if Y.ndim != 2:
            raise ValueError("Y must be (N, D)")
        self.num_data, self.input_dim = self.X.shape
        self.output_dim = Y.shape[1]
        self.Y = Y
        self.Y_normalized = Y
        self.Y_metadata = Y_metadata
        self.normalizer = None
        self.mean_function = None
        if inference_method is None:  # GPy: core/gp.py:97-102
            inference_method = (ExactGaussianInference() if isinstance(likelihood, Gaussian)
                                else EP())
        self.inference_method = inference_method
        self.kern = kernel
        self.likelihood = likelihood
        self._data_version = 0
        self._posterior_cache = None

    def _as_data(self, A) -> torch.Tensor:
        """Inputs as tensors on the model's device and dtype. numpy goes to
        the device; a tensor on another kind of device is refused."""
        if torch.is_tensor(A):
            if A.device.type != self.device.type:
                raise ValueError(f"data on {A.device}, the model runs on {self.device}")
            return A.detach().to(device=self.device, dtype=self.dtype)
        return torch.tensor(np.asarray(A, dtype=np.float64), dtype=self.dtype, device=self.device)

    # --- objective ---------------------------------------------------------
    def _inputs(self) -> torch.Tensor:
        """The inputs the kernel is evaluated at: X here, the latent X of a
        GPLVM (a parameter, or the mapping of Y in BCGPLVM)."""
        return self.X

    def log_likelihood(self) -> torch.Tensor:
        return self.inference_method.marginal_likelihood(
            self.kern, self._inputs(), self.likelihood, self.Y_normalized, None, self.Y_metadata)

    def _batched_objective(self, flats: torch.Tensor) -> torch.Tensor:
        """(C,) objectives at the rows of `flats` (Model._batched_objective).

        Each row's noisy Gram is built under its binding (one Gram kernel
        launch per row on the card), the C Grams are stacked and go through
        the inference's batched form once: one batched factorization per
        evaluation. The rows of an inference without a batched form (no
        `noisy_gram`: EP, Laplace) are evaluated one after the other."""
        inf = self.inference_method
        if not hasattr(inf, "noisy_gram"):
            return torch.stack([self._flat_objective(row) for row in flats])
        Kys, log_priors = [], []
        for row in flats:
            with self.bind_flat_raw(row):
                Kys.append(inf.noisy_gram(self.kern, self._inputs(), self.likelihood,
                                          self.Y_metadata))
                log_priors.append(self.log_prior())
        ll = inf.batched_log_marginal(torch.stack(Kys), self.Y_normalized)
        return -ll - torch.stack(log_priors)

    # --- posterior (cached against parameter values) ----------------------
    def _param_fingerprint(self):
        return (self._data_version,
                tuple((id(p), p._version) for p in self.parameters()))

    @property
    def posterior(self):
        fp = self._param_fingerprint()
        cache = self._posterior_cache
        if cache is not None and cache[0] == fp:
            return cache[1]
        with torch.no_grad():
            post = self._compute_posterior()
        self._posterior_cache = (fp, post)
        return post

    def _compute_posterior(self):
        return self.inference_method.inference(
            self.kern, self._inputs(), self.likelihood, self.Y_normalized, None,
            self.Y_metadata)[0]

    # --- prediction --------------------------------------------------------
    @property
    def _predictive_variable(self) -> torch.Tensor:
        """The inputs the posterior's woodbury terms refer to: X (or a
        GPLVM's latent X) here, the inducing inputs Z of a sparse GP
        (gpy_tpu/core/gp.py:87)."""
        return self._inputs()

    def _raw_predict(self, Xnew, full_cov=False, kern=None):
        """Xnew is an input array, or a q(X*) with .mean and .variance (a
        NormalPosterior): then the psi-statistics prediction."""
        kern = self.kern if kern is None else kern
        if not (hasattr(Xnew, "mean") and hasattr(Xnew, "variance")):
            Xnew = self._as_data(Xnew)
        post = self.posterior
        with torch.no_grad():
            return post._raw_predict(kern, Xnew, self._predictive_variable, full_cov)

    def predict(self, Xnew, full_cov=False, Y_metadata=None, kern=None, likelihood=None,
                include_likelihood=True):
        """Predictive mean and variance of Y* as numpy arrays. GPy: core/gp.py:308-365."""
        mu, var = self._raw_predict(Xnew, full_cov=full_cov, kern=kern)
        if include_likelihood:
            lik = self.likelihood if likelihood is None else likelihood
            with torch.no_grad():
                mu, var = lik.predictive_values(mu, var, full_cov, Y_metadata=Y_metadata)
        return mu.cpu().numpy(), var.cpu().numpy()

    def predict_noiseless(self, Xnew, full_cov=False, Y_metadata=None, kern=None):
        return self.predict(Xnew, full_cov, Y_metadata, kern, include_likelihood=False)

    def predict_quantiles(self, Xnew, quantiles=(2.5, 97.5), Y_metadata=None, kern=None,
                          likelihood=None):
        """Quantiles of p(y*) as numpy arrays. GPy: core/gp.py:395-416."""
        lik = self.likelihood if likelihood is None else likelihood
        mu, var = self._raw_predict(Xnew, full_cov=False, kern=kern)
        with torch.no_grad():
            qs = lik.predictive_quantiles(mu, var, quantiles, Y_metadata=Y_metadata)
        return [q.cpu().numpy() for q in qs]

    # --- optimization ----------------------------------------------------------
    def optimize(self, optimizer="lbfgsb", **kwargs):
        """Model.optimize between the inference's hooks (gpy_tpu/core/gp.py:
        591-606). Alternated EP converges its sites once, here, at the
        current hyperparameters, and holds them through the run; the
        posterior cache is dropped on both sides of it."""
        self.inference_method.on_optimization_start()
        if getattr(self.inference_method, "_frozen", False):
            self._posterior_cache = None
            _ = self.posterior
        try:
            return super().optimize(optimizer=optimizer, **kwargs)
        finally:
            self.inference_method.on_optimization_end()
            if getattr(self.inference_method, "ep_mode", None) == "alternated":
                self._posterior_cache = None

    # --- data mutation ------------------------------------------------------
    def set_XY(self, X=None, Y=None):
        """GPy: gp.py:212-249."""
        if X is not None:
            self.X = self._as_data(X)
            self.num_data = self.X.shape[0]
        if Y is not None:
            Y = self._as_data(Y)
            self.Y = Y
            self.Y_normalized = Y
        self._data_version += 1
        self._posterior_cache = None

    def set_X(self, X):
        self.set_XY(X=X)

    def set_Y(self, Y):
        self.set_XY(Y=Y)
