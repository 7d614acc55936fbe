"""Warped GPs: output warping (TanhFunction) and input warping (Kumaraswamy).

Counterpart of gpy_tpu/models/warped_gp.py:21-197 (GPy/models/warped_gp.py:13
and input_warped_gp.py:12).

WarpedGP's objective is exact inference on z = f(Y) plus the Jacobian
sum log f'(Y), on every path: the batched objective (HMC chains, parallel
restarts) stacks each row's own z and Jacobian (`_row_targets`), so no row
is evaluated on the unwarped Y. InputWarpedGP's kernel sees f(X) wherever
it sees inputs (`_inputs`), and new inputs are warped before predicting.

With a normalizer the port maps WarpedGP's predictions back to the scale of
Y and gives the density of y itself, as GP does (ROADMAP C(q)); the
reference leaves them at the normalized scale.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.stats import norm

from ..core.gp import GP
from ..core.module import check_placement
from ..inference.exact import ExactGaussianInference
from ..kern import RBF
from ..likelihoods import Gaussian
from ..likelihoods.likelihood import gh_points
from ..util.input_warping_functions import KumarWarping
from ..util.warping_functions import TanhFunction

__all__ = ["WarpedGP", "InputWarpedGP"]


class WarpedGP(GP):
    """GP on z = f(Y): log L = log N(f(Y); 0, K + s2 I) + sum log f'(Y).
    Predictions go back through f^-1: the mean by 20-point Gauss-Hermite
    quadrature of the latent Gaussian, or the median f^-1(mu) with the
    delta-method variance."""

    def __init__(self, X, Y, kernel=None, warping_function=None, warping_terms=3,
                 normalizer=None, name="warp_gp", device=None, dtype=None):
        if kernel is None:
            kernel = RBF(np.shape(X)[1], device=device, dtype=dtype)
        super().__init__(X, Y, kernel, Gaussian(device=device, dtype=dtype),
                         inference_method=ExactGaussianInference(), name=name,
                         normalizer=normalizer, device=device, dtype=dtype)
        if warping_function is None:
            warping_function = TanhFunction(warping_terms, device=device, dtype=dtype)
        check_placement("warping function", warping_function, self.device, self.dtype)
        self.warping_function = warping_function
        self.predict_in_warped_space = True

    def _log_jacobian(self) -> torch.Tensor:
        g = self.warping_function.fgrad_y(self.Y_normalized)
        return torch.sum(torch.log(torch.clamp(g, min=1e-12)))

    def log_likelihood(self) -> torch.Tensor:
        z = self.warping_function.f(self.Y_normalized)
        lml = self.inference_method.marginal_likelihood(
            self.kern, self._inputs(), self.likelihood, z, self.mean_function, self.Y_metadata)
        return lml + self._log_jacobian()

    def _row_targets(self):
        return self.warping_function.f(self.Y_normalized), self._log_jacobian()

    def _compute_posterior(self):
        z = self.warping_function.f(self.Y_normalized)
        return self.inference_method.inference(
            self.kern, self._inputs(), self.likelihood, z, self.mean_function,
            self.Y_metadata)[0]

    def _warp_tail(self, mu, var, include_likelihood, median):
        """The latent (mu, var) to the predictive mean and variance of y."""
        wf = self.warping_function
        if include_likelihood:
            var = var + self.likelihood.variance.values
        if not self.predict_in_warped_space:
            return mu, var
        if median:
            mean_w = wf.f_inv(mu)
            return mean_w, var / torch.clamp(wf.fgrad_y(mean_w), min=1e-12) ** 2
        x, w = gh_points(20, dtype=mu.dtype, device=mu.device)
        zs = mu[..., None] + torch.sqrt(var)[..., None] * x
        ys = wf.f_inv(zs.reshape(-1, 1)).reshape(zs.shape)
        mean_w = torch.sum(w * ys, dim=-1)
        var_w = torch.sum(w * ys * ys, dim=-1) - mean_w * mean_w
        return mean_w, torch.clamp(var_w, min=1e-12)

    def predict(self, Xnew, full_cov=False, Y_metadata=None, kern=None, likelihood=None,
                include_likelihood=True, median=False):
        """Predictive mean and variance of y* (marginal only, as the
        reference), as numpy."""
        mu, var = self._raw_predict(Xnew, full_cov=False, kern=kern)
        with torch.no_grad():
            mu, var = self._warp_tail(mu, var, include_likelihood, median)
        return self._denormalize(mu, var)

    def predict_quantiles(self, Xnew, quantiles=(2.5, 97.5), Y_metadata=None, **kw):
        """f^-1 of the latent Gaussian's quantiles (with the noise)."""
        mu, var = self._raw_predict(Xnew, full_cov=False)
        with torch.no_grad():
            sd = torch.sqrt(var + self.likelihood.variance.values)
            qs = [self.warping_function.f_inv(mu + float(norm.ppf(q / 100.0)) * sd)
                  for q in quantiles]
        return [self._denormalize(q)[0] for q in qs]

    def log_predictive_density(self, x_test, y_test, Y_metadata=None):
        """log p(y* | x*) = log N(f(y*); mu, var + s2) + log f'(y*)."""
        y = self._normalized_numpy(y_test)
        mu, var = self._raw_predict(x_test)
        with torch.no_grad():
            yt = torch.as_tensor(y, dtype=mu.dtype, device=mu.device)
            wf = self.warping_function
            lpd = self.likelihood.log_predictive_density(wf.f(yt), mu, var, Y_metadata)
            lpd = lpd + torch.log(torch.clamp(wf.fgrad_y(yt), min=1e-12))
            lpd = lpd - self._log_scale(lpd)
        return lpd.cpu().numpy()


class InputWarpedGP(GP):
    """GP on warped inputs f(x), the Kumaraswamy CDF per warped column."""

    def __init__(self, X, Y, kernel=None, normalizer=False, warping_function=None,
                 warping_indices=None, Xmin=None, Xmax=None, epsilon=None,
                 name="input_warped_gp", device=None, dtype=None):
        X = np.asarray(X.cpu().numpy() if torch.is_tensor(X) else X, dtype=np.float64)
        if kernel is None:
            kernel = RBF(X.shape[1], device=device, dtype=dtype)
        super().__init__(X, Y, kernel, Gaussian(device=device, dtype=dtype),
                         inference_method=ExactGaussianInference(), name=name,
                         normalizer=normalizer, device=device, dtype=dtype)
        if warping_function is None:
            warping_function = KumarWarping(X, warping_indices, epsilon or 1e-6, Xmin, Xmax,
                                            device=device, dtype=dtype)
        check_placement("warping function", warping_function, self.device, self.dtype)
        self.warping_function = warping_function

    def _inputs(self) -> torch.Tensor:
        return self.warping_function.f(self.X)

    def _raw_predict(self, Xnew, full_cov=False, kern=None):
        with torch.no_grad():
            Xw = self.warping_function.f(self._as_data(Xnew))
        return super()._raw_predict(Xw, full_cov=full_cov, kern=kern)
