"""GP base class: data + kern + likelihood + inference, and the predict API.

Counterpart of gpy_tpu/core/gp.py:29-586 (GPy/core/gp.py). Everything runs
eagerly: gpy_tpu's jit caches have no counterpart. The posterior is cached
against the parameters' in-place version counters and the data version, so
predict after predict factors once.

An output normalizer (util/normalizer.py; `normalizer=True` is
Standardize) scales Y on the host when the model is built; inference sees
`Y_normalized` and the predictions are mapped back. A mean function (a
mapping, mappings.py) is a child module after kern and likelihood, so its
parameters follow theirs in the flat vector, as in the reference.

Two reference faults are not copied (ROADMAP C(q), C(r)): with a
normalizer, log_predictive_density(_sampling) is the density of y itself
(the reference's is of the normalized y), and posterior_samples adds the
likelihood's noise before mapping back (the reference adds the normalized
noise to the mapped-back f).
"""
from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..config import resolve_device, resolve_dtype
from ..inference.ep import EP
from ..inference.exact import ExactGaussianInference
from ..likelihoods.gaussian import Gaussian
from ..util.normalizer import Standardize
from .model import Model, _adam
from .module import check_placement
from .optim import LBFGS

__all__ = ["GP"]


def _generator(seed, device) -> torch.Generator:
    """A torch.Generator as given, or one on `device` seeded with `seed`."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


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
        super().__init__(name=name, device=device, dtype=dtype)
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        parts = [("kernel", kernel), ("likelihood", likelihood)]
        if mean_function is not None:
            parts.append(("mean function", mean_function))
        for what, mod in parts:
            check_placement(what, mod, self.device, self.dtype)
        self.X = self._as_data(X)
        if normalizer is True:
            normalizer = Standardize()
        self.normalizer = normalizer or None
        self.num_data, self.input_dim = self.X.shape
        self._set_Y(Y)
        self.output_dim = self.Y.shape[1]
        self.Y_metadata = Y_metadata
        if inference_method is None:  # GPy: core/gp.py:97-102
            inference_method = (ExactGaussianInference() if isinstance(likelihood, Gaussian)
                                else EP())
        self.inference_method = inference_method
        self.kern = kernel
        self.likelihood = likelihood
        self.mean_function = mean_function
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

    def _set_Y(self, Y):
        """Y and Y_normalized: the normalizer is fitted to Y in float64 on
        the host (gpy_tpu/core/gp.py:51-59)."""
        Y = self._as_data(Y)
        if Y.ndim != 2:
            raise ValueError("Y must be (N, D)")
        self.Y = Y
        if self.normalizer is None:
            self.Y_normalized = Y
            return
        Ynp = Y.cpu().numpy().astype(np.float64)
        self.normalizer.scale_by(Ynp)
        self.Y_normalized = self._as_data(self.normalizer.normalize(Ynp))

    def _normalized_numpy(self, y):
        y = np.asarray(y.cpu().numpy() if torch.is_tensor(y) else y, dtype=np.float64)
        return y if self.normalizer is None else self.normalizer.normalize(y)

    # --- objective ---------------------------------------------------------
    def _inputs(self) -> torch.Tensor:
        """The inputs the kernel is evaluated at: X here, the latent X of a
        GPLVM (a parameter, or the mapping of Y in BCGPLVM)."""
        return self.X

    def log_likelihood(self) -> torch.Tensor:
        return self.inference_method.marginal_likelihood(
            self.kern, self._inputs(), self.likelihood, self.Y_normalized, self.mean_function,
            self.Y_metadata)

    def _batched_objective(self, flats: torch.Tensor) -> torch.Tensor:
        """(C,) objectives at the rows of `flats` (Model._batched_objective).

        Each row's noisy Gram is built under its binding (one Gram kernel
        launch per row on the card), the C Grams are stacked and go through
        the inference's batched form once: one batched factorization per
        evaluation. Where a row's targets depend on its parameters (a mean
        function, WarpedGP's warped Y: `_row_targets`) they are stacked
        too. The rows of an inference without a batched form (no
        `noisy_gram`: EP, Laplace, the iterative inference) are evaluated
        one after the other."""
        inf = self.inference_method
        if not hasattr(inf, "noisy_gram"):
            return torch.stack([self._flat_objective(row) for row in flats])
        Kys, Ys, rest = [], [], []
        for row in flats:
            with self.bind_flat_raw(row):
                Kys.append(inf.noisy_gram(self.kern, self._inputs(), self.likelihood,
                                          self.Y_metadata))
                Y, extra = self._row_targets()
                Ys.append(Y)
                rest.append(self.log_prior() + extra)
        Y = self.Y_normalized if Ys[0] is None else torch.stack(Ys)
        ll = inf.batched_log_marginal(torch.stack(Kys), Y)
        return -ll - torch.stack(rest)

    def _row_targets(self):
        """(targets, extra log likelihood) of the row bound now, for the
        batched objective: the targets are None where every row shares
        Y_normalized, else Y - m(X)."""
        mf = self.mean_function
        return (None if mf is None else self.Y_normalized - mf.f(self._inputs())), 0.0

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
            self.kern, self._inputs(), self.likelihood, self.Y_normalized, self.mean_function,
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
        NormalPosterior): then the psi-statistics prediction, which adds no
        mean function (as the reference)."""
        kern = self.kern if kern is None else kern
        uncertain = hasattr(Xnew, "mean") and hasattr(Xnew, "variance")
        if not uncertain:
            Xnew = self._as_data(Xnew)
        post = self.posterior
        with torch.no_grad():
            mu, var = post._raw_predict(kern, Xnew, self._predictive_variable, full_cov)
            if self.mean_function is not None and not uncertain:
                mu = mu + self.mean_function.f(Xnew)
        return mu, var

    def _denormalize(self, mu, var=None, full_cov=False):
        """numpy mean (and variance or covariance) mapped back through the
        normalizer."""
        mu = mu.cpu().numpy() if torch.is_tensor(mu) else mu
        var = var.cpu().numpy() if torch.is_tensor(var) else var
        if self.normalizer is None:
            return mu, var
        mu = self.normalizer.inverse_mean(mu)
        if var is not None:
            var = (self.normalizer.inverse_covariance(var) if full_cov
                   else self.normalizer.inverse_variance(var))
        return mu, var

    def predict(self, Xnew, full_cov=False, Y_metadata=None, kern=None, likelihood=None,
                include_likelihood=True):
        """Predictive mean and variance of Y* as numpy arrays. GPy: core/gp.py:308-365."""
        mu, var = self._raw_predict(Xnew, full_cov=full_cov, kern=kern)
        if include_likelihood:
            lik = self.likelihood if likelihood is None else likelihood
            with torch.no_grad():
                mu, var = lik.predictive_values(mu, var, full_cov, Y_metadata=Y_metadata)
        return self._denormalize(mu, var, full_cov)

    def predict_noiseless(self, Xnew, full_cov=False, Y_metadata=None, kern=None):
        return self.predict(Xnew, full_cov, Y_metadata, kern, include_likelihood=False)

    def predict_quantiles(self, Xnew, quantiles=(2.5, 97.5), Y_metadata=None, kern=None,
                          likelihood=None):
        """Quantiles of p(y*) as numpy arrays. GPy: core/gp.py:395-416."""
        lik = self.likelihood if likelihood is None else likelihood
        mu, var = self._raw_predict(Xnew, full_cov=False, kern=kern)
        with torch.no_grad():
            qs = lik.predictive_quantiles(mu, var, quantiles, Y_metadata=Y_metadata)
        return [self._denormalize(q)[0] for q in qs]

    # --- derivatives of the prediction ----------------------------------------
    def predictive_gradients(self, Xnew, kern=None):
        """(d mu / d Xnew of shape (N*, Q, D), d var / d Xnew of shape (N*, Q))
        at the normalized scale, as numpy. GPy: gp.py:418-474. Each point's
        prediction depends on its own row only, so the gradient of a sum
        over the points is every point's own gradient."""
        kern = self.kern if kern is None else kern
        Xnew = self._as_data(Xnew)
        post, pv = self.posterior, self._predictive_variable.detach()
        wv = post.woodbury_vector
        with torch.enable_grad(), self.stop_gradient():
            x = Xnew.clone().requires_grad_(True)
            mu = kern.K(x, pv) @ wv
            if self.mean_function is not None:
                mu = mu + self.mean_function.f(x)
            dmu = torch.stack([torch.autograd.grad(mu[:, d].sum(), x, retain_graph=True)[0]
                               for d in range(mu.shape[1])], dim=-1)
            _, var = post._raw_predict(kern, x, pv, full_cov=False)
            dvar = torch.autograd.grad(var[:, 0].sum(), x)[0]
        return dmu.cpu().numpy(), dvar.cpu().numpy()

    def predict_jacobian(self, Xnew, kern=None, full_cov=False):
        """Jacobian of the posterior mean, (N*, Q, D). GPy: gp.py:476-539."""
        return self.predictive_gradients(Xnew, kern=kern)[0]

    def predict_wishart_embedding(self, Xnew, kern=None, mean=True, covariance=True):
        """G = J' J summed over outputs, (N*, Q, Q). GPy: gp.py:541-599."""
        dmu = self.predict_jacobian(Xnew, kern=kern)
        return np.einsum("nqd,npd->nqp", dmu, dmu)

    def predict_magnification(self, Xnew, kern=None):
        """sqrt(det G) at each point."""
        G = self.predict_wishart_embedding(Xnew, kern=kern)
        return np.sqrt(np.maximum(np.linalg.det(G), 0.0))

    # --- sampling ----------------------------------------------------------
    @staticmethod
    def _sample_f_tail(mu, var, gen, size, full_cov):
        """(n, D, size) draws of f* ~ N(mu, var). With full_cov the factor
        is of var + 1e-8 tr(var)/n I; where it does not exist the draws are
        NaN, as the reference's jnp.linalg.cholesky returns NaN (no
        exception, no host read)."""
        n, D = mu.shape
        z = torch.randn((D, n, size), generator=gen, dtype=mu.dtype, device=mu.device)
        if full_cov:
            eye = torch.eye(n, dtype=var.dtype, device=var.device)
            L, info = torch.linalg.cholesky_ex(var + 1e-8 * torch.trace(var) / n * eye)
            L = torch.where(info == 0, L, torch.full_like(L, math.nan))
            samples = mu.T[:, :, None] + torch.einsum("ij,djs->dis", L, z)
        else:
            samples = mu.T[:, :, None] + torch.sqrt(var).T[:, :, None] * z
        return samples.permute(1, 0, 2)

    def _f_samples(self, X, size, full_cov, gen):
        """f* draws at the normalized scale, a (n, D, size) tensor."""
        mu, var = self._raw_predict(X, full_cov=full_cov)
        return GP._sample_f_tail(mu, var, gen, size, full_cov)

    def _inverse_mean_samples(self, s):
        """(n, D, size) numpy samples mapped back through the normalizer."""
        if self.normalizer is None:
            return s
        return self.normalizer.inverse_mean(s.transpose(0, 2, 1)).transpose(0, 2, 1)

    def posterior_samples_f(self, X, size=10, full_cov=True, seed=0, **kw):
        """Samples of the latent f*, (n, D, size) numpy. `seed` is an int or
        a torch.Generator (on the model's device). GPy: gp.py:601-628."""
        gen = _generator(seed, self.device)
        with torch.no_grad():
            fs = self._f_samples(X, size, full_cov, gen)
        return self._inverse_mean_samples(fs.cpu().numpy())

    def posterior_samples(self, X, size=10, Y_metadata=None, seed=0, full_cov=True, **kw):
        """Samples of Y*, (n, D, size) numpy: the likelihood's draw given
        each f* sample, at the normalized scale, then mapped back (ROADMAP
        C(r)). GPy: gp.py:630-652."""
        gen = _generator(seed, self.device)
        with torch.no_grad():
            fs = self._f_samples(X, size, full_cov, gen)
            ys = self.likelihood.samples_given_f(gen, fs, Y_metadata)
        return self._inverse_mean_samples(ys.cpu().numpy())

    # --- densities ----------------------------------------------------------
    def _log_scale(self, like):
        """sum_d log s_d of the normalizer's scale, for the density of y from
        the density of the normalized y (0 without a scale)."""
        std = getattr(self.normalizer, "std", None)
        if std is None:
            return 0.0
        return torch.as_tensor(np.log(np.asarray(std, dtype=np.float64)).reshape(1, -1),
                               dtype=like.dtype, device=like.device)

    def log_predictive_density(self, x_test, y_test, Y_metadata=None):
        """log p(y* | x*), (n, D) numpy. GPy: gp.py:700-714. With a scaling
        normalizer this is the density of y* itself: the reference's (the
        density of the normalized y*) less log(std) (ROADMAP C(q))."""
        y = self._normalized_numpy(y_test)
        mu, var = self._raw_predict(x_test)
        with torch.no_grad():
            lpd = self.likelihood.log_predictive_density(
                torch.as_tensor(y, dtype=mu.dtype, device=mu.device), mu, var, Y_metadata)
            lpd = lpd - self._log_scale(lpd)
        return lpd.cpu().numpy()

    def log_predictive_density_sampling(self, x_test, y_test, Y_metadata=None, num_samples=1000,
                                        seed=0):
        """Monte-Carlo log p(y* | x*): log (1/S) sum_s p(y* | f_s), f_s drawn
        from the posterior marginals. GPy: gp.py:716-732; the normalizer as
        in log_predictive_density."""
        y = self._normalized_numpy(y_test)
        mu, var = self._raw_predict(x_test)
        gen = _generator(seed, self.device)
        with torch.no_grad():
            z = torch.randn((num_samples,) + tuple(mu.shape), generator=gen, dtype=mu.dtype,
                            device=mu.device)
            fs = mu[None] + torch.sqrt(var)[None] * z
            yt = torch.as_tensor(y, dtype=mu.dtype, device=mu.device)
            logp = self.likelihood.logpdf(fs, yt[None], Y_metadata)
            lpd = torch.logsumexp(logp, dim=0) - math.log(num_samples)
            lpd = lpd - self._log_scale(lpd)
        return lpd.cpu().numpy()

    def posterior_covariance_between_points(self, X1, X2, kern=None):
        """Posterior covariance of f at X1 and X2, numpy. GPy: gp.py:735-786."""
        kern = self.kern if kern is None else kern
        with torch.no_grad():
            cov = self.posterior.covariance_between_points(
                kern, self._predictive_variable, self._as_data(X1), self._as_data(X2))
        cov = cov.cpu().numpy()
        return cov if self.normalizer is None else self.normalizer.inverse_covariance(cov)

    # --- new latent points -----------------------------------------------------
    def infer_newX(self, Y_new, optimize_iters=200, lr=1e-2, seed=0, variational=False, tol=1e-6,
                   optimizer="adam"):
        """Latent positions X* for new observations Y* under the current
        posterior, every model parameter held. gpy_tpu/core/gp.py:442-556.

        variational=False: the MAP point, minimizing
        0.5 sum((y* - mu(x*))^2 / v + log(2 pi v)), v = var(x*) + noise.
        Returns (X*, -objective). variational=True: q(X*) = N(mu, diag S)
        maximizing E_q[log p(y*|f*)] - KL(q || N(0, I)) through the
        psi-statistics prediction; returns (NormalPosterior, elbo).

        The start is the predictive variable's row at the index of the
        nearest training Y, clamped to its last row as jnp's gather clamps
        (ROADMAP C(s): for a sparse model that is a row of Z). At most
        optimize_iters steps of Adam(lr) or optax.lbfgs ("lbfgs"); with
        tol > 0 the loop stops once |prev - val| <= tol (1 + |val|) after two
        steps, which reads each step's value back to the host. The steps
        taken are in self._infer_newX_iters."""
        from .variational import NormalPosterior

        Y_new = self._as_data(self._normalized_numpy(Y_new))
        pv = self._predictive_variable.detach()
        post = self.posterior
        lik = self.likelihood
        noise = lik.variance.values.detach() if hasattr(lik, "variance") else 1e-6
        with torch.no_grad():
            d2 = torch.sum((Y_new[:, None, :] - self.Y_normalized[None]) ** 2, dim=-1)
            X0 = pv[torch.clamp(torch.argmin(d2, dim=1), max=pv.shape[0] - 1)].clone()
        n, Q = X0.shape

        def neg_obj(p):
            with self.stop_gradient():
                if variational:
                    mu_x, S = p[:n * Q].reshape(n, Q), torch.exp(p[n * Q:].reshape(n, Q))
                    mu, var = post._raw_predict(self.kern, SimpleNamespace(mean=mu_x, variance=S),
                                                pv, full_cov=False)
                    ell = -0.5 * torch.sum(((Y_new - mu) ** 2 + var) / noise
                                           + torch.log(2 * math.pi * noise))
                    kl = 0.5 * torch.sum(mu_x**2 + S - torch.log(S) - 1.0)
                    return -(ell - kl)
                mu, var = post._raw_predict(self.kern, p.reshape(n, Q), pv, full_cov=False)
                v = var + noise
                return 0.5 * torch.sum((Y_new - mu) ** 2 / v + torch.log(2 * math.pi * v))

        def vg(p):
            p = p.detach().requires_grad_(True)
            with torch.enable_grad():
                val = neg_obj(p)
                return val.detach(), torch.autograd.grad(val, p)[0]

        p = X0.reshape(-1)
        if variational:
            p = torch.cat([p, torch.full_like(p, math.log(0.5))])
        use_lbfgs = str(optimizer).lower() in ("lbfgs", "l-bfgs-b", "bfgs")
        if use_lbfgs:
            opt = LBFGS().init(p)
        else:
            leaf = p.clone().requires_grad_(True)
            adam = _adam(leaf, lr)
        prev = val = math.inf
        it = 0
        while it < optimize_iters and (not (tol and tol > 0) or it < 2
                                       or abs(prev - val) > tol * (1.0 + abs(val))):
            vt, g = vg(p)
            if use_lbfgs or (tol and tol > 0):
                v_host = vt.item()
            if use_lbfgs:
                p = opt.step(p, v_host, g, vg)
            else:
                leaf.grad = g
                adam.step()
                p = leaf.detach().clone()
            if tol and tol > 0:
                prev, val = val, v_host
            it += 1
        self._infer_newX_iters = it
        with torch.no_grad():
            final = neg_obj(p).item()
        if variational:
            qX = NormalPosterior(p[:n * Q].reshape(n, Q).cpu().numpy(),
                                 torch.exp(p[n * Q:]).reshape(n, Q).cpu().numpy(),
                                 device=self.device, dtype=self.dtype)
            return qX, -final
        return p.reshape(n, Q).cpu().numpy(), -final

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
        """GPy: gp.py:212-249; a normalizer is fitted to the new Y."""
        if X is not None:
            self.X = self._as_data(X)
            self.num_data = self.X.shape[0]
        if Y is not None:
            self._set_Y(Y)
        self._data_version += 1
        self._posterior_cache = None

    def set_X(self, X):
        self.set_XY(X=X)

    def set_Y(self, Y):
        self.set_XY(Y=Y)
