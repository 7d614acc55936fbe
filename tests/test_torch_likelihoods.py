"""The non-Gaussian likelihoods and links: gpy_tpu_torch against gpy_tpu.

Each likelihood is built in both packages with the same arguments, its raw
parameters compared first, then evaluated on the same numpy inputs on the
CPU at float64: logpdf and its first, second and third derivatives in f
(autograd against jax.grad), the Gauss-Hermite forms (variational
expectations with their gradients, EP moments, predictive moments, the log
predictive density) at rel 1e-12, and each link's transform with its
derivatives. Samplers draw from torch.Generator, not jax.random, so they
are held to moments (ROADMAP C(b)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import norm

import gpy_tpu.likelihoods as jl
import gpy_tpu.likelihoods.link_functions as jlf
import gpy_tpu_torch.likelihoods as tl
import gpy_tpu_torch.likelihoods.link_functions as tlf
from gpy_tpu_torch.util.convert import load_raw_params, raw_params_numpy

N = 9
REL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _f(n=N, seed=0, scale=1.2):
    return np.random.default_rng(seed).standard_normal((n, 1)) * scale


def _positive(n, seed):
    return np.exp(0.6 * np.random.default_rng(seed).standard_normal((n, 1)))


def _censored(n):
    return {"censored": (np.arange(n) % 3 == 0).astype(float).reshape(-1, 1)}


# name -> (constructor kwargs, y maker, metadata for the pointwise forms)
CASES = {
    "Bernoulli": ({}, lambda n: (np.arange(n) % 2).astype(float).reshape(-1, 1), None),
    "Binomial": ({}, lambda n: (np.arange(n) % 5).astype(float).reshape(-1, 1),
                 {"trials": 6.0}),
    "Poisson": ({}, lambda n: (np.arange(n) % 4).astype(float).reshape(-1, 1), None),
    "Exponential": ({}, lambda n: _positive(n, 1), None),
    "Gamma": ({"beta": 1.5}, lambda n: _positive(n, 2), None),
    "StudentT": ({"deg_free": 5.0, "sigma2": 0.5}, lambda n: _f(n, 3), None),
    "Weibull": ({"beta": 1.3}, lambda n: _positive(n, 4), _censored(N)),
    "LogLogistic": ({"r": 3.0}, lambda n: _positive(n, 5), _censored(N)),
    "LogGaussian": ({"sigma": 0.6}, lambda n: _positive(n, 6), _censored(N)),
}
# Gamma's second and third derivatives in f run through lgamma's: torch's
# polygamma(1, x) on the CPU is within ~5e-10 of scipy's, JAX's within 2e-16
DERIV_REL = {"Gamma": 5e-9}
# the quadrature forms broadcast y against (N, 1, P) nodes: per-point
# metadata of shape (N, 1) does not broadcast there in either package
QUAD_MD = {"Binomial": {"trials": 6.0}}


def _twins(name):
    kw = CASES[name][0]
    jlik = getattr(jl, name)(**kw)
    tlik = getattr(tl, name)(device="cpu", dtype=torch.float64, **kw)
    ref = {k: np.asarray(v) for k, v in jlik.get_raw_dict().items()}
    assert list(raw_params_numpy(tlik)) == list(ref)
    load_raw_params(tlik, ref)
    for k, v in raw_params_numpy(tlik).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    return jlik, tlik


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float64).requires_grad_(grad)


def _close(got, ref, rel=REL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rel, atol=rel * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_logpdf_and_its_derivatives_match_reference(name):
    """logpdf, d/df, d2/df2 and the third derivative (autograd through the
    second, which Laplace's differentiable Newton step needs)."""
    jlik, tlik = _twins(name)
    _, ymaker, md = CASES[name]
    f, y = _f(), ymaker(N)
    jf, jy = jnp.asarray(f), jnp.asarray(y)
    _close(tlik.logpdf(_t(f), _t(y), md), jlik.logpdf(jf, jy, md), what="logpdf")
    _close(tlik.d_logpdf_df(_t(f), _t(y), md), jlik.d_logpdf_df(jf, jy, md), what="d1")
    rel = DERIV_REL.get(name, REL)
    _close(tlik.d2_logpdf_df2(_t(f), _t(y), md), jlik.d2_logpdf_df2(jf, jy, md), rel=rel,
           what="d2")
    d3_ref = jax.grad(lambda ff: jnp.sum(jlik.d2_logpdf_df2(ff, jy, md)))(jf)
    tf = _t(f, grad=True)
    d3 = torch.autograd.grad(torch.sum(tlik.d2_logpdf_df2(tf, _t(y), md)), tf)[0]
    _close(d3, d3_ref, rel=max(rel, 1e-11), what="d3")


@pytest.mark.parametrize("name", list(CASES))
def test_quadrature_forms_match_reference(name):
    """variational_expectations (with dF/dm, dF/dv), predictive_values,
    predictive_mean/variance and log_predictive_density."""
    jlik, tlik = _twins(name)
    md = QUAD_MD.get(name)
    m, y = _f(seed=7, scale=0.5), CASES[name][1](N)
    v = 0.05 + 0.3 * np.random.default_rng(8).random((N, 1))
    jm, jv, jy = jnp.asarray(m), jnp.asarray(v), jnp.asarray(y)
    F_ref = jlik.variational_expectations(jy, jm, jv, md)
    dm_ref, dv_ref = jax.grad(lambda a, b: jnp.sum(jlik.variational_expectations(jy, a, b, md)),
                              argnums=(0, 1))(jm, jv)
    tm, tv = _t(m, grad=True), _t(v, grad=True)
    F = tlik.variational_expectations(_t(y), tm, tv, md)
    dm, dv = torch.autograd.grad(torch.sum(F), (tm, tv))
    _close(F, F_ref, what="F")
    _close(dm, dm_ref, rel=1e-11, what="dF/dm")
    _close(dv, dv_ref, rel=1e-11, what="dF/dv")
    with torch.no_grad():
        mu_p, var_p = tlik.predictive_values(_t(m), _t(v))
        mean_p = tlik.predictive_mean(_t(m), _t(v))
        var_p2 = tlik.predictive_variance(_t(m), _t(v))
        lpd = tlik.log_predictive_density(_t(y), _t(m), _t(v), md)
    mu_r, var_r = jlik.predictive_values(jm, jv)
    _close(mu_p, mu_r, what="predictive mean")
    _close(var_p, var_r, what="predictive variance")
    _close(mean_p, jlik.predictive_mean(jm, jv), what="predictive_mean")
    _close(var_p2, jlik.predictive_variance(jm, jv), what="predictive_variance")
    _close(lpd, jlik.log_predictive_density(jy, jm, jv, md), what="log_predictive_density")


@pytest.mark.parametrize("name,link", [("Bernoulli", "Probit"), ("Bernoulli", "Heaviside"),
                                       ("Poisson", None), ("StudentT", None)])
def test_moments_match_ep_match_reference(name, link):
    """Bernoulli's analytic probit and Heaviside moments; Poisson and
    StudentT by the log-sum-exp quadrature."""
    kw = CASES[name][0]
    jlik = getattr(jl, name)(**(dict(kw, gp_link=getattr(jlf, link)()) if link else kw))
    tlik = getattr(tl, name)(device="cpu", dtype=torch.float64,
                             **(dict(kw, gp_link=getattr(tlf, link)()) if link else kw))
    y = CASES[name][1](N)[:, 0]
    rng = np.random.default_rng(9)
    tau = 0.3 + 2.0 * rng.random(N)
    v = tau * rng.standard_normal(N)
    ref = jlik.moments_match_ep(jnp.asarray(y), jnp.asarray(tau), jnp.asarray(v))
    with torch.no_grad():
        got = tlik.moments_match_ep(_t(y), _t(tau), _t(v))
    for what, a, b in zip(("logZ", "mu_hat", "sigma2_hat"), got, ref):
        _close(a, b, what=what)


LINK_F = {"Reciprocal": lambda f: np.where(f >= 0, f + 0.5, f - 0.5),
          "Heaviside": lambda f: np.where(f == 0, 0.3, f)}


@pytest.mark.parametrize("name", ["Identity", "Probit", "ScaledProbit", "Cloglog", "Log",
                                  "Log_ex_1", "Reciprocal", "Heaviside"])
def test_link_transform_and_derivatives_match_reference(name):
    """transf and its first two derivatives, over f that includes the
    softplus link's linear region (f > 20)."""
    jlink = getattr(jlf, name)(**({"nu": 1.7} if name == "ScaledProbit" else {}))
    tlink = getattr(tlf, name)(**({"nu": 1.7} if name == "ScaledProbit" else {}))
    f = np.concatenate([np.linspace(-3.0, 3.0, 13), [21.0, 35.0]])
    f = LINK_F.get(name, lambda a: a)(f)
    jf = jnp.asarray(f)
    tf = _t(f, grad=True)
    out = tlink.transf(tf)
    _close(out, jlink.transf(jf), what="transf")
    d1_ref = jax.grad(lambda a: jnp.sum(jlink.transf(a)))
    d2_ref = jax.grad(lambda a: jnp.sum(d1_ref(a)))
    if not out.requires_grad:  # the step link: no dependence on f
        np.testing.assert_array_equal(np.asarray(d1_ref(jf)), 0.0)
        return
    d1 = torch.autograd.grad(torch.sum(out), tf, create_graph=True)[0]
    _close(d1, d1_ref(jf), what="d1")
    if d1.requires_grad:
        _close(torch.autograd.grad(torch.sum(d1), tf)[0], d2_ref(jf), rel=1e-11, what="d2")
    else:
        np.testing.assert_array_equal(np.asarray(d2_ref(jf)), 0.0)


@pytest.mark.parametrize("name", list(CASES))
def test_samples_have_the_conditional_moments(name):
    """samples() at a fixed latent: the sample mean within 5 standard errors
    of conditional_mean (whose value is the reference's, below), and for the
    hand-built Gamma and Student t draws the sample variance within 10% of
    conditional_variance."""
    jlik, tlik = _twins(name)
    md = QUAD_MD.get(name)
    f0 = 0.4
    n = 40000
    ys = tlik.samples(np.full((n, 1), f0), Y_metadata=md, seed=3)
    assert ys.shape == (n, 1) and np.isfinite(ys).all()
    with torch.no_grad():
        mean = tlik.conditional_mean(_t([[f0]])).item()
        var = tlik.conditional_variance(_t([[f0]])).item()
    np.testing.assert_allclose(mean, float(jlik.conditional_mean(jnp.asarray([[f0]]))[0, 0]),
                               rtol=REL)
    np.testing.assert_allclose(var, float(np.asarray(jlik.conditional_variance(
        jnp.asarray([[f0]]))).reshape(-1)[0]), rtol=REL)
    if name == "Binomial":  # conditional moments are per trial
        mean, var = 6.0 * mean, 6.0 * var
    assert abs(ys.mean() - mean) < 5.0 * np.sqrt(var / n), (ys.mean(), mean)
    if name in ("Gamma", "StudentT"):
        assert abs(ys.var() / var - 1.0) < 0.1, (ys.var(), var)
    # one seed gives one draw
    np.testing.assert_array_equal(tlik.samples(np.full((5, 1), f0), Y_metadata=md, seed=3),
                                  tlik.samples(np.full((5, 1), f0), Y_metadata=md, seed=3))


def test_predictive_quantiles_by_monte_carlo():
    """LogGaussian: log y* ~ N(mu, var + sigma2) exactly, so its quantiles are
    closed-form; the Monte-Carlo quantiles (2000 draws) stand within 5
    standard errors of them in log space, as the reference's do."""
    jlik, tlik = _twins("LogGaussian")
    mu = np.array([[0.2], [-0.5], [1.0]])
    var = np.array([[0.1], [0.3], [0.05]])
    qs = (2.5, 50.0, 97.5)
    sd = np.sqrt(var + 0.36)
    with torch.no_grad():
        got = tlik.predictive_quantiles(_t(mu), _t(var), qs)
    ref = jlik.predictive_quantiles(jnp.asarray(mu), jnp.asarray(var), qs)
    for q, g, r in zip(qs, got, ref):
        z = norm.ppf(q / 100.0)
        exact = mu + sd * z
        se = np.sqrt(q / 100.0 * (1 - q / 100.0) / 2000) / norm.pdf(z) * sd
        for a in (np.log(g.numpy()), np.log(np.asarray(r))):
            assert a.shape == (3, 1)
            assert np.all(np.abs(a - exact) < 5.0 * se), (q, a, exact)


def test_mcmc_pdf_samples_by_moments():
    """Random-walk Metropolis on StudentT's y | f: (n_chains, num_samples)
    output as the reference's, each chain's mean near its f, an acceptance
    ratio inside (0, 1), and one seed giving one chain."""
    _, tlik = _twins("StudentT")
    fnew = np.array([[-1.0], [0.5], [2.0]])
    s = tlik.MCMC_pdf_samples(fnew, num_samples=3000, burn_in=300, stepsize=1.5, seed=1)
    assert s.shape == (3, 3000) and np.isfinite(s).all()
    assert 0.0 < tlik.last_mcmc_accept_ratio < 1.0
    np.testing.assert_allclose(s.mean(axis=1), fnew[:, 0], atol=0.25)
    np.testing.assert_array_equal(
        s[:, :50], tlik.MCMC_pdf_samples(fnew, num_samples=50, burn_in=300, stepsize=1.5,
                                         seed=1))


def test_log_ex_1_is_logaddexp_not_the_thresholded_softplus():
    f = torch.tensor([25.0, 40.0], dtype=torch.float64)
    np.testing.assert_array_equal(tlf.Log_ex_1().transf(f).numpy(),
                                  np.asarray(jax.nn.softplus(jnp.asarray(f.numpy()))))


def test_likelihood_parameters_cross_from_the_reference():
    """Each new likelihood's raw parameters, fixed ones included (StudentT's
    deg_free, Gamma's beta), cross by load_raw_params from a changed
    reference; the fixed flags are the constructors' in both packages."""
    for name, changes in (("StudentT", {"t_scale2": 0.8, "deg_free": 7.0}),
                          ("Gamma", {"beta": 2.5}), ("Weibull", {"r_shape": 0.7}),
                          ("LogLogistic", {"r_log_shape": 4.2}),
                          ("LogGaussian", {"variance": 0.9})):
        jlik, tlik = _twins(name)
        for k, val in changes.items():
            getattr(jlik, k).set_value(val) if hasattr(getattr(jlik, k), "set_value") else \
                setattr(jlik, k, val)
        load_raw_params(tlik, {k: np.asarray(v) for k, v in jlik.get_raw_dict().items()})
        fixed_ref = {p for p, mod, n in jlik.named_params() if mod._specs[n].fixed}
        assert {p for p, mod, n in tlik.named_params() if mod._specs[n].fixed} == fixed_ref
        for k, val in changes.items():
            np.testing.assert_allclose(getattr(tlik, k).numpy(), val, rtol=1e-14)
        _, ymaker, md = CASES[name]
        y = ymaker(N)
        _close(tlik.logpdf(_t(_f()), _t(y), md), jlik.logpdf(jnp.asarray(_f()), jnp.asarray(y),
                                                             md), what=name)
