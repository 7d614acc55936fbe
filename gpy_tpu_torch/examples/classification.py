"""Classification demos. Counterpart of gpy_tpu/examples/classification.py
(GPy/examples/classification.py: toy_linear_1d_classification,
crescent_data, sparse variants, oil). The examples whose reference calls
optimize() with its defaults take max_iters (the default's 1000) as a
keyword, so that a caller can bound an EP fit."""
from __future__ import annotations

import numpy as np

from ..models import GPClassification, GPClassificationLaplace, SparseGPClassification
from ..util import datasets


def toy_linear_1d_classification(optimize=True, plot=False, seed=0, max_iters=1000, device=None,
                                 dtype=None):
    data = datasets.toy_linear_1d_classification(seed=seed)
    m = GPClassification(data["X"], data["Y"], device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    if plot:
        m.plot()
    return m


def toy_linear_1d_classification_laplace(optimize=True, plot=False, seed=0, max_iters=1000,
                                         device=None, dtype=None):
    data = datasets.toy_linear_1d_classification(seed=seed)
    m = GPClassificationLaplace(data["X"], data["Y"], device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def crescent_data(optimize=True, plot=False, seed=0, max_iters=1000, device=None, dtype=None):
    data = datasets.crescent_data(seed=seed)
    m = GPClassification(data["X"], data["Y"], device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def sparse_toy_linear_1d_classification(num_inducing=10, optimize=True, plot=False, seed=0,
                                        device=None, dtype=None):
    data = datasets.toy_linear_1d_classification(seed=seed)
    m = SparseGPClassification(data["X"], data["Y"], num_inducing=num_inducing, device=device,
                               dtype=dtype)
    if optimize:
        m.optimize(max_iters=200)
    return m


def oil(num_inducing=50, max_iters=100, optimize=True, plot=False, device=None, dtype=None):
    """Sparse classification on the three-phase oil-flow data (GPy
    classification.py oil); the synthetic stand-in where the data is not
    in the local cache."""
    try:
        data = datasets.oil()
    except datasets.DatasetNotAvailable as e:
        print(f"[gpy_tpu_torch.examples] dataset unavailable ({e}); using oil_synthetic")
        data = datasets.oil_synthetic()
    X = data["X"]
    Y = (data["Y"][:, 0:1] + 1.0) / 2.0  # first phase vs rest, {0,1}
    m = SparseGPClassification(X, Y, num_inducing=num_inducing, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def toy_heaviside(seed=0, max_iters=100, optimize=True, plot=False, device=None, dtype=None):
    """1-D classification with the Heaviside link under EP (GPy
    classification.py toy_heaviside: EP is the inference that handles the
    non-differentiable link)."""
    from ..core.gp import GP
    from ..inference import EP
    from ..kern import RBF
    from ..likelihoods import Bernoulli, link_functions

    data = datasets.toy_linear_1d_classification(seed=seed)
    Y = data["Y"][:, 0:1]  # already {0,1}
    m = GP(data["X"], Y, RBF(1, device=device, dtype=dtype),
           Bernoulli(gp_link=link_functions.Heaviside(), device=device, dtype=dtype),
           inference_method=EP(), name="gp_classification_heaviside", device=device,
           dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    if plot:
        m.plot()
    return m


def sparse_toy_linear_1d_classification_uncertain_input(
        num_inducing=10, seed=0, max_iters=100, optimize=True, plot=False, device=None,
        dtype=None):
    """Sparse classification with uncertain inputs (GPy classification.py
    sparse_toy_linear_1d_classification_uncertain_input)."""
    from ..models import SparseGPClassificationUncertainInput

    data = datasets.toy_linear_1d_classification(seed=seed)
    X = data["X"]
    X_var = np.random.default_rng(seed).uniform(0.3, 0.5, X.shape)
    Y = data["Y"][:, 0:1]  # already {0,1}
    m = SparseGPClassificationUncertainInput(X, X_var, Y, num_inducing=num_inducing,
                                             device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m
