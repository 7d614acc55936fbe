"""Non-Gaussian likelihood demos. Counterpart of
gpy_tpu/examples/non_gaussian.py (GPy/examples/non_gaussian.py:
student_t_approx, toy_poisson_rbf_1d_laplace:342, boston_example)."""
from __future__ import annotations

import numpy as np

from .. import kern
from ..core.gp import GP
from ..inference import Laplace
from ..likelihoods import Poisson, StudentT


def student_t_approx(optimize=True, plot=False, device=None, dtype=None):
    """Robust regression with outliers (GPy: non_gaussian.student_t_approx)."""
    rng = np.random.default_rng(0)
    X = np.sort(rng.random((40, 1)) * 6, 0)
    Y = np.sin(X) + 0.1 * rng.standard_normal((40, 1))
    Y[::9] += 2.5 * rng.standard_normal((Y[::9].shape[0], 1))  # outliers
    m = GP(X, Y, kern.RBF(1, device=device, dtype=dtype),
           StudentT(deg_free=4.0, sigma2=0.1, device=device, dtype=dtype),
           inference_method=Laplace(), name="studentt_gp", device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=200)
    if plot:
        m.plot()
    return m


def toy_poisson_rbf_1d_laplace(optimize=True, plot=False, device=None, dtype=None):
    """GPy: non_gaussian.py:342."""
    rng = np.random.default_rng(0)
    X = np.linspace(0, 6, 60).reshape(-1, 1)
    rate = np.exp(np.sin(X) + 1.0)
    Y = rng.poisson(rate).astype(float)
    m = GP(X, Y, kern.RBF(1, device=device, dtype=dtype), Poisson(device=device, dtype=dtype),
           inference_method=Laplace(), name="poisson_gp", device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=200)
    if plot:
        m.plot()
    return m


def boston_example(optimize=True, plot=False, num_folds=4, max_iters=80, device=None,
                   dtype=None):
    """Student-t process against Gaussian GP regression on Boston housing
    with k-fold RMSE (GPy non_gaussian.py boston_example, which raises
    NotImplementedError("Needs updating"); this one runs). Synthetic
    housing-like data where the data is not in the local cache."""
    from ..models import GPRegression, TPRegression
    from ..util import datasets

    try:
        data = datasets.boston_housing()
        X, Y = data["X"], data["Y"]
    except datasets.DatasetNotAvailable as e:
        print(f"[gpy_tpu_torch.examples] dataset unavailable ({e}); synthetic data")
        rng = np.random.default_rng(0)
        X = rng.normal(size=(120, 6))
        Y = (X @ rng.normal(size=(6, 1))) + 0.3 * rng.standard_t(3, size=(120, 1))
    X = (X - X.mean(0)) / X.std(0)
    Y = (Y - Y.mean()) / Y.std()
    n = X.shape[0]
    rng = np.random.default_rng(1)
    idx = rng.permutation(n)
    folds = np.array_split(idx, num_folds)
    scores = {"gaussian": [], "studentt": []}
    for k in range(num_folds):
        test = folds[k]
        train = np.concatenate([folds[j] for j in range(num_folds) if j != k])
        mg = GPRegression(X[train], Y[train], device=device, dtype=dtype)
        mt = TPRegression(X[train], Y[train], device=device, dtype=dtype)
        if optimize:
            mg.optimize(max_iters=max_iters)
            mt.optimize(max_iters=max_iters)
        for name, m in (("gaussian", mg), ("studentt", mt)):
            mu, _ = m.predict(X[test])
            scores[name].append(float(np.sqrt(np.mean((np.asarray(mu) - Y[test]) ** 2))))
    print({k: float(np.mean(v)) for k, v in scores.items()})
    return scores
