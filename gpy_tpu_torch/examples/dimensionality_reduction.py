"""Dimensionality-reduction demos. Counterpart of
gpy_tpu/examples/dimensionality_reduction.py
(GPy/examples/dimensionality_reduction.py: gplvm_oil_100,
bgplvm_simulation, mrd_simulation, ...). Where a registry dataset is not
in the local cache a synthetic stand-in of the same kind is used."""
from __future__ import annotations

import numpy as np

from ..models import GPLVM, MRD, BayesianGPLVM
from ..util import datasets


def _stand_in(e, what):
    print(f"[gpy_tpu_torch.examples] dataset unavailable ({e}); {what}")


def gplvm_oil_100(optimize=True, plot=False, device=None, dtype=None):
    data = datasets.oil_synthetic(n=100)
    m = GPLVM(data["X"], 2, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=200)
    if plot:
        m.plot_latent(labels=data["Y"][:, 0])
    return m


def bgplvm_simulation(optimize=True, plot=False, max_iters=300, device=None, dtype=None):
    data = datasets.simulation_BGPLVM(n=60, q_true=3, d=8)
    m = BayesianGPLVM(data["Y"], 5, num_inducing=10, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    if plot:
        m.plot_latent()
    return m


def bgplvm_infer_new(optimize=True, max_iters=150, device=None, dtype=None):
    """Train a BGPLVM, then variationally infer q(X*) for held-out rows and
    predict through the uncertain latents (psi-statistics posterior
    predictive): GPy's `m.infer_newX` and predict(VariationalPosterior)
    (inferenceX.py, posterior.py:249-270)."""
    data = datasets.simulation_BGPLVM(n=60, q_true=3, d=8)
    Y = data["Y"]
    m = BayesianGPLVM(Y[:50], 5, num_inducing=10, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    qXs, elbo = m.infer_newX(Y[50:], optimize_iters=200)
    mu, var = m.predict(qXs)  # uncertain-input predictive (mean, total var)
    rmse = float(np.sqrt(np.mean((mu - Y[50:]) ** 2)))
    print(f"infer_newX elbo={float(elbo):.2f}  heldout rmse={rmse:.3f}")
    return m, qXs, (mu, var)


def mrd_simulation(optimize=True, plot=False, max_iters=200, device=None, dtype=None):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((40, 2))
    Y1 = np.sin(X) @ rng.standard_normal((2, 5))
    Y2 = np.cos(X[:, :1]) @ rng.standard_normal((1, 4))
    m = MRD([Y1, Y2], 3, num_inducing=8, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def _oil_data(n=100):
    try:
        data = datasets.oil()
        return data["X"][:n], data["Y"][:n]
    except datasets.DatasetNotAvailable as e:
        _stand_in(e, "using oil_synthetic")
        data = datasets.oil_synthetic(n=n)
        return data["X"], data["Y"]


def _simulate_sincos(D1=4, D2=3, D3=4, N=60, num_inducing=8, plot_sim=False):
    """Three views driven by shared and private sin/cos latents (GPy
    dimensionality_reduction.py _simulate_sincos)."""
    rng = np.random.default_rng(1234)
    x = np.linspace(0, 4 * np.pi, N)[:, None]
    s1, s2, s3 = np.sin(x), np.cos(x), np.sin(2 * x)
    sS = np.cos(0.5 * x)
    S1 = np.hstack([s1, sS])
    S2 = np.hstack([s2, sS])
    S3 = np.hstack([s3, sS])
    Y1 = S1 @ rng.standard_normal((2, D1))
    Y2 = S2 @ rng.standard_normal((2, D2))
    Y3 = S3 @ rng.standard_normal((2, D3))
    return [Y + 0.05 * rng.standard_normal(Y.shape) for Y in (Y1, Y2, Y3)]


def bgplvm_test_model(optimize=False, verbose=1, plot=False, output_dim=200, nan=False,
                      device=None, dtype=None):
    """m = bgplvm_test_model(): model-building smoke (GPy
    dimensionality_reduction.py bgplvm_test_model)."""
    from ..models import BayesianGPLVMMiniBatch

    num_inputs = 13
    num_inducing = 5
    data = datasets.simulation_BGPLVM(n=num_inputs, q_true=2, d=output_dim)
    Y = data["Y"]
    if nan:
        Y = Y.copy()
        Y[np.random.default_rng(0).random(Y.shape) < 0.1] = np.nan
        m = BayesianGPLVMMiniBatch(Y, 3, num_inducing=num_inducing, missing_data=True,
                                   device=device, dtype=dtype)
    else:
        m = BayesianGPLVM(Y, 3, num_inducing=num_inducing, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=100)
    return m


def sparse_gplvm_oil(optimize=True, plot=False, N=100, Q=6, num_inducing=15, max_iters=50,
                     device=None, dtype=None):
    """Sparse GPLVM on oil flow (GPy dimensionality_reduction.py
    sparse_gplvm_oil)."""
    from ..models import SparseGPLVM

    X, _ = _oil_data(N)
    X = (X - X.mean(0)) / X.std(0)
    m = SparseGPLVM(X, Q, num_inducing=num_inducing, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def swiss_roll(optimize=True, verbose=1, plot=False, N=125, num_inducing=15, Q=4,
               device=None, dtype=None):
    """BGPLVM on the swiss roll (GPy dimensionality_reduction.py swiss_roll;
    generated analytically)."""
    data = datasets.swiss_roll_generated(num_samples=N)
    Y = data["Y"]
    Y = (Y - Y.mean(0)) / Y.std(0)
    m = BayesianGPLVM(Y, Q, num_inducing=num_inducing, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=150)
    return m


def bgplvm_oil(optimize=True, verbose=1, plot=False, N=100, Q=10, num_inducing=15,
               max_iters=150, device=None, dtype=None, **k):
    """Bayesian GPLVM on oil flow: the ARD scales should switch off excess
    latent dimensions (GPy dimensionality_reduction.py bgplvm_oil)."""
    X, _ = _oil_data(N)
    X = (X - X.mean(0)) / X.std(0)
    m = BayesianGPLVM(X, Q, num_inducing=num_inducing, device=device, dtype=dtype, **k)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def ssgplvm_oil(optimize=True, verbose=1, plot=False, N=100, Q=10, num_inducing=15,
                max_iters=150, device=None, dtype=None, **k):
    """Spike-and-slab GPLVM on oil flow (GPy dimensionality_reduction.py
    ssgplvm_oil)."""
    from ..models import SSGPLVM

    X, _ = _oil_data(N)
    X = (X - X.mean(0)) / X.std(0)
    m = SSGPLVM(X, Q, num_inducing=num_inducing, pi=0.5, device=device, dtype=dtype, **k)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def gplvm_simulation(optimize=True, verbose=1, plot=False, plot_sim=False, max_iters=200,
                     device=None, dtype=None):
    """MAP GPLVM on simulated data (GPy dimensionality_reduction.py
    gplvm_simulation)."""
    data = datasets.simulation_BGPLVM(n=60, q_true=3, d=8)
    m = GPLVM(data["Y"], 5, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def ssgplvm_simulation(optimize=True, verbose=1, plot=False, plot_sim=False, max_iters=200,
                       useGPU=False, device=None, dtype=None):
    """Spike-and-slab GPLVM on simulated data (GPy
    dimensionality_reduction.py ssgplvm_simulation)."""
    from ..models import SSGPLVM

    data = datasets.simulation_BGPLVM(n=60, q_true=3, d=8)
    m = SSGPLVM(data["Y"], 5, num_inducing=10, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def ssgplvm_simulation_linear(optimize=True, max_iters=100, device=None, dtype=None):
    """Linear-kernel spike-and-slab GPLVM recovering sparse linear factors
    (GPy dimensionality_reduction.py ssgplvm_simulation_linear)."""
    from ..kern import Linear
    from ..models import SSGPLVM

    rng = np.random.default_rng(0)
    N, Qtrue, D, Q = 60, 3, 8, 6
    X = rng.standard_normal((N, Qtrue))
    Y = X @ rng.standard_normal((Qtrue, D)) + 0.05 * rng.standard_normal((N, D))
    m = SSGPLVM(Y, Q, num_inducing=10, kernel=Linear(Q, ARD=True, device=device, dtype=dtype),
                device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def bgplvm_simulation_missing_data(optimize=True, verbose=1, plot=False, max_iters=100,
                                   percent_missing=0.1, device=None, dtype=None):
    """BGPLVM with missing entries (GPy dimensionality_reduction.py
    bgplvm_simulation_missing_data)."""
    from ..models import BayesianGPLVMMiniBatch

    data = datasets.simulation_BGPLVM(n=50, q_true=3, d=8)
    Y = data["Y"].copy()
    inan = np.random.default_rng(0).random(Y.shape) < percent_missing
    Y[inan] = np.nan
    m = BayesianGPLVMMiniBatch(Y, 5, num_inducing=10, missing_data=True, device=device,
                               dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def bgplvm_simulation_missing_data_stochastics(optimize=True, verbose=1, plot=False,
                                               max_iters=80, percent_missing=0.1, d=10,
                                               batchsize=2, device=None, dtype=None):
    """Missing-data BGPLVM with stochastic output-dimension subsampling
    (GPy dimensionality_reduction.py
    bgplvm_simulation_missing_data_stochastics)."""
    from ..models import BayesianGPLVMMiniBatch

    data = datasets.simulation_BGPLVM(n=50, q_true=3, d=d)
    Y = data["Y"].copy()
    inan = np.random.default_rng(0).random(Y.shape) < percent_missing
    Y[inan] = np.nan
    m = BayesianGPLVMMiniBatch(Y, 5, num_inducing=10, missing_data=True, stochastic=True,
                               batchsize=batchsize, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def mrd_simulation_missing_data(optimize=True, verbose=True, plot=False, plot_sim=False,
                                max_iters=100, device=None, dtype=None):
    """MRD where views lose rows (GPy dimensionality_reduction.py
    mrd_simulation_missing_data drops entries per view; as in the
    reference framework, one view drops whole rows and the views are cut to
    their common rows, since q(X) is shared)."""
    rng = np.random.default_rng(0)
    Ylist = _simulate_sincos()
    Ylist = [np.delete(Y, rng.permutation(Y.shape[0])[:5], axis=0) if i == 1 else Y
             for i, Y in enumerate(Ylist)]
    n = min(Y.shape[0] for Y in Ylist)
    Ylist = [Y[:n] for Y in Ylist]
    m = MRD(Ylist, 4, num_inducing=8, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def brendan_faces(optimize=True, verbose=True, plot=False, max_iters=100, device=None,
                  dtype=None):
    """GPLVM on Brendan Frey's face video (GPy dimensionality_reduction.py
    brendan_faces); synthetic shifting-blob frames where the data is not in
    the local cache."""
    try:
        data = datasets.brendan_faces()
        Y = data["Y"][0:-1:10]
    except datasets.DatasetNotAvailable as e:
        _stand_in(e, "synthetic frames")
        rng = np.random.default_rng(0)
        t = np.linspace(0, 2 * np.pi, 50)
        xx = np.arange(49)
        Y = np.stack([np.exp(-0.5 * (xx - 24 - 10 * np.sin(ti)) ** 2 / 9.0)
                      for ti in t]) + 0.01 * rng.standard_normal((50, 49))
    m = GPLVM(Y, 2, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def olivetti_faces(optimize=True, verbose=True, plot=False, max_iters=100, device=None,
                   dtype=None):
    """GPLVM on Olivetti faces (GPy dimensionality_reduction.py
    olivetti_faces); synthetic eigenface-style frames where the data is not
    in the local cache."""
    try:
        data = datasets.olivetti_faces()
        Y = data["Y"][:50]
    except datasets.DatasetNotAvailable as e:
        _stand_in(e, "synthetic frames")
        rng = np.random.default_rng(0)
        Y = rng.standard_normal((40, 3)) @ rng.standard_normal((3, 64)) \
            + 0.05 * rng.standard_normal((40, 64))
    m = GPLVM(Y, 2, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def _stick_data():
    try:
        return datasets.osu_run1()["Y"]
    except datasets.DatasetNotAvailable as e:
        _stand_in(e, "synthetic gait")
        rng = np.random.default_rng(0)
        t = np.linspace(0, 4 * np.pi, 60)[:, None]
        phases = rng.uniform(0, 2 * np.pi, (1, 12))
        return np.sin(t + phases) + 0.02 * rng.standard_normal((60, 12))


def stick_play(range=None, frame_rate=15, optimize=False, verbose=True, plot=False):
    """The OSU run1 mocap sequence (or its synthetic stand-in) as the data
    for the stick demos (GPy dimensionality_reduction.py stick_play)."""
    Y = _stick_data()
    if range is None:
        return Y
    return Y[range[0]:range[1]]


def stick(kernel=None, optimize=True, verbose=True, plot=False, max_iters=100, device=None,
          dtype=None):
    """GPLVM on motion-capture gait data (GPy dimensionality_reduction.py
    stick)."""
    from ..kern import RBF

    Y = _stick_data()
    m = GPLVM(Y, 2, kernel=kernel or RBF(2, device=device, dtype=dtype), device=device,
              dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def bcgplvm_linear_stick(kernel=None, optimize=True, verbose=True, plot=False,
                         max_iters=100, device=None, dtype=None):
    """Back-constrained GPLVM with a linear back-mapping on mocap data (GPy
    dimensionality_reduction.py bcgplvm_linear_stick)."""
    from ..mappings import Linear as LinearMapping
    from ..models import BCGPLVM

    Y = _stick_data()
    mapping = LinearMapping(Y.shape[1], 2, device=device, dtype=dtype)
    m = BCGPLVM(Y, 2, kernel=kernel, mapping=mapping, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def bcgplvm_stick(kernel=None, optimize=True, verbose=True, plot=False, max_iters=100,
                  device=None, dtype=None):
    """Back-constrained GPLVM with an MLP back-mapping (GPy
    dimensionality_reduction.py bcgplvm_stick)."""
    from ..models import BCGPLVM

    Y = _stick_data()
    m = BCGPLVM(Y, 2, kernel=kernel, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def stick_bgplvm(model=None, optimize=True, verbose=True, plot=False, max_iters=150,
                 device=None, dtype=None):
    """Bayesian GPLVM on mocap data (GPy dimensionality_reduction.py
    stick_bgplvm)."""
    Y = _stick_data()
    m = BayesianGPLVM(Y, 6, num_inducing=10, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def robot_wireless(optimize=True, verbose=True, plot=False, max_iters=100, device=None,
                   dtype=None):
    """BGPLVM on WiFi signal strengths (GPy dimensionality_reduction.py
    robot_wireless); a random-walk stand-in where the data is not in the
    local cache."""
    try:
        Y = datasets.robot_wireless()["Y"]
    except datasets.DatasetNotAvailable as e:
        _stand_in(e, "synthetic walk")
        rng = np.random.default_rng(0)
        X = np.cumsum(rng.normal(size=(80, 2)) * 0.1, axis=0)
        Y = np.tanh(X @ rng.normal(size=(2, 8)))
    m = BayesianGPLVM(Y, 4, num_inducing=12, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m


def cmu_mocap(subject="35", motion=["01"], in_place=True, optimize=True, verbose=True,
              plot=False, max_iters=100, device=None, dtype=None):
    """GPLVM on a CMU mocap walk (GPy dimensionality_reduction.py cmu_mocap);
    the synthetic gait where the data is not in the local cache."""
    try:
        Y = datasets.cmu_mocap(subject, motion)["Y"]
        if in_place:
            Y = Y.copy()
            Y[:, 0:3] = 0.0
    except datasets.DatasetNotAvailable as e:
        _stand_in(e, "synthetic gait")
        Y = _stick_data()
    m = GPLVM(Y, 2, device=device, dtype=dtype)
    if optimize:
        m.optimize(max_iters=max_iters)
    return m
