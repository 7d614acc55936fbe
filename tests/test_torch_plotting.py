"""Plotting on the port: gpy_tpu_torch.plotting against the reference's
committed plot data.

tests/plot_golden.py's four models (_models(), seed 42) are built as port
models from the same numpy draws, float64 on the CPU, and the seven plots
of its record_all() go through the port's 'recording' backend. Each
recorded array is held to tests/plot_baselines/*.npz (read only, never
re-recorded) within rel 1e-8 (|a - b| <= 1e-8 |b| + 1e-12), EP's
classifier and the Bayesian GPLVM included: no baseline differs by the
sign of the PCA start or an RNG stream, so no live recording is needed.
Then the semantic identities of tests/test_plot_golden.py (mean = predict,
band = quantiles), the backend registry and one matplotlib (Agg) draw.
"""
import os

import numpy as np
import pytest
import torch

from plot_golden import BASELINE_DIR, flatten
import gpy_tpu_torch
import gpy_tpu_torch.kern as tk
import gpy_tpu_torch.plotting as tplt
from gpy_tpu_torch.models import BayesianGPLVM, GPClassification, GPRegression, SparseGPRegression
from gpy_tpu_torch.plotting import gpy_plot as gp

DEV = "cpu"
PLOTS = ["reg_fit", "reg_density", "reg_errorbars", "sparse_fit", "clf_fit", "lvm_latent",
         "lvm_ard"]


def _models():
    """tests/plot_golden.py:_models() on the port."""
    rng = np.random.default_rng(42)
    X = np.linspace(0, 5, 30).reshape(-1, 1)
    Y = np.sin(X) + 0.15 * rng.standard_normal((30, 1))
    reg = GPRegression(X, Y, kernel=tk.RBF(1, variance=0.8, lengthscale=1.1, device=DEV),
                       noise_var=0.05, device=DEV)
    sparse = SparseGPRegression(X, Y, Z=X[::5].copy(), noise_var=0.05, device=DEV)
    sparse.kern.lengthscale = 1.3
    Xc = np.sort(rng.standard_normal((25, 1)), axis=0)
    Yc = (Xc[:, 0] > 0).astype(float).reshape(-1, 1)
    clf = GPClassification(Xc, Yc, kernel=tk.RBF(1, variance=2.0, lengthscale=0.8, device=DEV),
                           device=DEV)
    Yl = np.column_stack([np.sin(np.linspace(0, 6, 25)), np.cos(np.linspace(0, 6, 25)),
                          rng.standard_normal(25) * 0.1])
    lvm = BayesianGPLVM(Yl, 2, num_inducing=6, device=DEV)
    return {"reg": reg, "sparse": sparse, "clf": clf, "lvm": lvm}


@pytest.fixture(scope="module")
def recorded():
    torch.set_num_threads(1)
    prev = tplt._library_name[0]
    tplt.change_plotting_library("recording")
    try:
        m = _models()
        out = {
            "reg_fit": gp.plot_fit(m["reg"], resolution=50),
            "reg_density": gp.plot_density(m["reg"], resolution=40),
            "reg_errorbars": gp.plot_errorbars_trainset(m["reg"]),
            "sparse_fit": gp.plot_fit(m["sparse"], resolution=50),
            "clf_fit": gp.plot_fit(m["clf"], resolution=40),
            "lvm_latent": gp.plot_latent(m["lvm"], resolution=20),
            "lvm_ard": gp.plot_ARD(m["lvm"]),
        }
    finally:
        tplt.change_plotting_library(prev)
    return out, m


@pytest.mark.parametrize("name", PLOTS)
def test_against_reference_baseline(recorded, name):
    want = np.load(os.path.join(BASELINE_DIR, f"{name}.npz"))
    got = flatten(recorded[0][name])
    assert set(got) == set(want.files), sorted(set(got) ^ set(want.files))
    for k in want.files:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8, atol=1e-12, err_msg=f"{name}:{k}")


def test_fit_mean_and_band_are_predict_and_quantiles(recorded):
    canvas, m = recorded[0]["reg_fit"], recorded[1]["reg"]
    (mean,) = [d for d in canvas.arrays("plot") if d.get("label") == "mean"]
    mu, _ = m.predict(mean["X"].reshape(-1, 1))
    np.testing.assert_allclose(mean["Y"], mu[:, 0], rtol=1e-12)
    (band,) = canvas.arrays("fill_between")
    lo, hi = m.predict_quantiles(band["X"].reshape(-1, 1), (2.5, 97.5))
    np.testing.assert_allclose(band["lower"], lo[:, 0], rtol=1e-12)
    np.testing.assert_allclose(band["upper"], hi[:, 0], rtol=1e-12)
    (data,) = [d for d in canvas.arrays("plot") if d.get("label") == "data"]
    np.testing.assert_array_equal(data["X"], m.X.numpy()[:, 0])


def test_density_bands_nested_and_errorbars_centred(recorded):
    (grad,) = recorded[0]["reg_density"].arrays("fill_gradient")
    assert grad["percentiles"].shape[0] == 10
    assert np.all(np.diff(grad["percentiles"], axis=0) >= -1e-12)
    (eb,) = recorded[0]["reg_errorbars"].arrays("yerrorbar")
    m = recorded[1]["reg"]
    np.testing.assert_allclose(eb["Y"], m.predict(m.X)[0][:, 0], rtol=1e-12)
    assert np.all(eb["error"] > 0)


def test_latent_and_ard_plots(recorded):
    ims = recorded[0]["lvm_latent"].arrays("imshow")
    assert len(ims) == 1 and ims[0]["Z"].shape == (20, 20) and np.isfinite(ims[0]["Z"]).all()
    (bar,) = recorded[0]["lvm_ard"].arrays("bar")
    np.testing.assert_array_equal(bar["height"], recorded[1]["lvm"].kern.input_sensitivity())
    (ind,) = recorded[0]["sparse_fit"].arrays("scatter")
    np.testing.assert_array_equal(np.sort(ind["X"]),
                                  np.sort(recorded[1]["sparse"].Z.numpy()[:, 0]))


def test_magnification_gradient_map_and_kernel_plots(recorded):
    m = recorded[1]["lvm"]
    prev = tplt._library_name[0]
    tplt.change_plotting_library("recording")
    try:
        mag = gp.plot_magnification(m, resolution=8).arrays("imshow")[0]["Z"]
        steep = gp.plot_steepest_gradient_map(m, resolution=8).arrays("imshow")[0]["Z"]
        k1 = gp.plot_kernel(tk.RBF(1, device=DEV), resolution=30).arrays("plot")[0]
        k2 = gp.plot_kernel(tk.RBF(2, device=DEV), resolution=16).arrays("contour")[0]
        samples = gp.plot_samples(recorded[1]["reg"], resolution=20, samples=2).arrays("plot")
    finally:
        tplt.change_plotting_library(prev)
    assert mag.shape == (8, 8) and np.all(mag >= 0) and np.isfinite(mag).all()
    assert steep.shape == (8, 8) and set(np.unique(steep)) <= {0, 1, 2}
    np.testing.assert_allclose(k1["Y"], np.exp(-0.5 * k1["X"] ** 2), rtol=1e-12)
    assert k2["Z"].shape == (8, 8) and np.max(k2["Z"]) <= 1.0
    assert len(samples) == 2


def test_backend_registry(monkeypatch):
    prev = tplt._library_name[0]
    try:
        for name, cls in (("recording", "RecordingPlots"), ("matplotlib", "MatplotlibPlots")):
            tplt.change_plotting_library(name)
            assert type(tplt.plotting_library()).__name__ == cls
        tplt.change_plotting_library("none")
        with pytest.raises(RuntimeError, match="no plotting library"):
            tplt.plotting_library()
        with pytest.raises(ValueError, match="unknown plotting library"):
            tplt.change_plotting_library("bokeh")
    finally:
        tplt.change_plotting_library(prev)
    assert gpy_tpu_torch.plotting is tplt  # the package's lazy attribute
    for cls in (gpy_tpu_torch.GP, gpy_tpu_torch.models.GPLVM, gpy_tpu_torch.models.BayesianGPLVM):
        assert hasattr(cls, "plot_latent" if "GPLVM" in cls.__name__ else "plot")
    assert gpy_tpu_torch.kern.Kern.plot is gp.plot_kernel


def test_one_matplotlib_draw(recorded, tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    prev = tplt._library_name[0]
    tplt.change_plotting_library("matplotlib")
    try:
        ax = recorded[1]["reg"].plot(resolution=30)
        ax.figure.savefig(tmp_path / "fit.png")
    finally:
        tplt.change_plotting_library(prev)
        plt.close("all")
    assert (tmp_path / "fit.png").stat().st_size > 0
    assert {ln.get_label() for ln in ax.get_lines()} >= {"mean", "data"}


def test_import_and_default_backend_without_matplotlib():
    """The card's machine has no matplotlib: importing the plotting package
    (and the examples) still works, with 'matplotlib' as the default
    backend, and only drawing raises ImportError."""
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent("""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("matplotlib", "plotly"):
                    raise ImportError("no " + name)
        sys.meta_path.insert(0, Block())
        import numpy as np
        import gpy_tpu_torch.examples
        import gpy_tpu_torch.plotting as p
        from gpy_tpu_torch.models import GPRegression
        assert p._library_name[0] == "matplotlib"
        m = GPRegression(np.zeros((3, 1)), np.zeros((3, 1)), device="cpu")
        try:
            m.plot()
        except ImportError:
            print("draw-raises")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env.pop("GPY_TPU_TORCH_PLOTTING", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "draw-raises"
