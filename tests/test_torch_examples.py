"""The port's examples (gpy_tpu_torch.examples) against gpy_tpu's.

Every example function of the six modules runs on the CPU in float64 at a
small size, with optimize=False where it has the switch: its model (or
models) must evaluate to a finite NLML. For one example of each module
the port model's NLML equals the reference example's (one jitted
evaluation), built by gpy_tpu from the same seeded generators, within rel
1e-10. The datasets
the examples ask for are not cached here, so the loaders fall back to
their synthetic stand-ins through DatasetNotAvailable only.
"""
import contextlib
import inspect
import io

import numpy as np
import pytest
import torch

import gpy_tpu.examples as jex
import gpy_tpu_torch.examples as tex
import gpy_tpu_torch.plotting as tplt
from gpy_tpu_torch.util import datasets

# sizes cut for the CPU: the examples' own defaults are for the card
SMALL = {"big_data_svgp": {"n": 300}, "matrix_free_exact_gp": {"n": 200},
         "large_scale_iterative_regression": {"num_samples": 300},
         "state_space_example": {"n": 200}, "multiple_optima": {"resolution": 3},
         "bgplvm_infer_new": {"max_iters": 2}}


def _functions():
    for modname in tex.__all__:
        mod = getattr(tex, modname)
        for name, fn in inspect.getmembers(mod, inspect.isfunction):
            if not name.startswith("_") and fn.__module__ == mod.__name__:
                yield pytest.param(modname, name, id=f"{modname}.{name}")


@pytest.fixture(autouse=True)
def _setup(tmp_path, monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("GPY_DATA_PATH", str(tmp_path / "no_cache"))


def _models(out):
    if hasattr(out, "log_likelihood"):
        return [out]
    if isinstance(out, (list, tuple)):
        return [m for o in out for m in _models(o)]
    return []


@pytest.mark.parametrize("modname,name", list(_functions()))
def test_example_runs(modname, name):
    fn = getattr(getattr(tex, modname), name)
    params = inspect.signature(fn).parameters
    assert "device" in params or name == "stick_play"
    kw = dict(SMALL.get(name, {}))
    if "device" in params:
        kw["device"] = "cpu"
    if "optimize" in params and name != "bgplvm_infer_new":
        kw["optimize"] = False
    with contextlib.redirect_stdout(io.StringIO()):
        out = fn(**kw)
    if name == "stick_play":
        assert np.isfinite(out).all()
        return
    if name == "boston_example":
        assert all(np.isfinite(v).all() for v in out.values())
        return
    if name == "multiple_optima":  # (models, NLML surface): no model without optimize
        assert out[1].shape == (3, 3) and np.isfinite(out[1]).all()
        return
    models = _models(out)
    assert models, f"{modname}.{name} returned no model"
    for m in models:
        assert m.log_likelihood().dtype == torch.float64
        assert np.isfinite(m.log_likelihood().item())


PAIRS = [("advanced", "tied_lengthscales", {}),
         ("regression", "toy_rbf_1d", {"n": 50}),
         ("classification", "toy_linear_1d_classification", {}),
         ("dimensionality_reduction", "gplvm_simulation", {}),
         ("non_gaussian", "toy_poisson_rbf_1d_laplace", {}),
         ("state_space", "matern_kalman_1d", {"n": 60})]


@pytest.mark.parametrize("modname,name,kw", PAIRS, ids=[f"{m}.{n}" for m, n, _ in PAIRS])
def test_example_nlml_matches_reference(modname, name, kw):
    jm = getattr(getattr(jex, modname), name)(optimize=False, **kw)
    tm = getattr(getattr(tex, modname), name)(optimize=False, device="cpu", **kw)
    nlml_ref, _ = jm._get_objgrad()(jm.get_flat_raw())
    np.testing.assert_allclose(tm.objective_function().item(), float(nlml_ref), rtol=1e-10)


def test_dataset_fallback_catches_only_dataset_not_available():
    def broken():
        raise ValueError("a loader bug")

    with pytest.raises(ValueError, match="a loader bug"):
        tex.regression._dataset_or(broken, lambda: {"X": 0})

    def missing():
        raise datasets.DatasetNotAvailable("not cached")

    with contextlib.redirect_stdout(io.StringIO()):
        assert tex.regression._dataset_or(missing, lambda: {"X": 1}) == {"X": 1}


def test_example_plots_through_the_backend():
    prev = tplt._library_name[0]
    tplt.change_plotting_library("recording")
    try:
        m = tex.regression.toy_rbf_1d(optimize=False, plot=True, n=20, device="cpu")
        canvas = m.plot(resolution=10)
    finally:
        tplt.change_plotting_library(prev)
    assert "fill_between" in canvas.primitives()
