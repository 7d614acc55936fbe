"""Saving and loading port models: gpy_tpu_torch.util.serialization.

The cases of tests/test_serialization.py (kernels, likelihoods, models,
files, ties, the symbolic kernel) as parametrised cases on the port, and
the port's own: a MultioutputGP whose kernel is shared by two parts
(ROADMAP C(k)), ties that still move together after a load, refusal of a
class path outside gpy_tpu_torch, load(device="cpu"), and an EP model that
predicts from its stored sites without a new sweep.

Every loaded model is held bit for bit to the port model it was saved
from (NLML, flat gradient, predict). The models that have a reference twin
are built in gpy_tpu from the same numpy arrays, the port's raw parameters
carried across from its get_raw_dict() (util/convert.py); the loaded port
model is held to the twin within rel 1e-10: |a - b| <= 1e-10 max|b|, over
the NLML, the flat gradient and each predict array. float64 on the CPU.
"""
import json
import os

import numpy as np
import pytest
import torch

import gpy_tpu
import gpy_tpu.kern as gk
from gpy_tpu.models import GPClassification as JGPClassification
from gpy_tpu.models import GPRegression as JGPRegression
from gpy_tpu.models.sparse_gp_regression import SparseGPRegression as JSparseGPRegression
import gpy_tpu_torch
import gpy_tpu_torch.kern as tk
import gpy_tpu_torch.likelihoods as tl
from gpy_tpu_torch.models import (GPClassification, GPRegression, MultioutputGP,
                                  SparseGPRegression)
from gpy_tpu_torch.util.convert import load_raw_params
from gpy_tpu_torch.util.serialization import from_dict, load_model, save_model, to_dict

DEV = "cpu"
REL = 1e-10


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _data(seed=9):
    rng = np.random.default_rng(seed)
    X = rng.random((24, 2)) * 3.0
    Y = np.sin(X[:, :1]) + 0.3 * X[:, 1:] + 0.1 * rng.standard_normal((24, 1))
    Xs = rng.random((11, 2)) * 3.0
    return X, Y, Xs


def _raw(jm):
    return {k: np.asarray(v) for k, v in jm.get_raw_dict().items()}


# --- twin builders: (port model, reference model or None, prediction inputs)
def _gpr():
    X, Y, Xs = _data()
    jm = JGPRegression(X, Y, gk.RBF(2, variance=1.2, lengthscale=[0.6, 1.5], ARD=True),
                       noise_var=0.1)
    jm.kern.lengthscale.fix()
    jm.kern.variance.set_prior(gpy_tpu.priors.Gamma(2.0, 1.0))
    tm = GPRegression(X, Y, tk.RBF(2, variance=1.2, lengthscale=[0.6, 1.5], ARD=True,
                                   device=DEV), noise_var=0.1, device=DEV)
    tm.kern.lengthscale.fix()
    tm.kern.variance.set_prior(gpy_tpu_torch.priors.Gamma(2.0, 1.0))
    return tm, jm, Xs


def _sparse():
    X, Y, Xs = _data()
    Z = X[::4].copy()
    jm = JSparseGPRegression(X, Y, Z=Z, noise_var=0.05)
    tm = SparseGPRegression(X, Y, Z=Z, noise_var=0.05, device=DEV)
    return tm, jm, Xs


def _cls_ep():
    X, _, Xs = _data()
    Y = (X[:, :1] > 1.5).astype(float)
    jm = JGPClassification(X, Y, kernel=gk.RBF(2, variance=2.0, lengthscale=0.8))
    tm = GPClassification(X, Y, kernel=tk.RBF(2, variance=2.0, lengthscale=0.8, device=DEV),
                          device=DEV)
    return tm, jm, Xs


def _tied():
    X, Y, Xs = _data()
    jm = JGPRegression(X, Y, gk.RBF(2) + gk.Matern32(2))
    jm.tie("kern.parts#0.variance", "kern.parts#1.variance")
    tm = GPRegression(X, Y, tk.RBF(2, device=DEV) + tk.Matern32(2, device=DEV), device=DEV)
    tm.tie("kern.parts#0.variance", "kern.parts#1.variance")
    return tm, jm, Xs


def _symbolic():
    import sympy

    X, Y, Xs = _data()
    x, z, v = sympy.symbols("x z v")
    expr = v * sympy.exp(-(x - z) ** 2)
    jm = JGPRegression(X[:, :1], Y, gk.Symbolic(1, k=expr, parameters={"v": 1.5}))
    tm = GPRegression(X[:, :1], Y, tk.Symbolic(1, k=expr, parameters={"v": 1.5}, device=DEV),
                      device=DEV)
    return tm, jm, Xs[:, :1]


def _mogp_shared():
    """No reference twin: the reference's objective drops the f-f' blocks
    of a shared base kernel (ROADMAP C(k))."""
    X, Y, Xs = _data()
    x = X[:10, :1]
    k = tk.RBF(1, lengthscale=1.5, variance=0.2, device=DEV)
    tm = MultioutputGP([x, x], [Y[:10], np.cos(x)], [k, tk.DiffKern(k, 0, device=DEV)],
                       [tl.Gaussian(variance=0.01, device=DEV),
                        tl.Gaussian(variance=0.02, device=DEV)], device=DEV)
    Xp = np.hstack([Xs[:, :1], np.zeros((Xs.shape[0], 1))])
    return tm, None, Xp


TWINS = {"gpr": _gpr, "sparse": _sparse, "cls_ep": _cls_ep, "tied": _tied,
         "symbolic": _symbolic, "mogp_shared": _mogp_shared}


def _readings(m, Xs):
    f, g = m._objective_and_grad(m.get_flat_raw().numpy())
    mu, var = m.predict(Xs, Y_metadata={"output_index": np.zeros(Xs.shape[0], dtype=int)}
                        if isinstance(m, MultioutputGP) else None)
    return f, g, mu, var


@pytest.fixture(scope="module", params=list(TWINS))
def saved(request, tmp_path_factory):
    """(original, loaded, reference, Xs): the port model saved to a file and
    loaded back on the CPU; its raw parameters are the reference's."""
    torch.set_num_threads(1)
    tm, jm, Xs = TWINS[request.param]()
    if jm is not None:
        load_raw_params(tm, _raw(jm))
    path = save_model(tm, str(tmp_path_factory.mktemp("ser") / f"{request.param}.json"))
    return tm, gpy_tpu_torch.load(path, device=DEV), jm, Xs


def test_loaded_model_is_bit_equal(saved):
    tm, tm2, _, Xs = saved
    assert type(tm2) is type(tm)
    assert [p for p, _, _ in tm2.named_params()] == [p for p, _, _ in tm.named_params()]
    for a, b in zip(_readings(tm2, Xs), _readings(tm, Xs)):
        np.testing.assert_array_equal(a, b)


def test_loaded_model_matches_reference(saved):
    tm, tm2, jm, Xs = saved
    if jm is None:
        assert isinstance(tm, MultioutputGP)  # no twin: ROADMAP C(k)
        return
    f, g, mu, var = _readings(tm2, Xs)
    fr, gr = jm._get_objgrad()(jm.get_flat_raw())  # one jitted evaluation
    np.testing.assert_allclose(f, float(fr), rtol=REL)
    gr = np.asarray(gr)
    assert np.max(np.abs(g - gr)) <= REL * np.max(np.abs(gr))
    if isinstance(jm, JGPClassification):
        # the reference's eager EP posterior compiles for ~7 s on the CPU;
        # test_torch_classification holds the port's EP predict to it, and
        # the loaded model's predict is bit-equal to the port's
        return
    mu_r, var_r = jm.predict(Xs)
    for a, b in ((mu, mu_r), (var, var_r)):
        b = np.asarray(b)
        assert np.max(np.abs(a - b)) <= REL * np.max(np.abs(b))


# --- tests/test_serialization.py's cases --------------------------------------
rng = np.random.default_rng(9)


@pytest.mark.parametrize("make", [
    lambda: tk.RBF(2, variance=1.5, lengthscale=[0.5, 2.0], ARD=True, device=DEV),
    lambda: tk.Matern32(1, device=DEV) + tk.White(1, device=DEV),
    lambda: tk.Linear(2, device=DEV) * tk.Bias(2, device=DEV),
    lambda: tk.StdPeriodic(1, period=2.5, device=DEV),
    lambda: tk.Coregionalize(1, output_dim=3, rank=2, device=DEV),
], ids=["rbf_ard", "sum", "prod", "periodic", "coreg"])
def test_kernel_roundtrip(make):
    k = make()
    X = torch.tensor(rng.standard_normal((6, k.input_dim)))
    if isinstance(k, tk.Coregionalize):
        X = torch.tensor(rng.integers(0, 3, (6, 1)), dtype=torch.float64)
    k2 = from_dict(json.loads(json.dumps(to_dict(k))), device=DEV)
    torch.testing.assert_close(k2.K(X), k.K(X), rtol=0, atol=0)
    assert [p for p, _, _ in k.named_params()] == [p for p, _, _ in k2.named_params()]


@pytest.mark.parametrize("make", [
    lambda: tl.Gaussian(variance=0.3, device=DEV),
    lambda: tl.Bernoulli(device=DEV),
    lambda: tl.StudentT(deg_free=4.0, sigma2=1.2, device=DEV),
    lambda: tl.Poisson(device=DEV),
], ids=["gauss", "bern", "studentt", "poisson"])
def test_likelihood_roundtrip(make):
    lik = make()
    lik2 = from_dict(to_dict(lik), device=DEV)
    f = torch.tensor(rng.standard_normal((4, 1)))
    y = torch.tensor(np.abs(rng.standard_normal((4, 1))) + 0.5)
    if isinstance(lik, tl.Bernoulli):
        y = (y > 1.0).double()
    torch.testing.assert_close(lik2.logpdf(f, y), lik.logpdf(f, y), rtol=0, atol=0)


def test_model_roundtrip_file(tmp_path):
    X = np.linspace(0, 5, 20).reshape(-1, 1)
    Y = np.sin(X) + 0.1 * rng.standard_normal((20, 1))
    m = GPRegression(X, Y, device=DEV)
    m.kern.lengthscale.fix(1.3)
    m.kern.variance.set_prior(gpy_tpu_torch.priors.Gamma(2.0, 1.0))
    m.optimize(max_iters=30)
    m2 = load_model(save_model(m, str(tmp_path / "model.json.gz")), device=DEV)
    assert m2.log_likelihood().item() == m.log_likelihood().item()
    np.testing.assert_array_equal(m2.predict(X)[0], m.predict(X)[0])
    assert m2.kern._specs["lengthscale"].fixed
    assert isinstance(m2.kern._specs["variance"].prior, gpy_tpu_torch.priors.Gamma)
    m2.optimize(max_iters=10)  # a loaded model still optimizes


def test_uncompressed_file_and_suffix(tmp_path):
    X, Y, _ = _data()
    m = GPRegression(X, Y, device=DEV)
    plain = save_model(m, str(tmp_path / "plain.json"), compress=False)
    assert plain.endswith("plain.json") and json.load(open(plain))
    gz = save_model(m, str(tmp_path / "bare"))
    assert gz.endswith("bare.gz")
    for path in (plain, str(tmp_path / "bare")):
        assert load_model(path, device=DEV).log_likelihood().item() == m.log_likelihood().item()


def test_gpy_load_alias(tmp_path):
    X = np.linspace(0, 5, 10).reshape(-1, 1)
    m = GPRegression(X, np.sin(X), device=DEV)
    p = m.save_model(str(tmp_path / "m.json.gz"))
    assert isinstance(gpy_tpu_torch.load(p, device=DEV), GPRegression)


def test_symbolic_kernel_roundtrip():
    import sympy

    x, z, v = sympy.symbols("x z v")
    k = tk.Symbolic(1, k=v * sympy.exp(-(x - z) ** 2), parameters={"v": 1.5}, device=DEV)
    k2 = from_dict(to_dict(k), device=DEV)
    X = torch.tensor(np.random.default_rng(0).standard_normal((10, 1)))
    torch.testing.assert_close(k2.K(X), k.K(X), rtol=0, atol=0)


def test_symbolic_likelihood_and_constants_roundtrip():
    import sympy

    import gpy_tpu_torch.examples.advanced as ex

    m = ex.symbolic_laplace_regression(optimize=False, device=DEV)
    k = tk.Symbolic(1, k=sympy.pi * sympy.exp(-(sympy.Symbol("x") - sympy.Symbol("z")) ** 2 / sympy.E),
                    device=DEV)
    for a in (m, k):
        b = from_dict(json.loads(json.dumps(to_dict(a))), device=DEV)
        if a is m:
            assert b.objective_function().item() == m.objective_function().item()
        else:
            X = torch.linspace(0, 1, 5, dtype=torch.float64)[:, None]
            torch.testing.assert_close(b.K(X), k.K(X), rtol=0, atol=0)


# --- the port's own cases --------------------------------------------------------
def test_ties_move_together_after_a_load():
    X, Y, _ = _data()
    m = GPRegression(X, Y, tk.RBF(2, device=DEV) + tk.Matern32(2, device=DEV), device=DEV)
    m.tie("kern.parts#0.variance", "kern.parts#1.variance")
    m2 = from_dict(json.loads(json.dumps(to_dict(m))), device=DEV)
    assert m2.num_free_params == m.num_free_params
    assert m2.kern.parts[0]._parameters["variance"] is m2.kern.parts[1]._parameters["variance"]
    m2.kern.parts[0].variance = 3.0
    assert float(m2.kern.parts[1].variance) == pytest.approx(3.0, rel=1e-15)
    m.kern.parts[0].variance = 3.0
    assert m2.log_likelihood().item() == m.log_likelihood().item()
    m2.kern.parts[1].variance = 0.5  # the follower moves the leader
    assert float(m2.kern.parts[0].variance) == pytest.approx(0.5, rel=1e-15)


def test_shared_kernel_stays_one_object(saved):
    tm, tm2, _, _ = saved
    if not isinstance(tm, MultioutputGP):
        return
    base, diff = tm2.kern.parts
    assert diff.base_kern is base
    assert tm2.num_free_params == tm.num_free_params
    base.lengthscale = 0.7  # one write reaches both parts
    tm.kern.parts[0].lengthscale = 0.7
    assert tm2.objective_function().item() == tm.objective_function().item()


@pytest.mark.parametrize("where,path", [
    ("__module__", "os.path.join"),
    ("__module__", "torch.nn.Linear"),
    ("__obj__", "subprocess.Popen"),
    ("__sympy__", "Symbol('x').__class__.__init__.__globals__"),
    ("__sympy__", "__import__('os').system('true')"),
], ids=["module_os", "module_torch", "obj_subprocess", "sympy_attribute", "sympy_import"])
def test_refuses_names_outside_the_package(where, path):
    import sympy

    x, z, v = sympy.symbols("x z v")
    m = GPRegression(np.zeros((3, 1)), np.zeros((3, 1)),
                     tk.Symbolic(1, k=v * sympy.exp(-(x - z) ** 2), device=DEV), device=DEV)
    d = to_dict(m)
    text = json.dumps(d)
    if where == "__module__":
        text = text.replace('"gpy_tpu_torch.models.gp_regression.GPRegression"', json.dumps(path))
    elif where == "__obj__":
        text = text.replace('"gpy_tpu_torch.inference.exact.ExactGaussianInference"',
                            json.dumps(path))
    else:
        text = text.replace(json.dumps(sympy.srepr(m.kern._sym_k)), json.dumps(path), 1)
    assert text != json.dumps(d)
    with pytest.raises(ValueError):
        from_dict(json.loads(text), device=DEV)


def test_load_puts_every_tensor_and_device_field_on_the_device(tmp_path):
    X, Y, _ = _data()
    m = GPClassification(X, (Y > 0.5).astype(float), device=DEV)
    m.log_likelihood()
    m2 = gpy_tpu_torch.load(m.save_model(str(tmp_path / "c")), device="cpu")
    assert m2.device == torch.device("cpu") and m2._device_arg == torch.device("cpu")
    tensors = [m2.X, m2.Y, *m2.parameters(), *m2.inference_method._site_cache[1:]]
    assert all(t.device.type == "cpu" and t.dtype == torch.float64 for t in tensors)


def test_ep_predicts_from_stored_sites(tmp_path, monkeypatch):
    X, Y, Xs = _data()
    m = GPClassification(X, (Y > 0.5).astype(float), device=DEV)
    mu, var = m.predict(Xs)
    f, g = m._objective_and_grad(m.get_flat_raw().numpy())
    m2 = gpy_tpu_torch.load(m.save_model(str(tmp_path / "ep")), device=DEV)
    assert m2.inference_method._loading
    sweeps = []
    real = type(m2.inference_method)._run_sweeps
    monkeypatch.setattr(type(m2.inference_method), "_run_sweeps",
                        lambda self, *a, **k: sweeps.append(1) or real(self, *a, **k))
    mu2, var2 = m2.predict(Xs)
    f2, g2 = m2._objective_and_grad(m2.get_flat_raw().numpy())
    assert sweeps == []
    np.testing.assert_array_equal(mu2, mu)
    np.testing.assert_array_equal(var2, var)
    assert f2 == f
    np.testing.assert_array_equal(g2, g)
    m2.inference_method.on_optimization_start()  # an optimize converges them again
    m2.log_likelihood()
    assert sweeps == [1]


def test_caches_are_not_written_and_rebuild():
    X, Y, Xs = _data()
    m = GPRegression(X, Y, device=DEV)
    m.predict(Xs)
    assert m._posterior_cache is not None
    d = to_dict(m)
    assert d["dict"]["_posterior_cache"] is None
    m2 = from_dict(d, device=DEV)
    assert m2._posterior_cache is None
    np.testing.assert_array_equal(m2.predict(Xs)[0], m.predict(Xs)[0])


def test_pickle_roundtrip(tmp_path):
    import gzip
    import pickle

    X, Y, Xs = _data()
    m = GPRegression(X, Y, device=DEV)
    path = m.pickle(str(tmp_path / "m.pkl.gz"))
    with gzip.open(path, "rb") as f:
        m2 = pickle.load(f)
    np.testing.assert_array_equal(m2.predict(Xs)[0], m.predict(Xs)[0])


def test_float32_roundtrips_bit_for_bit(tmp_path):
    X, Y, Xs = _data()
    m = GPRegression(X, Y, tk.RBF(2, ARD=True, device=DEV, dtype=torch.float32), device=DEV,
                     dtype=torch.float32)
    m.kern.lengthscale = [0.3, 0.7]
    m2 = load_model(save_model(m, str(tmp_path / "f32")), device=DEV)
    assert m2.X.dtype == torch.float32 and m2.kern.lengthscale.dtype == torch.float32
    assert torch.equal(m2.X, m.X)
    assert m2.objective_function().item() == m.objective_function().item()
    assert os.path.getsize(str(tmp_path / "f32.gz")) > 0
