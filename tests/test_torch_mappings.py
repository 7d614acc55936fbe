"""gpy_tpu_torch.mappings against gpy_tpu.mappings: every class BCGPLVM can
take (Linear, Constant, Identity, Additive, Compound, MLP, MLPext,
PiecewiseLinear, Kernel) built after the same numpy seed, its f(X) and
gradients_X at float64 on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpy_tpu.kern as gk
import gpy_tpu.mappings as jmaps
import gpy_tpu_torch.kern as tk
import gpy_tpu_torch.mappings as tmaps
from gpy_tpu_torch.util.convert import raw_params_numpy

jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


MAPPINGS = ["linear", "constant", "identity", "additive", "compound", "mlp", "mlpext_relu",
            "piecewise", "kernel"]


def _mapping(pkg, name):
    """One mapping of each class, built in `pkg` (gpy_tpu.mappings or
    gpy_tpu_torch.mappings) after the same numpy seed."""
    np.random.seed(5)
    c = {} if pkg.__name__.startswith("gpy_tpu.") else {"device": "cpu"}
    if name == "linear":
        return pkg.Linear(3, 2, **c)
    if name == "constant":
        return pkg.Constant(3, 2, value=0.7, **c)
    if name == "identity":
        return pkg.Identity(3, 3, **c)
    if name == "additive":
        return pkg.Additive(pkg.Linear(3, 2, **c), pkg.MLP(3, 2, hidden_dim=4, **c))
    if name == "compound":
        return pkg.Compound(pkg.Linear(3, 4, **c), pkg.MLP(4, 2, **c))
    if name == "mlp":
        return pkg.MLP(3, 2, hidden_dim=5, **c)
    if name == "mlpext_relu":
        return pkg.MLPext(3, 2, hidden_dims=(4, 3), activation="relu", **c)
    if name == "piecewise":
        return pkg.PiecewiseLinear(1, 1, values=[0.5, -1.0, 2.0], breaks=[0.3, -0.4, 1.1], **c)
    Z = np.random.default_rng(6).standard_normal((4, 3))
    kern = gk.RBF(3, lengthscale=1.3) if not c else tk.RBF(3, lengthscale=1.3, **c)
    return pkg.Kernel(3, 2, Z, kern, **c)


@pytest.mark.parametrize("name", MAPPINGS)
def test_mappings_match_reference(name):
    """Each mapping class BCGPLVM can take: the same weights from one numpy
    seed (raw dicts equal), f(X) and d sum(C f(X)) / dX against the
    reference (rel 1e-12)."""
    jm, tm = _mapping(jmaps, name), _mapping(tmaps, name)
    ref_raw = {k: np.asarray(v) for k, v in jm.get_raw_dict().items()}
    got_raw = raw_params_numpy(tm)
    assert list(got_raw) == list(ref_raw)
    for k in ref_raw:
        np.testing.assert_allclose(got_raw[k], ref_raw[k], rtol=1e-15, err_msg=k)
    g = np.random.default_rng(7)
    X = g.uniform(-1.5, 1.5, (9, tm.input_dim))
    C = g.standard_normal((9, tm.output_dim))
    ref = np.asarray(jm.f(jnp.asarray(X)))
    got = tm.f(torch.tensor(X)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tm.gradients_X(torch.tensor(C), torch.tensor(X)).numpy(),
                               np.asarray(jm.gradients_X(C, X)), rtol=1e-12, atol=1e-14)
