"""Guards on gpy_tpu_torch: it never reaches JAX, never falls back to the CPU
without being asked, and never launches the CUDA kernel on CPU tensors."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpy_tpu_torch.inference import IterativeGaussianInference
from gpy_tpu_torch.kern import RBF, Matern32
from gpy_tpu_torch.mcmc import HMC
from gpy_tpu_torch.models import GPRegression
from gpy_tpu_torch.ops import block_chol as tb
from gpy_tpu_torch.ops import gram_matvec_fused as tf
from gpy_tpu_torch.ops import rbf_gram as tg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _port_sources():
    pkg = os.path.join(ROOT, "gpy_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "chol_probe.py")
    yield os.path.join(ROOT, "matvec_probe.py")
    yield os.path.join(ROOT, "hmc_ab.py")


def test_port_imports_neither_jax_nor_gpy_tpu():
    sources = list(_port_sources())
    assert len(sources) > 20
    for path in sources:
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "gpy_tpu"), f"{path} imports {name}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, gpy_tpu_torch, gpy_tpu_torch.models, gpy_tpu_torch.ops.rbf_gram, "
            "gpy_tpu_torch.ops.gram_matvec_fused, gpy_tpu_torch.inference.iterative, "
            "gpy_tpu_torch.mcmc, gpy_tpu_torch.ops.block_chol, gpy_tpu_torch.ops.blocked_linalg; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'gpy_tpu')]; "
            "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, Y = np.zeros((4, 2)), np.zeros((4, 1))
    with pytest.raises(RuntimeError, match="cuda"):
        GPRegression(X, Y, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        RBF(2)  # the package default device is cuda


def test_model_refuses_a_kernel_on_another_device_or_dtype():
    X, Y = np.zeros((4, 2)), np.zeros((4, 1))
    with pytest.raises(ValueError, match="kernel"):
        GPRegression(X, Y, RBF(2, device="cpu", dtype=torch.float32), device="cpu")


def test_cpu_tensors_never_launch_the_kernel():
    before = tg.launches
    rng = np.random.default_rng(0)
    X = rng.random((50, 2))
    Y = np.sin(X[:, :1])
    m = GPRegression(X, Y, RBF(2, ARD=True, device="cpu"), device="cpu")
    m.optimize(max_iters=3)
    m.predict(X[:5])
    assert tg.launches == before == 0
    assert tg._lib_handle is None
    x = torch.zeros((3, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tg.rbf_gram_cuda(x, x, torch.ones((), dtype=torch.float64))


@pytest.mark.parametrize("kern", [RBF, Matern32])
def test_cpu_fused_fit_never_launches_the_fused_kernels(kern):
    """A fused iterative fit on CPU tensors runs B5/B6's plain twins: the
    launch counters stay 0 and the CUDA library is never loaded."""
    rng = np.random.default_rng(1)
    X = rng.random((80, 2)) * 4.0
    Y = np.sin(X[:, :1])
    inf = IterativeGaussianInference(max_cg=12, n_probes=2, fused=True, materialize=False)
    m = GPRegression(X, Y, kern(2, ARD=True, device="cpu"), noise_var=0.1,
                     inference_method=inf, device="cpu")
    m.optimize(max_iters=2)
    m.predict(X[:5])
    assert tf.matvec_launches == tf.moments_launches == 0
    assert tf._lib_handle is None and tg.launches == 0


def test_cuda_only_entry_points_refuse_cpu_tensors():
    x = torch.zeros((3, 2), dtype=torch.float32)
    v = torch.ones(1, dtype=torch.float32)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tf.stationary_gram_matvec_cuda(x, x, x, v)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tf.gram_moments_cuda(x, x, x, v)
    assert tf._lib_handle is None


def test_unknown_accum_raises():
    X = torch.rand(10, 2)
    with pytest.raises(ValueError, match="accum"):
        tf.stationary_gram_matvec_fused(X, torch.rand(10, 2), 1.0, 1.0, accum="bf16")
    with pytest.raises(ValueError, match="accum"):
        tf.stationary_gram_matvec_fused_diff(X, torch.rand(10, 2), 1.0, 1.0, torch.ones(10),
                                             accum="highest")
    m = GPRegression(X.numpy(), X[:, :1].numpy(), RBF(2, device="cpu"), device="cpu",
                     inference_method=IterativeGaussianInference(max_cg=2, n_probes=2,
                                                                 fused=True, fused_accum="tf32"))
    with pytest.raises(ValueError, match="accum"):
        m.log_likelihood()


def test_cpu_batched_path_never_launches_the_block_kernels():
    """HMC chains and parallel restarts on CPU tensors at N = 300 factor
    through the blocked factorization with B2's plain twin: the counters stay 0 and
    the CUDA library is never loaded."""
    rng = np.random.default_rng(2)
    X = rng.random((300, 2)) * 4.0
    Y = np.sin(X[:, :1])
    m = GPRegression(X, Y, RBF(2, device="cpu"), noise_var=0.1, device="cpu")
    s = HMC(m, stepsize=1e-3, num_leapfrog=1).sample(num_samples=2, num_chains=2, seed=0)
    assert s.shape == (2, 2, 3) and np.isfinite(s).all()
    m.optimize_restarts(num_restarts=2, parallel=True, max_iters=1, verbose=False)
    assert tb.launches == tb.inv_launches == 0
    assert tb._lib_handle is None and tg.launches == 0


def test_block_kernels_refuse_cpu_tensors():
    A = torch.eye(128, dtype=torch.float32).expand(2, -1, -1).contiguous()
    assert not tb.block_chol_available(A)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tb.block_chol_cuda(A)
    with pytest.raises(ValueError, match="not a CUDA device"):
        tb.block_chol_inv_cuda(A)
    assert tb._lib_handle is None


def test_hmc_on_the_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        HMC(GPRegression(np.zeros((4, 2)), np.zeros((4, 1))))
