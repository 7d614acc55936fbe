#!/usr/bin/env python3
"""HMC over a sparse model's hyperparameters in float32 and float64, on the CPU.

    python3 hmc_f32_witness.py --package gpy_tpu|gpy_tpu_torch --dtype float32|float64
                               [--chains 4]

chip_smoke.py's sparse_hmc configuration, bench.py:847-853's HMC data
(N=1000, D=2, Y = sin(x_1) + 0.1 eps) as SparseGPRegression(num_inducing=64,
noise_var=0.1) with HMC(stepsize=2e-2, num_leapfrog=10) and 40 samples, run
by one package, one dtype a process: gpy_tpu (the JAX reference, its chains vmapped) or
gpy_tpu_torch (the port, its chains batched). Each process imports only
the package it runs. It prints one JSON line: the
acceptance rate, whether the samples are finite, and the log density at
the start.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

N, D, M, SAMPLES, LEAPFROG, STEP = 1000, 2, 64, 40, 10, 2e-2


def data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.random((N, D)).astype(np.float32) * 4.0
    Y = (np.sin(X[:, :1]) + 0.1 * rng.standard_normal((N, 1))).astype(np.float32)
    return X, Y


def run_reference(chains, dtype):
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["GPY_TPU_X64"] = "1" if dtype == "float64" else "0"  # gpy_tpu/config.py:21-24
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", dtype == "float64")
    from gpy_tpu.mcmc import HMC
    from gpy_tpu.models import SparseGPRegression

    X, Y = data()
    X, Y = X.astype(dtype), Y.astype(dtype)
    m = SparseGPRegression(X, Y, num_inducing=M, noise_var=0.1)
    h = HMC(m, stepsize=STEP, num_leapfrog=LEAPFROG)
    s = h.sample(num_samples=SAMPLES, num_chains=chains, seed=3)
    return h._accept_rate, bool(np.isfinite(s).all()), float(m.log_likelihood())


def run_port(chains, dtype):
    import torch
    from gpy_tpu_torch.mcmc import HMC
    from gpy_tpu_torch.models import SparseGPRegression

    torch.set_num_threads(4)
    X, Y = data()
    m = SparseGPRegression(X, Y, num_inducing=M, noise_var=0.1, device="cpu",
                           dtype=getattr(torch, dtype))
    h = HMC(m, stepsize=STEP, num_leapfrog=LEAPFROG)
    s = h.sample(num_samples=SAMPLES, num_chains=chains, seed=3)
    with torch.no_grad():
        ll = float(m.log_likelihood())
    return h._accept_rate, bool(np.isfinite(s).all()), ll


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("gpy_tpu", "gpy_tpu_torch"), required=True)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--dtype", choices=("float32", "float64"), required=True)
    a = ap.parse_args()
    run = run_reference if a.package == "gpy_tpu" else run_port
    accept, finite, ll = run(a.chains, a.dtype)
    print(json.dumps({"package": a.package, "dtype": a.dtype, "N": N, "M": M,
                      "chains": a.chains, "num_samples": SAMPLES, "num_leapfrog": LEAPFROG,
                      "stepsize": STEP, "accept_rate": accept, "samples_finite": finite,
                      "log_likelihood_at_start": ll}))


if __name__ == "__main__":
    main()
