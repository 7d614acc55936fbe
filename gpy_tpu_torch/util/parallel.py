"""Data division and checkpointed optimization.

Counterpart of gpy_tpu/util/parallel.py (GPy/util/parallel.py:
divide_data:14 for MPI row sharding, optimize_parallel:32, an optimize
loop with periodic model saves). `divide_data` is a host-side helper for
manual row partitioning; `optimize_parallel` keeps its real feature,
periodic checkpoints during optimization.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["divide_data", "optimize_parallel"]


def divide_data(datanum, rank, size):
    """Contiguous row range [start, end) plus index list for shard `rank` of
    `size` (GPy parallel.py:14-30: the remainder spread over the first
    shards)."""
    base = datanum // size
    rem = datanum % size
    start = rank * base + min(rank, rem)
    end = start + base + (1 if rank < rem else 0)
    return start, end, np.arange(start, end)


def optimize_parallel(model, optimizer=None, messages=True, max_iters=1000,
                      outpath=".", interval=100, name=None, **kwargs):
    """Optimize with a model save every `interval` iterations (GPy
    parallel.py:32-50). Checkpoints are save_model's gzip JSON, so a
    crashed run resumes from gpy_tpu_torch.load(). A save that fails
    raises: the optimization does not go on without its checkpoints."""
    name = name or getattr(model, "name", "model")
    os.makedirs(outpath, exist_ok=True)
    done = 0
    remaining = max_iters
    while remaining > 0:
        chunk = min(interval, remaining)
        model.optimize(optimizer or "lbfgsb", max_iters=chunk, messages=False, **kwargs)
        done += chunk
        remaining -= chunk
        path = model.save_model(os.path.join(outpath, f"{name}_checkpoint"))
        if messages:
            print(f"iter {done:6d}  obj {float(model.objective_function()):.6f}  saved {path}")
    return model
