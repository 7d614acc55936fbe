"""Profiler traces, named regions and honest step timing on torch.

Counterpart of gpy_tpu/util/profiling.py:

    from gpy_tpu_torch.util.profiling import trace, annotate, StepTimer

    with trace("/tmp/tb"):                  # torch.profiler -> Chrome trace in /tmp/tb
        model.optimize(max_iters=10)

    with annotate("elbo-step"):             # named range in the trace (and NVTX on the card)
        ...

    timer = StepTimer()
    for i in range(100):
        with timer.step(sync=out):          # synchronized with the card before the clock stops
            out = step_fn()
    timer.summary()                          # {n, mean_ms, p50_ms, p90_ms, min_ms}

A CUDA launch returns before the card has finished, so StepTimer
synchronizes with the card (torch.cuda.synchronize) on the CUDA tensor it
is given before it reads the clock. Nothing here degrades to a no-op: a
profiler or a synchronize that fails raises.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .diagnostics import _sync, chrome_trace_path, profiler_activities

__all__ = ["trace", "annotate", "StepTimer", "profile_objective"]


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler over the with-body, CPU and (where torch sees a card)
    CUDA activity; the Chrome trace (chrome://tracing, Perfetto) is written
    into `logdir` when the body ends without an exception. Yields logdir."""
    from torch.profiler import profile

    path = chrome_trace_path(logdir)
    with profile(activities=profiler_activities()) as prof:
        yield logdir
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def annotate(name: str):
    """A named region in the profiler's timeline (record_function), and an
    NVTX range where torch sees a card."""
    from torch.profiler import record_function

    with record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


class StepTimer:
    """Wall-clock step timing, synchronized with the card."""

    def __init__(self):
        self.times_s = []
        self.sync_target = None

    @contextlib.contextmanager
    def step(self, sync=None):
        """Time the with-body. Pass `sync=tensor` (or set
        `timer.sync_target = ...` inside the body): where it is a CUDA
        tensor the clock stops after the card has finished."""
        self.sync_target = sync
        t0 = time.perf_counter()
        yield self
        _sync(self.sync_target)
        self.times_s.append(time.perf_counter() - t0)

    def summary(self):
        t = np.asarray(self.times_s) * 1e3
        if t.size == 0:
            return {"n": 0}
        return {
            "n": int(t.size),
            "mean_ms": float(t.mean()),
            "p50_ms": float(np.percentile(t, 50)),
            "p90_ms": float(np.percentile(t, 90)),
            "min_ms": float(t.min()),
        }


def profile_objective(model, n_calls: int = 5, logdir: str | None = None):
    """Time the model's objective and gradient (Model._objective_and_grad,
    which reads both back to the host) at a fresh raw vector each call, so
    that no cached result is timed; optionally under `trace(logdir)`. Two
    untimed calls run first (kernel builds, first-use allocations). The
    model's parameters are left as they were. Returns the StepTimer
    summary."""
    flat = model.get_flat_raw().detach().cpu().numpy().astype(np.float64)
    try:
        model._objective_and_grad(flat)
        model._objective_and_grad(flat * (1.0 + 1e-7))
        timer = StepTimer()
        ctx = trace(logdir) if logdir else contextlib.nullcontext()
        with ctx:
            for i in range(1, n_calls + 1):
                with timer.step():
                    model._objective_and_grad(flat + 1e-6 * i)
    finally:
        model.set_flat_raw(flat)
    return timer.summary()
