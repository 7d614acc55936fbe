"""Step timing, metrics, profiler regions and kernel-build logging.

Counterpart of gpy_tpu/util/diagnostics.py. The reference framework has
no tracing or profiling (stdlib logging only, GPy/core/gp.py:16); this
module is the port's:

  * `StepTimer` times steps on the host clock and synchronizes with the
    card (torch.cuda.synchronize) on a CUDA tensor it is given, since a
    CUDA launch returns before the work is done. A failing synchronize
    raises.
  * `trace(name, trace_dir)` runs torch.profiler over a region (CPU and,
    where torch sees a card, CUDA activity) and writes a Chrome trace into
    `trace_dir`; without a directory it names the region inside an
    enclosing profiler session. A profiler that cannot start raises.
  * `Metrics` is an append-only scalar recorder with summaries.
  * `log_compiles` logs the kernel builds and loads of ops/_build.py.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = ["StepTimer", "Metrics", "trace", "log_compiles"]


def _first_cuda_tensor(value: Any):
    if torch.is_tensor(value):
        return value if value.is_cuda else None
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        for v in value:
            t = _first_cuda_tensor(v)
            if t is not None:
                return t
    return None


def _sync(value: Any) -> None:
    """Wait for the card where `value` holds a CUDA tensor (a tensor or a
    list, tuple or dict of them); host values need no wait."""
    t = _first_cuda_tensor(value)
    if t is not None:
        torch.cuda.synchronize(t.device)


class StepTimer:
    """Per-step wall-clock timing with device synchronization.

    Usage::

        timer = StepTimer()
        for i in range(n):
            with timer.step(sync_on=out_of_last_step):
                out = train_step(state, batch)
            timer.mark_output(out)   # optional: sync on this value
        print(timer.summary())
    """

    def __init__(self, skip_first: int = 1):
        self.times: List[float] = []
        self.skip_first = skip_first

    @contextlib.contextmanager
    def step(self, sync_on: Any = None):
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            _sync(sync_on)
        self.times.append(time.perf_counter() - t0)

    def mark_output(self, value: Any) -> None:
        """Synchronize on `value` and attribute the wait to the last step."""
        if not self.times:
            return
        t0 = time.perf_counter()
        _sync(value)
        self.times[-1] += time.perf_counter() - t0

    @property
    def steady_times(self) -> List[float]:
        return self.times[self.skip_first:] if len(self.times) > self.skip_first else self.times

    def summary(self) -> Dict[str, float]:
        ts = np.asarray(self.steady_times or [0.0])
        return {
            "steps": int(len(self.times)),
            "mean_s": float(ts.mean()),
            "median_s": float(np.median(ts)),
            "best_s": float(ts.min()),
            "p90_s": float(np.percentile(ts, 90)),
            "steps_per_s": float(1.0 / max(np.median(ts), 1e-12)),
        }


class Metrics:
    """Append-only scalar metric recorder with summaries."""

    def __init__(self):
        self._data: Dict[str, List[float]] = {}

    def record(self, name: str, value) -> None:
        self._data.setdefault(name, []).append(float(value))

    def record_many(self, **kv) -> None:
        for k, v in kv.items():
            self.record(k, v)

    def history(self, name: str) -> List[float]:
        return list(self._data.get(name, []))

    def last(self, name: str) -> Optional[float]:
        h = self._data.get(name)
        return h[-1] if h else None

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for k, vs in self._data.items():
            a = np.asarray(vs)
            out[k] = {
                "count": int(a.size),
                "last": float(a[-1]),
                "mean": float(a.mean()),
                "min": float(a.min()),
                "max": float(a.max()),
            }
        return out


def profiler_activities():
    """CPU activity, and CUDA activity where torch sees a card."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def chrome_trace_path(trace_dir: str) -> str:
    """A new file name for a Chrome trace in `trace_dir`."""
    os.makedirs(trace_dir, exist_ok=True)
    return os.path.join(trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")


@contextlib.contextmanager
def trace(name: str, trace_dir: Optional[str] = None):
    """Profile a region as the named range `name`. With `trace_dir` a
    torch.profiler session runs over the region and its Chrome trace is
    written there when the region ends without an exception; an exception
    from the region passes through unchanged."""
    from torch.profiler import profile, record_function

    if trace_dir is None:
        with record_function(name):
            yield
        return
    path = chrome_trace_path(trace_dir)
    with profile(activities=profiler_activities()) as prof:
        with record_function(name):
            yield
    prof.export_chrome_trace(path)


class _ListHandler(logging.Handler):
    def __init__(self, out: list):
        super().__init__(logging.INFO)
        self.out = out

    def emit(self, record):
        self.out.append(record.getMessage())


@contextlib.contextmanager
def log_compiles(enabled: bool = True):
    """Log every kernel build (nvcc or g++) and library load that
    gpy_tpu_torch/ops/_build.py makes inside the region, at INFO on the
    "gpy_tpu_torch.ops._build" logger; yields the list of messages. This is
    the port's counterpart of jax.log_compiles (XLA compilations): the
    port compiles its CUDA and C++ sources at first use."""
    from ..ops import _build

    events: list = []
    if not enabled:
        yield events
        return
    log = _build.log
    handler = _ListHandler(events)
    level = log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        yield events
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
