"""Stochastic output-dimension schedulers.

Counterpart of gpy_tpu/optimization.py (GPy/inference/optimization/
stochastics.py: StochasticStorage:31, SparseGPMissing:57,
SparseGPStochastics:81). They are numpy schedulers on the host: seeded the
same way, they give the reference's index sequences. The port's
missing-data bound evaluates every output dimension at once
(inference/var_dtc_missing.py), so they serve host-driven stochastic loops.
"""
from __future__ import annotations

import numpy as np

from .util.misc import common_subarrays, param_to_array

__all__ = ["StochasticStorage", "SparseGPMissing", "SparseGPStochastics"]


class StochasticStorage:
    def __init__(self, model):
        self.model = model

    def do_stochastics(self):
        pass

    def reset(self):
        pass


class SparseGPMissing(StochasticStorage):
    """One batch per unique missing-data pattern (GPy: stochastics.py:57)."""

    def __init__(self, model, batchsize=1):
        super().__init__(model)
        self.d = list(common_subarrays(np.isnan(param_to_array(model.Y)), axis=1).items())


class SparseGPStochastics(StochasticStorage):
    """Random output-dimension batches per iteration (GPy: stochastics.py:81)."""

    def __init__(self, model, batchsize=1, missing_data=True):
        super().__init__(model)
        self.batchsize = batchsize
        self.output_dim = int(param_to_array(model.Y).shape[1])
        self.missing_data = missing_data
        self._rng = np.random.default_rng(0)
        self.do_stochastics()

    def do_stochastics(self):
        perm = self._rng.permutation(self.output_dim)
        self.d = [perm[i:i + self.batchsize] for i in range(0, self.output_dim, self.batchsize)]
        self.current_dim = self.d[0]

    def reset(self):
        self._rng = np.random.default_rng(0)
        self.do_stochastics()
