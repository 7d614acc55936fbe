"""One-vs-all multiclass classification. Reference: gpy_tpu/models/
one_vs_all_classification.py (GPy/models/one_vs_all_classification.py and
one_vs_all_sparse_classification.py): one binary classifier per class,
each optimized with max_iters=100."""
from __future__ import annotations

import numpy as np

from .gp_classification import GPClassification
from .sparse_gp_classification import SparseGPClassification

__all__ = ["OneVsAllClassification", "OneVsAllSparseClassification"]


class OneVsAllClassification:
    def __init__(self, X, Y, kernel=None, Y_metadata=None, messages=True, device=None,
                 dtype=None):
        self._fit(X, Y, kernel, messages, lambda Yc, k: GPClassification(
            X, Yc, kernel=k, Y_metadata=Y_metadata, device=device, dtype=dtype))

    def _fit(self, X, Y, kernel, messages, build):
        Y = np.asarray(Y).reshape(-1)
        self.classes = np.unique(Y)
        self.results = {}
        for c in self.classes:
            Yc = (Y == c).astype(float).reshape(-1, 1)
            m = build(Yc, kernel.copy() if kernel is not None else None)
            m.optimize(max_iters=100)
            if messages:
                print(f"Class {c} vs all: trained")
            self.results[c] = m

    def predict(self, Xnew):
        """Per-class probabilities (one-vs-all, unnormalized) and the argmax class."""
        probs = np.hstack([self.results[c].predict(Xnew)[0] for c in self.classes])
        return probs, self.classes[np.argmax(probs, axis=1)]


class OneVsAllSparseClassification(OneVsAllClassification):
    def __init__(self, X, Y, kernel=None, Y_metadata=None, num_inducing=10, messages=True,
                 device=None, dtype=None):
        self._fit(X, Y, kernel, messages, lambda Yc, k: SparseGPClassification(
            X, Yc, kernel=k, num_inducing=num_inducing, Y_metadata=Y_metadata, device=device,
            dtype=dtype))
