"""Greedy clustering of time series with per-series input offsets.

Counterpart of gpy_tpu/util/cluster_with_offset.py (GPy/util/
cluster_with_offset.py, Mike Smith): clusters of time series merge while a
joint GPOffsetRegression model has a higher marginal likelihood than the
separate models. The models are the port's, on `device` ("cuda" unless
the caller passes "cpu") and `dtype`.
"""
from __future__ import annotations

import numpy as np

__all__ = ["cluster", "get_log_likelihood", "get_log_likelihood_offset"]


def get_log_likelihood(inputs, data, clust, device=None, dtype=None):
    """LL of the merged clusters ignoring offsets (plain GPRegression)."""
    from ..models import GPRegression

    X = np.vstack([inputs[p] for p in clust])
    Y = np.vstack([data[p].T for p in clust])
    m = GPRegression(X, Y, device=device, dtype=dtype)
    m.optimize(max_iters=100)
    return float(m.log_likelihood()), 0.0


def get_log_likelihood_offset(inputs, data, clust, device=None, dtype=None):
    """LL of the merged clusters with learned per-cluster input offsets."""
    from ..models import GPOffsetRegression

    if len(clust) == 1:
        return get_log_likelihood(inputs, data, clust, device, dtype)
    X = np.vstack(
        [np.hstack([inputs[p], np.full((inputs[p].shape[0], 1), float(i))])
         for i, p in enumerate(clust)]
    )
    Y = np.vstack([data[p].T for p in clust])
    m = GPOffsetRegression(X, Y, device=device, dtype=dtype)
    m.optimize(max_iters=100)
    off = np.asarray(m.offset).reshape(-1)
    return float(m.log_likelihood()), off


def cluster(data, inputs, verbose=False, device=None, dtype=None):
    """Agglomerative clustering driven by offset-GP marginal likelihood.

    data: list of (S, N_p) arrays (series x time) per item;
    inputs: list of (N_p, 1) time arrays. Returns a list of clusters
    (each a list of item indices). GPy: cluster_with_offset.cluster."""
    N = len(data)
    active = [[i] for i in range(N)]
    loglikes = {}

    def ll_of(clust):
        key = tuple(sorted(clust))
        if key not in loglikes:
            loglikes[key], _ = get_log_likelihood_offset(inputs, data, clust, device, dtype)
        return loglikes[key]

    improved = True
    while improved and len(active) > 1:
        improved = False
        best_gain, best_pair = 0.0, None
        for i in range(len(active)):
            for j in range(i + 1, len(active)):
                gain = ll_of(active[i] + active[j]) - ll_of(active[i]) - ll_of(active[j])
                if gain > best_gain:
                    best_gain, best_pair = gain, (i, j)
        if best_pair is not None:
            i, j = best_pair
            merged = active[i] + active[j]
            active = [c for k, c in enumerate(active) if k not in (i, j)] + [merged]
            improved = True
            if verbose:
                print(f"merged -> {active}")
    return active
