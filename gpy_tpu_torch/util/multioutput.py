"""Multi-output model builders: numpy stacking plus kernel composition.

Counterpart of gpy_tpu/util/multioutput.py:15-92 (GPy/util/multioutput.py
index_to_slices:6, build_XY:48, build_likelihood:70, ICM:86, LCM:118,
Private:138).
"""
from __future__ import annotations

import numpy as np

from ..kern.coregionalize import Coregionalize
from ..likelihoods.gaussian import Gaussian
from ..likelihoods.mixed_noise import MixedNoise

__all__ = ["build_XY", "build_likelihood", "ICM", "LCM", "Private", "index_to_slices"]


def index_to_slices(index):
    """GPy: util/multioutput.py:6 -- the contiguous slices of each index
    value, as a list (one entry per value) of lists of slices."""
    index = np.asarray(index).astype(int).reshape(-1)
    if index.size == 0:
        return []
    out = [[] for _ in range(index.max() + 1)]
    start = 0
    for i in range(1, index.size + 1):
        if i == index.size or index[i] != index[start]:
            out[index[start]].append(slice(start, i))
            start = i
    return out


def build_XY(input_list, output_list=None, index=None):
    """Stack per-output (X_i, Y_i) and append the output-index column.

    GPy: util/multioutput.py:48. Returns numpy (X, Y, output_index), Y None
    when no outputs are given; output i gets index[i] (default i)."""
    if output_list is not None:
        if len(output_list) != len(input_list):
            raise ValueError("input_list and output_list differ in length")
        Y = np.vstack(output_list)
    else:
        Y = None
    if index is None:
        index = range(len(input_list))
    elif len(index) != len(input_list):
        raise ValueError("index and input_list differ in length")
    I = np.hstack([np.repeat(j, x.shape[0]) for x, j in zip(input_list, index)])
    X = np.hstack([np.vstack(input_list), I[:, None]])
    return X, Y, I[:, None]


def build_likelihood(Y_list, noise_index, likelihoods_list=None, device=None, dtype=None):
    """GPy: util/multioutput.py:70 -- MixedNoise over one Gaussian per output
    (named Gaussian_noise_j), on `device` and `dtype`."""
    if likelihoods_list is None:
        likelihoods_list = [Gaussian(name=f"Gaussian_noise_{j}", device=device, dtype=dtype)
                            for j in range(len(Y_list))]
    elif len(likelihoods_list) != len(Y_list):
        raise ValueError("one likelihood per output")
    return MixedNoise(likelihoods_list, device=device, dtype=dtype)


def _kernel_placement(kernel, device, dtype):
    """The device and dtype of `kernel`'s parameters where none is given."""
    p = kernel._first_param()
    if p is not None:
        device = p.device if device is None else device
        dtype = p.dtype if dtype is None else dtype
    return device, dtype


def ICM(input_dim, num_outputs, kernel, W_rank=1, W=None, kappa=None, name="ICM",
        device=None, dtype=None):
    """Intrinsic coregionalization, kernel * B with B on the index column
    input_dim. GPy: util/multioutput.py:86.

    B takes `device` and `dtype`, by default those of the kernel's
    parameters. Known deviation: a kernel whose input_dim is not
    `input_dim` raises here before anything changes, where the reference
    first sets kernel.input_dim and then raises (ROADMAP C(d))."""
    if kernel.input_dim != input_dim:
        raise ValueError("kernel.input_dim does not match input_dim")
    device, dtype = _kernel_placement(kernel, device, dtype)
    B = Coregionalize(1, output_dim=num_outputs, rank=W_rank, W=W, kappa=kappa,
                      active_dims=[input_dim], name="B", device=device, dtype=dtype)
    K = kernel * B
    K.name = name
    return K


def LCM(input_dim, num_outputs, kernels_list, W_rank=1, name="ICM", device=None, dtype=None):
    """Linear coregionalization: the sum of one ICM per kernel.
    GPy: util/multioutput.py:118."""
    K = ICM(input_dim, num_outputs, kernels_list[0], W_rank, name=f"{name}0", device=device,
            dtype=dtype)
    for j, kernel in enumerate(kernels_list[1:]):
        K = K + ICM(input_dim, num_outputs, kernel, W_rank, name=f"{name}{j + 1}",
                    device=device, dtype=dtype)
    return K


def Private(input_dim, num_outputs, kernel, output, kappa=None, name="X", device=None,
            dtype=None):
    """An ICM with variance on one output only: W fixed at zero, kappa 1e-2
    on `output` and 0 elsewhere. GPy: util/multioutput.py:138."""
    K = ICM(input_dim, num_outputs, kernel, W_rank=1, kappa=kappa, name=name, device=device,
            dtype=dtype)
    coreg = K.parts[1]
    coreg.W.fix(np.zeros(coreg.W.shape))
    kap = np.zeros(num_outputs)
    kap[output] = 1e-2
    coreg.kappa = kap
    return K
