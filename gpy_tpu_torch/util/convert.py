"""Carry raw (unconstrained) parameters between gpy_tpu and gpy_tpu_torch.

Both packages key a model's raw parameters by the same dotted paths
(`kern.variance`, `kern.lengthscale`, `likelihood.variance`, ...). The
caller converts gpy_tpu's `get_raw_dict()` to numpy; nothing here imports
the JAX package. Fixed parameters are in the dict too (StudentT's
`deg_free`, Gamma's `beta`) and cross like the others, as raw values under
the same transforms (Logexp for every likelihood parameter); the fixed
flags are set by the constructors, equal in both packages. List children
cross as `key#i` (`kern.parts#1.W`, `likelihood.likelihoods_list#0.variance`).
A kernel shared by two parts (MultioutputGP's [k, DiffKern(k, 0)]) stands
at both of its paths; the later path's value is the one kept, as in the
reference's set_raw_dict.
"""
from __future__ import annotations

import numpy as np

__all__ = ["load_raw_params", "raw_params_numpy"]


def load_raw_params(model, raw: dict) -> None:
    """Write `raw` ({path: numpy array}) into `model`'s raw parameters.

    The keys must be exactly the model's parameter paths: a missing or an
    extra key raises KeyError, a shape mismatch ValueError.
    """
    paths = {path: mod._parameters[n] for path, mod, n in model.named_params()}
    missing = sorted(set(paths) - set(raw))
    extra = sorted(set(raw) - set(paths))
    if missing or extra:
        raise KeyError(f"raw parameters do not match the model: missing {missing}, extra {extra}")
    for path, p in paths.items():
        a = np.asarray(raw[path], dtype=np.float64)
        if a.shape != tuple(p.shape):
            raise ValueError(f"{path}: shape {a.shape}, the model has {tuple(p.shape)}")
    model.set_raw_dict(raw)


def raw_params_numpy(model) -> dict:
    """The model's raw parameters as {path: float64 numpy array}."""
    return {path: raw.cpu().numpy().astype(np.float64)
            for path, raw in model.get_raw_dict().items()}
