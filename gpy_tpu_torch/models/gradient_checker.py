"""Finite-difference checker harnesses, shipped as product features.

Counterpart of gpy_tpu/models/gradient_checker.py:21-146 (GPy/models/
gradient_checker.py: GradientChecker:24, HessianChecker:120,
SkewChecker:293): tools for checking hand-written derivatives against
central differences. The callables may be numpy functions or return torch
tensors, on the CPU or the card; their values are brought to the host as
float64 numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["GradientChecker", "HessianChecker", "SkewChecker"]


def _np(a) -> np.ndarray:
    """A callable's value as a float64 numpy array (np.asarray of a CUDA
    tensor raises)."""
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=float)


def _flatten_x0(x0):
    if isinstance(x0, (list, tuple)):
        parts = [np.atleast_1d(_np(p)) for p in x0]
        return parts
    return [np.atleast_1d(_np(x0))]


class GradientChecker:
    """Check df against finite differences of f.

    f : callable(*xs) -> scalar
    df : callable(*xs) -> gradient(s), same structure as x0
    x0 : array or list of arrays (the point(s) to check around)
    """

    def __init__(self, f, df, x0, names=None):
        self.f = f
        self.df = df
        self.x0 = _flatten_x0(x0)
        self.names = names or [f"x{i}" for i in range(len(self.x0))]

    def _fd_grad(self, step):
        grads = []
        xs = [p.copy() for p in self.x0]
        for i, p in enumerate(xs):
            g = np.zeros_like(p)
            for j in range(p.size):
                orig = p.flat[j]
                p.flat[j] = orig + step
                fp = float(np.sum(_np(self.f(*xs))))
                p.flat[j] = orig - step
                fm = float(np.sum(_np(self.f(*xs))))
                p.flat[j] = orig
                g.flat[j] = (fp - fm) / (2 * step)
            grads.append(g)
        return grads

    def checkgrad(self, verbose=False, step=1e-6, tolerance=1e-3):
        analytic = self.df(*self.x0)
        if not isinstance(analytic, (list, tuple)):
            analytic = [analytic]
        analytic = [np.broadcast_to(_np(a), p.shape)
                    for a, p in zip(analytic, self.x0)]
        numeric = self._fd_grad(step)
        ok = True
        for name, a, n in zip(self.names, analytic, numeric):
            denom = np.maximum(np.abs(a) + np.abs(n), 1e-10)
            ratio = np.abs(a - n) / denom
            good = bool(np.all(ratio < tolerance))
            ok = ok and good
            if verbose:
                print(f"{name}: analytic {a.ravel()} numeric {n.ravel()} "
                      f"max-ratio {ratio.max():.2e} {'OK' if good else 'FAIL'}")
        return ok


class HessianChecker(GradientChecker):
    """Check ddf (Hessian or per-block Hessians) against finite differences
    of df. GPy: gradient_checker.py:120."""

    def __init__(self, f, df, ddf, x0, names=None):
        super().__init__(f, df, x0, names)
        self.ddf = ddf

    def checkgrad(self, verbose=False, step=1e-5, tolerance=1e-3, block_indices=None):
        analytic = self.ddf(*self.x0)
        if not isinstance(analytic, (list, tuple)):
            analytic = [analytic]
        ok = True
        xs = [p.copy() for p in self.x0]
        for i, p in enumerate(xs):
            n = p.size
            H_num = np.zeros((n, n))
            for j in range(n):
                orig = p.flat[j]
                p.flat[j] = orig + step
                gp = _np(self.df(*xs)).ravel()
                p.flat[j] = orig - step
                gm = _np(self.df(*xs)).ravel()
                p.flat[j] = orig
                H_num[:, j] = (gp - gm) / (2 * step)
            H_ana = _np(analytic[i]).reshape(n, n)
            denom = np.maximum(np.abs(H_ana) + np.abs(H_num), 1e-10)
            ratio = np.abs(H_ana - H_num) / denom
            good = bool(np.all(ratio < tolerance))
            ok = ok and good
            if verbose:
                print(f"{self.names[i]} hessian max-ratio {ratio.max():.2e} "
                      f"{'OK' if good else 'FAIL'}")
        return ok


class SkewChecker(HessianChecker):
    """Check d3f (third derivatives) against finite differences of ddf.
    GPy: gradient_checker.py:293."""

    def __init__(self, df, ddf, dddf, x0, names=None):
        super().__init__(df, ddf, dddf, x0, names)
        # layout: f-slot holds df, df-slot holds ddf, ddf-slot holds dddf
        self.dddf = dddf

    def checkgrad(self, verbose=False, step=1e-4, tolerance=1e-3, **kw):
        analytic = self.dddf(*self.x0)
        if not isinstance(analytic, (list, tuple)):
            analytic = [analytic]
        ok = True
        xs = [p.copy() for p in self.x0]
        for i, p in enumerate(xs):
            n = p.size
            T_num = np.zeros((n, n, n))
            for j in range(n):
                orig = p.flat[j]
                p.flat[j] = orig + step
                # shifted layout: self.df holds the user's ddf (see __init__)
                Hp = _np(self.df(*xs)).reshape(n, n)
                p.flat[j] = orig - step
                Hm = _np(self.df(*xs)).reshape(n, n)
                p.flat[j] = orig
                T_num[:, :, j] = (Hp - Hm) / (2 * step)
            T_ana = _np(analytic[i]).reshape(n, n, n)
            denom = np.maximum(np.abs(T_ana) + np.abs(T_num), 1e-10)
            ratio = np.abs(T_ana - T_num) / denom
            good = bool(np.all(ratio < tolerance))
            ok = ok and good
            if verbose:
                print(f"{self.names[i]} skew max-ratio {ratio.max():.2e} "
                      f"{'OK' if good else 'FAIL'}")
        return ok
