"""Link functions (latent f -> mean-parameter space).

Counterpart of gpy_tpu/likelihoods/link_functions.py:29-80 (GPy/likelihoods/
link_functions.py). Only `transf` is needed: the derivative towers are
autograd's.
"""
from __future__ import annotations

import torch

__all__ = ["GPTransformation", "Identity", "Probit", "ScaledProbit", "Cloglog", "Log",
           "Log_ex_1", "Reciprocal", "Heaviside"]


class GPTransformation:
    def transf(self, f):
        raise NotImplementedError

    def __repr__(self):
        return self.__class__.__name__


class Identity(GPTransformation):
    def transf(self, f):
        return f


class Probit(GPTransformation):
    def transf(self, f):
        return torch.special.ndtr(f)


class ScaledProbit(Probit):
    def __init__(self, nu=1.0):
        self.nu = float(nu)

    def transf(self, f):
        return torch.special.ndtr(f * self.nu)


class Cloglog(GPTransformation):
    """p = 1 - exp(-exp(f))."""

    def transf(self, f):
        return 1.0 - torch.exp(-torch.exp(f))


class Log(GPTransformation):
    def transf(self, f):
        return torch.exp(f)


class Log_ex_1(GPTransformation):
    """softplus link: log(1 + exp(f)), as jax.nn.softplus = logaddexp(f, 0).
    F.softplus turns linear above its threshold and would differ there."""

    def transf(self, f):
        return torch.logaddexp(f, torch.zeros_like(f))


class Reciprocal(GPTransformation):
    def transf(self, f):
        return 1.0 / f


class Heaviside(GPTransformation):
    def transf(self, f):
        return torch.where(f > 0, torch.ones_like(f), torch.zeros_like(f))
