"""Mappings: parametric functions of the inputs (mean functions, the
back-constraint of BCGPLVM).

Counterpart of gpy_tpu/mappings.py:18-180 (GPy/core/mapping.py and
GPy/mappings/: Linear, Constant, Additive, Compound, Identity, MLP, MLPext,
PiecewiseLinear, Kernel). Only `f` is written; `gradients_X` is autograd's.
Weights drawn at construction come from numpy's generators in the
reference's order (the global `np.random.randn` where it uses it), so a seed
gives both packages the same start.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device, resolve_dtype
from .core.module import Module

__all__ = ["Mapping", "Linear", "Constant", "Additive", "Compound", "Identity", "MLP", "MLPext",
           "PiecewiseLinear", "Kernel"]


class Mapping(Module):
    def __init__(self, input_dim, output_dim, name="mapping", device=None, dtype=None):
        super().__init__(name=name, device=device, dtype=dtype)
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)

    def f(self, X):
        raise NotImplementedError

    def gradients_X(self, dL_dF, X):
        """dL/dX where L = sum(dL_dF * f(X))."""
        X = X.detach().requires_grad_(True)
        g = torch.autograd.grad(torch.sum(dL_dF * self.f(X)), X, allow_unused=True)[0]
        return torch.zeros_like(X) if g is None else g  # f independent of X (Constant)

    def __add__(self, other):
        return Additive(self, other)


class Linear(Mapping):
    """f(X) = X A. GPy: mappings/linear.py."""

    def __init__(self, input_dim, output_dim, name="linmap", device=None, dtype=None):
        super().__init__(input_dim, output_dim, name, device=device, dtype=dtype)
        self._add_param("A", np.random.randn(input_dim, output_dim))

    def f(self, X):
        return X @ self.A.values


class Constant(Mapping):
    """f(X) = c. GPy: mappings/constant.py."""

    def __init__(self, input_dim, output_dim, value=0.0, name="constmap", device=None,
                 dtype=None):
        super().__init__(input_dim, output_dim, name, device=device, dtype=dtype)
        self._add_param("C", np.full((1, output_dim), float(value)))

    def f(self, X):
        return self.C.values.expand(X.shape[0], self.output_dim)


class Identity(Mapping):
    def __init__(self, input_dim, output_dim, name="identity", device=None, dtype=None):
        if input_dim != output_dim:
            raise ValueError("Identity needs input_dim == output_dim")
        super().__init__(input_dim, output_dim, name, device=device, dtype=dtype)

    def f(self, X):
        return X


class Additive(Mapping):
    def __init__(self, mapping1, mapping2, name="add_map"):
        if (mapping1.input_dim != mapping2.input_dim
                or mapping1.output_dim != mapping2.output_dim):
            raise ValueError("Additive needs two mappings of one shape")
        super().__init__(mapping1.input_dim, mapping1.output_dim, name,
                         device=mapping1._device_arg, dtype=mapping1._dtype_arg)
        self.mapping1 = mapping1
        self.mapping2 = mapping2

    def f(self, X):
        return self.mapping1.f(X) + self.mapping2.f(X)


class Compound(Mapping):
    def __init__(self, mapping1, mapping2, name="compound_map"):
        if mapping1.output_dim != mapping2.input_dim:
            raise ValueError("Compound needs mapping1's output to be mapping2's input")
        super().__init__(mapping1.input_dim, mapping2.output_dim, name,
                         device=mapping1._device_arg, dtype=mapping1._dtype_arg)
        self.mapping1 = mapping1
        self.mapping2 = mapping2

    def f(self, X):
        return self.mapping2.f(self.mapping1.f(X))


class MLP(Mapping):
    """One-hidden-layer tanh MLP. GPy: mappings/mlp.py. W1 and W2 are drawn
    by np.random.randn, as the reference draws them (mappings.py:96-98)."""

    def __init__(self, input_dim, output_dim, hidden_dim=3, name="mlpmap", device=None,
                 dtype=None):
        super().__init__(input_dim, output_dim, name, device=device, dtype=dtype)
        self.hidden_dim = int(hidden_dim)
        self._add_param("W1", np.random.randn(input_dim, hidden_dim) / np.sqrt(input_dim + 1))
        self._add_param("b1", np.zeros(hidden_dim))
        self._add_param("W2", np.random.randn(hidden_dim, output_dim) / np.sqrt(hidden_dim + 1))
        self._add_param("b2", np.zeros(output_dim))

    def f(self, X):
        h = torch.tanh(X @ self.W1.values + self.b1.values)
        return h @ self.W2.values + self.b2.values


class MLPext(Mapping):
    """Multi-hidden-layer MLP with a linear output layer. GPy:
    mappings/mlpext.py:8 (tanh, sigmoid or relu; an optional Gaussian prior
    on every weight). Weights from default_rng(0)."""

    _ACTS = {"tanh": torch.tanh, "sigmoid": torch.sigmoid,
             "relu": lambda x: torch.where(x < 0, torch.zeros_like(x), x)}

    def __init__(self, input_dim=1, output_dim=1, hidden_dims=(3,), prior=None,
                 activation="tanh", name="mlpmap", device=None, dtype=None):
        super().__init__(input_dim, output_dim, name, device=device, dtype=dtype)
        if activation not in self._ACTS:
            raise ValueError("activation must be tanh, sigmoid or relu")
        self.activation = activation
        self.hidden_dims = list(hidden_dims)
        rng = np.random.default_rng(0)
        dims = [input_dim] + self.hidden_dims + [output_dim]
        self._n_layers = len(dims) - 1
        for i in range(self._n_layers):
            self._add_param("W%d" % i, rng.standard_normal((dims[i], dims[i + 1])))
            self._add_param("b%d" % i, rng.standard_normal(dims[i + 1]))
        if prior is not None:
            from .core.priors import Gaussian as GaussianPrior

            self.set_prior(GaussianPrior(0.0, float(prior)))

    def f(self, X):
        act = self._ACTS[self.activation]
        h = X
        for i in range(self._n_layers):
            h = h @ getattr(self, "W%d" % i).values + getattr(self, "b%d" % i).values
            if i < self._n_layers - 1:
                h = act(h)
        return h


class PiecewiseLinear(Mapping):
    """1-D piecewise-linear mapping through (breaks, values) knots, slope 1
    outside the knots. GPy: mappings/piecewise_linear.py:5."""

    def __init__(self, input_dim, output_dim, values, breaks, name="piecewise_linear",
                 device=None, dtype=None):
        if input_dim != 1 or output_dim != 1:
            raise ValueError("PiecewiseLinear maps one column to one column")
        super().__init__(input_dim, output_dim, name, device=device, dtype=dtype)
        values = np.asarray(values, dtype=float).ravel()
        breaks = np.asarray(breaks, dtype=float).ravel()
        if values.size != breaks.size:
            raise ValueError("PiecewiseLinear needs one value per break")
        self._add_param("values", values)
        self._add_param("breaks", breaks)

    def f(self, X):
        x = X.reshape(-1)
        b, v = self.breaks.values, self.values.values
        order = torch.argsort(b)
        sb, sv = b[order], v[order]
        if sb.numel() == 1:
            y = sv.expand_as(x)
        else:
            # jnp.interp between the knots: the segment of each x, clamped
            i = torch.clamp(torch.searchsorted(sb.detach(), x.detach(), right=True), 1,
                            sb.numel() - 1)
            x0, x1, y0, y1 = sb[i - 1], sb[i], sv[i - 1], sv[i]
            y = y0 + (x - x0) * (y1 - y0) / (x1 - x0)
        y = torch.where(x < sb[0], x + sv[0] - sb[0], y)
        y = torch.where(x > sb[-1], x + sv[-1] - sb[-1], y)
        return y.reshape(-1, 1)


class Kernel(Mapping):
    """f(X) = K(X, Z) A, a kernel-basis mapping. GPy: mappings/kernel.py."""

    def __init__(self, input_dim, output_dim, Z, kernel, name="kernmap", device=None,
                 dtype=None):
        super().__init__(input_dim, output_dim, name, device=device, dtype=dtype)
        self.Z = torch.tensor(np.asarray(Z, dtype=np.float64), dtype=resolve_dtype(dtype),
                              device=resolve_device(device))
        self.kernel = kernel
        self._add_param("A", np.random.randn(np.asarray(Z).shape[0], output_dim))

    def f(self, X):
        return self.kernel.K(X, self.Z) @ self.A.values
