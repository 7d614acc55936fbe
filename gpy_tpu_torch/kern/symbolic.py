"""Symbolic: a covariance function from a sympy expression.

Counterpart of gpy_tpu/kern/symbolic.py (GPy/kern/src/symbolic.py and the
sympy code generation of GPy/core/symbolic.py). The expression is turned
into torch code by `sympy.lambdify` once; K(X, X2) broadcasts the columns,
(N, 1) against (1, M), through it, and autograd gives every derivative the
reference generated symbolically.

The expression uses x_0..x_{Q-1} and z_0..z_{Q-1} (or x and z when
input_dim == 1); every other free symbol is a trainable parameter
(positive by default, as GPy's kernels).

sympy prints a numeric sub-expression such as sqrt(2), log(2) or
loggamma(5/2) as a call on a Python number (`sqrt(2)` is torch.sqrt(2),
which raises: torch's functions take tensors). `lambdify_torch` first
replaces every such sub-expression by its value as a 30-digit Float, which
prints as a Python float; in torch arithmetic it takes the dtype and device
of the tensors it meets. The lambdified callables do not pickle: they are
dropped with the state and made again from the stored expression.
"""
from __future__ import annotations

import torch

from ..config import resolve_device
from ..core.transformations import Logexp
from .kern import Kern

__all__ = ["Symbolic", "lambdify_torch"]


def _numeric_to_float(expr):
    """expr with every real numeric sub-expression that is not already a
    rational or a Float replaced by a Float of its value (sqrt(2), pi,
    log(2), loggamma(5/2), ...)."""
    import sympy

    def numeric(e):
        return bool(e.is_number and e.is_real and not e.is_Rational and not e.is_Float)

    return expr.replace(numeric, lambda e: sympy.Float(e.evalf(30), 30))


def lambdify_torch(args, expr):
    """sympy.lambdify to torch of `expr` with its numeric sub-expressions
    made Floats."""
    import sympy

    return sympy.lambdify(args, _numeric_to_float(expr), modules="torch")


def as_shape(out, shape, like):
    """The lambdified result as a tensor of `shape` with `like`'s dtype and
    device: an expression free of the inputs returns a parameter or a
    number, which is broadcast (and materialized)."""
    out = torch.as_tensor(out, dtype=like.dtype, device=like.device)
    if tuple(out.shape) != tuple(shape):
        out = out.expand(shape).contiguous()
    return out


class Symbolic(Kern):
    def __init__(self, input_dim, k=None, parameters=None, active_dims=None, name="symbolic",
                 positive_params=True, device=None, dtype=None):
        """k: a sympy expression in x_i, z_i and parameter symbols.

        parameters: optional {name: initial value} of the parameter symbols
        (default 1.0). positive_params: constrain the parameters through
        Logexp (False for expressions that need signed parameters).
        """
        import sympy

        if k is None:
            raise ValueError("You must provide a sympy expression for the covariance function.")
        super().__init__(input_dim, active_dims=active_dims, name=name, device=device,
                         dtype=dtype)
        resolve_device(device)  # raises for "cuda" without a card, parameters or not
        x_syms = [sympy.Symbol(f"x_{i}") for i in range(input_dim)]
        z_syms = [sympy.Symbol(f"z_{i}") for i in range(input_dim)]
        if input_dim == 1:
            # the x/z shorthand, renamed to x_0/z_0
            k = k.subs({sympy.Symbol("x"): x_syms[0], sympy.Symbol("z"): z_syms[0]})
        elif any(s.name in ("x", "z") for s in k.free_symbols):
            raise ValueError(
                "with input_dim > 1 use x_0..x_{Q-1} / z_0..z_{Q-1}; bare "
                "'x'/'z' would silently become trainable parameters")
        io_names = {s.name for s in x_syms} | {s.name for s in z_syms}
        param_syms = sorted((s for s in k.free_symbols if s.name not in io_names),
                            key=lambda s: s.name)
        parameters = dict(parameters or {})
        unknown = set(parameters) - {s.name for s in param_syms}
        if unknown:
            raise ValueError(f"parameters {sorted(unknown)} not in the expression")
        tr = Logexp() if positive_params else None
        for s in param_syms:
            self._add_param(s.name, float(parameters.get(s.name, 1.0)), transform=tr)
        self.__dict__["_param_names"] = [s.name for s in param_syms]
        self.__dict__["_sym_k"] = k
        self._rebuild_after_load()

    def _rebuild_after_load(self):
        """(Re)lambdify from the stored expression: one callable for K, one
        for its diagonal (K with z := x)."""
        import sympy

        x_syms = [sympy.Symbol(f"x_{i}") for i in range(self.input_dim)]
        z_syms = [sympy.Symbol(f"z_{i}") for i in range(self.input_dim)]
        param_syms = [sympy.Symbol(n) for n in self._param_names]
        kdiag = self._sym_k.subs(dict(zip(z_syms, x_syms)))
        self.__dict__["_k_fn"] = lambdify_torch(x_syms + z_syms + param_syms, self._sym_k)
        self.__dict__["_kdiag_fn"] = lambdify_torch(x_syms + param_syms, kdiag)

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_k_fn", None)
        d.pop("_kdiag_fn", None)
        return d

    def __setstate__(self, d):
        super().__setstate__(d)
        self._rebuild_after_load()

    def _param_values(self):
        return [getattr(self, n).values for n in self._param_names]

    def K(self, X, X2=None):
        X = self._slice(X)
        X2 = X if X2 is None else self._slice(X2)
        xs = [X[:, i, None] for i in range(self.input_dim)]
        zs = [X2[None, :, i] for i in range(self.input_dim)]
        out = self._k_fn(*xs, *zs, *self._param_values())
        return as_shape(out, (X.shape[0], X2.shape[0]), X)

    def Kdiag(self, X):
        X = self._slice(X)
        out = self._kdiag_fn(*[X[:, i] for i in range(self.input_dim)], *self._param_values())
        return as_shape(out, (X.shape[0],), X)

    def __str__(self):
        return f"Symbolic({self._sym_k})"
