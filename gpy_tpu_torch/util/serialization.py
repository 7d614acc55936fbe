"""Serialization: JSON save and load of whole models.

Counterpart of gpy_tpu/util/serialization.py (GPy's to_dict/from_dict and
GPy.load, GPy/core/model.py:22-55, GPy/__init__.py:41-58).

A port model is a torch.nn.Module tree, so its __dict__ holds torch's own
bookkeeping (`_parameters`, `_modules`, `_buffers`, hook dicts) beside the
model's attributes. The encoder writes the port's tree instead: each
Module's raw parameter values from `_parameters` (their ParamSpec --
transform, prior, fixed flag, tie group -- from `_specs`), its children
from `_modules` (list children included), its buffers, then its plain
attributes; torch's internals are rebuilt by nn.Module.__init__ on load,
never written.

Identity survives a round trip: every Module, nn.Parameter, tensor, tie
group and plain object is written once and referenced by number after
that. A tie is one shared nn.Parameter, so after a load a write to one
member is a write to all; a kernel shared by two parts (MultioutputGP's
[k, DiffKern(k, 0)]) stays one object.

Tensors are written with dtype and shape as their raw little-endian bytes
(base64), so every dtype round-trips bit for bit. Caches are written as
None (the GP posterior, SVGP's shuffled copy) or left out and rebuilt by
the owner's `_rebuild_after_load` (the symbolic kernel's and likelihood's
lambdified functions); EP keeps its converged sites, so a loaded EP model
predicts from them without a new sweep. `load(..., device=...)` puts every
tensor, parameters and plain attributes alike, and every stored device
field on that device ("cuda" unless the caller passes "cpu").

Class paths resolve only inside gpy_tpu_torch (and numpy's scalar types);
sympy expressions are read back only from sympy's own constructors. A file
that names anything else raises ValueError.
"""
from __future__ import annotations

import base64
import gzip
import importlib
import io
import json
import keyword
import os
import tokenize
from typing import Any

import numpy as np
import torch
from torch import nn

from ..config import resolve_device
from ..core.module import Module, ParamSpec, TieGroup

__all__ = ["to_dict", "from_dict", "save_model", "load_model"]

_PKG = "gpy_tpu_torch."
# torch.nn.Module's own entries of __dict__: rebuilt by nn.Module.__init__
_TORCH_KEYS = frozenset(nn.Module().__dict__)
# caches written as None: rebuilt at their first use after a load
_RESET_KEYS = frozenset({"_posterior_cache", "_fit_shuffle_cache"})
# lambdified callables: rebuilt by the owner's _rebuild_after_load
_REBUILT_KEYS = frozenset({"_k_fn", "_kdiag_fn", "_logpdf_fn", "_cmean_fn", "_cvar_fn"})
_DEVICE_KEYS = frozenset({"_device_arg"})


def _classpath(obj) -> str:
    cls = type(obj)
    return f"{cls.__module__}.{cls.__qualname__}"


def _resolve(path: str):
    """The class at `path`, which must lie inside gpy_tpu_torch."""
    if not isinstance(path, str) or not path.startswith(_PKG):
        raise ValueError(f"refusing to resolve a class outside gpy_tpu_torch: {path!r}")
    mod, _, name = path.rpartition(".")
    cls = importlib.import_module(mod)
    for part in name.split("."):
        cls = getattr(cls, part)
    if not isinstance(cls, type):
        raise ValueError(f"{path!r} is not a class")
    return cls


def _np_dtype(name: str) -> np.dtype:
    dt = np.dtype(name)
    if dt.kind not in "biufc":
        raise ValueError(f"refusing to decode an array of dtype {name!r}")
    return dt


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown torch dtype {name!r}")
    return dt


def _bytes(arr: np.ndarray) -> str:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.byteorder == ">":
        arr = arr.byteswap().view(arr.dtype.newbyteorder("<"))
    return base64.b64encode(arr.tobytes()).decode("ascii")


def _array(data: str, dtype: str, shape) -> np.ndarray:
    dt = _np_dtype(dtype).newbyteorder("<")
    return np.frombuffer(base64.b64decode(data), dtype=dt).reshape(shape).astype(
        dt.newbyteorder("="), copy=True)


def _check_srepr(text: str) -> None:
    """A sympy srepr string holds only sympy's classes and constants (pi,
    E, I, oo), literals and keyword arguments: no attribute access, no
    other name."""
    import sympy

    toks = list(tokenize.generate_tokens(io.StringIO(text).readline))
    for i, tok in enumerate(toks):
        if tok.type == tokenize.NAME:
            nxt = toks[i + 1].string if i + 1 < len(toks) else ""
            if tok.string in ("True", "False", "None") or (nxt == "=" and not keyword.iskeyword(
                    tok.string)):
                continue
            obj = getattr(sympy, tok.string, None)
            if tok.string.startswith("_") or not isinstance(obj, (type, sympy.Basic)):
                raise ValueError(f"refusing sympy expression naming {tok.string!r}")
        elif tok.type == tokenize.OP and tok.string not in ("(", ")", ",", "=", "-", "[", "]"):
            raise ValueError(f"refusing sympy expression with operator {tok.string!r}")


class _Encoder:
    def __init__(self):
        self.ids = {}  # id(obj) -> number
        self.keep = []  # the encoded objects, alive while their ids are in use

    def _ref(self, x):
        """(number, first): the number of `x`, and whether it is new."""
        n = self.ids.get(id(x))
        if n is not None:
            return n, False
        n = self.ids[id(x)] = len(self.ids)
        self.keep.append(x)
        return n, True

    def tensor(self, t: torch.Tensor):
        n, first = self._ref(t)
        if not first:
            return {"__ref__": n}
        a = t.detach().cpu().contiguous().numpy()
        tag = "__param__" if isinstance(t, nn.Parameter) else "__tensor__"
        return {tag: n, "dtype": str(t.dtype).replace("torch.", ""), "np": a.dtype.str,
                "shape": list(a.shape), "data": _bytes(a), "requires_grad": bool(t.requires_grad)}

    def attrs(self, d: dict, skip=frozenset()):
        out = {}
        for k, v in d.items():
            if k in skip or k in _REBUILT_KEYS:
                continue
            out[k] = None if k in _RESET_KEYS else self(v)
        return out

    def __call__(self, x: Any) -> Any:
        if x is None or isinstance(x, (bool, int, str)):
            return x
        if isinstance(x, float):
            return x
        if isinstance(x, Module):
            n, first = self._ref(x)
            if not first:
                return {"__ref__": n}
            return {
                "__module__": _classpath(x), "id": n, "training": bool(x.training),
                "params": {k: (None if p is None else self.tensor(p))
                           for k, p in x._parameters.items()},
                "modules": {k: self(m) for k, m in x._modules.items()},
                "buffers": {k: (None if b is None else self.tensor(b))
                            for k, b in x._buffers.items()},
                "dict": self.attrs(x.__dict__, _TORCH_KEYS),
            }
        if isinstance(x, nn.Module):
            raise TypeError(f"cannot serialize torch module {type(x)!r} outside gpy_tpu_torch")
        if isinstance(x, torch.Tensor):
            return self.tensor(x)
        if isinstance(x, ParamSpec):
            return {"__spec__": [self(x.transform), self(x.prior), bool(x.fixed), self(x.tie)]}
        if isinstance(x, TieGroup):
            n, first = self._ref(x)
            if not first:
                return {"__ref__": n}
            return {"__tie__": n, "leader": x.leader_path, "followers": list(x.follower_paths),
                    "members": [[self(m), name] for m, name in x.members]}
        if isinstance(x, np.ndarray):
            n, first = self._ref(x)
            if not first:
                return {"__ref__": n}
            if x.dtype.kind not in "biufc":
                raise TypeError(f"cannot serialize a numpy array of dtype {x.dtype}")
            return {"__ndarray__": n, "dtype": x.dtype.str, "shape": list(x.shape),
                    "data": _bytes(x)}
        if isinstance(x, np.generic):
            return {"__npscalar__": x.dtype.str, "data": _bytes(np.asarray(x))}
        if isinstance(x, complex):
            return {"__complex__": [x.real, x.imag]}
        if isinstance(x, torch.device):
            return {"__device__": str(x)}
        if isinstance(x, torch.dtype):
            return {"__dtype__": str(x).replace("torch.", "")}
        if isinstance(x, dict):
            return {"__dict__": [[self(k), self(v)] for k, v in x.items()]}
        if isinstance(x, (list, tuple)):
            return {"__seq__": [self(v) for v in x], "tuple": isinstance(x, tuple)}
        if isinstance(x, (set, frozenset)):
            return {"__set__": [self(v) for v in x], "frozen": isinstance(x, frozenset)}
        if isinstance(x, slice):
            return {"__slice__": [self(x.start), self(x.stop), self(x.step)]}
        if type(x).__module__.split(".")[0] == "sympy":
            import sympy

            return {"__sympy__": sympy.srepr(x)}
        if type(x).__module__.startswith(_PKG) and (hasattr(x, "__dict__")
                                                     or hasattr(type(x), "__slots__")):
            n, first = self._ref(x)
            if not first:
                return {"__ref__": n}
            state = dict(getattr(x, "__dict__", {}))
            for cls in type(x).__mro__:
                for s in getattr(cls, "__slots__", ()):
                    if s != "__dict__" and hasattr(x, s):
                        state[s] = getattr(x, s)
            return {"__obj__": _classpath(x), "id": n, "dict": self.attrs(state)}
        raise TypeError(f"cannot serialize {type(x)!r}")


class _Decoder:
    def __init__(self, device: torch.device):
        self.device = device
        self.objs = {}

    def tensor(self, d, param: bool):
        t = torch.from_numpy(_array(d["data"], d["np"], d["shape"])).to(self.device)
        if t.dtype != _torch_dtype(d["dtype"]):
            raise ValueError(f"tensor of dtype {d['dtype']} stored as {d['np']}")
        if param:
            t = nn.Parameter(t, requires_grad=d["requires_grad"])
        elif d["requires_grad"]:
            t.requires_grad_(True)
        self.objs[d["__param__" if param else "__tensor__"]] = t
        return t

    def attrs(self, d: dict) -> dict:
        out = {}
        for k, v in d.items():
            out[k] = self.device if k in _DEVICE_KEYS else self(v)
        return out

    @staticmethod
    def rebuild(obj):
        rebuild = getattr(obj, "_rebuild_after_load", None)
        if rebuild is not None:
            rebuild()
        return obj

    def __call__(self, x: Any) -> Any:
        if not isinstance(x, dict):
            return x
        if "__ref__" in x:
            return self.objs[x["__ref__"]]
        if "__module__" in x:
            cls = _resolve(x["__module__"])
            if not issubclass(cls, Module):
                raise ValueError(f"{x['__module__']!r} is not a gpy_tpu_torch Module")
            obj = object.__new__(cls)
            nn.Module.__init__(obj)
            self.objs[x["id"]] = obj
            obj.training = x["training"]
            for k, p in x["params"].items():
                obj._parameters[k] = None if p is None else self(p)
            for k, m in x["modules"].items():
                obj._modules[k] = self(m)
            for k, b in x["buffers"].items():
                obj._buffers[k] = None if b is None else self(b)
            obj.__dict__.update(self.attrs(x["dict"]))
            return self.rebuild(obj)
        if "__obj__" in x:
            cls = _resolve(x["__obj__"])
            obj = object.__new__(cls)
            self.objs[x["id"]] = obj
            state = self.attrs(x["dict"])
            slots = {s for c in cls.__mro__ for s in getattr(c, "__slots__", ())}
            for k, v in state.items():
                if k in slots:
                    object.__setattr__(obj, k, v)
                else:
                    obj.__dict__[k] = v
            return self.rebuild(obj)
        if "__param__" in x:
            return self.tensor(x, param=True)
        if "__tensor__" in x:
            return self.tensor(x, param=False)
        if "__spec__" in x:
            tr, prior, fixed, tie = x["__spec__"]
            return ParamSpec(self(tr), self(prior), bool(fixed), self(tie))
        if "__tie__" in x:
            tie = TieGroup.__new__(TieGroup)
            self.objs[x["__tie__"]] = tie
            tie.leader_path = x["leader"]
            tie.follower_paths = tuple(x["followers"])
            tie.members = [(self(m), name) for m, name in x["members"]]
            return tie
        if "__ndarray__" in x:
            arr = _array(x["data"], x["dtype"], x["shape"])
            self.objs[x["__ndarray__"]] = arr
            return arr
        if "__npscalar__" in x:
            return _array(x["data"], x["__npscalar__"], ())[()]
        if "__complex__" in x:
            return complex(*x["__complex__"])
        if "__device__" in x:
            return self.device
        if "__dtype__" in x:
            return _torch_dtype(x["__dtype__"])
        if "__dict__" in x:
            return {self(k): self(v) for k, v in x["__dict__"]}
        if "__seq__" in x:
            seq = [self(v) for v in x["__seq__"]]
            return tuple(seq) if x["tuple"] else seq
        if "__set__" in x:
            items = [self(v) for v in x["__set__"]]
            return frozenset(items) if x["frozen"] else set(items)
        if "__slice__" in x:
            return slice(*(self(v) for v in x["__slice__"]))
        if "__sympy__" in x:
            import sympy

            _check_srepr(x["__sympy__"])
            return sympy.sympify(x["__sympy__"])
        raise ValueError(f"unknown entry in a serialized model: {sorted(x)[:4]}")


def to_dict(obj) -> dict:
    """The JSON-ready dict of a Module (a model, kernel, likelihood, ...)."""
    return _Encoder()(obj)


def from_dict(d: dict, device=None):
    """The Module `d` describes, every tensor on `device` ("cuda" unless the
    caller passes "cpu")."""
    return _Decoder(resolve_device(device))(d)


def save_model(model: Module, path: str, compress: bool = True) -> str:
    """GPy: m.save_model(path) -- gzip JSON (".gz" or ".zip" appended when
    compressing a path without either). Returns the path written."""
    data = json.dumps(to_dict(model)).encode()
    if compress or path.endswith(".gz"):
        if not path.endswith((".gz", ".zip")):
            path = path + (".zip" if path.endswith(".json") else ".gz")
        with gzip.open(path, "wb") as f:
            f.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)
    return path


def load_model(path: str, device=None):
    """GPy: GPy.load(path). Tolerates the .gz/.zip suffix that save_model
    appends to a bare path; reads gzip or plain JSON."""
    if not os.path.exists(path):
        for ext in (".gz", ".zip", ".json.gz"):
            if os.path.exists(path + ext):
                path = path + ext
                break
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    return from_dict(json.loads(data.decode()), device=device)
