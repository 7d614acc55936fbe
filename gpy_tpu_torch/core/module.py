"""Parameter tree: gpy_tpu's Module/Param runtime on top of torch.nn.Module.

Counterpart of gpy_tpu/core/module.py:39-627. A model is a tree of Modules
whose parameters are stored *raw* (unconstrained) as nn.Parameters; the loss
applies each parameter's constraint transform, and torch.autograd supplies
the gradient in raw space.

The user surface is GPy's:

    m.kern.lengthscale = 2.0            # writes transform.inverse(2.0) into the raw leaf
    m.kern.variance.fix()
    m.likelihood.variance.constrain_bounded(1e-3, 10.)
    m.kern.lengthscale.set_prior(Gamma(2., 1.))
    print(m)

Attribute access to a parameter returns a `Param` handle (constrained value
semantics plus the mutation API). Assignment writes into the existing
nn.Parameter in place: it never replaces the parameter with a plain value.

The flat raw vector keeps gpy_tpu's order index for index: own parameters in
registration order, then children in registration order, with list children
keyed ``key#i``; fixed parameters and tie followers are left out. A module
reached by two paths (a kernel shared by two parts) has its parameters at
both paths of the raw dict and once in the flat vector, at the first.

Tied parameters share one nn.Parameter object, so a write to any member is a
write to all, and autograd sums every member's contribution into the one
gradient -- what gpy_tpu gets by writing the leader's block into every
member on each flat round trip.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import resolve_device, resolve_dtype
from .transformations import Logexp, Logistic, Transform

__all__ = ["Module", "Param", "ParamSpec", "TieGroup", "check_placement"]


def _as_tensor(value, dtype, device) -> torch.Tensor:
    if isinstance(value, Param):
        value = value.values.detach()
    if isinstance(value, torch.Tensor):
        return value.detach().to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(value, dtype=np.float64), dtype=dtype, device=device)


def check_placement(what: str, mod, device, dtype) -> None:
    """Raise unless every parameter of `mod` is `dtype` on `device`: a
    model's parts are built with the model's device= and dtype=."""
    for p in mod.parameters():
        if p.device != device or p.dtype != dtype:
            raise ValueError(
                f"{what} parameters are {p.dtype} on {p.device}, the model is {dtype} on "
                f"{device}: build the {what} with the model's device= and dtype=")


class ParamSpec:
    """Metadata for one parameter: constraint transform, prior, fixed flag and
    optional tie group."""

    __slots__ = ("transform", "prior", "fixed", "tie")

    def __init__(self, transform: Optional[Transform] = None, prior=None,
                 fixed: bool = False, tie=None):
        self.transform = transform
        self.prior = prior
        self.fixed = fixed
        self.tie = tie


class TieGroup:
    """Parameters sharing one value and one optimizer slot (paramz tie).

    leader_path/follower_paths are dotted paths from the module tie() was
    called on; `members` holds the (module, name) handles.
    """

    __slots__ = ("leader_path", "follower_paths", "members")

    def __init__(self, paths, members):
        self.leader_path = paths[0]
        self.follower_paths = tuple(paths[1:])
        self.members = list(members)


class Param:
    """Handle to one parameter of a Module: behaves as its constrained value
    and carries the GPy-style mutation API (fix/constrain/set_prior)."""

    __slots__ = ("_module", "_name")

    def __init__(self, module: "Module", name: str):
        object.__setattr__(self, "_module", module)
        object.__setattr__(self, "_name", name)

    # --- value access -----------------------------------------------------
    @property
    def spec(self) -> ParamSpec:
        return self._module._specs[self._name]

    @property
    def raw(self) -> nn.Parameter:
        return self._module._parameters[self._name]

    @property
    def values(self) -> torch.Tensor:
        """Constrained value, differentiable through the raw leaf."""
        t = self.spec.transform
        r = self.raw
        return t.forward(r) if t is not None else r

    def numpy(self) -> np.ndarray:
        return self.values.detach().cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        v = self.numpy()
        return v.astype(dtype) if dtype is not None else v

    @property
    def shape(self):
        return tuple(self.raw.shape)

    @property
    def size(self):
        return self.raw.numel()

    @property
    def ndim(self):
        return self.raw.ndim

    @property
    def dtype(self):
        return self.raw.dtype

    @property
    def device(self):
        return self.raw.device

    def _members(self):
        tie = self.spec.tie
        return tie.members if tie is not None else [(self._module, self._name)]

    # --- GPy-style mutation API ------------------------------------------
    def set_value(self, value):
        self._module._set_param(self._name, value)

    def fix(self, value=None):
        if value is not None:
            self.set_value(value)
        self._set_fixed(True)
        return self

    constrain_fixed = fix

    def unfix(self):
        self._set_fixed(False)
        return self

    unconstrain_fixed = unfix

    def _set_fixed(self, flag):
        # a tie group shares one value and one optimizer slot: fixing any
        # member fixes the group
        for mod, n in self._members():
            mod._specs[n].fixed = flag

    def _retransform(self, transform):
        # the members of a tie group share one raw leaf, so they change
        # constraint together
        v = self.values.detach()
        for mod, n in self._members():
            mod._specs[n].transform = transform
        with torch.no_grad():
            self.raw.copy_(transform.inverse(v) if transform is not None else v)
        return self

    def constrain(self, transform: Transform):
        return self._retransform(transform)

    def constrain_positive(self):
        return self.constrain(Logexp())

    def constrain_bounded(self, lower, upper):
        return self.constrain(Logistic(lower, upper))

    def unconstrain(self):
        return self._retransform(None)

    def set_prior(self, prior):
        self.spec.prior = prior
        return self

    def randomize(self, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        t = self.spec.transform
        v = rng.standard_normal(self.shape)
        if t is not None and t.domain == "positive":
            v = np.exp(v * 0.5)
        elif t is not None and t.domain == "bounded":
            v = t.lower + (t.upper - t.lower) / (1 + np.exp(-v))
        self.set_value(v)
        return self

    # --- numeric protocol -------------------------------------------------
    def __getitem__(self, idx):
        return self.values[idx]

    def __len__(self):
        return self.raw.shape[0]

    def __iter__(self):
        return iter(self.numpy())

    def __float__(self):
        return float(self.numpy())

    def __repr__(self):
        return f"Param({self._name}={self.numpy()!r})"

    def __str__(self):
        return str(self.numpy())


class Module(nn.Module):
    """A node in the parameter tree. Subclasses call `_add_param` in __init__.

    Child Modules register on attribute assignment, including lists of
    Modules (the parts of Add/Prod kernels), which register as ``key#i``.
    Parameters are created on `device` with `dtype` (the package defaults
    when None: see config.py).
    """

    def __init__(self, name: Optional[str] = None, device=None, dtype=None):
        super().__init__()
        self._specs = {}
        self._device_arg = device
        self._dtype_arg = dtype
        self.name = name or self.__class__.__name__.lower()

    # --- registration -----------------------------------------------------
    def _add_param(self, name, value, transform=None, prior=None, fixed=False):
        dev = resolve_device(self._device_arg)
        dt = resolve_dtype(self._dtype_arg)
        value = _as_tensor(value, dt, dev)
        raw = transform.inverse(value) if transform is not None else value
        self.register_parameter(name, nn.Parameter(raw.detach().clone()))
        self._specs[name] = ParamSpec(transform, prior, fixed)
        return Param(self, name)

    def _set_param(self, name, value):
        spec = self._specs[name]
        p = self._parameters[name]
        v = _as_tensor(value, p.dtype, p.device).expand(p.shape)
        with torch.no_grad():
            p.copy_(spec.transform.inverse(v) if spec.transform is not None else v)

    # --- attribute magic --------------------------------------------------
    def __setattr__(self, key, val):
        specs = self.__dict__.get("_specs")
        if specs is not None and key in specs:
            self._set_param(key, val)
            return
        if (isinstance(val, (list, tuple)) and len(val) > 0
                and all(isinstance(x, Module) for x in val)):
            mods = self.__dict__["_modules"]
            for k in [k for k in mods if k.startswith(key + "#")]:
                del mods[k]
            for i, m in enumerate(val):
                self.add_module(f"{key}#{i}", m)
        super().__setattr__(key, val)

    def __getattr__(self, key):
        specs = self.__dict__.get("_specs")
        if specs is not None and key in specs:
            return Param(self, key)
        return super().__getattr__(key)

    # --- traversal --------------------------------------------------------
    def named_params(self, prefix: str = "") -> Iterator[Tuple[str, "Module", str]]:
        for n in self._specs:
            yield (prefix + n, self, n)
        for cn, ch in self._modules.items():
            if isinstance(ch, Module):
                yield from ch.named_params(prefix + cn + ".")

    def _params(self) -> Iterator[Param]:
        for _, mod, n in self.named_params():
            yield Param(mod, n)

    def _first_param(self) -> Optional[nn.Parameter]:
        for _, mod, n in self.named_params():
            return mod._parameters[n]
        return None

    # --- hierarchy-broadcast constraint ops -------------------------------
    def fix(self, value=None):
        for p in self._params():
            p.fix(value)
        return self

    constrain_fixed = fix

    def unfix(self):
        for p in self._params():
            p.unfix()
        return self

    unconstrain_fixed = unfix

    def constrain_positive(self):
        for p in self._params():
            p.constrain_positive()
        return self

    def constrain_bounded(self, lower, upper):
        for p in self._params():
            p.constrain_bounded(lower, upper)
        return self

    def unconstrain(self):
        for p in self._params():
            p.unconstrain()
        return self

    def set_prior(self, prior):
        for p in self._params():
            p.set_prior(prior)
        return self

    # --- parameter tying --------------------------------------------------
    def tie(self, *paths):
        """Tie parameters so they share one value and one optimizer slot.

        paths are dotted parameter paths from this module (normally the model
        root); the first is the leader, whose block alone stands in the flat
        vector. Members must have equal shapes and identical transforms.
        """
        if len(paths) < 2:
            raise ValueError("tie needs at least two parameter paths")
        entries = {path: (mod, n) for path, mod, n in self.named_params()}
        mems = []
        for p in paths:
            if p not in entries:
                raise KeyError(f"no parameter at path {p!r}")
            mod, n = entries[p]
            if mod._specs[n].tie is not None:
                raise ValueError(f"{p!r} is already tied; untie first")
            mems.append((mod, n))
        lead_mod, lead_n = mems[0]
        lead = lead_mod._parameters[lead_n]
        lead_t = lead_mod._specs[lead_n].transform
        for (mod, n), p in zip(mems, paths):
            if mod._parameters[n].shape != lead.shape:
                raise ValueError(
                    f"tied shapes differ: {p!r} has {tuple(mod._parameters[n].shape)}, "
                    f"leader has {tuple(lead.shape)}")
            if mod._specs[n].transform != lead_t:
                raise ValueError(
                    f"tied transforms differ: {p!r} has {mod._specs[n].transform!r}, "
                    f"leader has {lead_t!r}; constrain members identically before tying")
        group = TieGroup(list(paths), mems)
        any_fixed = any(mod._specs[n].fixed for mod, n in mems)
        for mod, n in mems:
            spec = mod._specs[n]
            mod._specs[n] = ParamSpec(spec.transform, spec.prior, any_fixed, tie=group)
            mod._parameters[n] = lead
        return self

    def untie(self, *paths):
        """Release the tie groups holding any of `paths` (all groups when none
        is given); each follower gets its own copy of the shared value."""
        targets = set(paths)
        for path, mod, n in self.named_params():
            tie = mod._specs[n].tie
            if tie is None:
                continue
            if not targets or path in targets or tie.leader_path in targets:
                lead = tie.members[0][0]._parameters[tie.members[0][1]]
                for i, (m2, n2) in enumerate(tie.members):
                    sp = m2._specs[n2]
                    if sp.tie is tie:
                        m2._specs[n2] = ParamSpec(sp.transform, sp.prior, sp.fixed)
                        if i > 0:
                            m2._parameters[n2] = nn.Parameter(lead.detach().clone())
        return self

    # --- raw-dict plumbing ------------------------------------------------
    def get_raw_dict(self, free_only: bool = False) -> dict:
        out = {}
        for path, mod, n in self.named_params():
            if free_only and mod._specs[n].fixed:
                continue
            out[path] = mod._parameters[n].detach()
        return out

    def set_raw_dict(self, d: dict):
        with torch.no_grad():
            for path, mod, n in self.named_params():
                if path in d:
                    p = mod._parameters[n]
                    p.copy_(_as_tensor(d[path], p.dtype, p.device).reshape(p.shape))

    def copy(self) -> "Module":
        return copy.deepcopy(self)

    # --- flat vector interface (optimizer space) --------------------------
    def _free_entries(self):
        """(path, module, name) of each free parameter, each once: a module
        reached by two paths (one kernel shared by two parts of a
        MultioutputKern, through DiffKern's base_kern) stands at its first."""
        seen = set()
        out = []
        for path, mod, n in self.named_params():
            spec = mod._specs[n]
            if spec.fixed or (spec.tie is not None and path in spec.tie.follower_paths):
                continue
            if (id(mod), n) not in seen:
                seen.add((id(mod), n))
                out.append((path, mod, n))
        return out

    def _free_parameters(self):
        return [mod._parameters[n] for _, mod, n in self._free_entries()]

    @property
    def num_free_params(self) -> int:
        return sum(p.numel() for p in self._free_parameters())

    def get_flat_raw(self) -> torch.Tensor:
        ps = self._free_parameters()
        if not ps:
            p0 = self._first_param()
            if p0 is None:
                return torch.zeros(0, dtype=torch.float64, device="cpu")
            return torch.zeros(0, dtype=p0.dtype, device=p0.device)
        return torch.cat([p.detach().reshape(-1) for p in ps])

    def flat_to_raw_dict(self, flat) -> dict:
        out = {}
        i = 0
        groups = []
        for path, mod, n in self._free_entries():
            shp = mod._parameters[n].shape
            sz = mod._parameters[n].numel()
            out[path] = flat[i:i + sz].reshape(shp)
            i += sz
            tie = mod._specs[n].tie
            if tie is not None and path == tie.leader_path:
                groups.append(tie)
        for tie in groups:
            for f in tie.follower_paths:
                out[f] = out[tie.leader_path]
        return out

    def set_flat_raw(self, flat):
        """Write a flat raw vector (numpy or tensor) into the free parameters,
        with one host-to-device copy."""
        p0 = self._first_param()
        if p0 is None:
            return
        flat = _as_tensor(flat, p0.dtype, p0.device)
        self.set_raw_dict(self.flat_to_raw_dict(flat))

    @contextlib.contextmanager
    def _bind(self, raw: dict):
        """Inside the block each parameter that `raw` names ({path: tensor},
        followers of a tie included) is its tensor. Module.__setattr__ would
        copy a value into the Parameter, so the tensors go straight into
        `_parameters`; the Parameters are put back on exit, exception or
        not."""
        saved = []
        try:
            for path, mod, n in self.named_params():
                if path in raw:
                    saved.append((mod, n, mod._parameters[n]))
                    mod._parameters[n] = raw[path]
            yield self
        finally:
            for mod, n, p in reversed(saved):
                mod._parameters[n] = p

    def bind_raw_dict(self, d: dict):
        """Evaluate the model at the raw tensors of `d` ({path: tensor}, e.g.
        leaves that require grad): inside the block each named parameter is
        its tensor, so what is computed there is differentiable with respect
        to them; the others keep their values. Counterpart of gpy_tpu's
        functional `with_raw_dict` (core/module.py:474). A tie leader's
        tensor also binds its followers unless `d` names them."""
        raw = dict(d)
        for path, mod, n in self.named_params():
            tie = mod._specs[n].tie
            if tie is not None and tie.leader_path in d:
                raw.setdefault(path, d[tie.leader_path])
        return self._bind(raw)

    def bind_flat_raw(self, flat: torch.Tensor):
        """Evaluate the model at the raw vector `flat` (a (P,) tensor, e.g. a
        row of a (C, P) tensor that requires grad): inside the block every
        free parameter is its slice of `flat`, so what is computed there is
        differentiable with respect to `flat`. Counterpart of gpy_tpu's
        functional `with_flat_raw` (core/module.py:564). Tied followers get
        the leader's slice (flat_to_raw_dict), so no tie walk is needed."""
        return self._bind(self.flat_to_raw_dict(flat))

    def stop_gradient(self):
        """Inside the block every parameter is its detached value, so what is
        computed there builds no graph back to the parameters: the
        counterpart of gpy_tpu's functional `stop_gradient` copy
        (core/module.py:512-521), which fixed-point inference (EP's sites,
        Laplace's mode) runs its loops on. Fixed parameters too."""
        return self._bind({path: mod._parameters[n].detach()
                           for path, mod, n in self.named_params()})

    @property
    def param_array(self) -> np.ndarray:
        """Constrained values of all parameters (GPy compat)."""
        vals = [Param(mod, n).numpy().reshape(-1) for _, mod, n in self.named_params()]
        return np.concatenate(vals) if vals else np.zeros((0,))

    @property
    def optimizer_array(self) -> np.ndarray:
        return self.get_flat_raw().cpu().numpy()

    # --- priors -----------------------------------------------------------
    def log_prior(self) -> torch.Tensor:
        p0 = self._first_param()
        if p0 is None:
            return torch.zeros((), dtype=torch.float64, device="cpu")
        total = torch.zeros((), dtype=p0.dtype, device=p0.device)
        for _, mod, n in self.named_params():
            prior = mod._specs[n].prior
            if prior is not None:
                total = total + torch.sum(prior.lnpdf(Param(mod, n).values))
        return total

    def randomize(self, rng: Optional[np.random.Generator] = None):
        """GPy: m.randomize() -- draws in gpy_tpu's order, so one seed gives
        both packages the same values."""
        rng = rng or np.random.default_rng()
        for _, mod, n in self._free_entries():
            Param(mod, n).randomize(rng)
        return self

    # --- printing ---------------------------------------------------------
    def __str__(self):
        rows = []
        for path, mod, n in self.named_params():
            spec = mod._specs[n]
            v = Param(mod, n).numpy()
            vstr = f"{v:.6g}" if v.ndim == 0 else f"({', '.join(f'{x:.4g}' for x in v.reshape(-1)[:6])}{', ...' if v.size > 6 else ''})"
            cons = "fixed" if spec.fixed else (str(spec.transform) if spec.transform else "")
            if spec.tie is not None:
                cons = (cons + " " if cons else "") + (
                    "tied" if path == spec.tie.leader_path
                    else f"tied:{spec.tie.leader_path}")
            prior = type(spec.prior).__name__ if spec.prior is not None else ""
            rows.append((f"{self.name}.{path}", vstr, cons, prior))
        if not rows:
            return f"<{type(self).__name__} {self.name} (no params)>"
        w0 = max(len(r[0]) for r in rows + [("name", "", "", "")])
        w1 = max(len(r[1]) for r in rows + [("", "value", "", "")])
        w2 = max(len(r[2]) for r in rows + [("", "", "constraints", "")])
        lines = [f"{'name':<{w0}}  |  {'value':>{w1}}  |  {'constraints':>{w2}}  |  priors"]
        for r in rows:
            lines.append(f"{r[0]:<{w0}}  |  {r[1]:>{w1}}  |  {r[2]:>{w2}}  |  {r[3]}")
        return "\n".join(lines)

    def __repr__(self):
        return f"<{type(self).__name__} '{self.name}': {len(list(self.named_params()))} params>"
