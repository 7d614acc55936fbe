"""Process groups, device meshes, row shards and the packed collectives.

Counterpart of gpy_tpu/parallel/__init__.py:66-141. The reference is one
SPMD program over a jax Mesh; here every rank is a process (one card each
under `torchrun`) and a mesh is a torch DeviceMesh over the ranks of one
torch.distributed group:

  jax.distributed.initialize   -> distributed_initialize (init_process_group
                                  from the launcher's environment)
  Mesh(devices, ("data",))     -> make_mesh: a 1-D DeviceMesh
  Mesh(devices, ("dcn", "ici")) -> make_mesh_2d: a 2-D DeviceMesh
  NamedSharding(P(axis))       -> shard_rows: this rank's contiguous rows
  psum over axis names         -> all_reduce_packed: the tensors flattened
                                  into one buffer, one all_reduce a mesh
                                  dimension, the fast ("ici") one first
  an output sharded by rows    -> all_gather_rows (the list form of
                                  all_gather, which gloo and NCCL both take)

A mesh's device follows the package's rule: "cuda" unless the caller asks
for "cpu". NCCL carries a cuda mesh that this module's make_mesh builds;
a group the caller built (gloo ranks sharing one card, say) is used as it
is, whatever its backend. Every collective here is counted in `counts`:
calls, elements and bytes by operation.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import resolve_device

__all__ = ["distributed_initialize", "make_mesh", "make_mesh_2d", "shard_rows", "replicate",
           "pad_rows_to_multiple", "mesh_device", "num_shards", "check_device", "shard_slice",
           "on_model", "all_reduce_packed", "all_gather_rows", "counts", "reset_counts"]

# calls, elements and bytes of each collective since the last reset_counts()
counts = {}


def reset_counts() -> None:
    counts.clear()
    for op in ("all_reduce", "all_gather", "broadcast"):
        counts[op] = counts[f"{op}_elements"] = counts[f"{op}_bytes"] = 0


reset_counts()


def _count(op, t: torch.Tensor) -> None:
    counts[op] += 1
    counts[f"{op}_elements"] += t.numel()
    counts[f"{op}_bytes"] += t.numel() * t.element_size()


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def distributed_initialize(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device=None,
                           timeout: Optional[datetime.timedelta] = None, **kw) -> bool:
    """Join this process to the job's group: call once per process before
    building meshes. Returns True if it initialized the group, False if a
    group exists already or no launcher environment is present (one
    process on its own).

    The coordinator ("host:port"), the number of processes and this one's
    rank come from the arguments, else from the launcher's environment
    (torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK; LOCAL_RANK picks
    the card). NCCL on "cuda" (the default), gloo on "cpu". A launcher
    environment that is incomplete, or a coordinator that does not answer
    within `timeout`, raises: the reference returns False on any error
    (gpy_tpu/parallel/__init__.py:83-89), which hides a wrong coordinator
    (ROADMAP C(ai)). `kw` goes to torch.distributed.init_process_group.
    """
    if dist.is_initialized():
        return False
    env = os.environ
    if coordinator_address is None and not any(
            k in env for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")):
        return False
    if coordinator_address is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("launcher environment without MASTER_ADDR and MASTER_PORT")
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None:
        if "WORLD_SIZE" not in env:
            raise ValueError("launcher environment without WORLD_SIZE")
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        if "RANK" not in env:
            raise ValueError("launcher environment without RANK")
        process_id = int(env["RANK"])
    dev = resolve_device(device if device is not None or "LOCAL_RANK" not in env
                         else f"cuda:{int(env['LOCAL_RANK'])}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(_backend(dev), init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=timeout, **kw)
    return True


def _ensure_group(dev: torch.device) -> None:
    """A single process with no group gets a 1-rank group on an in-memory
    store, so that a mesh works there as the reference's does."""
    if not dist.is_initialized():
        dist.init_process_group(_backend(dev), store=dist.HashStore(), rank=0, world_size=1)


def _mesh(dev: torch.device, shape, names) -> DeviceMesh:
    n = int(np.prod(shape))
    if n > dist.get_world_size():
        raise ValueError(f"a mesh of {n} ranks in a group of {dist.get_world_size()}")
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape), mesh_dim_names=tuple(names))


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data", device=None) -> DeviceMesh:
    """1-D mesh over the group's first `n_devices` ranks (all by default)."""
    dev = resolve_device(device)
    _ensure_group(dev)
    return _mesh(dev, (n_devices or dist.get_world_size(),), (axis_name,))


def make_mesh_2d(n_dcn: Optional[int] = None, n_ici: Optional[int] = None,
                 axis_names=("dcn", "ici"), device=None) -> DeviceMesh:
    """2-D mesh: a slow axis across hosts ("dcn") by a fast axis within a
    host ("ici"). Ranks are host-major, so a reduction over "ici" stays on
    a host. Every sharded program here takes `axis_name`; pass the tuple
    ("dcn", "ici") to shard rows over both axes (gpy_tpu/parallel/
    __init__.py:98-118). Defaults: n_ici = the processes of a host
    (torchrun's LOCAL_WORLD_SIZE, else the whole group), n_dcn = the group
    over n_ici."""
    dev = resolve_device(device)
    _ensure_group(dev)
    world = dist.get_world_size()
    if n_ici is None:
        n_ici = int(os.environ.get("LOCAL_WORLD_SIZE", world)) if n_dcn is None else world // n_dcn
    if n_dcn is None:
        n_dcn = max(1, world // n_ici)
    return _mesh(dev, (n_dcn, n_ici), axis_names)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _check_mesh(mesh) -> None:
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, not {type(mesh).__name__}")


def _axes(mesh: DeviceMesh, axis_name) -> tuple:
    _check_mesh(mesh)
    axes = tuple(axis_name) if isinstance(axis_name, (tuple, list)) else (axis_name,)
    unknown = [a for a in axes if a not in (mesh.mesh_dim_names or ())]
    if unknown:
        raise ValueError(f"axes {unknown} are not in the mesh's {mesh.mesh_dim_names}")
    return axes


def _shard_index(mesh: DeviceMesh, axes) -> tuple:
    """(number of shards, this rank's shard) over `axes`, the first axis
    slowest (the reference's PartitionSpec over an axis tuple)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    k, idx = 1, 0
    for a in axes:
        d = mesh.mesh_dim_names.index(a)
        k, idx = k * mesh.size(d), idx * mesh.size(d) + coord[d]
    return k, idx


def num_shards(mesh: DeviceMesh, axis_name="data") -> int:
    """k: the shards that rows split into over `axis_name`."""
    return _shard_index(mesh, _axes(mesh, axis_name))[0]


def check_device(mesh: DeviceMesh, t: torch.Tensor) -> None:
    """A model's tensors must live where the mesh's collectives run."""
    _check_mesh(mesh)
    if t.device.type != mesh.device_type:
        raise ValueError(f"the model is on {t.device.type}, the mesh on {mesh.device_type}")


def shard_slice(mesh: DeviceMesh, n: int, axis_name="data") -> tuple:
    """(k, start, stop): this rank's contiguous block of `n` rows split over
    the k shards of `axis_name` (a name or a tuple of names); n must divide
    by k, as the reference's sharding requires."""
    k, idx = _shard_index(mesh, _axes(mesh, axis_name))
    if n % k:
        raise ValueError(f"{n} rows do not divide over {k} shards; "
                         "pad them with pad_rows_to_multiple")
    b = n // k
    return k, idx * b, (idx + 1) * b


def on_model(model, *arrays) -> list:
    """Each array as a tensor on the model's device, in its dtype."""
    p = model._first_param()
    return [torch.as_tensor(a).to(device=p.device, dtype=p.dtype) for a in arrays]


def shard_rows(mesh: DeviceMesh, x, axis_name="data") -> torch.Tensor:
    """This rank's contiguous row block of the full array `x` on the rank's
    device (GPy's divide_data; the reference's NamedSharding(P(axis)))."""
    _, i0, i1 = shard_slice(mesh, x.shape[0], axis_name)
    return torch.as_tensor(x[i0:i1]).to(mesh_device(mesh))


def _leaves(tree, out):
    if isinstance(tree, dict):
        for k in tree:
            _leaves(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)
    return out


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def replicate(mesh: DeviceMesh, tree):
    """The tree (dicts, lists and tuples of arrays) on every rank of the
    mesh: each leaf on the rank's device, broadcast from the mesh's first
    rank (GPy's Bcast of param_array), one packed broadcast a mesh
    dimension and dtype."""
    dev = mesh_device(mesh)
    leaves = [torch.as_tensor(v).to(dev) for v in _leaves(tree, [])]
    out = list(leaves)
    for dt in {t.dtype for t in leaves}:
        idx = [i for i, t in enumerate(leaves) if t.dtype == dt]
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        for d in reversed(range(mesh.ndim)):
            group = mesh.get_group(d)
            _count("broadcast", flat)
            dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
        for i, part in zip(idx, torch.split(flat, [leaves[i].numel() for i in idx])):
            out[i] = part.reshape(leaves[i].shape)
    return _rebuild(tree, iter(out))


def pad_rows_to_multiple(X, Y, k: int):
    """Pad (X, Y) with zero-weight rows to a multiple of k. Returns
    (Xp, Yp, w) with w in {0, 1} marking real rows."""
    n = X.shape[0]
    n_pad = (-n) % k
    w = np.ones((n + n_pad,), dtype=float)
    if n_pad:
        X = np.concatenate([X, np.zeros((n_pad, X.shape[1]), X.dtype)], 0)
        Y = np.concatenate([Y, np.zeros((n_pad, Y.shape[1]), Y.dtype)], 0)
        w[n:] = 0.0
    return X, Y, w


def all_reduce_packed(mesh: DeviceMesh, tensors, axis_name="data") -> list:
    """The sums over the shards of `axis_name` of a list of tensors (one
    dtype): flattened into one buffer, one all_reduce a mesh dimension, the
    last named (fast) axis first, then split back. The results are
    detached."""
    axes = _axes(mesh, axis_name)
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    for a in reversed(axes):
        _count("all_reduce", flat)
        dist.all_reduce(flat, group=mesh.get_group(a))
    parts = torch.split(flat, [t.numel() for t in tensors])
    return [p.reshape(t.shape) for p, t in zip(parts, tensors)]


def all_gather_rows(mesh: DeviceMesh, t: torch.Tensor, axis_name="data") -> torch.Tensor:
    """Every shard's rows of `t`, stacked in shard order: the full array
    that the reference's row-sharded output denotes. Each rank's block has
    the same shape. Detached."""
    axes = _axes(mesh, axis_name)
    t = t.detach().contiguous()
    for a in reversed(axes):
        group = mesh.get_group(a)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        _count("all_gather", t)
        dist.all_gather(parts, t, group=group)
        t = torch.cat(parts, 0)
    return t
