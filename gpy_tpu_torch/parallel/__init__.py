"""Sharding over several cards: meshes, row shards and the sharded programs.

Counterpart of gpy_tpu/parallel/__init__.py, which replaces GPy's MPI stack
(GPy/util/parallel.py divide_data:15-30, core/sparse_gp_mpi.py:82-115,
var_dtc_parallel.py's Allreduce of the psi statistics :121-131 and of the
gradient :337-424) with JAX SPMD over a Mesh. Here it is torch.distributed:

  MPI divide_data          -> shard_rows (this rank's contiguous rows)
  MPI Bcast(param_array)   -> replicate (a packed broadcast)
  MPI Allreduce            -> one packed all_reduce a mesh axis
  rank 0 / worker protocol -> every rank runs the same program (torchrun)

One process a card: launch K processes with `torchrun --nproc-per-node=K`,
call distributed_initialize() in each, then make_mesh() (or make_mesh_2d
for hosts x cards). In a single process make_mesh() builds a 1-rank group
on its own. Every sharded program here returns, on every rank, what the
serial model computes; `mesh.counts` counts the collectives.

HMC.sample(mesh=...) and Model.optimize_restarts(parallel=True, mesh=...)
split chains and restarts over the mesh's ranks (mcmc, core/model.py).
"""
from .collapsed import (sharded_bgplvm_elbo_and_grad, sharded_svi_multiout_elbo_and_grad,
                        sharded_svi_multiout_md_elbo_and_grad, sharded_vardtc_elbo_and_grad)
from .iterative import sharded_gram_matvec, sharded_iterative_nlml_grad
from .mesh import (distributed_initialize, make_mesh, make_mesh_2d, pad_rows_to_multiple,
                   replicate, shard_rows)
from .svgp import (data_parallel_elbo_and_grad, sharded_svgp_train_step, svgp_unwhiten_raw,
                   svgp_whiten_raw)

__all__ = [
    "distributed_initialize",
    "make_mesh",
    "make_mesh_2d",
    "shard_rows",
    "replicate",
    "pad_rows_to_multiple",
    "data_parallel_elbo_and_grad",
    "sharded_svgp_train_step",
    "svgp_whiten_raw",
    "svgp_unwhiten_raw",
    "sharded_gram_matvec",
    "sharded_iterative_nlml_grad",
    "sharded_vardtc_elbo_and_grad",
    "sharded_bgplvm_elbo_and_grad",
    "sharded_svi_multiout_elbo_and_grad",
    "sharded_svi_multiout_md_elbo_and_grad",
]
