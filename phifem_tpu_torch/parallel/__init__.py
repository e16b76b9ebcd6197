"""Sharded solves over a one-process shard mesh.

Counterpart of :mod:`phifem_tpu.parallel` (SPMD over ``jax.sharding.Mesh``).
A shard mesh (:func:`make_mesh`) is an ordered list of torch devices in
which one device may repeat: ``make_mesh(devices=["cpu"] * 4)`` for four
shards on the CPU, ``make_mesh(devices=["cuda:0"] * 4)`` for four on one
card, ``make_mesh()`` for one shard per card of the host.  Each shard's slab
of a vector is a tensor on its device; the halo exchanges, ghost exchanges
and dot-product sums are copies between the shards' tensors and sums in
shard order (:mod:`.sharding`).  No ``torch.distributed`` process group is
involved.
"""

from .halo import HaloOperator, UnsupportedFieldError, halo_solve
from .lattice import ShardedLatticeMG, build_sharded_lattice_mg, sharded_lattice_solve
from .lattice3 import ShardedLattice3MG, build_sharded_lattice3_mg, sharded_lattice3_solve
from .sharding import make_mesh, shard_vector, sharded_matvec_fn, sharded_solve
from .uop import ElementShardedOperator, PartitionedUOperator, element_sharded_solve, partitioned_solve

__all__ = [
    "HaloOperator",
    "ShardedLatticeMG",
    "build_sharded_lattice_mg",
    "sharded_lattice_solve",
    "ShardedLattice3MG",
    "build_sharded_lattice3_mg",
    "sharded_lattice3_solve",
    "UnsupportedFieldError",
    "ElementShardedOperator",
    "PartitionedUOperator",
    "element_sharded_solve",
    "partitioned_solve",
    "halo_solve",
    "make_mesh",
    "shard_vector",
    "sharded_matvec_fn",
    "sharded_solve",
]
