"""Sharding and multi-chip execution (SURVEY.md section 2 parallelism table).

The reference parallelizes with a rayon thread pool over DB entries within one host
(src/lib.rs:44-51) and with N MPC-party processes over TCP (src/main.rs). Here:

- the DB-entry axis shards across chips over a `jax.sharding.Mesh` axis ``"db"``
  (each chip scans its own HBM-resident DB shard),
- query batches shard across ``"batch"`` (data parallel),
- the global match winner is combined with an exact integer-fraction minimum over the
  ``"db"`` axis via collectives (all-gather of per-shard winner triples),
- party parallelism stays *outside* the mesh: each MPC party is its own JAX process
  universe; parties exchange u16 share tensors over host networking (see protocol/).
"""

from mpc_iris_tpu.parallel.mesh import make_mesh, mesh_shape_for
from mpc_iris_tpu.parallel.sharded import (
    ShardedMasksEngine,
    ShardedPlaintextEngine,
    ShardedKeyedShareEngine,
    ShardedShareEngine,
)
from mpc_iris_tpu.parallel.collectives import fraction_allmin
from mpc_iris_tpu.parallel import multihost

__all__ = [
    "make_mesh",
    "mesh_shape_for",
    "ShardedPlaintextEngine",
    "ShardedKeyedShareEngine",
    "ShardedShareEngine",
    "ShardedMasksEngine",
    "fraction_allmin",
    "multihost",
]
