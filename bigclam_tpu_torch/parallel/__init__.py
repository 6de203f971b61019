"""Sharded training on a (dp, tp) device mesh driven by one process: the
all-gather schedule (parallel.sharded) and the ring schedule
(parallel.ring), at any K and tp, each also fed from a compiled graph
cache, one shard file per node shard; and the sparse top-M member lists
on a (dp, 1) mesh with the capped sparse allreduce of sumF
(parallel.sparse_sharded, parallel.sparse_collectives)."""

from bigclam_tpu_torch.parallel.mesh import Mesh, make_mesh
from bigclam_tpu_torch.parallel.ring import RingBigClamModel, StoreRingBigClamModel
from bigclam_tpu_torch.parallel.sharded import (
    MeshNotPortedError,
    ShardedBigClamModel,
    StoreShardedBigClamModel,
)
from bigclam_tpu_torch.parallel.sparse_sharded import SparseShardedBigClamModel

__all__ = [
    "Mesh", "MeshNotPortedError", "RingBigClamModel", "ShardedBigClamModel",
    "SparseShardedBigClamModel", "StoreRingBigClamModel",
    "StoreShardedBigClamModel", "make_mesh",
]
