"""Sharded training on a device mesh, driven by one process or by every
rank of a torch.distributed process group (parallel.multihost): the
all-gather schedule (parallel.sharded) and the ring schedule
(parallel.ring) on a (dp, tp) mesh, at any K and tp, each also fed from a
compiled graph cache, one shard file per node shard; the sparse top-M
member lists on a (dp, 1) mesh with the capped sparse allreduce of sumF
(parallel.sparse_sharded, parallel.sparse_collectives); and the 2D
edge-block partition on a (rows, cols) mesh with the closure exchange
(parallel.twod), in memory or from a cache of rows * cols shards."""

from bigclam_tpu_torch.parallel.mesh import Mesh, Mesh2D, make_mesh, make_mesh_2d
from bigclam_tpu_torch.parallel.multihost import (
    initialize_distributed,
    load_host_seed_scores,
    load_host_shard,
    make_multihost_mesh,
    put_sharded,
)
from bigclam_tpu_torch.parallel.ring import RingBigClamModel, StoreRingBigClamModel
from bigclam_tpu_torch.parallel.sharded import (
    ShardedBigClamModel,
    StoreShardedBigClamModel,
)
from bigclam_tpu_torch.parallel.sparse_sharded import SparseShardedBigClamModel
from bigclam_tpu_torch.parallel.twod import (
    StoreTwoDShardedBigClamModel,
    TwoDShardedBigClamModel,
    twod_mesh_shape,
)

__all__ = [
    "Mesh", "Mesh2D", "RingBigClamModel", "initialize_distributed",
    "load_host_seed_scores", "load_host_shard", "make_multihost_mesh", "put_sharded",
    "ShardedBigClamModel", "SparseShardedBigClamModel",
    "StoreRingBigClamModel", "StoreShardedBigClamModel",
    "StoreTwoDShardedBigClamModel", "TwoDShardedBigClamModel", "make_mesh",
    "make_mesh_2d", "twod_mesh_shape",
]
