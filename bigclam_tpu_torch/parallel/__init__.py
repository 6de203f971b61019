"""Sharded training on a device mesh (tp = 1, single host): the all-gather
schedule (parallel.sharded) and the ring schedule (parallel.ring)."""

from bigclam_tpu_torch.parallel.mesh import Mesh, make_mesh
from bigclam_tpu_torch.parallel.ring import RingBigClamModel
from bigclam_tpu_torch.parallel.sharded import MeshNotPortedError, ShardedBigClamModel

__all__ = [
    "Mesh", "MeshNotPortedError", "RingBigClamModel", "ShardedBigClamModel",
    "make_mesh",
]
