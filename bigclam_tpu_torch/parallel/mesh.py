"""Device meshes of the port's sharded trainers.

Port of bigclam_tpu/parallel/mesh.py `make_mesh` (the 1D (nodes, k) mesh;
the 2D partition's `make_mesh_2d` is not ported). The port runs a mesh
single-controller, as the JAX package does: one Python process launches
each shard's work on that shard's `torch.device`. A device may repeat, so
`[torch.device("cuda:0")] * 4` is a 4-shard mesh on one card and
`[torch.device("cpu")] * 4` one on the CPU — the counterpart of the JAX
tests' fake CPU devices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

NODES_AXIS = "nodes"
K_AXIS = "k"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, tp) grid of torch devices: row i holds node shard i."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict:
        """{NODES_AXIS: dp, K_AXIS: tp}, as a JAX mesh's `shape`."""
        return {NODES_AXIS: len(self.devices), K_AXIS: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def node_devices(self) -> list:
        """The device of each node shard (the first of its row)."""
        return [row[0] for row in self.devices]

    def label(self) -> str:
        """'dpxtp', the JAX CLI's `_mesh_label` of a 1D mesh."""
        return f"{self.shape[NODES_AXIS]}x{self.shape[K_AXIS]}"


def row_shards(F) -> list:
    """The node-row shards of a state tensor, whatever its layout: [F] for
    one tensor, F itself for a tuple of row shards (tp = 1), and for a
    tuple of rows of column blocks (tp > 1: block (i, j) on mesh device
    (i, j)) each row's blocks joined along the last axis on its first
    block's device. The one view of a mesh state that its consumers
    (checkpoints, extraction, health, rollback) read."""
    if isinstance(F, torch.Tensor):
        return [F]
    return [
        torch.cat([b.to(row[0].device) for b in row], dim=-1)
        if isinstance(row, tuple) else row
        for row in F
    ]


def state_blocks(F) -> list:
    """Every tensor of a state tensor's layout (one tensor, row shards, or
    rows of column blocks), flattened in row-major order."""
    if isinstance(F, torch.Tensor):
        return [F]
    return [b for row in F for b in (row if isinstance(row, tuple) else (row,))]


def make_mesh(
    shape: Tuple[int, int] = (1, 1),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a (nodes, k) mesh over the given devices (default: every
    visible card). shape = (node_shards, k_shards); their product must equal
    the number of devices given, which may repeat."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    dp, tp = shape
    if dp < 1 or tp < 1 or dp * tp != len(devices):
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {dp * tp} devices, got {len(devices)}"
        )
    return Mesh(tuple(tuple(devices[i * tp : (i + 1) * tp]) for i in range(dp)))
