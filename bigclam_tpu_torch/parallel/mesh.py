"""Device meshes of the port's sharded trainers.

Port of bigclam_tpu/parallel/mesh.py: `make_mesh` (the 1D (nodes, k)
mesh) and `make_mesh_2d` (the (rows, cols) grid of the 2D edge-block
partition, parallel/twod.py). The port runs a mesh
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
# the 2D partition's axes: "rows" groups node blocks into processor rows
# (the closure exchange runs over it), "cols" is the replica axis of a
# row group (its src-row gather, grad reduction and psum_scatters)
ROWS_AXIS = "rows"
COLS_AXIS = "cols"


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


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """A (rows, cols) grid of torch devices for the 2D partition: position
    (i, j) is devices[i][j] and owns node block b = i * C + j, the 1D
    block order (C = 1 is the 1D (dp, 1) mesh's layout). The k axis is
    1: the 2D partition does not shard the community axis."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict:
        """{ROWS_AXIS: R, COLS_AXIS: C, K_AXIS: 1}, as the JAX 2D mesh's."""
        return {ROWS_AXIS: len(self.devices), COLS_AXIS: len(self.devices[0]),
                K_AXIS: 1}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def positions(self) -> list:
        """Every position's device in block order (row-major)."""
        return [d for row in self.devices for d in row]

    def label(self) -> str:
        """'rowsxcols', the JAX CLI's `_mesh_label` of a 2D mesh."""
        return f"{self.shape[ROWS_AXIS]}x{self.shape[COLS_AXIS]}"


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


def make_mesh_2d(
    shape: Tuple[int, int],
    devices: Optional[Sequence] = None,
) -> Mesh2D:
    """Build a (rows, cols) mesh for the 2D edge-block partition over the
    given devices (default: every visible card), row-major: position
    (i, j) is device i * C + j and owns node block i * C + j. shape =
    (dp_rows, replica_cols); their product must equal the number of
    devices given, which may repeat."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    rows, cols = shape
    if rows < 1 or cols < 1 or rows * cols != len(devices):
        raise ValueError(
            f"2d mesh shape {tuple(shape)} needs {rows * cols} devices, got "
            f"{len(devices)}"
        )
    return Mesh2D(tuple(tuple(devices[i * cols : (i + 1) * cols])
                        for i in range(rows)))
