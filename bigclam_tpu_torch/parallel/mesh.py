"""Device meshes of the port's sharded trainers.

Port of bigclam_tpu/parallel/mesh.py: `make_mesh` (the 1D (nodes, k)
mesh) and `make_mesh_2d` (the (rows, cols) grid of the 2D edge-block
partition, parallel/twod.py). A mesh made here runs single-controller:
one Python process launches each shard's work on that shard's
`torch.device`. A device may repeat, so `[torch.device("cuda:0")] * 4` is
a 4-shard mesh on one card and `[torch.device("cpu")] * 4` one on the CPU
— the counterpart of the JAX tests' fake CPU devices.

A mesh from parallel/multihost.py `make_multihost_mesh` spans the ranks of
a torch.distributed process group: each rank owns a contiguous block of
positions in row-major order (the JAX slice-major layout), `devices` holds
only this rank's block of the grid, `dims` the whole grid's shape and
`origin` the global (row, column) of devices[0][0]. `grid()` gives the
trainers their local rows as `Axis` lists, whose `group` says which
collectives cross ranks; everything else reads a local grid as it reads a
single-controller one.
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


class Axis(list):
    """The devices of this process's members of one collective over a mesh
    axis (a column of the grid for the nodes axis, a row for the k axis),
    in position order, and `group`: the torch.distributed group of the
    ranks that hold the axis's members, or None when they are all here
    (every single-controller mesh). A plain list reads as group None."""

    def __init__(self, devices=(), group=None):
        super().__init__(devices)
        self.group = group


class Grid(list):
    """A mesh's local grid: its rows as Axis lists (their k-axis groups)
    and `col_groups`, the nodes-axis group of each local column."""

    def __init__(self, rows=(), col_groups=()):
        super().__init__(rows)
        self.col_groups = tuple(col_groups)


def column(grid, j: int) -> Axis:
    """Local column j of a grid (a Grid or a plain list of rows) as an
    Axis with its nodes-axis group."""
    groups = getattr(grid, "col_groups", ())
    return Axis([r[j] for r in grid], groups[j] if groups else None)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, tp) grid of torch devices: row i holds node shard i. On a
    multi-process mesh (make_multihost_mesh) `devices` is this rank's
    block of the grid, at global `origin`, and `dims` the whole grid's
    (dp, tp)."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    dims: Optional[Tuple[int, int]] = None
    origin: Tuple[int, int] = (0, 0)
    col_groups: tuple = dataclasses.field(default=(), compare=False, repr=False)
    row_groups: tuple = dataclasses.field(default=(), compare=False, repr=False)

    @property
    def shape(self) -> dict:
        """{NODES_AXIS: dp, K_AXIS: tp} of the whole grid, as a JAX mesh's
        `shape`."""
        dp, tp = self.dims or (len(self.devices), len(self.devices[0]))
        return {NODES_AXIS: dp, K_AXIS: tp}

    @property
    def size(self) -> int:
        return self.shape[NODES_AXIS] * self.shape[K_AXIS]

    @property
    def distributed(self) -> bool:
        """Was the mesh built over a process group (its collectives and
        reads go through torch.distributed)?"""
        return self.dims is not None

    def local_rows(self) -> range:
        """The global indices of the node rows this process holds blocks of."""
        return range(self.origin[0], self.origin[0] + len(self.devices))

    def grid(self, resolve=lambda d: d) -> Grid:
        """The local grid with each device mapped by `resolve`."""
        rows = self.row_groups or (None,) * len(self.devices)
        return Grid([Axis([resolve(d) for d in row], g)
                     for row, g in zip(self.devices, rows)], self.col_groups)

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
