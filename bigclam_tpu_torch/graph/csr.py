"""Host-side graph container: symmetric CSR over contiguous node ids.

Copied from bigclam_tpu/graph/csr.py (`Graph`), plus `DeviceCSR`: the
graph's CSR arrays on a torch device, which the edge kernels read
directly (each node's neighbor list is one contiguous slice of
`indices`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch


def host_tensor(a, dtype, device=None) -> torch.Tensor:
    """`a` as a torch tensor of numpy `dtype` on `device`, uploaded from a
    contiguous, writable host array: a graph-cache load hands back
    read-only memmaps (GraphStore.load_graph(mmap=True)), which
    torch.as_tensor would warn about and, on the CPU, share."""
    a = np.asarray(a, dtype)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a, order="C", copy=True)
    return torch.from_numpy(a).to(device)


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected simple graph in CSR form.

    Attributes:
      indptr:  (N+1,) int64 — CSR row pointers.
      indices: (2E,) int32 — concatenated sorted neighbor lists.
      raw_ids: (N,) original node ids from the input file (raw_ids[i] is the
               id that was remapped to i); identity for synthetic graphs.
    """

    indptr: np.ndarray
    indices: np.ndarray
    raw_ids: np.ndarray

    @property
    def num_nodes(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def num_edges(self) -> int:
        """Number of undirected edges E (indices stores both directions)."""
        return int(self.indices.shape[0] // 2)

    @property
    def num_directed_edges(self) -> int:
        return int(self.indices.shape[0])

    @functools.cached_property
    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int64)

    @functools.cached_property
    def src(self) -> np.ndarray:
        """(2E,) int32 source node of each directed edge, aligned with indices."""
        return np.repeat(
            np.arange(self.num_nodes, dtype=np.int32), self.degrees
        )

    @property
    def dst(self) -> np.ndarray:
        """(2E,) int32 destination node of each directed edge (= indices)."""
        return self.indices

    def neighbors(self, u: int) -> np.ndarray:
        return self.indices[self.indptr[u] : self.indptr[u + 1]]

    def permute(self, perm: np.ndarray) -> "Graph":
        """Relabel nodes: old id u becomes perm[u]. Returns a new CSR graph
        over the same edges (used by the shard-balance transform,
        parallel/balance.py). perm must be a permutation of [0, N)."""
        n = self.num_nodes
        perm = np.asarray(perm)
        if perm.shape != (n,):
            raise ValueError(f"perm has shape {perm.shape}, want {(n,)}")
        new_src = perm[self.src].astype(np.int64)
        new_dst = perm[self.dst].astype(np.int64)
        order = np.lexsort((new_dst, new_src))
        indices = new_dst[order].astype(np.int32)
        degrees = np.bincount(new_src, minlength=n)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(degrees, out=indptr[1:])
        inv = np.empty(n, dtype=np.int64)
        inv[perm] = np.arange(n)
        return Graph(indptr=indptr, indices=indices, raw_ids=self.raw_ids[inv])

    def to_device(self, device: Optional[torch.device]) -> "DeviceCSR":
        return DeviceCSR(
            indptr=host_tensor(self.indptr, np.int64, device),
            indices=host_tensor(self.indices, np.int32, device),
            src=host_tensor(self.src, np.int64, device),
            dst=host_tensor(self.indices, np.int64, device),
        )


class DeviceCSR(NamedTuple):
    """The CSR on a device. `indptr`/`indices` feed the CUDA kernels;
    `src`/`dst` (int64 directed-edge endpoints, CSR order) feed the plain
    torch edge sweeps. `order`, where set (a ring bucket's visit order,
    parallel/ring.py `visit_order`), lists the rows with an edge in the
    order kernel #8's warps take them. `rev`, where set (the K-blocked
    paths, ops/kblocked.py `reverse_edges`), gives for each CSR position
    of (u, v) the position of (v, u)."""

    indptr: torch.Tensor    # (N+1,) int64
    indices: torch.Tensor   # (2E,) int32
    src: torch.Tensor       # (2E,) int64
    dst: torch.Tensor       # (2E,) int64
    order: Optional[torch.Tensor] = None   # (rows with an edge,) int32
    rev: Optional[torch.Tensor] = None     # (2E,) int32

    @property
    def num_nodes(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def num_directed_edges(self) -> int:
        return int(self.indices.shape[0])
