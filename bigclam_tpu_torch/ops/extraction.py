"""Community extraction: delta-thresholding of F with argmax fallback.

Port of bigclam_tpu/ops/extraction.py. The threshold is
delta = sqrt(-log(1 - eps)) with eps = 2E / (N(N-1)). Node u belongs to
community c iff F_uc >= delta; if max(F_u) < delta, u is assigned to every
community whose value EQUALS the row max (on ties, all tied columns; an
all-zero row therefore lands in every community, as in the reference).

Two forms of the result:

* `extract_communities` -> {community: sorted raw member ids} and
  `save_communities(path, dict)`: the JAX API, and the plain versions the
  tests hold the array form to;
* `extract_community_arrays` (host F) and `extract_community_arrays_device`
  (F on a device, pairs fetched chunk by chunk) -> CommunityArrays (the
  non-empty community ids, their offsets, their members sorted by raw id),
  written by `write_communities` with numpy-formatted ids in a few large
  writes. `cli fit --out` takes this form; the file is byte for byte the
  one save_communities writes for the same F and graph.

`extract_communities_device` returns the dict, as the JAX function does.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from bigclam_tpu_torch.graph.csr import Graph

# members formatted per write_communities chunk, and the threads that
# format chunks (together they bound the writer's scratch memory)
WRITE_CHUNK_PAIRS = 1 << 22
WRITE_THREADS = 8


def delta_threshold(num_nodes: int, num_edges: int) -> float:
    """delta = sqrt(-log(1 - eps)), eps = 2E/(N(N-1)) (background edge prob)."""
    n = max(num_nodes, 2)
    eps = 2.0 * num_edges / (n * (n - 1.0))
    eps = min(eps, 1.0 - 1e-12)
    return float(np.sqrt(-np.log1p(-eps)))


def membership_mask(F: np.ndarray, delta: float) -> np.ndarray:
    """(N, K) boolean membership (threshold or row-max fallback)."""
    F = np.asarray(F)
    above = F >= delta
    row_max = F.max(axis=1, keepdims=True)
    fallback = (row_max < delta) & (F == row_max)
    return above | fallback


def extract_communities(F: np.ndarray, g: Graph, delta: float | None = None
                        ) -> Dict[int, List[int]]:
    """Invert per-node memberships to community -> sorted member list.
    Empty communities are omitted. Node ids are the graph's raw ids."""
    if delta is None:
        delta = delta_threshold(g.num_nodes, g.num_edges)
    mask = membership_mask(F, delta)
    nodes, comms = np.nonzero(mask)
    return _group_pairs(nodes, comms, g.raw_ids)


def _group_pairs(
    nodes: np.ndarray, comms: np.ndarray, raw_ids: np.ndarray
) -> Dict[int, List[int]]:
    """(node, community) pairs -> {community: sorted raw member ids}."""
    raw = raw_ids[nodes]
    order = np.argsort(comms, kind="stable")
    comms_sorted, raw_sorted = comms[order], raw[order]
    uniq, starts = np.unique(comms_sorted, return_index=True)
    out: Dict[int, List[int]] = {}
    for c, members in zip(uniq, np.split(raw_sorted, starts[1:])):
        out[int(c)] = sorted(members.tolist())
    return out


@dataclasses.dataclass
class CommunityArrays:
    """Communities as arrays: community ids[i] (ascending, non-empty only)
    holds the graph nodes nodes[offsets[i]:offsets[i + 1]], ordered by raw
    id; raw_ids maps a node to its raw id."""

    ids: np.ndarray        # (C,) int64
    offsets: np.ndarray    # (C + 1,) int64
    nodes: np.ndarray      # (P,) node indices
    raw_ids: np.ndarray    # (N,) int64

    @classmethod
    def from_counts(cls, counts: np.ndarray, nodes: np.ndarray,
                    raw_ids: np.ndarray) -> "CommunityArrays":
        """From community-major member nodes and the member count of every
        community (empty ones included)."""
        ids = np.flatnonzero(counts)
        offsets = np.concatenate([[0], np.cumsum(counts[ids])]).astype(np.int64)
        return cls(ids=ids, offsets=offsets, nodes=nodes, raw_ids=raw_ids)

    def __len__(self) -> int:
        return int(self.ids.size)

    def to_dict(self) -> Dict[int, List[int]]:
        """The extract_communities form."""
        members = self.raw_ids[self.nodes]
        return {
            int(c): members[lo:hi].tolist()
            for c, lo, hi in zip(self.ids, self.offsets[:-1], self.offsets[1:])
        }


def _raw_order(raw_of_row: np.ndarray) -> Optional[np.ndarray]:
    """Rows in ascending raw-id order (a numpy argsort), or None when they
    already are."""
    if np.all(raw_of_row[1:] > raw_of_row[:-1]):
        return None
    return np.argsort(raw_of_row, kind="stable")


def _community_arrays(F_t: torch.Tensor, g: Graph, delta: float | None,
                      k: int, chunk_rows: int,
                      row_to_node: Optional[np.ndarray]) -> CommunityArrays:
    """Rows of F_t (row r is node row_to_node[r], or r) visited in raw-id
    order, chunk_rows at a time; one torch.nonzero of each chunk's
    transposed mask gives its pairs community-major with rows ascending,
    and a stable sort by community on F_t's device merges the chunks.
    Only the rows and the per-community counts come back."""
    if delta is None:
        delta = delta_threshold(g.num_nodes, g.num_edges)
    n = g.num_nodes
    row_node = (None if row_to_node is None
                else np.asarray(row_to_node, dtype=np.int64)[:n])
    order = _raw_order(g.raw_ids if row_node is None else g.raw_ids[row_node])
    dev = F_t.device
    order_t = None if order is None else torch.as_tensor(order, device=dev)
    comms, rows = [], []
    for lo in range(0, n, chunk_rows):
        hi = min(lo + chunk_rows, n)
        F_c = (F_t[lo:hi, :k] if order_t is None
               else F_t.index_select(0, order_t[lo:hi])[:, :k])
        # F's own dtype: the host path's boundary decisions
        row_max = F_c.max(dim=1, keepdim=True).values
        mask = (F_c >= delta) | ((row_max < delta) & (F_c == row_max))
        pairs = torch.nonzero(mask.T).to(torch.int32)
        comms.append(pairs[:, 0])
        rows.append(pairs[:, 1] + lo)
    comm = torch.cat(comms) if comms else torch.empty(0, dtype=torch.int32, device=dev)
    row = torch.cat(rows) if rows else torch.empty(0, dtype=torch.int32, device=dev)
    if len(rows) > 1:
        comm, perm = torch.sort(comm, stable=True)
        row = row[perm]
    counts = torch.bincount(comm, minlength=k).cpu().numpy()
    nodes = row.cpu().numpy()
    if order is not None:
        nodes = order[nodes]
    if row_node is not None:
        nodes = row_node[nodes]
    return CommunityArrays.from_counts(counts, nodes, g.raw_ids)


def extract_community_arrays(
    F: np.ndarray, g: Graph, delta: float | None = None
) -> CommunityArrays:
    """extract_communities as CommunityArrays, in one pass over the host
    F: the rows in raw-id order (as they stand unless raw_ids is not
    ascending, as after Graph.permute), so nonzero of the transposed mask
    gives the members of each community in order — no per-community sort."""
    F = np.asarray(F)
    return _community_arrays(torch.from_numpy(F), g, delta, F.shape[1],
                             max(g.num_nodes, 1), None)


def extract_community_arrays_device(
    F_dev: torch.Tensor,
    g: Graph,
    delta: float | None = None,
    num_communities: int | None = None,
    chunk_rows: int = 1 << 16,
    row_to_node: Optional[np.ndarray] = None,
    mesh=None,
) -> CommunityArrays:
    """extract_community_arrays for F on a device (any torch device), in
    row chunks of at most chunk_rows (and (1 << 27) // k) rows. F_dev may
    be padded: rows >= g.num_nodes and columns >= num_communities
    (default: all columns) are ignored; a sequence of row shards (a mesh
    state's F) is joined on the first shard's device. Row r of F_dev is
    node row_to_node[r] of g (None: node r), as ShardedBigClamModel's
    internal_row_to_node() gives it for a relabelled trainer. The state of
    a multi-process `mesh` holds this rank's blocks only: every rank
    enters the all-gather of the whole F (parallel/multihost.py
    `fetch_global`, the JAX function's readback) and extracts it on its
    first block's device."""
    if getattr(mesh, "distributed", False):
        from bigclam_tpu_torch.parallel.mesh import state_blocks
        from bigclam_tpu_torch.parallel.multihost import fetch_global

        dev = state_blocks(F_dev)[0].device
        F_dev = torch.from_numpy(fetch_global(F_dev, mesh)).to(dev)
    if isinstance(F_dev, (list, tuple)):
        from bigclam_tpu_torch.parallel.mesh import row_shards

        parts = row_shards(F_dev)
        F_dev = torch.cat([f.to(parts[0].device) for f in parts])
    k = num_communities or int(F_dev.shape[1])
    chunk_rows = max(1, min(chunk_rows, (1 << 27) // max(k, 1)))
    return _community_arrays(F_dev, g, delta, k, chunk_rows, row_to_node)


def extract_communities_device(
    F_dev: torch.Tensor,
    g: Graph,
    delta: float | None = None,
    num_communities: int | None = None,
    chunk_rows: int = 1 << 16,
    row_to_node: Optional[np.ndarray] = None,
    mesh=None,
) -> Dict[int, List[int]]:
    """extract_communities for F on a device (bigclam_tpu's
    extract_communities_device): extract_community_arrays_device as a
    dict."""
    return extract_community_arrays_device(
        F_dev, g, delta, num_communities, chunk_rows, row_to_node, mesh
    ).to_dict()


def _id_table(raw_ids: np.ndarray):
    """Each raw id's decimal text followed by a tab, as an (N, W + 1) byte
    table, and each text's length."""
    text = np.asarray(raw_ids, dtype=np.int64).astype("S21")
    lens = np.char.str_len(text).astype(np.int64)
    w = int(lens.max()) if lens.size else 0
    table = np.zeros((lens.size, w + 1), dtype=np.uint8)
    table[:, :w] = text.view(np.uint8).reshape(lens.size, 21)[:, :w]
    table[np.arange(lens.size), lens] = ord("\t")
    return table, lens


def _format_chunk(table, lens, nodes, ends) -> np.ndarray:
    """The bytes of members `nodes` (a chunk of the member sequence), the
    members at positions `ends` ending their line with a newline."""
    lens_c = lens[nodes]
    used = np.arange(table.shape[1])[None, :] <= lens_c[:, None]
    buf = table[nodes][used]
    buf[np.cumsum(lens_c + 1)[ends] - 1] = ord("\n")
    return buf


def write_communities(path: str, com: CommunityArrays) -> None:
    """SNAP cmty format from CommunityArrays: one community per line,
    tab-separated member ids, a newline after each line — the bytes
    save_communities writes for com.to_dict(). Each raw id is formatted
    once; the members' bytes are gathered with numpy in chunks of
    WRITE_CHUNK_PAIRS, formatted on a few threads (numpy's gathers run
    without the GIL) and written in order."""
    table, lens = _id_table(com.raw_ids)
    ends = com.offsets[1:] - 1                    # each line's last member
    p = com.nodes.size
    starts = range(0, p, WRITE_CHUNK_PAIRS)
    workers = max(1, min(WRITE_THREADS, os.cpu_count() or 1))

    def chunk(p0):
        p1 = min(p0 + WRITE_CHUNK_PAIRS, p)
        last = ends[np.searchsorted(ends, p0):np.searchsorted(ends, p1)] - p0
        return _format_chunk(table, lens, com.nodes[p0:p1], last)

    with open(path, "wb") as f, ThreadPoolExecutor(workers) as pool:
        for w0 in range(0, len(starts), workers):
            for buf in pool.map(chunk, starts[w0 : w0 + workers]):
                f.write(buf.data)


def save_communities(path: str, communities: Dict[int, List[int]]) -> None:
    """SNAP cmty format: one community per line, tab-separated member ids."""
    with open(path, "w") as f:
        for c in sorted(communities):
            f.write("\t".join(str(u) for u in communities[c]) + "\n")


def load_communities(path: str) -> List[List[int]]:
    """Parse a SNAP cmty file into a list of member-id lists."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            out.append([int(t) for t in line.split()])
    return out
