"""SNAP edge-list ingest: parse -> remap -> symmetrize -> dedup -> CSR.

Copied from bigclam_tpu/graph/ingest.py (`load_edge_list`,
`dedup_directed`, `graph_from_edges`, `build_graph`). The file is parsed
by the native library's `bc_parse_edge_list` (graph/native), or, where
that library is unavailable, by the streaming scanner of graph/stream.py.
`build_graph` also opens a graph-cache directory compiled by `cli ingest`
(graph/store.py): binary shards, no parse, remap or dedup.

Format: SNAP edge lists — ``#``-prefixed comment lines, then one
whitespace-separated integer pair per line. Self-loops are dropped;
duplicate edges (including files that list both directions) are
deduplicated.
"""

from __future__ import annotations

import numpy as np

from bigclam_tpu_torch.graph import native
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.graph.stream import load_edge_list_streaming, parse_bytes

__all__ = ["build_graph", "dedup_directed", "graph_from_edges",
           "load_edge_list", "parse_bytes"]


def load_edge_list(path: str) -> np.ndarray:
    """Parse a SNAP edge-list file into an (M, 2) int64 array of raw id
    pairs: natively, else with the streaming scanner."""
    try:
        return native.parse_edge_list(path)
    except native.NativeUnavailableError:
        pass
    return load_edge_list_streaming(path)


def dedup_directed(both: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sort directed (src, dst) pairs lexicographically and drop duplicate
    rows; returns (src, dst) int64 in CSR order."""
    both = np.asarray(both, dtype=np.int64).reshape(-1, 2)
    if both.shape[0] == 0:
        return both[:, 0], both[:, 1]
    order = np.lexsort((both[:, 1], both[:, 0]))
    both = both[order]
    keep = np.empty(both.shape[0], dtype=bool)
    keep[0] = True
    np.any(both[1:] != both[:-1], axis=1, out=keep[1:])
    both = both[keep]
    return both[:, 0].copy(), both[:, 1].copy()


def graph_from_edges(pairs: np.ndarray, num_nodes: int | None = None) -> Graph:
    """Build a symmetric deduplicated CSR from raw (u, v) id pairs.

    Raw ids are remapped to contiguous [0, N) by ascending raw id. If
    ``num_nodes`` is given, ids are assumed already contiguous in [0, N).
    """
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    if num_nodes is None:
        raw_ids, remapped = np.unique(pairs, return_inverse=True)
        pairs = remapped.reshape(-1, 2)
        n = int(raw_ids.shape[0])
    else:
        n = int(num_nodes)
        raw_ids = np.arange(n, dtype=np.int64)
        if pairs.size and (pairs.min() < 0 or pairs.max() >= n):
            raise ValueError("edge endpoint out of range for given num_nodes")

    keep = pairs[:, 0] != pairs[:, 1]           # drop self-loops
    pairs = pairs[keep]

    if n > np.iinfo(np.int32).max:
        raise ValueError(
            f"num_nodes={n} exceeds the int32 CSR indices bound (2^31-1)"
        )

    # symmetrize: every edge in both directions, then dedup directed pairs
    both = np.concatenate([pairs, pairs[:, ::-1]], axis=0)
    src, dst = dedup_directed(both)

    counts = np.bincount(src, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return Graph(indptr=indptr, indices=dst.astype(np.int32), raw_ids=raw_ids)


def build_graph(path: str, self_heal: bool = False) -> Graph:
    """Load a graph: a SNAP edge-list file (parse + remap + dedup) or a
    graph-cache directory compiled by `cli ingest` (binary reload).
    `self_heal` lets a cache quarantine and rebuild a crc-failed shard
    from its source edge list (graph.store.GraphStore) instead of
    rejecting the whole cache."""
    from bigclam_tpu_torch.graph.store import GraphStore, is_cache_dir

    if is_cache_dir(path):
        return GraphStore.open(path, self_heal=self_heal).load_graph()
    return graph_from_edges(load_edge_list(path))
