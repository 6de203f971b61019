"""SNAP edge-list ingest: parse -> remap -> symmetrize -> dedup -> CSR.

Copied from bigclam_tpu/graph/ingest.py (`load_edge_list`,
`dedup_directed`, `graph_from_edges`) and the parse grammar of
bigclam_tpu/graph/stream.py (`parse_bytes`). The file is parsed by the
native library's `bc_parse_edge_list` (graph/native), or, where that
library is unavailable, by one numpy parse of the whole file
(`parse_bytes`); the graph cache/store is a later slice.

Format: SNAP edge lists — ``#``-prefixed comment lines, then one
whitespace-separated integer pair per line. Self-loops are dropped;
duplicate edges (including files that list both directions) are
deduplicated.
"""

from __future__ import annotations

import numpy as np

from bigclam_tpu_torch.graph import native
from bigclam_tpu_torch.graph.csr import Graph


def parse_bytes(data: bytes, where: str = "") -> np.ndarray:
    """Parse whole lines of a SNAP edge list into an (M, 2) int64 array
    (``#``-prefixed comment lines and blank lines dropped)."""
    lines = data.split(b"\n")
    body = b" ".join(
        ln for ln in lines if ln.strip() and not ln.lstrip().startswith(b"#")
    )
    if not body:
        return np.empty((0, 2), dtype=np.int64)
    flat = np.array(body.split(), dtype=np.int64)
    if flat.size % 2 != 0:
        raise ValueError(
            f"{where or 'edge list'}: expected an even number of integers, "
            f"got {flat.size}"
        )
    return flat.reshape(-1, 2)


def load_edge_list(path: str) -> np.ndarray:
    """Parse a SNAP edge-list file into an (M, 2) int64 array of raw id
    pairs: natively, else with parse_bytes."""
    try:
        return native.parse_edge_list(path)
    except native.NativeUnavailableError:
        pass
    with open(path, "rb") as f:
        return parse_bytes(f.read(), where=path)


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


def build_graph(path: str) -> Graph:
    """Load a graph from a SNAP edge-list text file."""
    return graph_from_edges(load_edge_list(path))
