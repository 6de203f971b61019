"""Community extraction: delta-thresholding of F with argmax fallback.

Copied from the host path of bigclam_tpu/ops/extraction.py. The threshold
is delta = sqrt(-log(1 - eps)) with eps = 2E / (N(N-1)). Node u belongs to
community c iff F_uc >= delta; if max(F_u) < delta, u is assigned to every
community whose value EQUALS the row max (on ties, all tied columns; an
all-zero row therefore lands in every community, as in the reference).
The device-side extraction is a later slice.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from bigclam_tpu_torch.graph.csr import Graph


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
