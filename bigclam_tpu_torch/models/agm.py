"""AGM synthetic graph generator: sample a graph from a planted F.

Copied from bigclam_tpu/models/agm.py: P(edge u,v) = 1 - exp(-F_u . F_v)
(Yang & Leskovec WSDM'13). For a given numpy Generator the samplers draw
the same numbers in the same order as the JAX package's, so they return
the same graphs bit for bit.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.graph.ingest import graph_from_edges


def sample_graph(
    F: np.ndarray, rng: Optional[np.random.Generator] = None
) -> Graph:
    """Sample an undirected simple graph with P(u~v) = 1 - exp(-F_u.F_v).

    Dense O(N^2) sampling — intended for test-scale graphs.
    """
    rng = rng or np.random.default_rng(0)
    F = np.asarray(F, dtype=np.float64)
    n = F.shape[0]
    P = 1.0 - np.exp(-(F @ F.T))
    iu, ju = np.triu_indices(n, k=1)
    hit = rng.random(iu.shape[0]) < P[iu, ju]
    edges = np.stack([iu[hit], ju[hit]], axis=1)
    return graph_from_edges(edges, num_nodes=n)


def sample_planted_graph(
    n: int,
    k: int,
    p_in: float = 0.15,
    overlap: int = 0,
    rng: Optional[np.random.Generator] = None,
) -> tuple[Graph, List[List[int]]]:
    """Sparse AGM-style sampler for planted equal blocks at community scale.

    Per block, the edge count is Binomial(C(s,2), p_in) and pairs are drawn
    uniformly — O(E) total. With `overlap`, the first `overlap` nodes of
    each block also join the next block. Returns (graph, ground-truth
    communities).
    """
    rng = rng or np.random.default_rng(0)
    size = n // k
    if size < 2:
        raise ValueError(f"blocks need >= 2 nodes (n={n}, k={k})")
    truth: List[List[int]] = []
    srcs, dsts = [], []
    for c in range(k):
        members = np.arange(c * size, min((c + 1) * size, n))
        if overlap:
            members = np.concatenate(
                [members, (members[:overlap] + size) % n]
            )
        s = members.size
        pairs = s * (s - 1) // 2
        m = rng.binomial(pairs, p_in)
        if m:
            a = rng.integers(0, s, m)
            b = rng.integers(0, s, m)
            keep = a != b
            srcs.append(members[a[keep]])
            dsts.append(members[b[keep]])
        truth.append(sorted(set(members.tolist())))
    if srcs:
        edges = np.stack(
            [np.concatenate(srcs), np.concatenate(dsts)], axis=1
        )
    else:
        edges = np.empty((0, 2), np.int64)
    return graph_from_edges(edges, num_nodes=n), truth


def planted_partition_F(
    n: int,
    k: int,
    strength: float = 3.0,
    overlap: int = 0,
) -> tuple[np.ndarray, List[List[int]]]:
    """A deterministic planted F with k equal blocks of n//k nodes at the
    given membership strength; `overlap` extra nodes per community straddle
    the next block. Returns (F, ground-truth communities)."""
    F = np.zeros((n, k))
    size = n // k
    truth: List[List[int]] = []
    for c in range(k):
        members = list(range(c * size, min((c + 1) * size, n)))
        extra = [(m + size) % n for m in members[:overlap]]
        for u in members + extra:
            F[u, c] = strength
        truth.append(sorted(members + extra))
    return F, truth
