"""Conductance-based seeding: ego-net conductance, locally-minimal ranking,
and the conductance-seeded F initializer.

Copied from the host path of bigclam_tpu/ops/seeding.py (exact numpy
triangle counts, closed-form conductance, the locally-minimal ranking and
the covering walk). The seed order equals the JAX package's exactly: the
counts are integers, and the ranking is the same arithmetic on them. The
device backends and the degree-capped estimator are later slices.

For every node u with ego-net S(u) = {u} ∪ N(u):

    |z|    = deg(u) + S1(u),   S1(u) = sum_{v in N(u)} deg(v)
    vol_S  = 2*deg(u) + 2*tri(u)
    cut_S  = S1(u) - deg(u) - 2*tri(u)
    phi    = 0 if vol_S==0 else 1 if vol_T==0 else cut_S/min(vol_S, vol_T)
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph


def triangle_counts(g: Graph) -> np.ndarray:
    """tri(u) = number of edges among N(u) (= triangles through u).

    Host pass: per node u, one boolean-mask gather over the concatenated
    neighbor lists of N(u); the sum of hits double-counts
    intra-neighborhood edges, so tri(u) = hits / 2.
    """
    n = g.num_nodes
    indptr, indices = g.indptr, g.indices
    flags = np.zeros(n, dtype=bool)
    tri = np.zeros(n, dtype=np.int64)
    for u in range(n):
        nbrs = indices[indptr[u] : indptr[u + 1]]
        if nbrs.size == 0:
            continue
        flags[nbrs] = True
        z = np.concatenate([indices[indptr[v] : indptr[v + 1]] for v in nbrs])
        tri[u] = np.count_nonzero(flags[z]) // 2
        flags[nbrs] = False
    return tri


def conductance(
    g: Graph, backend: str = "numpy", tri: Optional[np.ndarray] = None
) -> np.ndarray:
    """Ego-net conductance phi(u) for every node (float64), from exact
    host triangle counts ("numpy"; "auto" is the same in this slice). A
    precomputed per-node triangle-count array `tri` skips the counting."""
    if backend not in ("numpy", "auto"):
        raise ValueError(
            f"conductance backend {backend!r} is not in the port yet "
            "(host 'numpy' only)"
        )
    deg = g.degrees
    two_e = float(g.num_directed_edges)
    if tri is None:
        tri = triangle_counts(g)
    s1 = np.zeros(g.num_nodes)
    np.add.at(s1, g.src, deg[g.dst].astype(np.float64))
    return phi_from_counts(deg, s1, tri, two_e)


def phi_from_counts(
    deg: np.ndarray, s1: np.ndarray, tri: np.ndarray, two_e: float
) -> np.ndarray:
    """Ego-net conductance from deg(u), S1(u), tri(u) and 2E."""
    # clamp tri into its feasible range [0, (s1-deg)/2]
    tri = np.clip(tri, 0.0, np.maximum(s1 - deg, 0.0) / 2.0)
    cut = s1 - deg - 2.0 * tri
    vol_s = 2.0 * deg + 2.0 * tri
    vol_t = two_e - vol_s - 2.0 * cut
    phi = np.where(
        vol_s == 0,
        0.0,
        np.where(
            vol_t <= 0,
            1.0,
            cut / np.maximum(np.minimum(vol_s, vol_t), 1e-300),
        ),
    )
    return phi


def rank_seeds(g: Graph, phi: np.ndarray, cfg: Optional[BigClamConfig] = None
               ) -> np.ndarray:
    """Locally-minimal seed ranking: each node nominates
    argmin_{v in N(u)} (phi(v), v); neighbor-less nodes nominate themselves
    at the sentinel phi. Returns nominee ids deduplicated, sorted ascending
    by (phi, id)."""
    cfg = cfg or BigClamConfig()
    n = g.num_nodes
    indptr, indices = g.indptr, g.indices
    if indices.size == 0:
        return np.arange(n, dtype=np.int64)
    # segmented argmin on the key (phi(v), v): per-segment min phi, then
    # the min id among the neighbors attaining it (NaN phi ranks as +inf)
    phi = np.where(np.isnan(phi), np.inf, np.asarray(phi, np.float64))
    phi_nbr = phi[indices]
    has_nbrs = g.degrees > 0
    starts = indptr[:-1].astype(np.int64)
    nominee = np.arange(n, dtype=np.int64)
    nominee_phi = np.full(n, float(cfg.isolated_phi_sentinel))
    seg_min = np.minimum.reduceat(np.append(phi_nbr, np.inf), starts)
    src = g.src
    is_min = phi_nbr == seg_min[src]
    id_or_n = np.where(is_min, indices.astype(np.int64), n)
    seg_min_id = np.minimum.reduceat(np.append(id_or_n, n), starts)
    nominee[has_nbrs] = seg_min_id[has_nbrs]
    nominee_phi[has_nbrs] = seg_min[has_nbrs]
    cand, first = np.unique(nominee, return_index=True)
    cand_phi = nominee_phi[first]
    rank = np.lexsort((cand, cand_phi))
    return cand[rank]


def covering_order(
    g: Graph, phi: np.ndarray, cfg: Optional[BigClamConfig] = None
) -> np.ndarray:
    """Candidate order for the covering walk: locally-minimal nominees
    first (rank_seeds), then every remaining node by ascending (phi, id)
    with NaN phi sorted last."""
    cfg = cfg or BigClamConfig()
    n = g.num_nodes
    ranked = rank_seeds(g, phi, cfg)
    rest = np.setdiff1d(
        np.arange(n, dtype=np.int64), ranked, assume_unique=False
    )
    phi_fb = np.where(np.isnan(phi), np.inf, np.asarray(phi, np.float64))
    rest = rest[np.lexsort((rest, phi_fb[rest]))]
    return np.concatenate([ranked, rest])


def select_seeds_covering(
    g: Graph,
    phi: np.ndarray,
    k: int,
    cfg: Optional[BigClamConfig] = None,
    hops: int = 1,
    order: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Coverage-aware seed selection: walk the candidates in covering_order
    and skip any already covered by a chosen seed's `hops`-neighborhood
    (2-hop fans capped at cfg.seeding_degree_cap, default 256)."""
    cfg = cfg or BigClamConfig()
    if k <= 0:
        return np.empty(0, dtype=np.int64)
    cap = cfg.seeding_degree_cap
    if not cap or cap <= 0:
        cap = 256
    if order is None:
        order = covering_order(g, phi, cfg)
    covered = np.zeros(g.num_nodes, dtype=bool)
    indptr, indices = g.indptr, g.indices
    out = []
    for s in order:
        s = int(s)
        if covered[s]:
            continue
        out.append(s)
        covered[s] = True
        nbrs = indices[indptr[s] : indptr[s + 1]]
        covered[nbrs] = True
        if hops >= 2:
            if nbrs.size > cap:
                nbrs = nbrs[:: max(nbrs.size // cap, 1)][:cap]
            for v in nbrs:
                covered[indices[indptr[v] : indptr[v + 1]][:cap]] = True
        if len(out) >= k:
            break
    return np.asarray(out, dtype=np.int64)   # may be < k: fully covered


def init_F(
    g: Graph,
    seeds: np.ndarray,
    cfg: BigClamConfig,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Conductance-seeded F0: column c is the ego-net indicator of seed c
    (adjacency row + self = 1.0; cfg.seed_include_self=False drops the
    self entry). Columns beyond len(seeds) are Bernoulli(0.5) {0,1} rows.
    Seeds beyond K are dropped."""
    rng = rng or np.random.default_rng(cfg.seed)
    n, k = g.num_nodes, cfg.num_communities
    seeds = np.asarray(seeds, dtype=np.int64)[:k]
    F = np.zeros((n, k), dtype=np.float64)
    for c, s in enumerate(seeds):
        F[g.neighbors(s), c] = 1.0
        if cfg.seed_include_self:
            F[s, c] = 1.0
    if len(seeds) < k:
        F[:, len(seeds):] = rng.integers(0, 2, size=(n, k - len(seeds)))
    return F


def conductance_seeds(
    g: Graph,
    cfg: Optional[BigClamConfig] = None,
    phi: Optional[np.ndarray] = None,
) -> np.ndarray:
    """conductanceLocalMin: phi + ranking in one call. With
    cfg.seed_exclusion (auto-on in quality mode) the ranking is the
    covering walk (select_seeds_covering, 2 hops)."""
    cfg = cfg or BigClamConfig()
    if cfg.seeding_degree_cap is not None:
        raise ValueError(
            "seeding_degree_cap selects the capped conductance estimator, "
            "which the port does not have yet (exact host counts only)"
        )
    if phi is None:
        phi = conductance(g)
    else:
        phi = np.asarray(phi, np.float64)
        if phi.shape != (g.num_nodes,):
            raise ValueError(
                f"precomputed phi has shape {phi.shape}, want "
                f"({g.num_nodes},)"
            )
    exclude = (
        cfg.quality_mode if cfg.seed_exclusion is None else cfg.seed_exclusion
    )
    if exclude:
        return select_seeds_covering(
            g, phi, cfg.num_communities, cfg, hops=2
        )
    return rank_seeds(g, phi, cfg)
