"""Conductance-based seeding: ego-net conductance, locally-minimal ranking,
and the conductance-seeded F initializer.

Port of bigclam_tpu/ops/seeding.py. For every node u with ego-net
S(u) = {u} ∪ N(u):

    |z|    = deg(u) + S1(u),   S1(u) = sum_{v in N(u)} deg(v)
    vol_S  = 2*deg(u) + 2*tri(u)
    cut_S  = S1(u) - deg(u) - 2*tri(u)
    phi    = 0 if vol_S==0 else 1 if vol_T==0 else cut_S/min(vol_S, vol_T)

with tri(u) = #edges among N(u) from one of the conductance backends:

* "numpy": exact counts on the host — the native library's OpenMP pass
  (graph/native `bc_triangle_counts`), or triangle_counts_numpy's loop
  where that library is unavailable;
* "dense": rowsum((A @ A) * A) / 2 on a dense float32 adjacency on a
  device (exact while counts stay below 2^24: DENSE_DEVICE_MAX_DEGREE);
* "sampled": the degree-capped estimator on the host (native
  `bc_triangle_counts_capped`, or the chunked numpy sweep);
* "sampled_device": the same estimator as a chunked two-hop sweep on a
  device;
* "auto": sampled when a degree cap is set and some degree exceeds it;
  else dense when the graph fits the dense bounds and the caller names a
  device; else exact host counts. (The JAX rule takes its device for
  dense whenever the graph fits; dense and exact host counts are the same
  integers, so the seeds are the same either way, and the port uses a
  device only when the caller names one.)

All capped backends share one splitmix64 sampler (capped_csr, bit for bit
the native one), so the same config gives the same seed ranking on every
backend. The device backends run on `cuda` unless the caller passes
another device (`device="cpu"` runs them on the CPU).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph import native
from bigclam_tpu_torch.graph.csr import Graph, host_tensor
from bigclam_tpu_torch.utils.device import disable_tf32, resolve_device

# the dense (N, N) device adjacency's node bound
DENSE_DEVICE_MAX_NODES = 16384
# float32 matmul accumulators are exact only below 2^24; 2*tri(u) <= deg(u)^2,
# so cap the degree the dense backend accepts
DENSE_DEVICE_MAX_DEGREE = 4095

BACKENDS = ("numpy", "dense", "sampled", "sampled_device", "auto")


def triangle_counts(g: Graph) -> np.ndarray:
    """tri(u) = number of edges among N(u) (= triangles through u): the
    native OpenMP pass, or triangle_counts_numpy without the library."""
    try:
        return native.triangle_counts(g)
    except native.NativeUnavailableError:
        return triangle_counts_numpy(g)


def triangle_counts_numpy(g: Graph) -> np.ndarray:
    """The numpy pass: per node u, one boolean-mask gather over the
    concatenated neighbor lists of N(u); the sum of hits double-counts
    intra-neighborhood edges, so tri(u) = hits / 2. O(sum deg^2)."""
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


def triangle_counts_dense_device(g: Graph, device=None) -> np.ndarray:
    """Device backend: tri = rowsum((A @ A) * A) / 2 on a dense float32
    adjacency on `device` (cuda by default), TF32 off so the product is
    exact in full float32. Refuses degrees above DENSE_DEVICE_MAX_DEGREE,
    where the counts could pass 2^24."""
    deg = g.degrees
    if deg.size and int(deg.max()) > DENSE_DEVICE_MAX_DEGREE:
        raise ValueError(
            f"max degree {int(deg.max())} exceeds float32-exact bound "
            f"{DENSE_DEVICE_MAX_DEGREE}; use the host backend"
        )
    dev = resolve_device(device)
    disable_tf32()
    n = g.num_nodes
    A = torch.zeros((n, n), dtype=torch.float32, device=dev)
    A[host_tensor(g.src, np.int64, dev), host_tensor(g.dst, np.int64, dev)] = 1.0
    tri = ((A @ A) * A).sum(dim=1) / 2.0
    return torch.round(tri).to(torch.int64).cpu().numpy()


_SPLITMIX_ADD = np.uint64(0x9E3779B97F4A7C15)
_SPLITMIX_MUL1 = np.uint64(0xBF58476D1CE4E5B9)
_SPLITMIX_MUL2 = np.uint64(0x94D049BB133111EB)
_ROW_KEY = np.uint64(0x2545F4914F6CDD1D)
_M64 = (1 << 64) - 1


def _splitmix64(x) -> np.ndarray:
    """The native sampler's PRNG (native.cpp bc_splitmix64) elementwise on
    uint64 values, wrapping mod 2^64 as C does."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        x = x + _SPLITMIX_ADD
        x = (x ^ (x >> np.uint64(30))) * _SPLITMIX_MUL1
        x = (x ^ (x >> np.uint64(27))) * _SPLITMIX_MUL2
    return x ^ (x >> np.uint64(31))


def capped_neighbor_lists(
    indptr: np.ndarray,
    indices: np.ndarray,
    cap: int,
    seed: int,
    row_offset: int = 0,
):
    """Capped-list sampler over a CSR row range: rows of degree <= cap
    copied, each longer row a uniform sample of `cap` neighbors by the
    native partial Fisher-Yates (native.cpp bc_triangle_counts_capped) on
    a splitmix64 stream keyed by the global row id `row_offset + r`. The
    Fisher-Yates steps run for all capped rows at once, one vectorized
    swap per step. Returns (indptr_c, indices_c) with each capped list
    sorted ascending."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices)
    deg = np.diff(indptr)
    nr = deg.size
    cdeg = np.minimum(deg, cap)
    indptr_c = np.concatenate([[0], np.cumsum(cdeg)]).astype(np.int64)
    indices_c = np.empty(indptr_c[-1], dtype=indices.dtype)
    # uncapped rows: straight copy (already ascending in CSR)
    rows = np.repeat(np.arange(nr, dtype=np.int64), deg)
    pos = np.arange(indices.size, dtype=np.int64) - np.repeat(indptr[:-1], deg)
    small_e = deg[rows] <= cap
    indices_c[indptr_c[rows[small_e]] + pos[small_e]] = indices[small_e]
    hubs = np.flatnonzero(deg > cap)
    if hubs.size == 0:
        return indptr_c, indices_c
    # capped rows: their lists side by side in one scratch array
    hdeg = deg[hubs]
    hoff = np.concatenate([[0], np.cumsum(hdeg)[:-1]]).astype(np.int64)
    scratch = indices[
        np.repeat(indptr[hubs] - hoff, hdeg) + np.arange(hdeg.sum(), dtype=np.int64)
    ]
    keys = (hubs + int(row_offset)).astype(np.uint64)
    with np.errstate(over="ignore"):
        s = _splitmix64(np.uint64(int(seed) & _M64) ^ (keys * _ROW_KEY))
    picked = np.empty((hubs.size, cap), dtype=indices.dtype)
    for i in range(cap):                      # partial Fisher-Yates
        s = _splitmix64(s)
        j = i + (s % (hdeg - i).astype(np.uint64)).astype(np.int64)
        a, b = hoff + i, hoff + j
        tmp = scratch[a]
        scratch[a] = scratch[b]
        scratch[b] = tmp
        picked[:, i] = scratch[a]
    picked.sort(axis=1)
    indices_c[indptr_c[hubs][:, None] + np.arange(cap)] = picked
    return indptr_c, indices_c


def capped_csr(g: Graph, cap: int, seed: int):
    """Per-node uniform sample (without replacement) of at most `cap`
    neighbors, bit for bit the native backend's sampler, so every capped
    backend sees the SAME lists. Returns (indptr_c, indices_c) with each
    capped list sorted ascending."""
    return capped_neighbor_lists(g.indptr, g.indices, cap, seed)


def triangle_counts_sampled(
    g: Graph,
    cap: int,
    rng: Optional[np.random.Generator] = None,
    chunk_entries: int = 1 << 26,
    use_native: bool = True,
) -> np.ndarray:
    """Degree-capped estimator of tri(u).

    Each node keeps a uniform sample S_u of at most `cap` neighbors;
    triangles are counted over (v in S_u, w in S_v) hits w in S_u, each hit
    weighted by deg(v)/|S_v|, and the total rescaled by
    C(deg_u, 2)/C(|S_u|, 2). With cap >= max degree this is the exact count.
    Work O(N * cap^2), in node chunks of at most `chunk_entries` two-hop
    entries (the numpy path).

    ONE seed is drawn from `rng` whichever backend runs, and the numpy
    sampler (capped_csr) is the native one bit for bit, so the native and
    numpy paths return the same estimates up to summation order.
    """
    rng = rng or np.random.default_rng(0)
    n = g.num_nodes
    deg = g.degrees.astype(np.int64)
    seed = int(rng.integers(2**63))       # drawn on EVERY path (see above)
    if n == 0 or g.indices.size == 0:
        return np.zeros(n, dtype=np.float64)
    if use_native:
        try:
            return native.triangle_counts_capped(g, cap, seed=seed)
        except native.NativeUnavailableError:
            pass
    indptr_c, indices_c = capped_csr(g, cap, seed)
    cdeg = np.diff(indptr_c)
    # globally sorted ego keys u*n + w, one per capped edge
    ego_src = np.repeat(np.arange(n, dtype=np.int64), cdeg)
    ego_keys = ego_src * n + indices_c
    inner_w = deg / np.maximum(cdeg, 1)      # deg(v)/|S_v| hit weight
    tri_w = np.zeros(n, dtype=np.float64)

    # chunk nodes so the expanded two-hop arrays stay bounded
    two_hop = np.zeros(n, dtype=np.int64)    # per-u expanded entry count
    np.add.at(two_hop, ego_src, cdeg[indices_c])
    bounds = np.searchsorted(
        np.cumsum(two_hop), np.arange(1, two_hop.sum() // chunk_entries + 2)
        * chunk_entries
    )
    starts = np.concatenate([[0], np.minimum(bounds + 1, n)])
    for lo, hi in zip(starts[:-1], starts[1:]):
        if lo >= hi:
            continue
        e0, e1 = indptr_c[lo], indptr_c[hi]
        if e0 == e1:
            continue                         # chunk of isolated nodes only
        v = indices_c[e0:e1]                 # first-hop targets
        reps = cdeg[v]
        z_u = np.repeat(ego_src[e0:e1], reps)          # origin node u
        z_wt = np.repeat(inner_w[v], reps)             # deg(v)/|S_v|
        # second hop: concatenate v's capped lists
        take = np.repeat(indptr_c[v], reps) + (
            np.arange(reps.sum(), dtype=np.int64)
            - np.repeat(np.concatenate([[0], np.cumsum(reps[:-1])]), reps)
        )
        z_w = indices_c[take]
        # membership w in S_u via the sorted ego keys
        cand = z_u * n + z_w
        idx = np.searchsorted(ego_keys, cand)
        hit = (idx < ego_keys.size) & (ego_keys[np.minimum(idx, ego_keys.size - 1)] == cand)
        np.add.at(tri_w, z_u[hit], z_wt[hit])
    pairs = cdeg * (cdeg - 1)
    scale = np.where(
        pairs > 0, deg * (deg - 1) / np.maximum(pairs, 1), 0.0
    )
    return tri_w / 2.0 * scale


def triangle_counts_sampled_device(
    g: Graph,
    cap: int,
    seed: int,
    chunk_nodes: Optional[int] = None,
    device=None,
) -> np.ndarray:
    """Device backend of the degree-capped estimator, on `device` (cuda by
    default): the host estimators' capped lists and weights, evaluated as
    a chunked two-hop membership sweep. Per node chunk it gathers the
    (C, cap) padded capped rows, expands them to the (C, cap*cap) two-hop
    candidates and tests each in the sorted ego row with a batched
    torch.searchsorted (left side); rows are padded with the sentinel n,
    which sorts last and never counts. Chunks hold at most
    (1 << 26) // cap^2 nodes; hits accumulate in float32 (counts <= cap^2
    are exact, the deg/|S_v| weights round at 1e-7 relative)."""
    dev = resolve_device(device)
    n = g.num_nodes
    deg = g.degrees.astype(np.int64)
    if n == 0 or g.indices.size == 0:
        return np.zeros(n, dtype=np.float64)
    if chunk_nodes is None:
        chunk_nodes = max(64, min(n, (1 << 26) // max(cap * cap, 1)))
    indptr_c, indices_c = capped_csr(g, cap, seed)
    cdeg = np.diff(indptr_c)
    # (n + 1, cap) padded rows, ascending with sentinel n; row n is all
    # sentinel (the rows past the graph and the sentinel's own hop)
    S = np.full((n + 1, cap), n, dtype=np.int32)
    pos = np.arange(indices_c.size, dtype=np.int64) - np.repeat(indptr_c[:-1], cdeg)
    S[np.repeat(np.arange(n, dtype=np.int64), cdeg), pos] = indices_c
    inner_w = np.append(deg / np.maximum(cdeg, 1), 0.0).astype(np.float32)
    Sd = torch.from_numpy(S).to(dev)
    wd = torch.from_numpy(inner_w).to(dev)
    n_pad = -(-n // chunk_nodes) * chunk_nodes
    tri = torch.empty(n_pad, dtype=torch.float32, device=dev)
    for lo in range(0, n_pad, chunk_nodes):
        u = torch.arange(lo, lo + chunk_nodes, device=dev).clamp_(max=n)
        ego = Sd[u]                                          # (C, cap)
        v = ego.reshape(-1).long()
        two = Sd[v].reshape(chunk_nodes, cap * cap)          # (C, cap*cap)
        w = wd[v].reshape(chunk_nodes, cap)
        idx = torch.searchsorted(ego, two, out_int32=True).clamp_(max=cap - 1)
        found = torch.gather(ego, 1, idx.long()) == two
        hits = (found & (two < n)).to(torch.float32).reshape(chunk_nodes, cap, cap)
        tri[lo : lo + chunk_nodes] = (hits.sum(dim=2) * w).sum(dim=1)
    tri_w = tri[:n].cpu().numpy().astype(np.float64)
    pairs = cdeg * (cdeg - 1)
    scale = np.where(
        pairs > 0, deg * (deg - 1) / np.maximum(pairs, 1), 0.0
    )
    return tri_w / 2.0 * scale


def auto_backend(g: Graph, degree_cap: Optional[int] = None, device=None) -> str:
    """The backend "auto" takes: "sampled" when degree_cap is set and some
    degree exceeds it; "dense" when a device is named, 0 < N <=
    DENSE_DEVICE_MAX_NODES and no degree exceeds DENSE_DEVICE_MAX_DEGREE;
    else "numpy"."""
    max_deg = int(g.degrees.max()) if g.degrees.size else 0
    if degree_cap is not None and max_deg > degree_cap:
        return "sampled"
    if (device is not None and 0 < g.num_nodes <= DENSE_DEVICE_MAX_NODES
            and max_deg <= DENSE_DEVICE_MAX_DEGREE):
        return "dense"
    return "numpy"


def conductance(
    g: Graph, backend: str = "auto", degree_cap: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
    tri: Optional[np.ndarray] = None,
    device=None,
) -> np.ndarray:
    """Ego-net conductance phi(u) for every node (float64) from the
    triangle counts of `backend` (module docstring).
    The capped backends sample at most `degree_cap` neighbors (128 when
    unset) with one seed drawn from `rng`; the device backends run on
    `device` (cuda by default). A precomputed per-node triangle-count
    array `tri` skips the counting."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown conductance backend {backend!r} (one of {BACKENDS})"
        )
    if backend == "auto":
        backend = auto_backend(g, degree_cap, device)
    deg = g.degrees
    two_e = float(g.num_directed_edges)
    if tri is not None:
        pass
    elif backend == "sampled_device":
        seed = int((rng or np.random.default_rng(0)).integers(2**63))
        tri = triangle_counts_sampled_device(g, degree_cap or 128, seed,
                                             device=device)
    elif backend == "sampled":
        tri = triangle_counts_sampled(g, degree_cap or 128, rng)
    elif backend == "dense":
        tri = triangle_counts_dense_device(g, device)
    else:
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
    try:
        return native.select_seeds_covering(g, order, k, hops, cap)
    except native.NativeUnavailableError:
        return _covering_walk_numpy(g, order, k, hops, cap)


def _covering_walk_numpy(
    g: Graph, order: np.ndarray, k: int, hops: int, cap: int
) -> np.ndarray:
    """numpy version of the covering walk; the native walk
    (bc_select_seeds_covering) chooses the same seeds."""
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
    backend: str = "auto",
    phi: Optional[np.ndarray] = None,
    device=None,
) -> np.ndarray:
    """conductanceLocalMin: phi + ranking in one call. phi comes from
    conductance(g, backend, cfg.seeding_degree_cap, default_rng(cfg.seed),
    device=device) unless given. With cfg.seed_exclusion (auto-on in
    quality mode) the ranking is the covering walk (select_seeds_covering,
    2 hops)."""
    cfg = cfg or BigClamConfig()
    if phi is None:
        phi = conductance(
            g,
            backend=backend,
            degree_cap=cfg.seeding_degree_cap,
            rng=np.random.default_rng(cfg.seed),
            device=device,
        )
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
