"""Serving snapshots: publication, crc-verified loading, membership index.

Copied from bigclam_tpu/serve/snapshot.py with the imports pointed at the
port; a snapshot either package publishes is the other's. A serving
snapshot is a published F artifact (utils.checkpoint.publish —
fsync-rename archive + per-array crc32 sidecar + atomic latest.json
pointer, the SAME publication primitive the fit side uses) holding either
the dense (N, K) F or the sparse (ids, w) member lists, the raw node ids,
and the objective constants the fold-in engine needs to reproduce the
trainer's semantics.

Loading builds the full query surface for two of the three families:

  * "communities of u" — a threshold read of F[u] with EXACTLY the
    ops.extraction membership semantics (delta = sqrt(-log(1-eps)) and
    the argmax-tie fallback, Bigclamv2.scala:226-229);
  * "members of c" — a community -> member CSR inverted at load (one
    argsort over the membership pairs; sparse-representation aware: the
    pairs come straight from the member lists, no dense N*K detour).

The third family (fold-in "suggested communities") runs in
serve.server.FoldInEngine — the only torch path. This module imports
numpy alone.

The per-community MASS SHARE (sumF_c / sum(sumF) — the same signal as the
health pack's top_mass_share, ops.diagnostics) is computed at load and
keys the Zipf-aware hot-community cache (serve.server.HotCommunityCache).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bigclam_tpu_torch.ops.extraction import delta_threshold, membership_mask
from bigclam_tpu_torch.utils.checkpoint import CheckpointManager


class SnapshotError(ValueError):
    """No loadable published snapshot, or one that does not match the
    serving graph."""


# objective constants stamped into the snapshot meta so the fold-in
# engine rebuilds the trainer's exact semantics (cfg fields of the same
# names — conv_tol included: `cli serve` defaults its fold-in stop rule
# to the TRAINER's tolerance, so it must ride the snapshot); everything
# else about BigClamConfig is a training knob
FOLDIN_CFG_FIELDS = (
    "alpha", "beta", "max_backtracks", "min_p", "max_p", "min_f", "max_f",
    "conv_tol",
)


def publish_snapshot(
    directory: str,
    step: Optional[int] = None,
    F: Optional[np.ndarray] = None,
    ids: Optional[np.ndarray] = None,
    w: Optional[np.ndarray] = None,
    raw_ids: Optional[np.ndarray] = None,
    num_edges: int = 0,
    cfg=None,
    meta: Optional[dict] = None,
) -> str:
    """Publish a serving snapshot (dense: F; sparse: ids + w) through the
    checkpoint manager's atomic publish(). `cfg` (a BigClamConfig) stamps
    the objective constants; `num_edges` feeds the delta threshold.
    step=None takes the NEXT generation under the publish lock
    (CheckpointManager.publish_next — the continuous refit loop's
    strictly-monotonic publication path)."""
    if (F is None) == (ids is None or w is None):
        raise ValueError("publish_snapshot needs F (dense) XOR ids+w (sparse)")
    arrays: Dict[str, np.ndarray] = {}
    if F is not None:
        F = np.asarray(F)
        n, k = F.shape
        arrays["F"] = F
        rep = "dense"
    else:
        ids = np.asarray(ids)
        w = np.asarray(w)
        n = ids.shape[0]
        if meta and "k" in meta:
            k = int(meta["k"])
        elif cfg is not None:
            k = int(cfg.num_communities)
        else:
            raise ValueError(
                "sparse publish_snapshot needs k (via cfg or meta) — the "
                "member-id sentinel makes it unrecoverable from ids alone"
            )
        arrays["ids"] = ids
        arrays["w"] = w
        rep = "sparse"
    arrays["raw_ids"] = (
        np.asarray(raw_ids) if raw_ids is not None
        else np.arange(n, dtype=np.int64)
    )
    m = {
        "representation": rep,
        "n": int(n),
        "k": int(k),
        "num_edges": int(num_edges),
        "delta": delta_threshold(n, num_edges),
        # wall-clock publication instant: serving surfaces "generation
        # age" from this (how stale is serving)
        "published_ts": time.time(),
        **(meta or {}),
    }
    if cfg is not None:
        for f in FOLDIN_CFG_FIELDS:
            m[f] = getattr(cfg, f)
        m.setdefault("k", cfg.num_communities)
    cm = CheckpointManager(directory)
    if step is None:
        return cm.publish_next(arrays, meta=m)[1]
    return cm.publish(step, arrays, meta=m)


def publish_fleet_snapshot(
    directory: str,
    shard_ranges: Sequence[Tuple[int, int]],
    F: Optional[np.ndarray] = None,
    ids: Optional[np.ndarray] = None,
    w: Optional[np.ndarray] = None,
    raw_ids: Optional[np.ndarray] = None,
    num_edges: int = 0,
    cfg=None,
    meta: Optional[dict] = None,
) -> Tuple[int, str]:
    """Publish ONE serving generation as per-shard row-range archives +
    a fleet manifest: shard s gets rows
    [lo_s, hi_s) of F (dense) or of the member lists (sparse — M-sized
    slots, never a densified N*K block), its raw-id slice, and the
    GLOBAL sumF vector (K floats — the fold-in tail term is global even
    when the rows are sharded). Runs under the same publish-lock
    monotonicity as publish_snapshot (CheckpointManager.publish_fleet_
    next — one primitive, fleet-wide). Returns (step, manifest_path).

    On a pod each host calls this with only ITS row range materialized;
    this single-host entry takes the full arrays and slices — the CLI's
    `fit --publish-shards` path for store-backed fits."""
    if (F is None) == (ids is None or w is None):
        raise ValueError(
            "publish_fleet_snapshot needs F (dense) XOR ids+w (sparse)"
        )
    if not shard_ranges:
        raise ValueError("publish_fleet_snapshot needs >= 1 shard range")
    if F is not None:
        F = np.asarray(F)
        n, k = F.shape
        rep = "dense"
        sumF = F.sum(axis=0)
    else:
        ids = np.asarray(ids)
        w = np.asarray(w)
        n = ids.shape[0]
        if meta and "k" in meta:
            k = int(meta["k"])
        elif cfg is not None:
            k = int(cfg.num_communities)
        else:
            raise ValueError(
                "sparse publish_fleet_snapshot needs k (via cfg or meta)"
            )
        rep = "sparse"
        sumF = np.zeros(k, w.dtype)
        valid = ids < k
        np.add.at(sumF, ids[valid].astype(np.int64), w[valid])
    raw = (
        np.asarray(raw_ids) if raw_ids is not None
        else np.arange(n, dtype=np.int64)
    )
    if int(shard_ranges[0][0]) != 0 or int(shard_ranges[-1][1]) != n:
        raise ValueError(
            f"shard ranges {shard_ranges[0]}..{shard_ranges[-1]} do not "
            f"cover [0, {n})"
        )
    common = {
        "representation": rep,
        "n_global": int(n),
        "num_shards": len(shard_ranges),
        "k": int(k),
        "num_edges": int(num_edges),
        # delta from the GLOBAL n/E: membership semantics must not
        # depend on which shard answers
        "delta": delta_threshold(n, num_edges),
        "published_ts": time.time(),
        **(meta or {}),
    }
    if cfg is not None:
        for f in FOLDIN_CFG_FIELDS:
            common[f] = getattr(cfg, f)
    shard_arrays: List[Dict[str, np.ndarray]] = []
    shard_meta: List[dict] = []
    for s, (lo, hi) in enumerate(shard_ranges):
        lo, hi = int(lo), int(hi)
        raw_s = raw[lo:hi]
        arrays: Dict[str, np.ndarray] = {
            "raw_ids": raw_s,
            "sumF_global": np.asarray(sumF),
        }
        if rep == "dense":
            arrays["F"] = F[lo:hi]
        else:
            arrays["ids"] = ids[lo:hi]
            arrays["w"] = w[lo:hi]
        shard_arrays.append(arrays)
        shard_meta.append(
            {
                **common,
                "shard": s,
                "n": hi - lo,
                "lo": lo,
                "hi": hi,
                # raw-id interval for the router's range map: disjoint
                # intervals (unpermuted cache) route a raw id with one
                # bisect; overlapping ones (balanced/permuted cache)
                # make the router probe every containing shard
                "raw_lo": int(raw_s.min()) if raw_s.size else 0,
                "raw_hi": int(raw_s.max()) if raw_s.size else -1,
            }
        )
    manifest_meta = dict(common)
    return CheckpointManager(directory).publish_fleet_next(
        shard_arrays, shard_meta, meta=manifest_meta
    )


def load_fleet_shard(
    directory: str,
    shard: int,
    step: Optional[int] = None,
    manifest: Optional[dict] = None,
) -> "ServingSnapshot":
    """Load + index ONE shard of a published fleet generation. The
    snapshot's n/rows are the SHARD's; delta/sumF/k are global (stamped
    at publish), so every query family answers with fleet-wide
    semantics over local rows only."""
    cm = CheckpointManager(directory)
    if manifest is None:
        manifest = cm.load_fleet_manifest(step)
    if manifest is None:
        raise SnapshotError(
            f"{directory}: no published fleet generation (fit with "
            "--publish-dir --publish-shards, or publish_fleet_snapshot())"
        )
    got = cm.load_fleet_shard(manifest, shard)
    return ServingSnapshot.from_arrays(*got)


def pad_neighbor_batch(
    indptr: np.ndarray,
    indices: np.ndarray,
    nodes: Sequence[int],
    max_deg: Optional[int] = None,
    pad_deg_to: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Padded (B, D) neighbor batch for fold-in from a CSR adjacency.

    D = max degree in the batch, clipped to `max_deg` (hub queries keep
    their FIRST max_deg neighbors — CSR order, deterministic; the
    truncated count is returned so callers can report the approximation)
    and rounded up to `pad_deg_to` when given (compile-cache reuse).
    Padding slots: id 0, mask 0 (ops.foldin padding conventions)."""
    nodes = np.asarray(nodes, np.int64)
    degs = (indptr[nodes + 1] - indptr[nodes]).astype(np.int64)
    capped = degs if max_deg is None else np.minimum(degs, max_deg)
    truncated = int((degs - capped).sum())
    d = max(int(capped.max(initial=0)), 1)
    if pad_deg_to:
        d = ((d + pad_deg_to - 1) // pad_deg_to) * pad_deg_to
    b = len(nodes)
    nbr = np.zeros((b, d), np.int32)
    mask = np.zeros((b, d), np.float32)
    for i, (u, du) in enumerate(zip(nodes, capped)):
        lo = int(indptr[u])
        nbr[i, :du] = indices[lo : lo + int(du)]
        mask[i, :du] = 1.0
    return nbr, mask, truncated


def _sparse_membership_pairs(
    ids: np.ndarray, w: np.ndarray, k: int, delta: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(nodes, comms, weights) membership pairs from member lists,
    without a dense N*K detour: above-threshold slots plus the row-max
    fallback among the node's OWN member slots (a node whose every slot
    is empty has no membership — the dense path's all-zero-row
    "member of everything" corner has no sparse representation, a
    documented deviation)."""
    valid = ids < k
    above = valid & (w >= delta)
    row_max = np.where(valid, w, -np.inf).max(axis=1)
    has_valid = valid.any(axis=1)
    fallback = (
        valid
        & (row_max[:, None] < delta)
        & (w == row_max[:, None])
        & has_valid[:, None]
    )
    sel = above | fallback
    ni, si = np.nonzero(sel)
    return ni, ids[ni, si].astype(np.int64), w[ni, si]


@dataclasses.dataclass
class ServingSnapshot:
    """A loaded, indexed snapshot: everything the read-side query
    families need, immutable — hot-swap replaces the whole object."""

    step: int
    representation: str
    n: int
    k: int
    num_edges: int
    delta: float
    F: Optional[np.ndarray]
    ids: Optional[np.ndarray]
    w: Optional[np.ndarray]
    sumF: np.ndarray
    raw_ids: np.ndarray
    meta: dict
    comm_indptr: np.ndarray      # (K+1,) member-index row pointers
    comm_members: np.ndarray     # member RAW ids, per-community sorted
    mass_share: np.ndarray       # (K,) sumF_c / sum(sumF)
    _raw_order: np.ndarray = dataclasses.field(repr=False, default=None)
    # raw_ids[_raw_order], materialized ONCE at load: row_of is on the
    # hot read path and must stay O(log N), not re-gather O(N) per query
    _raw_sorted: np.ndarray = dataclasses.field(repr=False, default=None)

    # ------------------------------------------------------------- load
    @classmethod
    def load(
        cls,
        directory: str,
        step: Optional[int] = None,
        store=None,
        chunk_rows: int = 1 << 16,
    ) -> "ServingSnapshot":
        """Load + index the published snapshot (latest when step=None,
        falling back past corrupt ones — utils.checkpoint). With a
        GraphStore, the snapshot is verified against the manifest (node
        count + edge count must agree: a snapshot from another graph
        must refuse, not silently serve wrong members)."""
        got = CheckpointManager(directory).load_published(step)
        if got is None:
            raise SnapshotError(
                f"{directory}: no published snapshot (fit with "
                "--publish-dir, or publish_snapshot())"
            )
        step, arrays, meta = got
        return cls.from_arrays(
            step, arrays, meta, store=store, chunk_rows=chunk_rows
        )

    @classmethod
    def from_arrays(
        cls,
        step: int,
        arrays: Dict[str, np.ndarray],
        meta: dict,
        store=None,
        chunk_rows: int = 1 << 16,
    ) -> "ServingSnapshot":
        """Build + index a snapshot from already-loaded arrays — the
        shared back half of load() and the per-shard fleet loader
        (serve.snapshot.load_fleet_shard). A `sumF_global` array (fleet
        shards stamp it) overrides the locally-summed sumF: mass share,
        delta context, and the fold-in tail term are global quantities
        even when this snapshot holds one shard's rows."""
        directory = "<arrays>"
        rep = meta.get("representation", "dense")
        n = int(meta.get("n", 0))
        k = int(meta.get("k", 0))
        num_edges = int(meta.get("num_edges", 0))
        F = ids = w = None
        if rep == "dense":
            if "F" not in arrays:
                raise SnapshotError(
                    f"{directory}: dense snapshot {step} has no F array"
                )
            F = np.asarray(arrays["F"])
            n = n or F.shape[0]
            k = k or F.shape[1]
            sumF = F[:n, :k].sum(axis=0)
        elif rep == "sparse":
            if "ids" not in arrays or "w" not in arrays:
                raise SnapshotError(
                    f"{directory}: sparse snapshot {step} missing ids/w"
                )
            ids = np.asarray(arrays["ids"])
            w = np.asarray(arrays["w"])
            n = n or ids.shape[0]
            if not k:
                raise SnapshotError(
                    f"{directory}: sparse snapshot {step} meta has no k"
                )
            sumF = np.zeros(k, w.dtype)
            valid = ids[:n] < k
            np.add.at(
                sumF, ids[:n][valid].astype(np.int64), w[:n][valid]
            )
        else:
            raise SnapshotError(
                f"{directory}: unknown representation {rep!r}"
            )
        if "sumF_global" in arrays:
            sumF = np.asarray(arrays["sumF_global"])
        raw = arrays.get("raw_ids")
        raw_ids = (
            np.asarray(raw)[:n] if raw is not None
            else np.arange(n, dtype=np.int64)
        )
        if store is not None:
            if store.num_nodes != n or (
                num_edges and store.num_directed_edges != 2 * num_edges
            ):
                raise SnapshotError(
                    f"snapshot {step} ({n} nodes, {num_edges} edges) does "
                    f"not match the store ({store.num_nodes} nodes, "
                    f"{store.num_directed_edges // 2} edges) — wrong "
                    "graph cache for this snapshot"
                )
        delta = float(meta.get("delta", delta_threshold(n, num_edges)))
        # ---- membership pairs -> community->members CSR (load-time
        # index; the "members of c" family is then one slice per query)
        if rep == "dense":
            pnodes: List[np.ndarray] = []
            pcomms: List[np.ndarray] = []
            for lo in range(0, n, max(chunk_rows, 1)):
                hi = min(lo + max(chunk_rows, 1), n)
                mask = membership_mask(F[lo:hi, :k], delta)
                ni, ci = np.nonzero(mask)
                pnodes.append(ni + lo)
                pcomms.append(ci)
            nodes_i = np.concatenate(pnodes) if pnodes else np.zeros(0, int)
            comms_i = np.concatenate(pcomms) if pcomms else np.zeros(0, int)
        else:
            nodes_i, comms_i, _ = _sparse_membership_pairs(
                ids[:n], w[:n], k, delta
            )
        # sort pairs by (community, RAW id) — not internal row: balanced
        # caches permute rows, and the members_of contract (matching
        # ops.extraction._group_pairs) is raw-id-sorted member lists
        member_raw = raw_ids[nodes_i]
        order = np.lexsort((member_raw, comms_i))
        comm_members = member_raw[order]
        counts = np.bincount(comms_i, minlength=k)
        comm_indptr = np.zeros(k + 1, np.int64)
        np.cumsum(counts, out=comm_indptr[1:])
        total = float(sumF.sum())
        mass_share = (
            sumF / total if total > 0 else np.zeros(k, np.float64)
        )
        raw_order = np.argsort(raw_ids, kind="stable")
        return cls(
            step=step, representation=rep, n=n, k=k, num_edges=num_edges,
            delta=delta, F=F, ids=ids, w=w, sumF=np.asarray(sumF),
            raw_ids=raw_ids, meta=meta, comm_indptr=comm_indptr,
            comm_members=comm_members, mass_share=np.asarray(mass_share),
            _raw_order=raw_order, _raw_sorted=raw_ids[raw_order],
        )

    # ---------------------------------------------------------- queries
    def row_of(self, raw_id: int) -> int:
        """Internal row of a raw node id (binary search over the
        load-time sorted raw-id view; raises KeyError on unknown ids)."""
        pos = np.searchsorted(self._raw_sorted, raw_id)
        if pos >= self.n or self._raw_sorted[pos] != raw_id:
            raise KeyError(f"unknown node id {raw_id}")
        return int(self._raw_order[pos])

    def row_weights(self, row: int) -> Tuple[np.ndarray, np.ndarray]:
        """(community ids, weights) of a node's POSITIVE affiliations."""
        if self.representation == "dense":
            r = self.F[row, : self.k]
            nz = np.nonzero(r > 0)[0]
            return nz, r[nz]
        valid = (self.ids[row] < self.k) & (self.w[row] > 0)
        return (
            self.ids[row][valid].astype(np.int64),
            self.w[row][valid],
        )

    def communities_of(self, row: int) -> Tuple[np.ndarray, np.ndarray]:
        """Threshold read of one row — ops.extraction.membership_mask
        semantics (>= delta, argmax-tie fallback), sorted by weight
        descending."""
        if self.representation == "dense":
            mask = membership_mask(
                self.F[row : row + 1, : self.k], self.delta
            )[0]
            cids = np.nonzero(mask)[0]
            weights = self.F[row, cids]
        else:
            ni, cids, weights = _sparse_membership_pairs(
                self.ids[row : row + 1], self.w[row : row + 1],
                self.k, self.delta,
            )
        order = np.argsort(-weights, kind="stable")
        return cids[order], weights[order]

    def members_of(self, c: int) -> np.ndarray:
        """Sorted raw member ids of community c (the load-time inverted
        index; one slice per query)."""
        if not 0 <= c < self.k:
            raise KeyError(f"community {c} out of range [0, {self.k})")
        return self.comm_members[
            self.comm_indptr[c] : self.comm_indptr[c + 1]
        ]

    def top_mass_communities(self, count: int) -> np.ndarray:
        """Communities by descending mass share — the Zipf-aware cache's
        admission ranking (serve.server.HotCommunityCache)."""
        count = max(min(count, self.k), 0)
        return np.argsort(-self.mass_share, kind="stable")[:count]

    # ------------------------------------------- shard / fleet context
    @property
    def lo(self) -> int:
        """First GLOBAL internal row this snapshot holds (0 on a
        single-archive snapshot; the shard's range start on a fleet
        shard). Global row g lives at local row g - lo."""
        return int(self.meta.get("lo", 0))

    @property
    def n_global(self) -> int:
        """Fleet-wide node count (== n on a single-archive snapshot)."""
        return int(self.meta.get("n_global", self.n))

    @property
    def published_ts(self) -> Optional[float]:
        ts = self.meta.get("published_ts")
        return float(ts) if isinstance(ts, (int, float)) else None

    def age_s(self) -> Optional[float]:
        """Wall-clock seconds since this generation was published — the
        'how stale is serving' number (None on older snapshots that
        carry no published_ts)."""
        ts = self.published_ts
        return max(time.time() - ts, 0.0) if ts is not None else None
