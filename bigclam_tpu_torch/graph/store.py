"""Out-of-core sharded graph store: compile once, load per mesh position.

Copied from bigclam_tpu/graph/store.py; a cache either package writes is
the other's, byte for byte. The input-pipeline layer between raw SNAP
text and the trainers:

* ``compile_graph_cache`` builds a write-once **binary shard cache** from an
  edge list without ever holding the edge set in RAM: the streaming scanner
  (graph/stream.py) spills parsed pairs chunk by chunk, a scatter pass
  buckets directed edges by owner node range, a per-bucket lexsort dedups,
  and the result is written as per-node-range packed CSR shards
  (``indptr``/``indices`` npy blobs). Peak RSS is O(chunk + bucket + N),
  never O(E) or O(file). With ``balance=True`` the degree-balance
  permutation (parallel/balance.py) is baked into the shards at compile
  time, so a mesh loads already-balanced node ranges.
* a versioned JSON **manifest** records the format version, N/E, the shard
  table (node ranges + per-shard directed-edge counts) and a crc32 per blob;
  loads verify the version and checksums, so a stale or corrupted cache is
  rejected instead of silently mis-training.
* ``GraphStore.load_shard`` / ``load_shard_range`` give **per-position
  loading**: a mesh position reads exactly the shard files of the
  node-contiguous rows it owns (the store-backed trainers of
  parallel/sharded.py and parallel/ring.py) — the trainer never assembles
  the global CSR. ``load_graph`` assembles the full ``Graph`` (bit-identical
  to ``build_graph`` on the same text for unbalanced caches), the
  mmap-backed fast reload behind ``cli --cache-dir``.

Cache directory layout::

    manifest.json
    raw_ids.npy                  original node id of each compact id
    perm.npy                     (balanced caches) old id -> new id
    shard_00000.indptr.npy       per-shard local CSR row pointers (rebased)
    shard_00000.indices.npy      per-shard neighbor lists (global int32 ids)
    shard_00000.phi.npy          per-shard ingest-baked seed scores
                                 (ego-net conductance, float64; format v2)
    shard_00000.closure.npy      per-shard closure gather lists (format v3)
    ...
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.graph.ingest import dedup_directed
from bigclam_tpu_torch.graph.stream import (
    DEFAULT_CHUNK_BYTES,
    BoundedBlobCache,
    stream_edge_list,
)

# v2: ingest-baked per-node seed scores (shard_*.phi.npy +
# per-entry "phi" crc). v1 caches still LOAD (graceful migration — the
# graph bytes are identical); only load_seed_scores refuses on them, with
# a re-ingest hint, and fit-time seeding falls back to the streaming
# conductance pass.
# v3: ingest-baked neighborhood-closure gather lists
# (shard_*.closure.npy + per-entry "closure" crc) — the per-shard-pair
# touched-row ids the 2D edge-block partition exchanges instead of a full
# F all_gather. Same migration contract: v1/v2 caches still LOAD; only
# load_closure_lists refuses on them (re-ingest hint), and the 2D
# trainers fall back to streaming the lists from the host's own CSR.
MANIFEST_VERSION = 3
SUPPORTED_MANIFEST_VERSIONS = (1, 2, 3)
MANIFEST_NAME = "manifest.json"
QUARANTINE_DIR = "quarantine"

# The EXACT seed-bake triangle pass expands sum_v deg(v)^2 two-hop entries
# — edge-quadratic on hubs, infeasible at the graph scale the store
# targets. Past this many entries an uncapped ingest
# SKIPS the bake with a --seed-cap hint instead of silently walling for
# hours (~a few minutes of vectorized sweep at the threshold).
SEED_BAKE_EXACT_MAX_WORK = 2e10


class ShardCorruption(ValueError):
    """A cache blob failed its manifest crc32 (or rebuild could not
    reproduce it). Carries the shard index when the blob belongs to one,
    so the self-heal path knows what to quarantine."""

    def __init__(self, msg: str, shard: Optional[int] = None):
        super().__init__(msg)
        self.shard = shard


def rows_of_raw_ids(values: np.ndarray, order: np.ndarray,
                    raw_sorted: np.ndarray):
    """Internal rows of raw node ids via the sorted raw-id table: the
    ONE remap used by the quarantine rebuild, the delta re-ingest, and
    the refit's touched-row discovery (models.refit) — the unknown-id
    clamp must never diverge between them. Returns (rows, known) with
    `rows` valid only where `known`; callers decide how an unknown id
    errors (source-changed vs delta-cannot-grow-N)."""
    pos = np.searchsorted(raw_sorted, values)
    clamped = np.minimum(pos, raw_sorted.size - 1)
    known = raw_sorted[clamped] == values
    return order[clamped], known


def is_cache_dir(path: str) -> bool:
    """True when `path` is a graph-cache directory (has a manifest)."""
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, MANIFEST_NAME)
    )


def _crc32_file(path: str, bufsize: int = 1 << 22) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            buf = f.read(bufsize)
            if not buf:
                return crc
            crc = zlib.crc32(buf, crc)


def _shard_files(s: int) -> Tuple[str, str]:
    return f"shard_{s:05d}.indptr.npy", f"shard_{s:05d}.indices.npy"


@dataclasses.dataclass(frozen=True)
class HostShard:
    """The node-contiguous slice of a cached graph one host loads.

    ``indptr`` is rebased to 0 at ``lo`` (length hi - lo + 1); ``indices``
    keep GLOBAL destination ids, so device code slices F rows without any
    further translation. ``shard_edge_counts`` covers ALL shards (from the
    manifest), letting every host agree on padded edge-block geometry
    without touching another host's files — ``files_read`` records exactly
    which blobs were opened, so tests can pin the isolation contract.
    """

    lo: int
    hi: int
    indptr: np.ndarray
    indices: np.ndarray
    num_nodes: int
    num_directed_edges: int
    rows_per_shard: int
    shard_ids: Tuple[int, ...]
    shard_edge_counts: Tuple[int, ...]
    files_read: Tuple[str, ...]

    @property
    def num_local_nodes(self) -> int:
        return self.hi - self.lo


@dataclasses.dataclass(frozen=True)
class ShardSeedScores:
    """A node-contiguous slice of the ingest-baked per-node seed scores
    (ego-net conductance phi, float64). Same files_read isolation contract
    as HostShard: a host reads exactly the phi blobs of its own shards.
    `cap`/`seed` echo the bake's estimator parameters so fit-time callers
    can check they match the run's seeding config before trusting the
    scores (cli._init_F falls back to the streaming pass on mismatch)."""

    lo: int
    hi: int
    phi: np.ndarray
    cap: Optional[int]
    seed: Optional[int]
    files_read: Tuple[str, ...]

    def matches(self, cap: Optional[int], seed: int) -> bool:
        """True when the baked estimator agrees with a fit that would
        stream with `seeding_degree_cap=cap, seed=seed` (the stream seed
        only matters once a cap engages the sampler)."""
        return self.cap == cap and (cap is None or self.seed == seed)


@dataclasses.dataclass(frozen=True)
class ShardClosure:
    """One shard's baked neighborhood-closure gather lists (the 2D partition's).

    Per peer shard b (== a 2D trainer node block when num_shards == R*C):

      * ``out_ids[b]``   — sorted unique GLOBAL dst ids this shard's edges
        touch inside b: the rows this shard must GATHER from b's owner.
      * ``in_ids[b]``    — sorted unique GLOBAL row ids of THIS shard that
        have >= 1 edge into b: the rows this shard must SEND to b's owner.
        By edge symmetry in_ids(s)[b] == out_ids(b)[s] — each side of an
        exchange derives its half from its OWN blob, which is what keeps
        the per-host files_read isolation contract intact.
      * ``edge_counts[b]`` — directed edges from this shard into b, so
        every host agrees on padded 2D edge-block geometry manifest-only.

    A ``None`` list is the capped-buffer overflow sentinel (the bake's
    per-pair cap was exceeded): consumers degrade that pair to the full
    dst block — correctness is never cap-dependent, only bytes."""

    out_ids: Tuple[Optional[np.ndarray], ...]
    in_ids: Tuple[Optional[np.ndarray], ...]
    edge_counts: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class ShardClosureLists:
    """Closure lists for a host's shard range, same files_read isolation
    contract as HostShard: exactly the owned shards' closure blobs are
    opened. ``cap`` echoes the bake's per-pair cap (0 = uncapped)."""

    shards: Dict[int, "ShardClosure"]
    cap: int
    files_read: Tuple[str, ...]


class GraphStore:
    """Handle on a compiled cache directory (validated manifest).

    With ``self_heal=True`` (shard quarantine + re-ingest) a
    crc32-failed SHARD blob is moved to ``quarantine/``, rebuilt from the
    source edge list for just its node range (``rebuild_shard``), the
    manifest re-stamped, and the load retried — a pod run degrades and
    heals instead of dying. Default False: library opens keep the strict
    reject-on-mismatch contract; the CLI turns healing on.
    """

    def __init__(self, directory: str, manifest: dict,
                 self_heal: bool = False):
        self.directory = directory
        self.manifest = manifest
        self.self_heal = self_heal

    @classmethod
    def open(cls, directory: str, self_heal: bool = False) -> "GraphStore":
        mpath = os.path.join(directory, MANIFEST_NAME)
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise ValueError(f"{directory}: not a graph cache ({e})") from e
        version = manifest.get("format_version")
        if version not in SUPPORTED_MANIFEST_VERSIONS:
            raise ValueError(
                f"{directory}: cache format version {version!r} not in "
                f"{SUPPORTED_MANIFEST_VERSIONS} (stale cache; re-run "
                "`python -m bigclam_tpu_torch.cli ingest`)"
            )
        for key in ("num_nodes", "num_directed_edges", "num_shards",
                    "rows_per_shard", "shards", "files"):
            if key not in manifest:
                raise ValueError(f"{directory}: manifest missing {key!r}")
        if len(manifest["shards"]) != manifest["num_shards"]:
            raise ValueError(
                f"{directory}: shard table has {len(manifest['shards'])} "
                f"entries for num_shards={manifest['num_shards']}"
            )
        return cls(directory, manifest, self_heal=self_heal)

    # --- manifest accessors ---
    @property
    def num_nodes(self) -> int:
        return int(self.manifest["num_nodes"])

    @property
    def num_directed_edges(self) -> int:
        return int(self.manifest["num_directed_edges"])

    @property
    def num_shards(self) -> int:
        return int(self.manifest["num_shards"])

    @property
    def rows_per_shard(self) -> int:
        return int(self.manifest["rows_per_shard"])

    @property
    def balanced(self) -> bool:
        return bool(self.manifest.get("balanced", False))

    @property
    def delta_seq(self) -> int:
        """How many edge deltas have been applied since compile: 0 on a freshly compiled cache, bumped by every
        ``apply_delta``. Part of the cache's workload identity — two
        caches at different delta_seq hold different graphs."""
        return int(self.manifest.get("delta_seq", 0))

    def shard_files(self, s: int) -> Tuple[str, str]:
        """Absolute (indptr, indices) blob paths of shard s."""
        entry = self.manifest["shards"][s]
        return (
            os.path.join(self.directory, entry["indptr"]),
            os.path.join(self.directory, entry["indices"]),
        )

    def node_range(self, s: int) -> Tuple[int, int]:
        entry = self.manifest["shards"][s]
        return int(entry["lo"]), int(entry["hi"])

    def node_ranges(self) -> List[Tuple[int, int]]:
        """[(lo, hi)] of every cache shard, manifest order — the
        manifest-driven range map the serving fleet's publication and
        routing table derive from."""
        return [self.node_range(s) for s in range(self.num_shards)]

    def host_ranges(self, num_hosts: int) -> List[Tuple[int, int]]:
        """Node ranges of an even `num_hosts` split of the cache shards
        (load_shard geometry: num_shards % num_hosts == 0) — the row
        ranges `cli fit --publish-shards` publishes one fleet shard
        archive per."""
        S = self.num_shards
        if num_hosts <= 0 or S % num_hosts != 0:
            raise ValueError(
                f"num_shards={S} not divisible by num_hosts={num_hosts}"
            )
        per = S // num_hosts
        return [
            (
                self.node_range(h * per)[0],
                self.node_range((h + 1) * per - 1)[1],
            )
            for h in range(num_hosts)
        ]

    # --- loading ---
    def _load_blob(
        self,
        relname: str,
        crc: Optional[int],
        verify: bool,
        mmap: bool,
        files_read: List[str],
        shard: Optional[int] = None,
    ) -> np.ndarray:
        path = os.path.join(self.directory, relname)
        if verify:
            got = _crc32_file(path)
            if got != crc:
                raise ShardCorruption(
                    f"{path}: checksum mismatch (expected {crc}, got {got}) "
                    "— cache corrupted; re-run ingest",
                    shard=shard,
                )
        files_read.append(relname)
        return np.load(path, mmap_mode="r" if mmap else None)

    def _load_shard_blobs(
        self, s: int, verify: bool, mmap: bool, files_read: List[str]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One shard's (indptr, indices), crc-checked; the self-heal path
        quarantines+rebuilds on a checksum failure and retries ONCE (a
        rebuild that still mismatches propagates — the source is bad)."""
        entry = self.manifest["shards"][s]
        # fault-injection site (resilience.faults): corrupt this shard's
        # indices blob just before the crc check
        from bigclam_tpu_torch.resilience import faults as _faults

        spec = _faults.maybe_fire("store.load_shard", shard=s)
        if spec is not None and spec["kind"] == "corrupt_shard":
            _faults.apply_file_fault(
                spec, os.path.join(self.directory, entry["indices"])
            )
        try:
            return self._read_shard_blobs(s, entry, verify, mmap, files_read)
        except ShardCorruption as e:
            if not self.self_heal:
                raise
            self.quarantine_and_rebuild(s, reason=str(e))
            entry = self.manifest["shards"][s]    # crc may be re-stamped
            return self._read_shard_blobs(s, entry, verify, mmap, files_read)

    def _read_shard_blobs(self, s, entry, verify, mmap, files_read):
        ip = self._load_blob(
            entry["indptr"], entry["crc32"]["indptr"], verify, mmap,
            files_read, shard=s,
        ).astype(np.int64, copy=False)
        dp = self._load_blob(
            entry["indices"], entry["crc32"]["indices"], verify, mmap,
            files_read, shard=s,
        )
        return ip, dp

    def workload(self) -> Dict:
        """Manifest-only workload numbers for the capacity
        preflight (`cli preflight` / obs.memory.preflight): sizes, the
        shard geometry, and the per-shard directed-edge counts — read
        without touching any blob, so the answer costs one JSON parse
        even for a billion-edge cache."""
        return {
            "n": self.num_nodes,
            "directed_edges": self.num_directed_edges,
            "num_shards": self.num_shards,
            "rows_per_shard": self.rows_per_shard,
            "balanced": self.balanced,
            "shard_edge_counts": [
                int(e["edges"]) for e in self.manifest["shards"]
            ],
            # 2D-partition closure summary: per-pair touched-row
            # counts straight off the manifest so `cli preflight` prices
            # the closure exchange exactly (-1 = capped-overflow pair ->
            # consumers degrade it to the full dst block).
            "closure": (
                {
                    "baked": True,
                    "cap": int(
                        self.manifest.get("closure", {}).get("cap", 0)
                    ),
                    "pair_counts": [
                        [int(c) for c in e["closure"]["out_counts"]]
                        for e in self.manifest["shards"]
                    ],
                }
                if all("closure" in e for e in self.manifest["shards"])
                else {"baked": False}
            ),
        }

    def load_shard_range(
        self,
        first_shard: int,
        last_shard: int,
        verify: bool = True,
        mmap: bool = False,
    ) -> HostShard:
        """Assemble shards [first_shard, last_shard) into one contiguous
        HostShard, reading ONLY those shards' blobs."""
        S = self.num_shards
        if not (0 <= first_shard < last_shard <= S):
            raise ValueError(
                f"shard range [{first_shard}, {last_shard}) outside [0, {S})"
            )
        files_read: List[str] = []
        entries = self.manifest["shards"][first_shard:last_shard]
        iparts, dparts = [], []
        for off in range(first_shard, last_shard):
            ip, dp = self._load_shard_blobs(off, verify, mmap, files_read)
            iparts.append(ip)
            dparts.append(dp)
        lo = int(entries[0]["lo"])
        hi = int(entries[-1]["hi"])
        indptr = np.zeros(hi - lo + 1, dtype=np.int64)
        offset = 0
        row = 0
        for part in iparts:
            rows = part.shape[0] - 1
            indptr[row : row + rows + 1] = part + offset
            offset = int(indptr[row + rows])
            row += rows
        indices = (
            np.concatenate(dparts)
            if len(dparts) > 1
            else np.asarray(dparts[0])
        ).astype(np.int32, copy=False)
        if indptr[-1] != indices.shape[0]:
            raise ValueError(
                f"{self.directory}: shard range [{first_shard}, "
                f"{last_shard}) indptr/indices length mismatch "
                f"({int(indptr[-1])} vs {indices.shape[0]})"
            )
        return HostShard(
            lo=lo,
            hi=hi,
            indptr=indptr,
            indices=indices,
            num_nodes=self.num_nodes,
            num_directed_edges=self.num_directed_edges,
            rows_per_shard=self.rows_per_shard,
            shard_ids=tuple(range(first_shard, last_shard)),
            shard_edge_counts=tuple(
                int(e["edges"]) for e in self.manifest["shards"]
            ),
            files_read=tuple(files_read),
        )

    def load_shard(
        self, host_id: int, num_hosts: int, verify: bool = True
    ) -> HostShard:
        """The node-contiguous shard slice host `host_id` of `num_hosts`
        owns (requires num_shards % num_hosts == 0 — compile the cache with
        one shard per node-shard of the target mesh)."""
        S = self.num_shards
        if num_hosts <= 0 or S % num_hosts != 0:
            raise ValueError(
                f"num_shards={S} not divisible by num_hosts={num_hosts}"
            )
        if not (0 <= host_id < num_hosts):
            raise ValueError(f"host_id={host_id} outside [0, {num_hosts})")
        per = S // num_hosts
        return self.load_shard_range(
            host_id * per, (host_id + 1) * per, verify=verify
        )

    def load_seed_scores(
        self,
        first_shard: int = 0,
        last_shard: Optional[int] = None,
        verify: bool = True,
    ) -> ShardSeedScores:
        """The ingest-baked per-node conductance scores of shards
        [first_shard, last_shard), reading ONLY those shards' phi blobs.

        Raises ValueError with a re-ingest hint on caches compiled before
        the seed bake existed (format v1) or with the bake disabled —
        callers (cli seeding) degrade to the streaming conductance pass."""
        S = self.num_shards
        last = S if last_shard is None else last_shard
        if not (0 <= first_shard < last <= S):
            raise ValueError(
                f"shard range [{first_shard}, {last}) outside [0, {S})"
            )
        entries = self.manifest["shards"][first_shard:last]
        if any("phi" not in e for e in entries):
            raise ValueError(
                f"{self.directory}: cache has no baked seed scores "
                "(compiled before format v2, or with the seed bake "
                "disabled) — re-ingest to bake seeds "
                "(`python -m bigclam_tpu_torch.cli ingest`), or use a "
                "streaming --seed-backend"
            )
        files_read: List[str] = []
        parts = [
            np.asarray(
                self._load_blob(
                    e["phi"], e["crc32"].get("phi"), verify, False,
                    files_read, shard=first_shard + i,
                ),
                np.float64,
            )
            for i, e in enumerate(entries)
        ]
        meta = self.manifest.get("seed_scores", {})
        return ShardSeedScores(
            lo=int(entries[0]["lo"]),
            hi=int(entries[-1]["hi"]),
            phi=np.concatenate(parts) if len(parts) > 1 else parts[0],
            cap=meta.get("cap"),
            seed=meta.get("seed"),
            files_read=tuple(files_read),
        )

    def load_closure_lists(
        self,
        first_shard: int = 0,
        last_shard: Optional[int] = None,
        verify: bool = True,
    ) -> ShardClosureLists:
        """The ingest-baked neighborhood-closure gather lists of shards
        [first_shard, last_shard), reading ONLY those shards' closure
        blobs (the 2D partition's per-host exchange sets).

        Raises ValueError with a re-ingest hint on caches compiled before
        format v3 or with the closure bake disabled — the 2D trainers
        degrade to streaming the lists from the host's own CSR instead."""
        S = self.num_shards
        last = S if last_shard is None else last_shard
        if not (0 <= first_shard < last <= S):
            raise ValueError(
                f"shard range [{first_shard}, {last}) outside [0, {S})"
            )
        entries = self.manifest["shards"][first_shard:last]
        if any("closure" not in e for e in entries):
            raise ValueError(
                f"{self.directory}: cache has no baked closure gather "
                "lists (compiled before format v3, or with the closure "
                "bake disabled) — re-ingest to bake closures "
                "(`python -m bigclam_tpu_torch.cli ingest`); the 2D trainers "
                "fall back to streaming the lists from the cached CSR"
            )
        files_read: List[str] = []
        cap = int(self.manifest.get("closure", {}).get("cap", 0))
        shards: Dict[int, ShardClosure] = {}
        for i, e in enumerate(entries):
            meta = e["closure"]
            ids = np.asarray(
                self._load_blob(
                    meta["ids"], e["crc32"].get("closure"), verify, False,
                    files_read, shard=first_shard + i,
                ),
                np.int32,
            )
            out_counts = np.asarray(meta["out_counts"], dtype=np.int64)
            in_counts = np.asarray(meta["in_counts"], dtype=np.int64)
            lens = np.concatenate(
                [np.maximum(out_counts, 0), np.maximum(in_counts, 0)]
            )
            if int(lens.sum()) != ids.shape[0]:
                raise ShardCorruption(
                    f"{self.directory}: shard {first_shard + i} closure "
                    f"blob holds {ids.shape[0]} ids, manifest counts sum "
                    f"to {int(lens.sum())} — cache corrupted; re-run "
                    "ingest",
                    shard=first_shard + i,
                )
            bounds = np.concatenate([[0], np.cumsum(lens)])
            parts = [
                ids[bounds[j]:bounds[j + 1]] for j in range(lens.size)
            ]
            shards[first_shard + i] = ShardClosure(
                out_ids=tuple(
                    None if c < 0 else parts[b]
                    for b, c in enumerate(out_counts)
                ),
                in_ids=tuple(
                    None if c < 0 else parts[S + b]
                    for b, c in enumerate(in_counts)
                ),
                edge_counts=tuple(int(c) for c in meta["edge_counts"]),
            )
        return ShardClosureLists(
            shards=shards, cap=cap, files_read=tuple(files_read)
        )

    def load_raw_ids(self, verify: bool = True) -> np.ndarray:
        entry = self.manifest["files"]["raw_ids"]
        return np.asarray(
            self._load_blob(entry["name"], entry["crc32"], verify, False, [])
        )

    def load_perm(self, verify: bool = True) -> Optional[np.ndarray]:
        """The baked-in balance permutation (old id -> new id), or None for
        unbalanced caches."""
        entry = self.manifest["files"].get("perm")
        if entry is None:
            return None
        return np.asarray(
            self._load_blob(entry["name"], entry["crc32"], verify, False, [])
        )

    def load_graph(self, verify: bool = True, mmap: bool = True) -> Graph:
        """Assemble the full Graph from every shard (the fast single-host
        reload path: binary blobs, optionally mmap-read — no text parse,
        no remap, no dedup)."""
        import time

        t0 = time.perf_counter()
        hs = self.load_shard_range(0, self.num_shards, verify=verify,
                                   mmap=mmap)
        g = Graph(
            indptr=hs.indptr,
            indices=np.ascontiguousarray(hs.indices),
            raw_ids=self.load_raw_ids(verify=verify),
        )
        from bigclam_tpu_torch.obs import telemetry as _obs

        tel = _obs.current()
        if tel is not None:
            tel.event(
                "graph_load",
                source="cache",
                path=self.directory,
                nodes=self.num_nodes,
                directed_edges=self.num_directed_edges,
                seconds=round(time.perf_counter() - t0, 4),
                mmap=bool(mmap),
            )
        return g

    # --- quarantine + re-ingest ---
    def quarantine_and_rebuild(self, s: int, reason: str = "") -> None:
        """Rebuild shard `s` from the source edge list for just its node
        range, move the corrupt blobs to quarantine/, and re-stamp the
        manifest. The rebuild runs FIRST (_rebuild_shard_arrays): when it
        is impossible (source missing / changed / raw-id table corrupt)
        the ShardCorruption propagates with the cache left exactly as
        found — still diagnosable by its checksum error, never stripped
        of files the manifest references. Emits one `quarantine`
        telemetry event on success."""
        entry = self.manifest["shards"][s]
        local_indptr, indices = self._rebuild_shard_arrays(s)
        qdir = os.path.join(self.directory, QUARANTINE_DIR)
        os.makedirs(qdir, exist_ok=True)
        moved = []
        for rel in (entry["indptr"], entry["indices"]):
            src = os.path.join(self.directory, rel)
            if os.path.exists(src):
                dst = os.path.join(qdir, rel)
                n = 0
                while os.path.exists(dst):      # keep every incident
                    n += 1
                    dst = os.path.join(qdir, f"{rel}.{n}")
                os.replace(src, dst)
                moved.append(os.path.basename(dst))
        restamped = self._write_shard_blobs(s, local_indptr, indices)
        print(
            f"warning: shard {s} of {self.directory} quarantined and "
            f"rebuilt from source ({reason or 'checksum mismatch'})",
            file=sys.stderr,
        )
        from bigclam_tpu_torch.obs import telemetry as _obs

        tel = _obs.current()
        if tel is not None:
            tel.event(
                "quarantine",
                shard=s,
                reason=reason[:200],
                quarantined=moved,
                crc_restamped=restamped,
                cache_dir=self.directory,
            )

    def rebuild_shard(self, s: int) -> bool:
        """Re-ingest shard `s` alone and write fresh blobs in place.
        Returns True when the manifest crc had to be re-stamped (a
        byte-identical rebuild leaves it untouched)."""
        local_indptr, indices = self._rebuild_shard_arrays(s)
        return self._write_shard_blobs(s, local_indptr, indices)

    def _raw_id_order(self):
        """(order, raw_sorted) of the cache's raw-id table — the raw ->
        internal-row translation every range-scoped edge source shares
        (covers balanced caches: raw_ids.npy is in FINAL node order)."""
        raw_final = self.load_raw_ids(verify=True)   # corrupt table: raise
        order = np.argsort(raw_final, kind="stable")
        return order, raw_final[order]

    def _mapped_range_pairs(
        self,
        path: str,
        lo: int,
        hi: int,
        order: np.ndarray,
        raw_sorted: np.ndarray,
        shard: Optional[int] = None,
        what: str = "source",
    ) -> np.ndarray:
        """RANGE-SCOPED edge source: stream ONE edge
        file and return the directed internal pairs whose source row
        falls in [lo, hi) — raw ids remapped through the cache's table,
        self-loops dropped, symmetrized. Shared by the quarantine rebuild
        (source + every recorded delta file) and apply_delta's touched-
        row discovery; unknown raw ids refuse with a re-ingest hint (the
        file changed since it was ingested)."""
        parts: List[np.ndarray] = []
        for pairs in stream_edge_list(path, DEFAULT_CHUNK_BYTES):
            if pairs.size == 0:
                continue
            mapped, known = rows_of_raw_ids(pairs, order, raw_sorted)
            if not known.all():
                raise ShardCorruption(
                    f"{path}: contains node ids absent from the cache's "
                    f"raw-id table — {what} changed since ingest; re-run "
                    "ingest",
                    shard=shard,
                )
            mapped = mapped[mapped[:, 0] != mapped[:, 1]]
            both = np.concatenate([mapped, mapped[:, ::-1]], axis=0)
            keep = both[(both[:, 0] >= lo) & (both[:, 0] < hi)]
            if keep.size:
                parts.append(keep)
        return (
            np.concatenate(parts, axis=0)
            if parts
            else np.empty((0, 2), dtype=np.int64)
        )

    def _delta_entries(self) -> List[dict]:
        """Manifest records of every applied delta: the
        quarantine rebuild must replay them on top of the source, and
        each is verified against its recorded size first (a delta file
        that changed since apply cannot reproduce the cache)."""
        return list(self.manifest.get("deltas", []))

    def _rebuild_shard_arrays(self, s: int):
        """Re-ingest shard `s` IN MEMORY: stream the source edge list
        PLUS every recorded delta file through the range-scoped edge
        source (_mapped_range_pairs), dedup, and validate against the
        manifest's edge count. Touches no cache files, so callers can
        sequence it before any destructive step."""
        entry = self.manifest["shards"][s]
        source = self.manifest.get("source", {}).get("path")
        if not source or not os.path.exists(source):
            raise ShardCorruption(
                f"{self.directory}: shard {s} corrupt and the source edge "
                f"list is unavailable ({source!r}) — cannot rebuild; "
                "re-run ingest",
                shard=s,
            )
        order, raw_sorted = self._raw_id_order()
        lo, hi = int(entry["lo"]), int(entry["hi"])
        parts = [
            self._mapped_range_pairs(
                source, lo, hi, order, raw_sorted, shard=s
            )
        ]
        for d in self._delta_entries():
            dpath = d.get("path")
            if not dpath or not os.path.exists(dpath):
                raise ShardCorruption(
                    f"{self.directory}: shard {s} rebuild needs applied "
                    f"delta file {dpath!r}, which is unavailable — "
                    "re-run ingest",
                    shard=s,
                )
            if "bytes" in d and os.path.getsize(dpath) != int(d["bytes"]):
                raise ShardCorruption(
                    f"{dpath}: size changed since it was applied "
                    f"({os.path.getsize(dpath)} vs {d['bytes']} bytes) — "
                    "delta file changed; re-run ingest",
                    shard=s,
                )
            parts.append(
                self._mapped_range_pairs(
                    dpath, lo, hi, order, raw_sorted, shard=s,
                    what="applied delta",
                )
            )
        both = np.concatenate([p for p in parts if p.size], axis=0) if any(
            p.size for p in parts
        ) else np.empty((0, 2), dtype=np.int64)
        src, dst = dedup_directed(both)
        local_indptr = np.zeros(hi - lo + 1, dtype=np.int64)
        if src.size:
            np.cumsum(
                np.bincount(src - lo, minlength=hi - lo),
                out=local_indptr[1:],
            )
        indices = dst.astype(np.int32)
        if int(indices.shape[0]) != int(entry["edges"]):
            raise ShardCorruption(
                f"{self.directory}: shard {s} rebuild produced "
                f"{indices.shape[0]} directed edges, manifest says "
                f"{entry['edges']} — source changed since ingest; re-run "
                "ingest",
                shard=s,
            )
        return local_indptr, indices

    def _write_shard_blobs(
        self, s: int, local_indptr: np.ndarray, indices: np.ndarray
    ) -> bool:
        """Atomically install rebuilt blobs for shard `s` and re-stamp
        the manifest crc when the bytes differ; True iff re-stamped."""
        entry = self.manifest["shards"][s]
        for rel, arr in ((entry["indptr"], local_indptr),
                         (entry["indices"], indices)):
            path = os.path.join(self.directory, rel)
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        new_crc = {
            # start from the existing stamps: a shard rebuild must not strip
            # the phi blob's crc (the seed scores are untouched by it)
            **entry["crc32"],
            "indptr": _crc32_file(
                os.path.join(self.directory, entry["indptr"])
            ),
            "indices": _crc32_file(
                os.path.join(self.directory, entry["indices"])
            ),
        }
        restamped = new_crc != entry["crc32"]
        if restamped:
            entry["crc32"] = new_crc
            _atomic_json(
                os.path.join(self.directory, MANIFEST_NAME), self.manifest
            )
        return restamped

    # ------------------------------ incremental edge deltas
    def _shard_pairs_from_blobs(
        self, s: int, files_read: List[str]
    ) -> np.ndarray:
        """Shard `s`'s directed pairs from its OWN blobs — the O(shard)
        half of a delta merge (the quarantine path re-streams the full
        source; a delta rebuild must not). crc-verified; self-heal
        quarantines + retries once like any load."""
        entry = self.manifest["shards"][s]
        try:
            ip, dx = self._read_shard_blobs(
                s, entry, True, False, files_read
            )
        except ShardCorruption as e:
            if not self.self_heal:
                raise
            self.quarantine_and_rebuild(s, reason=str(e))
            entry = self.manifest["shards"][s]
            ip, dx = self._read_shard_blobs(
                s, entry, True, False, files_read
            )
        lo = int(entry["lo"])
        src = lo + np.repeat(
            np.arange(ip.shape[0] - 1, dtype=np.int64), np.diff(ip)
        )
        return np.stack([src, dx.astype(np.int64)], axis=1)

    def apply_delta(
        self,
        delta_path: str,
        seed_rebake: bool = True,
        profile=None,
    ) -> Dict:
        """Append an edge file to this cache by rebuilding ONLY the
        touched node ranges (the delta re-ingest).

        The delta is parsed once (it is small), mapped through the raw-id
        table, and scattered to the shards owning its endpoints; each
        touched shard is rebuilt as existing-blob pairs + delta pairs ->
        dedup -> fresh blobs (O(shard + delta), never O(source text) —
        the range-scoped edge source satellite). Untouched shard blobs
        are left BYTE-IDENTICAL. The manifest bumps `delta_seq`, records
        the delta file (so quarantine rebuilds replay it), re-stamps the
        touched shards' crcs and edge counts, and — when seed scores are
        baked — re-bakes phi for the touched shards only (their
        conductance sees the updated graph exactly; untouched shards
        keep their pre-delta phi blobs, a documented staleness).

        New NODES refuse with a re-ingest hint: the shard geometry is
        sized to N at compile time, and growing N re-shards everything —
        that is a full `cli ingest`, not a delta.

        Returns the delta report: edges_added (directed), touched shard
        ids, touched internal rows, touched_frac, files_read (the
        isolation contract — only touched shards' blobs are opened), and
        seconds. A crash mid-apply leaves crc mismatches the self-heal
        path repairs back to the PRE-delta cache (the manifest — written
        last — still describes it), after which the delta can simply be
        re-applied."""
        import time

        t0 = time.perf_counter()
        if not os.path.exists(delta_path):
            raise ValueError(f"{delta_path}: no such delta edge file")
        files_read: List[str] = ["raw_ids.npy"]
        order, raw_sorted = self._raw_id_order()
        n = self.num_nodes
        rows = self.rows_per_shard
        # parse ONCE, raw -> internal, loops dropped, symmetrized
        raw_pairs = 0
        parts: List[np.ndarray] = []
        for pairs in stream_edge_list(delta_path, DEFAULT_CHUNK_BYTES):
            if pairs.size == 0:
                continue
            raw_pairs += int(pairs.shape[0])
            mapped, known = rows_of_raw_ids(pairs, order, raw_sorted)
            if not known.all():
                bad = pairs[~known.all(axis=1)][:3].tolist()
                raise ValueError(
                    f"{delta_path}: contains node ids absent from the "
                    f"cache (e.g. {bad}) — deltas cannot grow N (the "
                    "shard geometry is sized at compile time); re-run "
                    "`cli ingest` on the merged edge list"
                )
            mapped = mapped[mapped[:, 0] != mapped[:, 1]]
            if mapped.size:
                parts.append(
                    np.concatenate([mapped, mapped[:, ::-1]], axis=0)
                )
        both = (
            np.concatenate(parts, axis=0)
            if parts
            else np.empty((0, 2), dtype=np.int64)
        )
        if both.size == 0:
            # nothing to merge (empty file / self-loops only): a pure
            # no-op — recording it would make the quarantine rebuild
            # depend on a file that contributes nothing
            return {
                "delta_path": os.path.abspath(delta_path),
                "delta_seq": self.delta_seq,
                "raw_pairs": raw_pairs,
                "edges_added": 0,
                "num_directed_edges": self.num_directed_edges,
                "touched_shards": [],
                "touched_rows": np.empty(0, dtype=np.int64),
                "touched_frac": 0.0,
                "phi_rebaked_shards": [],
                "closure_rebaked_shards": [],
                "files_read": tuple(files_read),
                "seconds": round(time.perf_counter() - t0, 4),
            }
        touched_rows = np.unique(both[:, 0])
        touched_shards = sorted(
            {int(r // rows) for r in touched_rows.tolist()}
        )
        old_total = self.num_directed_edges
        # merge each touched shard: existing blob pairs + delta pairs
        for s in touched_shards:
            entry = self.manifest["shards"][s]
            lo, hi = int(entry["lo"]), int(entry["hi"])
            add = both[(both[:, 0] >= lo) & (both[:, 0] < hi)]
            existing = self._shard_pairs_from_blobs(s, files_read)
            src, dst = dedup_directed(
                np.concatenate([existing, add], axis=0)
            )
            local_indptr = np.zeros(hi - lo + 1, dtype=np.int64)
            if src.size:
                np.cumsum(
                    np.bincount(src - lo, minlength=hi - lo),
                    out=local_indptr[1:],
                )
            indices = dst.astype(np.int32)
            # write fresh blobs atomically but stamp the MANIFEST only
            # once at the end: a crash mid-apply then reads as crc
            # mismatches against the old manifest, and the self-heal
            # rebuild (source + previously recorded deltas) restores the
            # pre-delta cache instead of a half-applied one
            for rel, arr in ((entry["indptr"], local_indptr),
                             (entry["indices"], indices)):
                path = os.path.join(self.directory, rel)
                tmp = f"{path}.{os.getpid()}.tmp"
                with open(tmp, "wb") as f:
                    np.save(f, arr)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, path)
            entry["edges"] = int(indices.shape[0])
            entry["crc32"] = {
                **entry["crc32"],
                "indptr": _crc32_file(
                    os.path.join(self.directory, entry["indptr"])
                ),
                "indices": _crc32_file(
                    os.path.join(self.directory, entry["indices"])
                ),
            }
            if profile is not None:
                profile.sample_rss()
        new_total = sum(
            int(e["edges"]) for e in self.manifest["shards"]
        )
        self.manifest["num_directed_edges"] = new_total
        self.manifest["num_undirected_edges"] = new_total // 2
        seq = self.delta_seq + 1
        self.manifest["delta_seq"] = seq
        self.manifest.setdefault("deltas", []).append({
            "path": os.path.abspath(delta_path),
            "bytes": os.path.getsize(delta_path),
            "raw_pairs": raw_pairs,
            "seq": seq,
            "touched_shards": touched_shards,
        })
        # touched-shard phi re-bake: exact conductance on the UPDATED
        # graph for touched rows (degrees re-read from every indptr blob
        # — O(N) ints; the pair sweep reads neighbor shards' indices, so
        # the strict only-touched files_read contract applies to caches
        # without baked seeds)
        rebaked: List[int] = []
        if (
            seed_rebake
            and touched_shards
            and self.manifest.get("seed_scores", {}).get("baked")
        ):
            meta = self.manifest["seed_scores"]
            deg_final = np.zeros(max(n, 1), dtype=np.int64)
            for e in self.manifest["shards"]:
                lo, hi = int(e["lo"]), int(e["hi"])
                if hi <= lo:
                    continue
                ip = np.load(os.path.join(self.directory, e["indptr"]))
                deg_final[lo:hi] = np.diff(ip)
            bake_seed_scores(
                self.directory, self.manifest["shards"], deg_final[:n],
                new_total, cap=meta.get("cap"), seed=meta.get("seed") or 0,
                profile=profile, only_shards=set(touched_shards),
            )
            rebaked = touched_shards
        # touched-shard closure re-bake: EXACT (a shard's closure depends
        # only on its own edge lists, and deltas symmetrize, so every
        # shard whose lists changed is in touched_shards)
        closure_rebaked: List[int] = []
        if touched_shards and self.manifest.get("closure", {}).get("baked"):
            bake_closure_lists(
                self.directory, self.manifest["shards"],
                self.rows_per_shard,
                cap=int(self.manifest["closure"].get("cap", 0)),
                profile=profile, only_shards=set(touched_shards),
            )
            closure_rebaked = touched_shards
        _atomic_json(
            os.path.join(self.directory, MANIFEST_NAME), self.manifest
        )
        seconds = time.perf_counter() - t0
        out = {
            "delta_path": os.path.abspath(delta_path),
            "delta_seq": seq,
            "raw_pairs": raw_pairs,
            "edges_added": new_total - old_total,
            "num_directed_edges": new_total,
            "touched_shards": touched_shards,
            "touched_rows": touched_rows,
            "touched_frac": (
                round(touched_rows.size / n, 6) if n else 0.0
            ),
            "phi_rebaked_shards": rebaked,
            "closure_rebaked_shards": closure_rebaked,
            "files_read": tuple(files_read),
            "seconds": round(seconds, 4),
        }
        from bigclam_tpu_torch.obs import telemetry as _obs

        tel = _obs.current()
        if tel is not None:
            tel.event(
                "delta_ingest",
                edges_added=int(out["edges_added"]),
                touched_shards=len(touched_shards),
                shards=touched_shards,
                touched_rows=int(touched_rows.size),
                touched_frac=out["touched_frac"],
                delta_seq=seq,
                phi_rebaked=len(rebaked),
                cache_dir=self.directory,
                seconds=out["seconds"],
            )
        return out


# --------------------------------------------------------------------------
# ingest-time seed bake: conductance scores next to the shards
# --------------------------------------------------------------------------


def _phi_name(s: int) -> str:
    return f"shard_{s:05d}.phi.npy"


def _gather_rows(indptr_b: np.ndarray, data_b: np.ndarray, rows: np.ndarray):
    """Concatenate CSR rows `rows` of (indptr_b, data_b) — the two-hop
    expansion of the shard-pair sweeps. Returns (values, counts)."""
    starts = indptr_b[rows]
    cnts = indptr_b[rows + 1] - starts
    total = int(cnts.sum())
    if total == 0:
        return data_b[:0], cnts
    take = np.repeat(starts, cnts) + (
        np.arange(total, dtype=np.int64)
        - np.repeat(np.concatenate([[0], np.cumsum(cnts[:-1])]), cnts)
    )
    return data_b[take], cnts


def bake_seed_scores(
    cache_dir: str,
    shard_table: List[dict],
    deg_final: np.ndarray,
    num_directed_edges: int,
    cap: Optional[int] = None,
    seed: int = 0,
    profile=None,
    only_shards=None,
) -> None:
    """Compute per-node ego-net conductance OUT OF CORE over the written
    shard blobs and bake per-shard phi blobs next to them (mutates
    `shard_table` entries in place with "phi" names + crcs; the caller
    writes the manifest).

    The fit-time scorer streams the whole graph again (triangle pass +
    neighbor-degree sums); here both passes run at ingest, where the shard
    blobs are already hot, as SHARD-PAIR sweeps: tri(u) needs N(v) for
    v in N(u), so for each ordered shard pair (a, b) the sweep intersects
    shard a's rows with the neighbor lists v owned by shard b — at most
    two shard blobs (BoundedBlobCache) plus O(N) flag/degree vectors are
    resident, never the global CSR. With cap=None the counts are exact
    integers and the baked phi is BIT-IDENTICAL to
    ops.seeding.conductance(g, backend="numpy"); with a degree cap the
    capped lists come from the same splitmix64 sampler
    (seeding.capped_neighbor_lists keyed by GLOBAL row id), so the
    estimates match triangle_counts_sampled up to float summation order.

    `only_shards` (the delta re-ingest's touched-shard phi
    refresh) restricts the OUTER sweeps and the phi writes to those
    shards: their scores see the whole updated graph (inner pair sweeps
    still read neighbor shards), every other shard's phi blob is left
    byte-identical.
    """
    # lazy: ops.seeding is imported only here, so opening a cache stays
    # cheap to import
    from bigclam_tpu_torch.ops.seeding import (
        capped_neighbor_lists,
        phi_from_counts,
    )

    n = int(deg_final.size)
    blobs = BoundedBlobCache(capacity=4)

    def shard_csr(entry):
        ip = np.asarray(
            blobs.get(os.path.join(cache_dir, entry["indptr"])), np.int64
        )
        dx = blobs.get(os.path.join(cache_dir, entry["indices"]))
        return ip, dx

    # --- pass 1: S1(u) = sum of neighbor degrees, one shard at a time ---
    s1 = np.zeros(n, dtype=np.float64)
    for s, e in enumerate(shard_table):
        if only_shards is not None and s not in only_shards:
            continue
        lo, hi = int(e["lo"]), int(e["hi"])
        if hi <= lo:
            continue
        ip, dx = shard_csr(e)
        rows = np.repeat(
            np.arange(hi - lo, dtype=np.int64), np.diff(ip)
        )
        s1[lo:hi] = np.bincount(
            rows, weights=deg_final[dx].astype(np.float64),
            minlength=hi - lo,
        )
        if profile is not None:
            profile.sample_rss()

    # --- pass 2: triangle counts via ordered shard-pair sweeps ---
    # Vectorized (no per-row Python loop — O(N*S) iterations would wall an
    # ingest at real shard counts): per pair (a, b), membership "w in
    # N(u)" is a searchsorted against shard a's globally-sorted ego keys
    # u*n + w (CSR rows ascending, neighbor lists ascending — the same
    # trick as triangle_counts_sampled), with the two-hop expansion
    # processed in bounded entry chunks.
    chunk_entries = 1 << 22
    scratch = None
    if cap is None:
        tri_acc = np.zeros(n, dtype=np.int64)
    else:
        tri_acc = np.zeros(n, dtype=np.float64)
        # same stream-seed derivation as triangle_counts_sampled(rng)
        stream_seed = int(np.random.default_rng(seed).integers(2**63))
        cdeg_all = np.minimum(deg_final, cap)
        inner_w = deg_final / np.maximum(cdeg_all, 1)
        # capped lists are computed ONCE per shard and spilled to scratch
        # blobs riding the same BoundedBlobCache as the raw CSR: the pair
        # sweep reads each shard O(S) times, and the per-hub Fisher-Yates
        # sampler (a Python loop) must not rerun per pair. Computed
        # LAZILY on first read — a touched-shard delta rebake
        # (only_shards) then samples only the shards its sweeps actually
        # touch, not the whole graph per delta
        import tempfile

        # system tmp, not cache_dir: a crashed bake must not leave scratch
        # blobs inside a directory the manifest will later validate
        scratch = tempfile.mkdtemp(prefix="bigclam_seed_bake_")

        def capped_csr_of(idx: int) -> tuple:
            ipath = os.path.join(scratch, f"{idx}.indptr.npy")
            dpath = os.path.join(scratch, f"{idx}.indices.npy")
            if not os.path.exists(ipath):
                ip, dx = shard_csr(shard_table[idx])
                ip_c, dx_c = capped_neighbor_lists(
                    ip, dx, cap, stream_seed,
                    row_offset=int(shard_table[idx]["lo"]),
                )
                np.save(ipath, ip_c)
                np.save(dpath, dx_c)
                if profile is not None:
                    profile.sample_rss()
            return (
                np.asarray(blobs.get(ipath), np.int64),
                blobs.get(dpath),
            )

    try:
        for a, ea in enumerate(shard_table):
            if only_shards is not None and a not in only_shards:
                continue
            lo_a, hi_a = int(ea["lo"]), int(ea["hi"])
            if hi_a <= lo_a:
                continue
            # shard a's arrays and its derived ego keys depend only on the
            # OUTER shard: hoisted out of the pair loop (local refs keep
            # them alive past any cache eviction by the inner-b reads)
            ipa, dxa = shard_csr(ea) if cap is None else capped_csr_of(a)
            rows_a = hi_a - lo_a
            ego_src = np.repeat(
                np.arange(rows_a, dtype=np.int64), np.diff(ipa)
            )
            ego_keys = (ego_src + lo_a) * n + dxa       # sorted ascending
            for b, eb in enumerate(shard_table):
                lo_b, hi_b = int(eb["lo"]), int(eb["hi"])
                if hi_b <= lo_b:
                    continue
                # intersect FIRST: shard b's (possibly lazily sampled)
                # arrays are only loaded when shard a actually has
                # neighbors there
                sel = np.flatnonzero((dxa >= lo_b) & (dxa < hi_b))
                if sel.size == 0:
                    continue
                ipb, dxb = shard_csr(eb) if cap is None else capped_csr_of(b)
                v_rows = dxa[sel].astype(np.int64) - lo_b
                cnt_v = (ipb[v_rows + 1] - ipb[v_rows]).astype(np.int64)
                # chunk the selected edges so the expansion stays bounded
                cum = np.cumsum(cnt_v)
                splits = np.searchsorted(
                    cum,
                    np.arange(chunk_entries, int(cum[-1]) + chunk_entries,
                              chunk_entries),
                )
                starts = np.concatenate(
                    [[0], np.minimum(splits + 1, sel.size)]
                )
                for c0, c1 in zip(starts[:-1], starts[1:]):
                    if c0 >= c1:
                        continue
                    piece = sel[c0:c1]
                    z, cnts = _gather_rows(
                        ipb, dxb, dxa[piece].astype(np.int64) - lo_b
                    )
                    if z.size == 0:
                        continue
                    z_u = np.repeat(ego_src[piece], cnts)
                    cand = (z_u + lo_a) * n + z
                    idx = np.searchsorted(ego_keys, cand)
                    hit = (idx < ego_keys.size) & (
                        ego_keys[np.minimum(idx, ego_keys.size - 1)]
                        == cand
                    )
                    if cap is None:
                        tri_acc[lo_a:hi_a] += np.bincount(
                            z_u[hit], minlength=rows_a
                        )
                    else:
                        w = np.repeat(inner_w[dxa[piece]], cnts)
                        tri_acc[lo_a:hi_a] += np.bincount(
                            z_u[hit], weights=w[hit], minlength=rows_a
                        )
                if profile is not None:
                    profile.sample_rss()
    finally:
        if scratch is not None:
            shutil.rmtree(scratch, ignore_errors=True)
    if cap is None:
        tri = tri_acc // 2
    else:
        pairs = cdeg_all * (cdeg_all - 1)
        scale = np.where(
            pairs > 0,
            deg_final * (deg_final - 1) / np.maximum(pairs, 1),
            0.0,
        )
        tri = tri_acc / 2.0 * scale

    phi = phi_from_counts(
        deg_final.astype(np.int64), s1, tri, float(num_directed_edges)
    )

    # --- write per-shard phi blobs, stamp the table in place ---
    for s, e in enumerate(shard_table):
        if only_shards is not None and s not in only_shards:
            continue
        lo, hi = int(e["lo"]), int(e["hi"])
        name = _phi_name(s)
        np.save(os.path.join(cache_dir, name), phi[lo:hi])
        e["phi"] = name
        e["crc32"]["phi"] = _crc32_file(os.path.join(cache_dir, name))


# --------------------------------------------------------------------------
# closure bake: per-shard-pair gather lists next to the shards
# --------------------------------------------------------------------------


def _closure_name(s: int) -> str:
    return f"shard_{s:05d}.closure.npy"


def closure_pair_lists(
    lo: int,
    indptr: np.ndarray,
    indices: np.ndarray,
    rows_per_shard: int,
    num_shards: int,
    cap: int = 0,
):
    """Per dst-shard closure lists of ONE shard's CSR — the single
    derivation shared by the ingest bake and the 2D trainers' v2
    streaming fallback (they must never diverge: the send side of an
    exchange is the mirror of some other shard's gather side).

    Returns (out_ids, in_ids, edge_counts) over peer shards b:
    out_ids[b] = sorted unique GLOBAL dst ids in b, in_ids[b] = sorted
    unique GLOBAL src rows of this shard with an edge into b,
    edge_counts[b] = directed edges into b. cap > 0 replaces any list
    longer than cap with None (the overflow sentinel — consumers degrade
    that pair to the full dst block)."""
    S = num_shards
    dx = np.asarray(indices, dtype=np.int64)
    src = lo + np.repeat(
        np.arange(indptr.shape[0] - 1, dtype=np.int64), np.diff(indptr)
    )
    dshard = dx // rows_per_shard
    order = np.argsort(dshard, kind="stable")
    dx_s, src_s, dshard_s = dx[order], src[order], dshard[order]
    bounds = np.searchsorted(dshard_s, np.arange(S + 1))
    out_ids: List[Optional[np.ndarray]] = []
    in_ids: List[Optional[np.ndarray]] = []
    edge_counts: List[int] = []
    for b in range(S):
        sl = slice(int(bounds[b]), int(bounds[b + 1]))
        edge_counts.append(sl.stop - sl.start)
        out = np.unique(dx_s[sl])
        ins = np.unique(src_s[sl])
        out_ids.append(None if cap and out.size > cap else out)
        in_ids.append(None if cap and ins.size > cap else ins)
    return out_ids, in_ids, edge_counts


def bake_closure_lists(
    cache_dir: str,
    shard_table: List[dict],
    rows_per_shard: int,
    cap: int = 0,
    profile=None,
    only_shards=None,
) -> None:
    """Bake per-shard closure blobs next to the CSR blobs (mutates
    `shard_table` entries in place with "closure" metadata + crcs; the
    caller writes the manifest).

    One sweep per shard over its OWN blobs only — O(S) blob loads total,
    and a touched-shard delta rebake (`only_shards`, mirroring the phi
    rebake contract) is exact because a shard's closure depends on
    nothing but its own edge lists. The blob is a single int32 npy:
    concat(out lists for b=0..S-1, then in lists), with lengths in the
    manifest entry (-1 marks a capped-overflow pair whose list is
    omitted)."""
    S = len(shard_table)
    for s, e in enumerate(shard_table):
        if only_shards is not None and s not in only_shards:
            continue
        lo, hi = int(e["lo"]), int(e["hi"])
        ip = np.load(os.path.join(cache_dir, e["indptr"])).astype(
            np.int64, copy=False
        )
        dx = np.load(os.path.join(cache_dir, e["indices"]))
        out_ids, in_ids, edge_counts = closure_pair_lists(
            lo, ip, dx, rows_per_shard, S, cap=cap
        )
        parts = [a for a in out_ids + in_ids if a is not None]
        blob = (
            np.concatenate(parts)
            if parts
            else np.empty(0, dtype=np.int64)
        ).astype(np.int32)
        name = _closure_name(s)
        np.save(os.path.join(cache_dir, name), blob)
        e["closure"] = {
            "ids": name,
            "out_counts": [
                -1 if a is None else int(a.size) for a in out_ids
            ],
            "in_counts": [
                -1 if a is None else int(a.size) for a in in_ids
            ],
            "edge_counts": [int(c) for c in edge_counts],
        }
        e["crc32"]["closure"] = _crc32_file(os.path.join(cache_dir, name))
        if profile is not None:
            profile.sample_rss()


# --------------------------------------------------------------------------
# compile: text -> cache, out of core
# --------------------------------------------------------------------------


class _BucketWriter:
    """Append-only int64 pair spill files, one per node-range bucket."""

    def __init__(self, directory: str, num_buckets: int, tag: str):
        os.makedirs(directory, exist_ok=True)
        self.paths = [
            os.path.join(directory, f"{tag}_{b:05d}.bin")
            for b in range(num_buckets)
        ]
        self._handles = [open(p, "ab") for p in self.paths]

    def append(self, bucket: int, pairs: np.ndarray) -> None:
        if pairs.size:
            self._handles[bucket].write(
                np.ascontiguousarray(pairs, dtype=np.int64).tobytes()
            )

    def close(self) -> None:
        for h in self._handles:
            h.close()

    def read(self, bucket: int) -> np.ndarray:
        return np.fromfile(self.paths[bucket], dtype=np.int64).reshape(-1, 2)


def _scatter_by_bucket(
    pairs: np.ndarray, rows: int, writer: _BucketWriter
) -> None:
    """Append each directed pair to the bucket owning its source node."""
    if pairs.shape[0] == 0:
        return
    bidx = pairs[:, 0] // rows
    order = np.argsort(bidx, kind="stable")
    pairs = pairs[order]
    bidx = bidx[order]
    bounds = np.flatnonzero(np.diff(bidx)) + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [pairs.shape[0]]])
    for s, e in zip(starts, ends):
        writer.append(int(bidx[s]), pairs[s:e])


def _merge_sorted_unique(table: np.ndarray, chunk: np.ndarray) -> np.ndarray:
    """Fold a chunk's ids into the sorted unique id table WITHOUT re-sorting
    the table (np.union1d re-sorts all N ids per chunk — O(chunks * N log N)
    across a billion-edge scan): unique the chunk, drop ids already in
    the table via searchsorted, merge-insert the rest. O(N + m) per chunk.
    """
    ids = np.unique(chunk)
    if table.size == 0:
        return ids
    if ids.size == 0:
        return table
    pos = np.searchsorted(table, ids)
    known = table[np.minimum(pos, table.size - 1)] == ids
    fresh = ids[~known]
    if fresh.size == 0:
        return table
    return np.insert(table, np.searchsorted(table, fresh), fresh)


def _atomic_json(path: str, obj: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def compile_graph_cache(
    text_path: str,
    cache_dir: str,
    num_shards: int = 8,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    workers: int = 0,
    balance: bool = False,
    overwrite: bool = False,
    profile=None,
    seed_bake: bool = True,
    seed_cap: Optional[int] = None,
    seed: int = 0,
    closure_bake: bool = True,
    closure_cap: int = 0,
) -> GraphStore:
    """Compile a SNAP edge list into a binary shard cache, out of core.

    Stages (each a `profile` stage when an IngestProfile is passed):
      scan     stream newline-snapped chunks, spill parsed raw pairs to
               disk, merge the sorted unique raw-id table (O(chunk + N) RSS)
      scatter  remap raw ids -> compact [0, N), drop self-loops, symmetrize,
               bucket directed pairs by owner node range
      dedup    per-bucket lexsort + duplicate-row drop (duplicates of an
               edge always land in the same bucket, so local dedup is
               globally exact); exact deduped degrees fall out here
      shards   (balance=True: relabel through the balance permutation and
               re-scatter first) write per-shard packed CSR blobs + the
               versioned manifest with per-blob crc32s
      seed_bake (seed_bake=True, the default) per-node conductance scores
               baked next to the shards (bake_seed_scores: shard-pair
               sweeps over the just-written blobs, O(2 shards + N) RSS),
               so fit-time seeding on a cache reads scores instead of
               re-streaming the graph. seed_cap engages the degree-capped
               splitmix64 estimator (exact when cap >= max degree); `seed`
               is the cfg-level PRNG seed its stream derives from
      closure_bake (closure_bake=True, the default) per-shard-pair
               neighborhood-closure gather lists baked next to the shards
               (bake_closure_lists — one sweep per shard over its own
               blobs), so the 2D-partition trainers read exchange sets
               instead of re-deriving them. closure_cap bounds the
               per-pair list length (0 = uncapped; overflow pairs degrade
               to full-block exchange)

    Shard s owns node rows [s*rows, (s+1)*rows) with
    rows = ceil(max(N, num_shards) / num_shards) — exactly the contiguous
    ranges the sharded trainers slice on a dp=num_shards mesh, so a baked
    balance permutation (balance_permutation(degrees, num_shards, rows *
    num_shards)) is the same relabeling ShardedBigClamModel(balance=True)
    would compute at model build.
    """
    if num_shards <= 0:
        raise ValueError(f"num_shards must be positive, got {num_shards}")
    manifest_path = os.path.join(cache_dir, MANIFEST_NAME)
    if os.path.exists(manifest_path):
        if not overwrite:
            raise FileExistsError(
                f"{cache_dir}: cache already compiled (pass overwrite=True "
                "/ --overwrite to rebuild)"
            )
        # drop the OLD manifest (and its blobs) before rebuilding: a crash
        # mid-rebuild must leave an unrecognizable directory, never an
        # old manifest validating over mixed old/new shard files
        os.unlink(manifest_path)
        for name in os.listdir(cache_dir):
            if name.endswith(".npy") and (
                name.startswith("shard_") or name in ("raw_ids.npy",
                                                      "perm.npy")
            ):
                os.unlink(os.path.join(cache_dir, name))
    os.makedirs(cache_dir, exist_ok=True)
    spill_dir = os.path.join(cache_dir, "_spill")
    if os.path.exists(spill_dir):
        shutil.rmtree(spill_dir)
    os.makedirs(spill_dir)

    if profile is None:
        from bigclam_tpu_torch.utils.profiling import IngestProfile

        profile = IngestProfile()

    try:
        return _compile(
            text_path, cache_dir, spill_dir, manifest_path, num_shards,
            chunk_bytes, workers, balance, profile, seed_bake, seed_cap,
            seed, closure_bake, closure_cap,
        )
    finally:
        shutil.rmtree(spill_dir, ignore_errors=True)


def _compile(
    text_path, cache_dir, spill_dir, manifest_path, num_shards,
    chunk_bytes, workers, balance, profile, seed_bake, seed_cap, seed,
    closure_bake, closure_cap,
) -> GraphStore:
    # --- scan: parse chunks, spill raw pairs, merge unique raw ids ---
    chunk_paths: List[str] = []
    raw_ids = np.empty(0, dtype=np.int64)
    raw_edges = 0
    with profile.stage("scan"):
        for i, pairs in enumerate(
            stream_edge_list(text_path, chunk_bytes, workers)
        ):
            cpath = os.path.join(spill_dir, f"chunk_{i:06d}.bin")
            pairs.tofile(cpath)
            chunk_paths.append(cpath)
            raw_edges += pairs.shape[0]
            raw_ids = _merge_sorted_unique(raw_ids, pairs)
            profile.count("chunks")
            profile.count("raw_edges", pairs.shape[0])
            profile.sample_rss()
    n = int(raw_ids.shape[0])
    if n > np.iinfo(np.int32).max:
        # dedup/remap are ceiling-free, but shard indices are int32 (the
        # Graph container's dtype): refuse instead of wrapping negative
        raise ValueError(
            f"num_nodes={n} exceeds the int32 CSR indices bound (2^31-1)"
        )
    rows = -(-max(n, num_shards) // num_shards)    # == trainers' n_pad // dp

    # --- scatter: remap, drop loops, symmetrize, bucket by src range ---
    buckets = _BucketWriter(spill_dir, num_shards, "bucket")
    with profile.stage("scatter"):
        for cpath in chunk_paths:
            pairs = np.fromfile(cpath, dtype=np.int64).reshape(-1, 2)
            os.unlink(cpath)
            pairs = np.searchsorted(raw_ids, pairs)
            pairs = pairs[pairs[:, 0] != pairs[:, 1]]
            both = np.concatenate([pairs, pairs[:, ::-1]], axis=0)
            _scatter_by_bucket(both, rows, buckets)
            profile.sample_rss()
    buckets.close()

    # --- dedup: per-bucket lexsort + unique rows; exact degrees ---
    degrees = np.zeros(max(n, 1), dtype=np.int64)
    deduped = _BucketWriter(spill_dir, num_shards, "dedup")
    with profile.stage("dedup"):
        for b in range(num_shards):
            both = buckets.read(b)
            os.unlink(buckets.paths[b])
            src, dst = dedup_directed(both)
            lo, hi = min(b * rows, n), min((b + 1) * rows, n)
            if src.size:
                degrees[lo:hi] += np.bincount(src - lo, minlength=hi - lo)
            deduped.append(b, np.stack([src, dst], axis=1))
            profile.sample_rss()
    deduped.close()

    # --- balance permutation (baked at compile time) ---
    perm = None
    if balance:
        # lazy: parallel/__init__ pulls in torch, which the default ingest
        # path does not pay for
        from bigclam_tpu_torch.parallel.balance import balance_permutation

        perm = balance_permutation(degrees[:n], num_shards, rows * num_shards)

    # --- shards: (relabel + re-scatter when balanced,) write CSR blobs ---
    final = deduped
    if perm is not None:
        final = _BucketWriter(spill_dir, num_shards, "final")
        with profile.stage("shards"):
            for b in range(num_shards):
                arr = deduped.read(b)
                os.unlink(deduped.paths[b])
                _scatter_by_bucket(perm[arr], rows, final)
                profile.sample_rss()
        final.close()

    shard_table = []
    total_directed = 0
    deg_final = np.zeros(max(n, 1), dtype=np.int64)  # FINAL node order
    with profile.stage("shards"):
        for s in range(num_shards):
            arr = final.read(s)
            os.unlink(final.paths[s])
            lo, hi = min(s * rows, n), min((s + 1) * rows, n)
            if perm is not None and arr.size:
                # re-scattered buckets are unsorted; dedup already happened
                order = np.lexsort((arr[:, 1], arr[:, 0]))
                arr = arr[order]
            local_indptr = np.zeros(hi - lo + 1, dtype=np.int64)
            if arr.size:
                np.cumsum(
                    np.bincount(arr[:, 0] - lo, minlength=hi - lo),
                    out=local_indptr[1:],
                )
            deg_final[lo:hi] = np.diff(local_indptr)
            indices = arr[:, 1].astype(np.int32)
            iname, dname = _shard_files(s)
            np.save(os.path.join(cache_dir, iname), local_indptr)
            np.save(os.path.join(cache_dir, dname), indices)
            total_directed += int(indices.shape[0])
            shard_table.append(
                {
                    "lo": lo,
                    "hi": hi,
                    "edges": int(indices.shape[0]),
                    "indptr": iname,
                    "indices": dname,
                    "crc32": {
                        "indptr": _crc32_file(
                            os.path.join(cache_dir, iname)
                        ),
                        "indices": _crc32_file(
                            os.path.join(cache_dir, dname)
                        ),
                    },
                }
            )
            profile.count("directed_edges", int(indices.shape[0]))
            profile.sample_rss()

        # raw_ids in FINAL node order (balanced caches relabel rows)
        if perm is not None:
            raw_final = np.empty_like(raw_ids)
            raw_final[perm] = raw_ids
        else:
            raw_final = raw_ids
        np.save(os.path.join(cache_dir, "raw_ids.npy"), raw_final)
        files: Dict[str, dict] = {
            "raw_ids": {
                "name": "raw_ids.npy",
                "crc32": _crc32_file(os.path.join(cache_dir, "raw_ids.npy")),
            }
        }
        if perm is not None:
            np.save(os.path.join(cache_dir, "perm.npy"), perm)
            files["perm"] = {
                "name": "perm.npy",
                "crc32": _crc32_file(os.path.join(cache_dir, "perm.npy")),
            }

    # --- seed bake: conductance scores next to the shards ---
    bake_skipped = None
    if seed_bake and seed_cap is None:
        exact_work = float(
            np.square(deg_final[:n].astype(np.float64)).sum()
        )
        if exact_work > SEED_BAKE_EXACT_MAX_WORK:
            seed_bake = False
            bake_skipped = "exact_work"
            print(
                f"warning: skipping the seed bake — the exact triangle "
                f"pass would expand {exact_work:.2e} two-hop entries "
                f"(> {SEED_BAKE_EXACT_MAX_WORK:.0e}); re-run ingest with "
                "--seed-cap to bake the degree-capped estimator instead",
                file=sys.stderr,
            )
    if seed_bake:
        with profile.stage("seed_bake"):
            bake_seed_scores(
                cache_dir, shard_table, deg_final[:n], total_directed,
                cap=seed_cap, seed=seed, profile=profile,
            )
            profile.sample_rss()

    # --- closure bake: 2D-partition gather lists ---
    if closure_bake:
        with profile.stage("closure_bake"):
            bake_closure_lists(
                cache_dir, shard_table, rows, cap=closure_cap,
                profile=profile,
            )
            profile.sample_rss()

    manifest = {
        "format_version": MANIFEST_VERSION,
        "num_nodes": n,
        "num_directed_edges": total_directed,
        "num_undirected_edges": total_directed // 2,
        "num_shards": num_shards,
        "rows_per_shard": rows,
        "balanced": perm is not None,
        "dtypes": {"indptr": "int64", "indices": "int32",
                   "raw_ids": "int64"},
        "shards": shard_table,
        "files": files,
        "seed_scores": (
            {"baked": True, "cap": seed_cap, "seed": seed}
            if seed_bake
            else {"baked": False, "skipped": bake_skipped}
            if bake_skipped
            else {"baked": False}
        ),
        "closure": (
            {"baked": True, "cap": int(closure_cap)}
            if closure_bake
            else {"baked": False}
        ),
        "source": {
            "path": os.path.abspath(text_path),
            "bytes": os.path.getsize(text_path),
            "raw_pairs": raw_edges,
        },
    }
    _atomic_json(manifest_path, manifest)
    from bigclam_tpu_torch.obs import telemetry as _obs

    tel = _obs.current()
    if tel is not None:
        tel.event(
            "ingest",
            edges=total_directed // 2,
            nodes=n,
            shards=num_shards,
            balanced=perm is not None,
            seed_baked=bool(seed_bake),
            cache_dir=cache_dir,
        )
    return GraphStore(cache_dir, manifest)
