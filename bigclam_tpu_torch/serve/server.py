"""The membership server: three query families at batch QPS over an
immutable, hot-swappable snapshot.

Port of bigclam_tpu/serve/server.py. HotCommunityCache and
MembershipServer are the JAX module's; FoldInEngine runs the fold-in in
torch on an explicit device.

    server = MembershipServer("snaps/", store=GraphStore.open("g.cache"))
    server.query({"family": "communities_of", "u": 12})
    server.query({"family": "members_of", "c": 3})
    server.query({"family": "suggest_for", "u": 12})
    server.hot_swap()            # after a new publish(); drops no queries

Families:
  * communities_of u — threshold read of F[u] (ops.extraction semantics,
    answered straight off the ServingSnapshot);
  * members_of c     — the load-time inverted index, fronted by the
    Zipf-aware HotCommunityCache;
  * suggest_for u    — FOLD-IN: optimize u's row against the frozen F
    (ops.foldin — the trainer's own per-node update, batched). `u` may be
    a graph node (neighbours come from the store/graph adjacency) or
    absent with an explicit "neighbors" list (a brand-new node).

All families flow through ONE RequestBatcher (serve.batcher): a batch
flushes at max_batch or when the latency budget closes. The handler holds
the swap lock for the whole batch, so `hot_swap` = load the new snapshot
off to the side, take the lock (this drains the in-flight batch), swap
the pointer, reset the caches — queued and future queries see the new
generation, and nothing is ever dropped.

Observability rides the obs stack: each batch emits a `serve` event
(family counts, batch size, exec seconds) under a serve/batch span; swaps
emit `snapshot_swap`; stats() produces the p50/p99/QPS/cache-hit figures
`cli serve` stamps into the telemetry final, so the perf ledger records
and `cli perf diff` verdicts serve p99 like any other regression axis.

The server resolves its device when it starts (`cuda` unless told
otherwise; no card raises utils.device.DeviceUnavailableError) and the
batcher's worker thread creates every fold-in tensor on it by name, never
on "the current device" of that thread.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from bigclam_tpu_torch.obs import telemetry as _obs
from bigclam_tpu_torch.obs import trace as _trace
from bigclam_tpu_torch.obs.ledger import _percentile
from bigclam_tpu_torch.serve.batcher import (
    Future,
    OverloadedError,
    Request,
    RequestBatcher,
)
from bigclam_tpu_torch.serve.snapshot import (
    FOLDIN_CFG_FIELDS,
    ServingSnapshot,
    SnapshotError,
)
from bigclam_tpu_torch.utils.checkpoint import CheckpointManager
from bigclam_tpu_torch.utils.device import resolve_device

FAMILIES = ("communities_of", "members_of", "suggest_for")


def _pow2(x: int, lo: int = 1) -> int:
    return max(1 << max(int(x) - 1, 0).bit_length(), lo)


class HotCommunityCache:
    """Members-of-c cache, Zipf-aware.

    Under Zipf traffic a community's query popularity tracks its size,
    and size IS the mass share sumF_c / sum(sumF) — the per-community
    resolution of the health pack's top_mass_share signal
    (ops.diagnostics). So instead of LRU (which thrashes on the long
    tail), the cache is KEYED by mass share: at reset it pre-warms the
    top-share communities, and a miss is only admitted by evicting a
    resident with a LOWER share. The resident set converges to the hot
    head of the Zipf curve and stays there."""

    def __init__(self, slots: int):
        self.slots = max(int(slots), 0)
        self.share: Optional[np.ndarray] = None
        self.data: Dict[int, np.ndarray] = {}
        self.hits = 0
        self.misses = 0

    def reset(self, snapshot: ServingSnapshot) -> None:
        """Rebind to a snapshot generation: drop everything (the member
        lists changed), pre-warm the top-mass communities."""
        self.share = snapshot.mass_share
        self.data = {}
        self.hits = 0
        self.misses = 0
        for c in snapshot.top_mass_communities(self.slots):
            self.data[int(c)] = snapshot.members_of(int(c))

    def get(self, c: int) -> Optional[np.ndarray]:
        got = self.data.get(c)
        if got is None:
            self.misses += 1
        else:
            self.hits += 1
        return got

    def put(self, c: int, members: np.ndarray) -> None:
        if self.slots <= 0 or self.share is None:
            return
        if len(self.data) < self.slots:
            self.data[c] = members
            return
        coldest = min(self.data, key=lambda r: self.share[r])
        if self.share[c] > self.share[coldest]:
            del self.data[coldest]
            self.data[c] = members

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class FoldInEngine:
    """The suggest family's device side: the frozen snapshot arrays
    uploaded to `device` once per generation (the server builds one
    engine per generation), and the batched fold-in of ops.foldin
    (per-node Armijo ascent with per-node convergence). Batch and
    neighbour axes pad to powers of two, as the JAX engine pads them for
    its compile cache, so the two engines' results match slot for slot.

    `dtype` defaults to float32 on the card, whatever the snapshot's (a
    float64 archive is served as the JAX engine serves it without x64),
    and to the snapshot's on the CPU; float64 runs on the CPU only (the
    parity reference)."""

    def __init__(
        self,
        snapshot: ServingSnapshot,
        max_iters: int = 200,
        conv_tol: Optional[float] = None,
        pad_b_to: int = 8,
        device=None,
        dtype: Optional[torch.dtype] = None,
    ):
        from bigclam_tpu_torch.config import BigClamConfig
        from bigclam_tpu_torch.ops import foldin as fi

        self._fi = fi
        self.snapshot = snapshot
        self.device = resolve_device(device)
        if dtype is None:
            dtype = (torch.from_numpy(np.zeros(0, snapshot.sumF.dtype)).dtype
                     if self.device.type == "cpu" else torch.float32)
        self.dtype = dtype
        if self.dtype == torch.float64 and self.device.type != "cpu":
            raise ValueError("float64 fold-in is the CPU parity dtype")
        meta = snapshot.meta
        cfg = BigClamConfig(
            num_communities=snapshot.k,
            **{f: meta[f] for f in FOLDIN_CFG_FIELDS if f in meta},
        )
        self.cfg = cfg
        self.pad_b_to = max(int(pad_b_to), 1)
        if snapshot.representation == "dense":
            self._F = self._upload(snapshot.F)
            self._ids = self._w = None
        else:
            self._ids = torch.from_numpy(
                np.ascontiguousarray(snapshot.ids)).to(self.device)
            self._w = self._upload(snapshot.w)
            self._F = None
        self._sumF = self._upload(snapshot.sumF)
        self._fit = fi.make_foldin_fit(
            cfg,
            max_iters=max_iters,
            conv_tol=(
                conv_tol if conv_tol is not None else cfg.conv_tol
            ),
        )

    def _upload(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=self.device, dtype=self.dtype)

    def suggest_batch(
        self,
        items: Sequence[Tuple[np.ndarray, Optional[int]]],
        top_n: int = 20,
    ) -> List[dict]:
        """items: (internal neighbour ids, own internal row or None for a
        brand-new node). Returns per item the folded row's communities
        above delta (argmax fallback — extraction semantics), ranked by
        weight, plus the fold-in LLH and iteration count."""
        return self._postprocess(*self.fold(items), len(items), top_n)

    def fold(
        self, items: Sequence[Tuple[np.ndarray, Optional[int]]]
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The fold-in of suggest_batch's items: (rows (B_pad, K), llh,
        iters) on the engine's device, padding slots included."""
        fi = self._fi
        snap = self.snapshot
        dev, dt = self.device, self.dtype
        b = len(items)
        bp = _pow2(b, self.pad_b_to)
        d = _pow2(max((len(nbr) for nbr, _ in items), default=1))
        nbr_ids = np.zeros((bp, d), np.int64)
        mask = np.zeros((bp, d), np.float64)
        own = np.full(bp, -1, np.int64)
        for i, (nbr, row) in enumerate(items):
            nbr_ids[i, : len(nbr)] = nbr
            mask[i, : len(nbr)] = 1.0
            if row is not None:
                own[i] = row
        nbr_dev = torch.from_numpy(nbr_ids).to(dev)
        mask_dev = torch.from_numpy(mask).to(device=dev, dtype=dt)
        own_dev = torch.from_numpy(np.maximum(own, 0)).to(dev)
        has_row = torch.from_numpy(own >= 0).to(dev)[:, None]
        zeros = torch.zeros((bp, snap.k), dtype=dt, device=dev)
        if self._F is not None:
            nbr_rows = fi.gather_neighbor_rows(self._F, nbr_dev)
            own_rows = torch.where(has_row, self._F[own_dev], zeros)
        else:
            nbr_rows = fi.densify_member_rows(
                self._ids, self._w, nbr_dev, snap.k
            )
            own_rows = torch.where(
                has_row,
                fi.densify_rows(self._ids, self._w, own_dev, snap.k),
                zeros,
            )
        sumF_others = self._sumF[None, :] - own_rows
        # warm-start policy (models.bigclam.foldin_rows): an existing node
        # refines its OWN trained row (fixed point = training parity,
        # fewest iterations); a brand-new node starts from its neighbour
        # mean, and so does an existing node whose trained row froze at
        # ZERO (a fixed point the ascent can never leave)
        has_own = has_row & (own_rows.max(dim=1, keepdim=True).values > 0)
        rows0 = torch.where(
            has_own, own_rows, fi.neighbor_mean_rows(nbr_rows, mask_dev)
        )
        return self._fit(rows0, nbr_rows, mask_dev, sumF_others)

    def suggest_batch_rows(
        self,
        items: Sequence[Tuple[np.ndarray, Optional[np.ndarray]]],
        top_n: int = 20,
    ) -> List[dict]:
        """items: (neighbour ROWS as a (d_i, K) array, own (K,) row or None
        for a brand-new node): the fleet's addressing, where non-local
        neighbour rows arrive pre-gathered and the fold-in runs against
        the GLOBAL sumF — the same math as suggest_batch."""
        fi = self._fi
        snap = self.snapshot
        dev, dt = self.device, self.dtype
        b = len(items)
        bp = _pow2(b, self.pad_b_to)
        d = _pow2(max((len(nr) for nr, _ in items), default=1))
        np_dt = np.float64 if dt == torch.float64 else np.float32
        nbr_rows = np.zeros((bp, d, snap.k), np_dt)
        mask = np.zeros((bp, d), np.float64)
        own_rows = np.zeros((bp, snap.k), np_dt)
        has_own = np.zeros(bp, bool)
        for i, (nr, own) in enumerate(items):
            nr = np.asarray(nr, np_dt).reshape(-1, snap.k)
            nbr_rows[i, : len(nr)] = nr
            mask[i, : len(nr)] = 1.0
            if own is not None:
                own_rows[i] = np.asarray(own, np_dt)
                # same warm-start policy as suggest_batch
                has_own[i] = bool(own_rows[i].max() > 0)
        nbr_dev = torch.from_numpy(nbr_rows).to(dev)
        mask_dev = torch.from_numpy(mask).to(device=dev, dtype=dt)
        own_dev = torch.from_numpy(own_rows).to(dev)
        sumF_others = self._sumF[None, :] - own_dev
        rows0 = torch.where(
            torch.from_numpy(has_own).to(dev)[:, None],
            own_dev,
            fi.neighbor_mean_rows(nbr_dev, mask_dev),
        )
        rows, llh, iters = self._fit(rows0, nbr_dev, mask_dev, sumF_others)
        return self._postprocess(rows, llh, iters, b, top_n)

    def _postprocess(
        self, rows, llh, iters, b: int, top_n: int
    ) -> List[dict]:
        snap = self.snapshot
        rows = rows.cpu().numpy()
        llh = llh.cpu().numpy()
        iters = iters.cpu().numpy()
        out = []
        for i in range(b):
            r = rows[i]
            cids = np.nonzero(r >= snap.delta)[0]
            if cids.size == 0 and r.size:
                cids = np.asarray([int(np.argmax(r))])
            order = np.argsort(-r[cids], kind="stable")[:top_n]
            cids = cids[order]
            out.append(
                {
                    "suggested": [
                        [int(c), float(r[c])] for c in cids
                    ],
                    "llh": float(llh[i]),
                    "iters": int(iters[i]),
                }
            )
        return out


class MembershipServer:
    """See module docstring. Thread-safe; close() releases the batcher
    and watcher threads."""

    def __init__(
        self,
        snapshot_dir: str,
        store=None,
        graph=None,
        max_batch: int = 64,
        budget_s: float = 0.005,
        cache_slots: int = 64,
        foldin_max_iters: int = 200,
        foldin_conv_tol: Optional[float] = None,
        foldin_max_deg: int = 4096,
        watch_interval_s: float = 0.0,
        max_queue_depth: int = 0,
        shed_wait_s: float = 0.0,
        device=None,
    ):
        self.snapshot_dir = snapshot_dir
        self._device = resolve_device(device)
        self._store = store
        self._graph = graph
        self._adj: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._foldin_max_iters = foldin_max_iters
        self._foldin_conv_tol = foldin_conv_tol
        self._foldin_max_deg = foldin_max_deg
        self._lock = threading.RLock()
        self._snapshot = ServingSnapshot.load(snapshot_dir, store=store)
        self._engine: Optional[FoldInEngine] = None
        self._cache = HotCommunityCache(cache_slots)
        self._cache.reset(self._snapshot)
        self._latencies: Dict[str, List[float]] = {
            f: [] for f in FAMILIES
        }
        self._errors = 0
        self._swaps = 0
        self._truncated_neighbors = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._batcher = RequestBatcher(
            self._handle_batch,
            max_batch=max_batch,
            budget_s=budget_s,
            max_depth=max_queue_depth,
            shed_wait_s=shed_wait_s,
        ).start()
        self._watch_stop = threading.Event()
        self._watcher: Optional[threading.Thread] = None
        if watch_interval_s > 0:
            self._watcher = threading.Thread(
                target=self._watch_loop,
                args=(watch_interval_s,),
                name="bigclam-serve-watch",
                daemon=True,
            )
            self._watcher.start()

    # ------------------------------------------------------- lifecycle
    def close(self) -> None:
        self._watch_stop.set()
        if self._watcher is not None:
            self._watcher.join(timeout=10.0)
            self._watcher = None
        self._batcher.stop()

    def __enter__(self) -> "MembershipServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------- hot swap
    @property
    def generation(self) -> int:
        return self._snapshot.step

    def _refresh_store(self) -> None:
        """Re-open the graph cache's manifest before a swap:
        the continuous delta pipeline mutates the cache UNDER a running
        server (edge counts, delta_seq), and verifying a post-delta
        snapshot against the stale in-memory manifest would refuse
        every new generation. One JSON parse when a store is attached;
        the suggest adjacency cache is dropped only when the graph
        actually changed (delta_seq moved)."""
        if self._store is None:
            return
        from bigclam_tpu_torch.graph.store import GraphStore

        try:
            fresh = GraphStore.open(
                self._store.directory, self_heal=self._store.self_heal
            )
        except ValueError:
            return          # torn manifest mid-delta: retry next poll
        # store swap + adjacency invalidation under ONE lock hold: a
        # suggest batch racing between them could rebuild _adj from the
        # OLD store and cache the stale adjacency forever
        with self._lock:
            changed = fresh.manifest.get(
                "delta_seq", 0
            ) != self._store.manifest.get("delta_seq", 0)
            self._store = fresh
            if changed:
                self._adj = None            # adjacency changed

    def hot_swap(self, step: Optional[int] = None) -> int:
        """Swap to the latest (or a named) published snapshot. The load
        + index build happens OUTSIDE the lock; taking the lock then
        drains the in-flight batch, so queries keep queueing throughout
        and none is dropped. Returns the new generation's step."""
        self._refresh_store()
        new = ServingSnapshot.load(
            self.snapshot_dir, step=step, store=self._store
        )
        return self._install(new)

    def _install(self, new: ServingSnapshot) -> int:
        with self._lock:
            previous = self._snapshot.step
            self._snapshot = new
            self._engine = None          # rebuilt lazily per generation
            self._cache.reset(new)
            self._swaps += 1
        tel = _obs.current()
        if tel is not None:
            tel.event(
                "snapshot_swap", step=int(new.step),
                previous=int(previous),
            )
        return new.step

    def maybe_reload(self) -> Optional[int]:
        """Hot-swap iff a NEWER snapshot is published (the watcher's
        poll; the cheap no-change case is one latest.json read). The
        load goes through the FALLBACK path (step=None), so a corrupt
        newest publication resolves to the best loadable snapshot —
        which may be the one already serving (then: no swap). The
        generation NEVER moves backward: a stale
        latest.json racing a newer snap_ archive — or a pointer rolled
        back by a crashed publisher — resolves to an older step, and an
        older step is never installed over the one already serving."""
        latest = CheckpointManager(self.snapshot_dir).latest()
        if latest is None or latest <= self._snapshot.step:
            return None
        self._refresh_store()
        new = ServingSnapshot.load(self.snapshot_dir, store=self._store)
        if new.step <= self._snapshot.step:
            return None     # newest publication unreadable/stale: keep
        return self._install(new)

    def _watch_loop(self, interval: float) -> None:
        while not self._watch_stop.wait(interval):
            try:
                self.maybe_reload()
            except Exception:   # noqa: BLE001 — the watcher must outlive
                # any transient publication state (torn pointer, corrupt
                # archive, store mismatch mid-publish): keep serving the
                # current snapshot and poll again next interval
                pass

    # ------------------------------------------------------- queries
    def submit(self, query: Dict[str, Any]) -> Future:
        return self._batcher.submit(query)

    def query(
        self, query: Dict[str, Any], timeout: float = 60.0
    ) -> Dict[str, Any]:
        return self.submit(query).result(timeout)

    def run_queries(
        self,
        queries: Sequence[Dict[str, Any]],
        timeout: float = 600.0,
        collect: bool = True,
    ) -> List[Optional[Dict[str, Any]]]:
        """Open-loop load (the `cli serve --queries` path): submit
        everything, wait for everything. Per-query failures come back as
        {"error": ...} results, never exceptions."""
        futures = [self.submit(q) for q in queries]
        out: List[Optional[Dict[str, Any]]] = []
        for fut in futures:
            try:
                res = fut.result(timeout)
            except OverloadedError:
                # admission-control shed: a deliberate fast answer, NOT
                # a serve error (the batcher already counted it)
                res = {"error": "overloaded"}
            except Exception as e:   # noqa: BLE001 — batch infra failure
                self._errors += 1
                res = {"error": f"{type(e).__name__}: {e}"}
            out.append(res if collect else None)
        return out

    # ------------------------------------------------------- handler
    def _adjacency(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._adj is None:
            if self._graph is not None:
                self._adj = (self._graph.indptr, self._graph.indices)
            elif self._store is not None:
                # re-open the manifest first: the delta pipeline may
                # have rewritten shard blobs since this handle was
                # opened, and reading them against a stale manifest
                # would raise (or worse, self-heal-revert a writer's
                # work — which is why serve opens stores read-only)
                self._refresh_store()
                g = self._store.load_graph()
                self._adj = (g.indptr, g.indices)
            else:
                raise SnapshotError(
                    "suggest_for a graph node needs adjacency — pass a "
                    "graph/store to the server, or send an explicit "
                    "'neighbors' list"
                )
        return self._adj

    def _answer_read(
        self, snap: ServingSnapshot, q: Dict[str, Any]
    ) -> Dict[str, Any]:
        fam = q["family"]
        if fam == "communities_of":
            row = snap.row_of(int(q["u"]))
            cids, weights = snap.communities_of(row)
            return {
                "u": int(q["u"]),
                "communities": [
                    [int(c), float(v)] for c, v in zip(cids, weights)
                ],
            }
        c = int(q["c"])
        members = self._cache.get(c)
        cached = members is not None
        if members is None:
            members = snap.members_of(c)
            self._cache.put(c, members)
        return {
            "c": c,
            # the JAX list of ints, built by numpy: a community can hold
            # every all-zero row (the argmax-tie fallback), and a Python
            # loop over such a list dominated a batch
            "members": members.tolist(),
            "cached": cached,
        }

    def _handle_batch(self, batch: List[Request]) -> None:
        t0 = time.perf_counter()
        families: Dict[str, int] = {}
        suggests: List[Request] = []
        with self._lock, _trace.span("serve/batch", emit=False):
            snap = self._snapshot
            for req in batch:
                q = req.payload if isinstance(req.payload, dict) else {}
                fam = q.get("family")
                # telemetry key: always a string (a malformed query with
                # family None/12 must not make sorted()/join() throw and
                # lose the whole batch's serve event)
                families[str(fam)] = families.get(str(fam), 0) + 1
                if fam == "suggest_for":
                    suggests.append(req)
                    continue
                try:
                    if fam not in FAMILIES:
                        raise KeyError(f"unknown family {fam!r}")
                    req.future.set_result(self._answer_read(snap, q))
                except Exception as e:   # noqa: BLE001 — per-query
                    self._errors += 1
                    req.future.set_result(
                        {"error": f"{type(e).__name__}: {e}"}
                    )
            if suggests:
                self._handle_suggests(snap, suggests)
        self._record_latencies(batch)
        depth = self._batcher.depth()
        tel = _obs.current()
        if tel is not None:
            # queue depth rides the telemetry object so heartbeat stall
            # events can embed it next to the span stack (obs.heartbeat)
            tel.last_queue_depth = depth
            age = self._snapshot.age_s()
            tel.event(
                "serve",
                family="|".join(sorted(families)),
                batch=len(batch),
                seconds=round(time.perf_counter() - t0, 6),
                step=int(snap.step),
                queue_depth=depth,
                **(
                    {"gen_age_s": round(age, 3)} if age is not None
                    else {}
                ),
                **{f"n_{k}": v for k, v in families.items()},
            )

    def _handle_suggests(
        self, snap: ServingSnapshot, reqs: List[Request]
    ) -> None:
        items = []
        live: List[Request] = []
        for req in reqs:
            q = req.payload
            try:
                if "neighbors" in q:
                    nbr = np.asarray(
                        [snap.row_of(int(v)) for v in q["neighbors"]],
                        np.int64,
                    )
                    row = (
                        snap.row_of(int(q["u"])) if "u" in q else None
                    )
                else:
                    row = snap.row_of(int(q["u"]))
                    indptr, indices = self._adjacency()
                    lo, hi = int(indptr[row]), int(indptr[row + 1])
                    if hi - lo > self._foldin_max_deg:
                        self._truncated_neighbors += 1
                        hi = lo + self._foldin_max_deg
                    nbr = indices[lo:hi].astype(np.int64)
                items.append((nbr, row))
                live.append(req)
            except Exception as e:   # noqa: BLE001 — per-query
                self._errors += 1
                req.future.set_result(
                    {"error": f"{type(e).__name__}: {e}"}
                )
        if not live:
            return
        if self._engine is None:
            self._engine = FoldInEngine(
                snap,
                max_iters=self._foldin_max_iters,
                conv_tol=self._foldin_conv_tol,
                device=self._device,
            )
        try:
            results = self._engine.suggest_batch(items)
        except Exception as e:   # noqa: BLE001 — whole sub-batch
            for req in live:
                self._errors += 1
                req.future.set_result(
                    {"error": f"{type(e).__name__}: {e}"}
                )
            return
        for req, res in zip(live, results):
            q = req.payload
            if "u" in q:
                res = {"u": int(q["u"]), **res}
            req.future.set_result(res)

    def _record_latencies(self, batch: List[Request]) -> None:
        now = time.perf_counter()
        for req in batch:
            fam = (
                req.payload.get("family")
                if isinstance(req.payload, dict) else None
            )
            lat = req.future.latency_s
            if fam in self._latencies and lat is not None:
                self._latencies[fam].append(lat)
            t_sub = req.future.t_submit
            if self._t_first is None or t_sub < self._t_first:
                self._t_first = t_sub
        if self._t_last is None or now > self._t_last:
            self._t_last = now

    # --------------------------------------------------------- stats
    def reset_stats(self) -> None:
        """Zero the latency/error/cache counters (gates warm the engine
        compile caches first, then measure a clean window; the snapshot,
        caches' CONTENTS, and compiled fold-in stay warm)."""
        self._batcher.drain()
        self._latencies = {f: [] for f in FAMILIES}
        self._errors = 0
        self._truncated_neighbors = 0
        self._t_first = self._t_last = None
        self._cache.hits = self._cache.misses = 0
        self._batcher.batches = 0
        self._batcher.flushed_full = 0
        self._batcher.flushed_deadline = 0
        self._batcher.shed_depth = 0
        self._batcher.shed_deadline = 0
        self._batcher.depth_peak = 0

    def stats(self) -> Dict[str, Any]:
        """The serving scoreboard `cli serve` stamps into the telemetry
        final: obs.ledger records serve_p99_s/serve_qps/cache_hit_rate
        per run and `cli perf diff` verdicts them (a p99 regression
        fails CI like a step-time regression would)."""
        lats = [v for fam in FAMILIES for v in self._latencies[fam]]
        total = len(lats)
        wall = (
            max(self._t_last - self._t_first, 1e-9)
            if self._t_first is not None and self._t_last is not None
            else 0.0
        )
        mix = "|".join(
            f"{fam}:{len(self._latencies[fam]) / total:.2f}"
            for fam in FAMILIES
            if self._latencies[fam]
        )
        out = {
            "serve_queries": total,
            "serve_errors": self._errors,
            "serve_by_family": {
                fam: len(self._latencies[fam])
                for fam in FAMILIES
                if self._latencies[fam]
            },
            "serve_mix": mix,
            "serve_p50_s": _percentile(lats, 50),
            "serve_p99_s": _percentile(lats, 99),
            "serve_qps": (total / wall) if wall else None,
            "cache_hit_rate": round(self._cache.hit_rate, 4),
            "snapshot_step": int(self._snapshot.step),
            "snapshot_swaps": self._swaps,
            "batches": self._batcher.batches,
            "batches_full": self._batcher.flushed_full,
            "batches_deadline": self._batcher.flushed_deadline,
            "foldin_truncated": self._truncated_neighbors,
            "serve_shed": self._batcher.shed,
            "serve_shed_rate": round(
                self._batcher.shed / (total + self._batcher.shed), 4
            ) if (total + self._batcher.shed) else 0.0,
            "queue_depth_peak": self._batcher.depth_peak,
        }
        age = self._snapshot.age_s()
        if age is not None:
            out["generation_age_s"] = round(age, 3)
        for key in ("serve_p50_s", "serve_p99_s", "serve_qps"):
            if out[key] is not None:
                out[key] = round(out[key], 6)
        return out
