# Copied from bigclam_tpu/serve/fleet.py (the replica's fold-in engine is the port's torch FoldInEngine on the replica's device).
"""The serving fleet's replica side.

A fleet generation is one `publish_fleet_snapshot` publication: per-shard
row-range archives plus a manifest (utils.checkpoint.publish_fleet_next —
the same exclusive-lock monotonic counter as single-archive publishes).
This module is the process that HOLDS one such shard:

  * `ShardReplica` — loads shard s of the latest fleet generation,
    answers the routed sub-query protocol (below), and can hold up to
    two generations at once so a fleet-wide rollout never drops an
    in-flight query: the router keeps pinning generation g until every
    replica of every shard reports g+1 loaded, then flips — queries
    pinned to g keep answering from the retained g snapshot.
  * `ReplicaServer` — a JSON-lines-over-TCP front (one request dict per
    line, one answer dict per line) feeding a RequestBatcher with
    admission control; every answer piggybacks the live queue `depth`
    so the router's pick-least-loaded dispatch needs no extra probe.
  * `LocalReplica` — the same `.request()` transport surface with no
    socket (unit tests and single-process drills); answers round-trip
    through json to enforce the wire contract.

Sub-query protocol (all answers echo `gen` — the generation that
actually answered, the router's mixed-generation tripwire):

  status                          -> shard, generations held, depth
  communities_of u gen            -> membership read, or {"not_owner"}
  members_of c gen                -> THIS shard's member raw ids (the
                                     router merges across shards)
  rows_of rows=[global rows] gen  -> dense K-vectors (fleet suggest's
                                     neighbor-row gather; global
                                     internal row ranges are disjoint
                                     by construction, so each row has
                                     exactly one owner)
  rows_of raw=[raw ids] gen       -> {raw id: K-vector} for ids this
                                     shard owns (probe semantics)
  suggest_for u gen               -> phase 1: the owner returns the
                                     neighbor GLOBAL row ids + its own
                                     row ({"needs_rows", "own_row"})
  suggest_rows ... gen            -> phase 2: fold-in over the
                                     router-gathered neighbor rows
                                     against the GLOBAL sumF — the only
                                     device op, lazy per
                                     generation

torch-free at import; FoldInEngine is built lazily on the first
suggest_rows of a generation (serve.server semantics, same engine), on
the replica's device.
"""

from __future__ import annotations

import json
import os
import socketserver
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from bigclam_tpu_torch.resilience.faults import apply_wire_fault, maybe_fire
from bigclam_tpu_torch.serve.batcher import (
    OverloadedError,
    Request,
    RequestBatcher,
)
from bigclam_tpu_torch.serve.server import HotCommunityCache
from bigclam_tpu_torch.serve.snapshot import (
    ServingSnapshot,
    SnapshotError,
    load_fleet_shard,
)
from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

# current + next: enough for a barrier-free rollout (queries pin at most
# one generation back), small enough that a replica's RAM is ~2 shards
MAX_HELD_GENERATIONS = 2


class ShardReplica:
    """One shard's query brain (see module docstring). Thread-safe:
    answer() may be called from many transport threads; generation
    installs swap immutable ServingSnapshot objects under a lock."""

    def __init__(
        self,
        snapshot_dir: str,
        shard: int,
        store=None,
        cache_slots: int = 64,
        foldin_max_iters: int = 200,
        foldin_conv_tol: Optional[float] = None,
        foldin_max_deg: int = 4096,
        watch_interval_s: float = 0.0,
        step: Optional[int] = None,
        device=None,
    ):
        from bigclam_tpu_torch.utils.device import resolve_device

        # the fold-in's device, resolved before anything loads: `cuda`
        # unless told otherwise, and no card raises DeviceUnavailableError
        self.device = resolve_device(device)
        self.snapshot_dir = snapshot_dir
        self.shard = int(shard)
        self._store = store
        self._cache_slots = int(cache_slots)
        self._foldin_max_iters = foldin_max_iters
        self._foldin_conv_tol = foldin_conv_tol
        self._foldin_max_deg = int(foldin_max_deg)
        self._lock = threading.RLock()
        self._gens: Dict[int, ServingSnapshot] = {}
        self._caches: Dict[int, HotCommunityCache] = {}
        self._engines: Dict[int, Any] = {}
        self._adj: Optional[Tuple[Tuple[int, int], Any]] = None
        self.queries = 0
        self.errors = 0
        self.truncated = 0
        self._install(load_fleet_shard(snapshot_dir, self.shard, step=step))
        self._watch_stop = threading.Event()
        self._watcher: Optional[threading.Thread] = None
        if watch_interval_s > 0:
            self._watcher = threading.Thread(
                target=self._watch_loop,
                args=(float(watch_interval_s),),
                name=f"bigclam-fleet-watch-s{self.shard}",
                daemon=True,
            )
            self._watcher.start()

    # ------------------------------------------------------ generations
    def _install(self, snap: ServingSnapshot) -> int:
        with self._lock:
            self._gens[snap.step] = snap
            cache = HotCommunityCache(self._cache_slots)
            cache.reset(snap)
            self._caches[snap.step] = cache
            while len(self._gens) > MAX_HELD_GENERATIONS:
                dead = min(self._gens)
                del self._gens[dead]
                self._caches.pop(dead, None)
                self._engines.pop(dead, None)
        return snap.step

    @property
    def generations(self) -> List[int]:
        with self._lock:
            return sorted(self._gens)

    def maybe_load_next(self) -> Optional[int]:
        """Load the newest published fleet generation if it is newer
        than everything held (the watcher's poll — never backward, same
        contract as MembershipServer.maybe_reload). Holding BOTH the
        old and new generation is the point: the router only flips once
        every replica holds the new one."""
        latest = CheckpointManager(self.snapshot_dir).latest_fleet()
        with self._lock:
            head = max(self._gens) if self._gens else -1
        if latest is None or latest <= head:
            return None
        return self._install(
            load_fleet_shard(self.snapshot_dir, self.shard, step=latest)
        )

    def _watch_loop(self, interval: float) -> None:
        while not self._watch_stop.wait(interval):
            try:
                self.maybe_load_next()
            except Exception:   # noqa: BLE001 — outlive torn publishes
                pass

    def close(self) -> None:
        self._watch_stop.set()
        if self._watcher is not None:
            self._watcher.join(timeout=10.0)
            self._watcher = None

    # -------------------------------------------------------- adjacency
    def _adjacency(self, snap: ServingSnapshot):
        """Local CSR over this shard's global row range [lo, lo+n) —
        cache shards covering the range, assembled once and reused
        across generations with the same range."""
        key = (snap.lo, snap.lo + snap.n)
        if self._adj is not None and self._adj[0] == key:
            return self._adj[1]
        if self._store is None:
            raise SnapshotError(
                "fleet suggest_for needs adjacency — start the replica "
                "with the graph store (`cli serve --fleet ... <cache>`)"
            )
        lo, hi = key
        S = self._store.num_shards
        first = next(
            s for s in range(S) if self._store.node_range(s)[1] > lo
        )
        last = (
            next(
                s for s in range(S - 1, -1, -1)
                if self._store.node_range(s)[0] < hi
            )
            + 1
        )
        hs = self._store.load_shard_range(first, last)
        if hs.lo > lo or hs.hi < hi:
            raise SnapshotError(
                f"cache shards [{first}, {last}) cover [{hs.lo}, {hs.hi}) "
                f"— does not contain the fleet shard range [{lo}, {hi})"
            )
        self._adj = (key, hs)
        return hs

    # ------------------------------------------------------------ reads
    @staticmethod
    def _dense_row(snap: ServingSnapshot, row: int) -> np.ndarray:
        if snap.representation == "dense":
            return np.asarray(snap.F[row, : snap.k], dtype=snap.sumF.dtype)
        r = np.zeros(snap.k, snap.sumF.dtype)
        valid = snap.ids[row] < snap.k
        r[snap.ids[row][valid].astype(np.int64)] = snap.w[row][valid]
        return r

    def _engine_for(self, snap: ServingSnapshot):
        with self._lock:
            eng = self._engines.get(snap.step)
            if eng is None:
                from bigclam_tpu_torch.serve.server import FoldInEngine

                eng = FoldInEngine(
                    snap,
                    max_iters=self._foldin_max_iters,
                    conv_tol=self._foldin_conv_tol,
                    device=self.device,
                )
                self._engines[snap.step] = eng
        return eng

    def status(self) -> Dict[str, Any]:
        with self._lock:
            steps = sorted(self._gens)
            head = self._gens[steps[-1]] if steps else None
        out = {
            "shard": self.shard,
            "generations": steps,
            "queries": self.queries,
            "errors": self.errors,
            "device": self.device.type,
        }
        if head is not None:
            out["lo"] = head.lo
            out["hi"] = head.lo + head.n
            age = head.age_s()
            if age is not None:
                out["gen_age_s"] = round(age, 3)
        return out

    # ---------------------------------------------------------- answer
    def answer(self, q: Dict[str, Any]) -> Dict[str, Any]:
        """One routed sub-query -> one answer dict; per-query failures
        come back as {"error": ...}, never exceptions (the transport
        thread and the batcher must outlive any bad query)."""
        self.queries += 1
        try:
            return self._answer(q if isinstance(q, dict) else {})
        except Exception as e:   # noqa: BLE001 — per-query isolation
            self.errors += 1
            return {"error": f"{type(e).__name__}: {e}"}

    def _answer(self, q: Dict[str, Any]) -> Dict[str, Any]:
        fam = q.get("family")
        if fam == "status":
            return self.status()
        with self._lock:
            gens = dict(self._gens)
        gen = q.get("gen")
        step = int(gen) if gen is not None else max(gens)
        snap = gens.get(step)
        if snap is None:
            # the router retries another replica that still holds the
            # pinned generation — this is a signal, not a failure
            return {"error": "unknown_generation", "gen": step}
        if fam == "communities_of":
            try:
                row = snap.row_of(int(q["u"]))
            except KeyError:
                return {"not_owner": True, "gen": step}
            cids, weights = snap.communities_of(row)
            return {
                "u": int(q["u"]),
                "communities": [
                    [int(c), float(v)] for c, v in zip(cids, weights)
                ],
                "gen": step,
            }
        if fam == "members_of":
            c = int(q["c"])
            cache = self._caches.get(step)
            members = cache.get(c) if cache is not None else None
            if members is None:
                members = snap.members_of(c)
                if cache is not None:
                    cache.put(c, members)
            return {
                "c": c,
                "members": [int(u) for u in members],
                "gen": step,
            }
        if fam == "rows_of":
            if "rows" in q:
                lo, hi = snap.lo, snap.lo + snap.n
                rows = []
                for g in q["rows"]:
                    g = int(g)
                    if not lo <= g < hi:
                        return {
                            "error": (
                                f"row {g} outside shard range [{lo}, {hi})"
                            ),
                            "gen": step,
                        }
                    rows.append(
                        [float(v) for v in self._dense_row(snap, g - lo)]
                    )
                return {"rows": rows, "gen": step}
            raw_rows = {}
            for u in q.get("raw", []):
                try:
                    row = snap.row_of(int(u))
                except KeyError:
                    continue
                raw_rows[str(int(u))] = [
                    float(v) for v in self._dense_row(snap, row)
                ]
            return {"raw_rows": raw_rows, "gen": step}
        if fam == "suggest_for":
            try:
                row = snap.row_of(int(q["u"]))
            except KeyError:
                return {"not_owner": True, "gen": step}
            hs = self._adjacency(snap)
            g = snap.lo + row
            a = int(hs.indptr[g - hs.lo])
            b = int(hs.indptr[g - hs.lo + 1])
            if b - a > self._foldin_max_deg:
                self.truncated += 1
                b = a + self._foldin_max_deg
            return {
                "u": int(q["u"]),
                # neighbor GLOBAL internal rows in CSR order — the
                # router gathers their dense rows by disjoint row range
                # and resends as suggest_rows (order preserved, so the
                # fold-in matches the single-process batch exactly)
                "needs_rows": [int(v) for v in hs.indices[a:b]],
                "own_row": [
                    float(v) for v in self._dense_row(snap, row)
                ],
                "gen": step,
            }
        if fam == "suggest_rows":
            engine = self._engine_for(snap)
            nbr = np.asarray(
                q.get("neighbor_rows", []), snap.sumF.dtype
            ).reshape(-1, snap.k)
            own = q.get("own_row")
            own_row = (
                np.asarray(own, snap.sumF.dtype) if own is not None
                else None
            )
            res = engine.suggest_batch_rows([(nbr, own_row)])[0]
            if "u" in q:
                res = {"u": int(q["u"]), **res}
            res["gen"] = step
            return res
        return {"error": f"unknown family {fam!r}"}


class LocalReplica:
    """In-process transport: the TcpReplica `.request()` surface with no
    socket. Answers round-trip through json so unit tests exercise the
    exact wire contract the TCP path serializes."""

    def __init__(self, replica: ShardReplica):
        self.replica = replica
        self.shard = replica.shard
        self.depth = 0

    def request(
        self,
        q: Dict[str, Any],
        timeout: Optional[float] = None,
        handle: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        traced = isinstance(q, dict) and q.get("trace")
        t0 = time.perf_counter()
        res = self.replica.answer(q)
        if traced and isinstance(res, dict):
            # no socket, no batcher: decode/queue/batch hops are zero
            # by construction, execute is the whole replica-side time —
            # the same compact hop block as ReplicaServer (integer
            # microseconds [decode, queue, batch_wait, execute,
            # replica]) so single-process tests exercise full trace
            # assembly
            us = int((time.perf_counter() - t0) * 1e6 + 0.5)
            res = dict(res)
            res["hops"] = [0, 0, 0, us, us]
        return json.loads(json.dumps(res))

    def cancel(self, handle: Dict[str, Any]) -> None:
        """No socket to shut down — hedged in-process losers just finish
        and get ignored (the TcpReplica surface, for hedging tests)."""
        handle["cancelled"] = True

    def close(self) -> None:
        pass


class ReplicaServer:
    """JSON-lines TCP front of one ShardReplica: one request dict per
    line in, one answer dict per line out, every answer piggybacking the
    live queue `depth`. Query ops flow through a RequestBatcher WITH
    admission control (serve.batcher watermarks) — an overload burst
    sheds fast `{"error": "overloaded"}` answers instead of growing an
    unbounded queue; `status`/`stop` bypass the batcher (health checks
    must answer even when the query queue is saturated).

    Distributed tracing : a sub-query carrying the router's
    `trace` marker gets a compact `hops` timing block on its answer —
    an integer-microsecond array [decode, queue, batch_wait, execute,
    replica]: decode (transport json decode), queue (deque wait until
    the batch flushed), batch_wait (intra-batch serialization behind
    batch-mates), execute (ShardReplica.answer), replica (receipt to
    answer, the wire-vs-replica split the router subtracts). Integers,
    not named floats: the block rides EVERY traced answer, and the
    tracing overhead pin (<2% of routed wall)
    is won or lost on wire bytes + float formatting — the router
    expands it to named `*_s` seconds at assembly. The block exists
    ONLY on traced requests: untraced answers are byte-identical to
    pre-trace builds (the off-path contract), and the router strips
    `hops` with the other transport fields before returning answers to
    callers.

    Fault injection: the BIGCLAM_QTRACE_FAULT
    env var — a JSON object {"hop": "execute"|"decode", "delay_s": X}
    — plants a delay into the named hop of THIS replica, so a drill
    can prove a planted slowdown is attributed to the right (shard,
    hop) and that a clean run attributes nothing."""

    def __init__(
        self,
        replica: ShardReplica,
        host: str = "127.0.0.1",
        port: int = 0,
        max_batch: int = 64,
        budget_s: float = 0.002,
        max_queue_depth: int = 0,
        shed_wait_s: float = 0.0,
    ):
        self.replica = replica
        # fleet-member identity (supervisor-assigned via env): fault
        # specs match on it, so a chaos drill can hit ONE slot of a
        # fleet that shares a single BIGCLAM_FAULTS env
        self.member = os.environ.get("BIGCLAM_FLEET_MEMBER", "")
        self._batcher = RequestBatcher(
            self._handle,
            max_batch=max_batch,
            budget_s=budget_s,
            max_depth=max_queue_depth,
            shed_wait_s=shed_wait_s,
        ).start()
        self._stopped = threading.Event()
        self._fault_hop = None
        self._fault_delay_s = 0.0
        fault = os.environ.get("BIGCLAM_QTRACE_FAULT")
        if fault:
            try:
                fobj = json.loads(fault)
                self._fault_hop = str(fobj.get("hop", "execute"))
                self._fault_delay_s = max(float(fobj.get("delay_s", 0.0)), 0.0)
            except (ValueError, TypeError):
                pass
        outer = self

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for line in self.rfile:
                    line = line.strip()
                    if not line:
                        continue
                    t_recv = time.perf_counter()
                    if outer._fault_hop == "decode" and outer._fault_delay_s:
                        time.sleep(outer._fault_delay_s)
                    q = None
                    try:
                        q = json.loads(line)
                    except ValueError:
                        res = {"error": "bad json"}
                    else:
                        res = outer._dispatch(
                            q,
                            t_recv=t_recv,
                            decode_s=time.perf_counter() - t_recv,
                        )
                    fam = q.get("family") if isinstance(q, dict) else None
                    payload = (json.dumps(res) + "\n").encode()
                    try:
                        wired = None
                        if fam not in ("status", "stop", "drain"):
                            # the wire-fault chokepoint : every
                            # QUERY answer frame passes here; control ops
                            # are exempt so health checks and teardown
                            # stay drillable under an active fault plan
                            spec = maybe_fire(
                                "replica.answer_write",
                                family=str(fam),
                                shard=outer.replica.shard,
                                member=outer.member,
                            )
                            if spec is not None:
                                wired = apply_wire_fault(
                                    spec, self.wfile, payload
                                )
                        if wired == "close":
                            return   # torn frame: hang up mid-answer
                        if wired != "skip":
                            self.wfile.write(payload)
                            self.wfile.flush()
                    except OSError:
                        return       # client went away mid-answer
                    if fam in ("stop", "drain"):
                        # shutdown AFTER the ack is flushed (and from a
                        # fresh thread — shutdown() deadlocks called
                        # from a handler): acking first is what keeps
                        # `route --stop` from racing the process exit
                        # and miscounting a clean stop as unreachable.
                        # drain and stop share the teardown: close()
                        # shuts the admission door, drains in-flight,
                        # then stops — the zero-drop part of a DRAIN is
                        # the protocol around it (the supervisor flips
                        # membership and waits the router-reload grace
                        # BEFORE sending this op).
                        threading.Thread(
                            target=outer.close, daemon=True
                        ).start()
                        return

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True
            # an overload burst churns router connections (pool-capped
            # clients reconnect constantly) — the default backlog of 5
            # turns that into SYN-retransmit latency spikes
            request_queue_size = 128

        self._srv = _Server((host, int(port)), _Handler)
        self.host, self.port = self._srv.server_address[:2]
        self._thread = threading.Thread(
            target=self._srv.serve_forever,
            name=f"bigclam-replica-s{replica.shard}",
            daemon=True,
        )
        self._thread.start()

    # --------------------------------------------------------- dispatch
    def _handle(self, batch: List[Request]) -> None:
        for req in batch:
            traced = (
                isinstance(req.payload, dict) and req.payload.get("trace")
            )
            if not traced:
                if self._fault_hop == "execute" and self._fault_delay_s:
                    time.sleep(self._fault_delay_s)
                req.future.set_result(self.replica.answer(req.payload))
                continue
            # execute hop + intra-batch serialization wait: this loop
            # runs the batch serially, so a request's batch_wait is the
            # gap between the batch being taken and ITS answer starting
            t0 = time.perf_counter()
            if self._fault_hop == "execute" and self._fault_delay_s:
                # inside the timed window: the planted fault must be
                # ATTRIBUTED to the execute hop, that is what a drill
                # proves
                time.sleep(self._fault_delay_s)
            res = self.replica.answer(req.payload)
            if isinstance(res, dict):
                taken = req.future.t_taken
                # seconds here; _dispatch converts the assembled block
                # to the compact integer-microsecond wire form
                res["hops"] = (
                    t0 - (taken if taken is not None else t0),
                    time.perf_counter() - t0,
                )
            req.future.set_result(res)

    def _dispatch(
        self,
        q: Dict[str, Any],
        t_recv: Optional[float] = None,
        decode_s: float = 0.0,
    ) -> Dict[str, Any]:
        fam = q.get("family") if isinstance(q, dict) else None
        if fam == "status":
            st = self.replica.status()
            st["depth"] = self._batcher.depth()
            st["shed"] = self._batcher.shed
            st["depth_peak"] = self._batcher.depth_peak
            if self._batcher.draining:
                st["draining"] = True
            return st
        if fam == "stop":
            # the HANDLER schedules close() after flushing this ack
            return {"ok": True}
        if fam == "drain":
            # same teardown as stop (the handler schedules close());
            # the distinct op exists so the supervisor's drain protocol
            # reads as intent on the wire and in logs
            return {"ok": True, "draining": True}
        fut = None
        try:
            fut = self._batcher.submit(q)
            res = fut.result(60.0)
        except OverloadedError:
            res = {"error": "overloaded"}
        except Exception as e:   # noqa: BLE001 — transport must live
            res = {"error": f"{type(e).__name__}: {e}"}
        if isinstance(res, dict):
            res.setdefault("depth", self._batcher.depth())
            if isinstance(q, dict) and q.get("trace"):
                bw, ex = res.pop("hops", None) or (0.0, 0.0)
                queue_s = (
                    fut.t_taken - fut.t_submit
                    if fut is not None and fut.t_taken is not None
                    else 0.0
                )
                replica_s = (
                    time.perf_counter() - t_recv
                    if t_recv is not None else 0.0
                )
                # compact wire form: integer microseconds
                # [decode, queue, batch_wait, execute, replica]
                res["hops"] = [
                    int(decode_s * 1e6 + 0.5),
                    int(queue_s * 1e6 + 0.5),
                    int(bw * 1e6 + 0.5),
                    int(ex * 1e6 + 0.5),
                    int(replica_s * 1e6 + 0.5),
                ]
        return res

    # -------------------------------------------------------- lifecycle
    def serve_until_stopped(
        self, timeout: Optional[float] = None
    ) -> bool:
        """Block until a `stop` op arrives (the replica-process main
        loop of `cli serve --fleet --listen`)."""
        return self._stopped.wait(timeout)

    def close(self) -> None:
        if self._stopped.is_set():
            return
        self._stopped.set()
        self._srv.shutdown()
        self._srv.server_close()
        # graceful order : door first (late submits shed fast
        # instead of hanging), drain what was admitted (zero drops),
        # THEN stop — stop() alone fail-fasts queued futures with
        # BatcherStopped, which is the crash path, not this one
        self._batcher.close_door()
        try:
            self._batcher.drain(timeout=30.0)
        except TimeoutError:
            pass
        self._batcher.stop()
        self.replica.close()
