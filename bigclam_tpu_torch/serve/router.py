# Copied from bigclam_tpu/serve/router.py (standard library and numpy only).
"""The serving fleet's query router.

`FleetRouter` fronts N replicas × S shards of a published fleet
generation (serve.fleet protocol) and answers the same three query
families as the single-process MembershipServer, with the same answer
shapes:

  * communities_of / suggest_for route BY NODE from the manifest's
    raw-id range map: disjoint raw intervals (unpermuted cache) resolve
    with one bisect; overlapping intervals (balanced/permuted cache)
    probe every containing shard and the owner answers (`not_owner`
    elsewhere);
  * members_of scatter-gathers every shard's local inverted index and
    merges with np.unique — ascending raw-id dedup, which IS the
    single-process sorted-by-raw-id contract (each node lives in
    exactly one shard, so the union is the full member list);
  * suggest_for is two-phase: the owner returns its neighbors' GLOBAL
    internal rows (phase 1), the router gathers their dense rows by
    DISJOINT row range across shards (order preserved), and the owner
    folds in against the global sumF (phase 2) — bit-for-bit the
    single-process batch math, different addressing.

Replica choice is pick-least-loaded over health-checked replicas: every
fleet answer piggybacks the replica's live queue depth, and `refresh()`
(the health poll) re-reads status from everyone.

Barrier-free rollout: the router serves generation g until EVERY
healthy replica of EVERY shard reports g+1 loaded (intersection of
generation sets), then flips — and never backward. Each query captures
the serving generation at submit and pins every sub-query to it;
replicas echo the generation that answered, so a mixed-generation
answer is a counted tripwire (`mixed_generation`, asserted zero by
the fleet tests), not a silent wrong answer. A shard one
generation behind simply keeps the whole fleet pinned at g — correct,
not an error (tests/test_torch_fleet.py).

Distributed query tracing : with telemetry installed, every
routed query opens a trace — the router stamps a `trace` marker on each
sub-query, replicas echo a per-hop timing block (serve.fleet), and the
router assembles the cross-process decomposition. Sub-sends within one
route() call are SEQUENTIAL, so the identity

    total_s = sum(wire_s over hops) + merge_s

holds exactly (merge_s is router-side work: bucketing, np.unique, the
fold-in row gather bookkeeping), and each hop's wire_s further splits
into transport_s (wire minus replica receipt-to-answer) + decode_s +
queue_s + batch_wait_s + execute_s. Per-hop means aggregate fleet-wide
and per-shard into stats() (the perf ledger verdicts them — "the
router got slower" and "shard 3 got slower" are different regressions),
the slowest TRACE_TOP traces per TRACE_WINDOW completed queries are
emitted as schema'd `qtrace` exemplar events, and `freshness` events
sample generation age (ROADMAP 3a). Tracing is off-path-free: with no
telemetry installed no marker is stamped, replicas attach nothing, and
answers are bit-identical to an untraced run.

Self-healing : the router is also a long-lived tier.
`RouterServer` (`cli route --daemon`) serves route() over the same
newline-framed JSON wire; each query gets an optional wall DEADLINE,
idempotent read sub-queries get bounded refresh+retry rounds after a
whole replica set fails (the window in which the FleetSupervisor
restarts a kill -9'd replica — the client sees a retried answer, not an
error), and optional tail-latency HEDGING duplicates a slow read to a
second replica after a p99-derived delay (winner counted, loser's
socket shut down). With `members_file` the endpoint set is a watched
membership document (supervisor-published, serve.supervise): refresh()
reconciles it, so add-replica and drain work mid-stream with zero
drops. Counters: router_retries / hedged / hedge_wins /
deadline_exceeded / membership_reloads, rate-verdicted in the perf
ledger. For hedged queries the sequential trace identity above becomes
an inequality (two hops overlap in time); hedged hops are marked.

Standard library and numpy only: routing is bisect + np.unique; the
device work stays on the replicas.
"""

from __future__ import annotations

import json
import queue as _queuemod
import socket
import socketserver
import threading
import time
from bisect import bisect_right
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from heapq import heappush, heappushpop
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from bigclam_tpu_torch.obs import telemetry as _obs
from bigclam_tpu_torch.obs.ledger import _percentile
from bigclam_tpu_torch.obs.trace import new_trace_id
from bigclam_tpu_torch.resilience.faults import maybe_fire
from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

FAMILIES = ("communities_of", "members_of", "suggest_for")

# sub-query families the router may RE-dispatch after every replica of a
# shard failed (a refresh + bounded retry round) and may HEDGE: the
# idempotent cheap reads. suggest_rows — the fold-in execute — is
# excluded on purpose: duplicating device work amplifies exactly the
# overload that makes replicas slow, and the transport failover (send
# failed, no work started) already covers it (DESIGN.md "Fleet failure
# model").
_RETRY_FAMILIES = frozenset(
    ("communities_of", "members_of", "rows_of", "suggest_for")
)

# rolling window of sub-query wire latencies feeding the p99-derived
# hedge delay (bounded: old samples age out under any load)
_WIRE_WINDOW = 512

# slow-query exemplar log: keep the TRACE_TOP slowest traces per
# TRACE_WINDOW completed traced queries, emit them as `qtrace` events,
# reset — bounded event volume under any load
TRACE_WINDOW = 1000
TRACE_TOP = 5

# replica-echoed hop fields (serve.fleet) + the router-derived transport
# split, in decomposition order; `merge` (router-side) joins them in the
# fleet-wide accumulators
_HOP_NAMES = ("transport", "decode", "queue", "batch_wait", "execute")


class RouterError(RuntimeError):
    """No serving generation, or no healthy replica for a shard."""


class _Shed(Exception):
    """A sub-query was shed by replica admission control — the whole
    routed query degrades to one fast {"error": "overloaded"} answer."""


class _DeadlineExceeded(Exception):
    """The per-query deadline ran out mid-route — the whole query
    degrades to one {"error": "deadline_exceeded"} answer (counted;
    the ledger verdicts the rate)."""


class TcpReplica:
    """Client transport to one ReplicaServer endpoint: persistent
    JSON-lines connections (a small pool, so concurrent router workers
    don't serialize on one socket). On an I/O error — including a TORN
    answer frame (peer killed mid-write) or a garbage line — the
    connection is dropped and the request retried once on a fresh one; a
    second failure propagates (the router marks the endpoint unhealthy).
    A read TIMEOUT is different: the socket is closed and TimeoutError
    raised immediately — a stalled replica costs at most one timeout,
    never a blind same-budget retry .

    Hedging support: pass a `handle` dict and the in-flight connection
    is tracked in it; `cancel(handle)` shutdown()s that socket, which
    reliably wakes a blocked recv so a hedge loser stops consuming a
    connection the moment the winner answers."""

    def __init__(
        self, host: str, port: int, timeout_s: float = 60.0, pool: int = 4
    ):
        self.host = host
        self.port = int(port)
        self.timeout_s = float(timeout_s)
        self.shard: Optional[int] = None   # filled by router discovery
        self.depth = 0
        self._pool: List[Any] = []
        self._pool_lock = threading.Lock()
        self._pool_max = max(int(pool), 1)
        self._closed = False

    def _connect(self):
        spec = maybe_fire(
            "wire.connect", endpoint=f"{self.host}:{self.port}"
        )
        if spec is not None and spec.get("kind") == "connect_refuse":
            raise ConnectionRefusedError(
                f"injected connect_refuse to {self.host}:{self.port}"
            )
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout_s
        )
        return (sock, sock.makefile("rb"))

    def _acquire(self):
        with self._pool_lock:
            if self._pool:
                return self._pool.pop()
        return self._connect()

    def _release(self, conn) -> None:
        with self._pool_lock:
            if not self._closed and len(self._pool) < self._pool_max:
                self._pool.append(conn)
                return
        self._discard(conn)

    @staticmethod
    def _discard(conn) -> None:
        try:
            conn[1].close()
            conn[0].close()
        except OSError:
            pass

    def _handle_set(self, handle, conn) -> None:
        if handle is not None:
            with self._pool_lock:
                handle["conn"] = conn

    def request(
        self,
        q: Dict[str, Any],
        timeout: Optional[float] = None,
        handle: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        payload = (json.dumps(q) + "\n").encode()
        budget = timeout if timeout is not None else self.timeout_s
        last: Optional[BaseException] = None
        for attempt in range(2):
            if handle is not None and handle.get("cancelled"):
                raise ConnectionError("request cancelled (hedge loser)")
            conn = None
            try:
                conn = self._acquire()
                sock, rfile = conn
                sock.settimeout(budget)
                self._handle_set(handle, conn)
                sock.sendall(payload)
                line = rfile.readline()
                if not line:
                    raise ConnectionError("replica closed the connection")
                if not line.endswith(b"\n"):
                    # torn frame: the peer died mid-write (or the read
                    # was cancelled) — never hand a partial frame to the
                    # json decoder as if it were an answer
                    raise ConnectionError("torn answer frame")
                # parse BEFORE releasing: a garbage line must discard
                # this connection, never park it back in the pool
                res = json.loads(line)
                self._handle_set(handle, None)
                self._release(conn)
                return res
            except socket.timeout as e:
                # bounded read: close the wedged socket and surface the
                # timeout NOW — the caller (router) owns the deadline
                # and decides whether another replica gets a try
                self._handle_set(handle, None)
                if conn is not None:
                    self._discard(conn)
                raise TimeoutError(
                    f"replica {self.host}:{self.port} timed out "
                    f"after {budget:.3f}s"
                ) from e
            except (OSError, ValueError, ConnectionError) as e:
                last = e
                self._handle_set(handle, None)
                if conn is not None:
                    self._discard(conn)
        raise ConnectionError(
            f"replica {self.host}:{self.port} unreachable: {last}"
        )

    def cancel(self, handle: Dict[str, Any]) -> None:
        """Wake a blocked hedge-loser read NOW: shutdown() the in-flight
        socket (a plain close() does not reliably interrupt a blocked
        recv; shutdown does)."""
        with self._pool_lock:
            handle["cancelled"] = True
            conn = handle.get("conn")
        if conn is not None:
            try:
                conn[0].shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def close(self) -> None:
        with self._pool_lock:
            self._closed = True
            pool, self._pool = self._pool, []
        for conn in pool:
            self._discard(conn)


class FleetRouter:
    """See module docstring. Transports need `.request(dict) -> dict`,
    `.shard` (set by discovery from their status answer), and `.depth`
    (updated from piggybacked answers) — TcpReplica and
    serve.fleet.LocalReplica both qualify."""

    def __init__(
        self,
        directory: str,
        endpoints: Sequence[Any] = (),
        max_workers: int = 16,
        health_interval_s: float = 0.0,
        request_timeout_s: float = 60.0,
        deadline_s: float = 0.0,
        retry_rounds: int = 1,
        hedge: bool = False,
        hedge_delay_s: float = 0.0,
        hedge_min_samples: int = 64,
        members_file: Optional[str] = None,
    ):
        self.directory = directory
        self._cm = CheckpointManager(directory)
        self.endpoints = list(endpoints)
        self.request_timeout_s = float(request_timeout_s)
        # --- fleet self-healing knobs (module docstring) ---
        # deadline_s: per-query wall budget (0 = off); retry_rounds: how
        # many refresh+re-dispatch rounds a read sub-query gets after
        # EVERY replica of its shard failed (the window in which the
        # supervisor restarts a kill -9'd replica); hedge: duplicate a
        # slow read sub-query to a second replica after hedge_delay_s
        # (0 = derive from the rolling wire p99 once hedge_min_samples
        # accumulated), first answer wins, loser cancelled.
        self._deadline_s = max(float(deadline_s), 0.0)
        self._retry_rounds = max(int(retry_rounds), 0)
        self._hedge = bool(hedge)
        self._hedge_delay_s = max(float(hedge_delay_s), 0.0)
        self._hedge_min_samples = max(int(hedge_min_samples), 1)
        self._hedge_pool: Optional[ThreadPoolExecutor] = None
        self._wire_window: deque = deque(maxlen=_WIRE_WINDOW)
        self._members_file = members_file
        self._membership_seq: Optional[int] = None
        self.membership_reloads = 0
        self.retried = 0
        self.hedged = 0
        self.hedge_wins = 0
        self.deadline_exceeded = 0
        self._deadline_local = threading.local()
        self._tables: Dict[int, Dict[str, Any]] = {}
        self._by_shard: Dict[int, List[Any]] = {}
        self._down: set = set()
        self._serving: Optional[int] = None
        self._lock = threading.Lock()
        self._latencies: Dict[str, List[float]] = {
            f: [] for f in FAMILIES
        }
        self._shard_lat: Dict[int, List[float]] = {}
        self._errors = 0
        self._shed = 0
        self.mixed_generation = 0
        # failover tripwires : how often a sub-query
        # moved past a replica because its transport failed vs because it
        # had pruned the pinned generation — surfaced in stats()/report
        # instead of dying as a local error string
        self.pruned_generation = 0
        self.transport_failovers = 0
        self.rollouts = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        # --- distributed query tracing (module docstring) ---
        self._trace_local = threading.local()   # per-thread open trace
        self._inflight: Dict[str, float] = {}   # trace_id -> t0 (perf)
        self._traced = 0
        self._hop_sum: Dict[str, float] = {}
        self._hop_n: Dict[str, int] = {}
        self._shard_hops: Dict[int, Dict[str, List[float]]] = {}
        self._trace_heap: List[Any] = []        # (total_s, seq, record)
        self._trace_seq = 0
        self._trace_seen = 0                    # window fill counter
        self._pool = ThreadPoolExecutor(
            max_workers=max(int(max_workers), 1),
            thread_name_prefix="bigclam-route",
        )
        self.refresh()
        if self._serving is None:
            raise RouterError(
                f"{directory}: no common generation across healthy "
                "replicas — is the fleet up?"
            )
        self._health_stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        if health_interval_s > 0:
            self._health_thread = threading.Thread(
                target=self._health_loop,
                args=(float(health_interval_s),),
                name="bigclam-route-health",
                daemon=True,
            )
            self._health_thread.start()

    # ------------------------------------------------------ range table
    def _table(self, step: int) -> Dict[str, Any]:
        t = self._tables.get(step)
        if t is not None:
            return t
        man = self._cm.load_fleet_manifest(step)
        if man is None:
            raise RouterError(
                f"{self.directory}: fleet manifest for generation "
                f"{step} is unreadable"
            )
        entries = sorted(man["shards"], key=lambda e: int(e["lo"]))
        raw_sorted = sorted(
            entries, key=lambda e: int(e.get("raw_lo", 0))
        )
        disjoint = all(
            int(raw_sorted[i]["raw_hi"])
            < int(raw_sorted[i + 1]["raw_lo"])
            for i in range(len(raw_sorted) - 1)
        )
        t = {
            "row_lo": [int(e["lo"]) for e in entries],
            "row_shard": [int(e["shard"]) for e in entries],
            "shard_ids": [int(e["shard"]) for e in man["shards"]],
            "raw_lo": [int(e.get("raw_lo", 0)) for e in raw_sorted],
            "raw_hi": [int(e.get("raw_hi", -1)) for e in raw_sorted],
            "raw_shard": [int(e["shard"]) for e in raw_sorted],
            "raw_disjoint": disjoint,
            "published_ts": man.get("published_ts"),
        }
        self._tables[step] = t
        return t

    def _owners_of_raw(self, u: int, step: int) -> List[int]:
        """Shards that may own raw id u: one (bisect) when the raw-id
        intervals are disjoint, every containing interval otherwise."""
        t = self._table(step)
        if t["raw_disjoint"]:
            i = bisect_right(t["raw_lo"], u) - 1
            if i >= 0 and u <= t["raw_hi"][i]:
                return [t["raw_shard"][i]]
            return []
        hits = [
            s
            for lo, hi, s in zip(
                t["raw_lo"], t["raw_hi"], t["raw_shard"]
            )
            if lo <= u <= hi
        ]
        return hits or list(t["shard_ids"])

    def _shard_of_row(self, g: int, step: int) -> int:
        t = self._table(step)
        i = bisect_right(t["row_lo"], g) - 1
        return t["row_shard"][max(i, 0)]

    # --------------------------------------------------- health/rollout
    def _reload_membership(self) -> None:
        """Re-read the watched membership file (supervisor-published,
        atomic tmp+rename) and reconcile the endpoint set: members in
        state "up" are admitted (existing TcpReplica objects — and their
        warm connection pools — are kept by endpoint), everything else
        (draining/quarantined/removed) is dropped and closed. A torn or
        missing file keeps the current set: membership only ever moves
        on a complete document."""
        try:
            with open(self._members_file) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return
        seq = doc.get("seq")
        if seq is not None and seq == self._membership_seq:
            return
        want: Dict[str, dict] = {}
        for m in doc.get("members", []):
            ep = m.get("endpoint")
            if ep and m.get("state") == "up":
                want[str(ep)] = m
        have = {
            f"{t.host}:{t.port}": t
            for t in self.endpoints
            if isinstance(t, TcpReplica)
        }
        if set(want) != set(have):
            new_eps: List[Any] = []
            for ep in want:
                t = have.get(ep)
                if t is None:
                    host, port = ep.rsplit(":", 1)
                    t = TcpReplica(
                        host, int(port), timeout_s=self.request_timeout_s
                    )
                new_eps.append(t)
            dropped = [t for ep, t in have.items() if ep not in want]
            with self._lock:
                self.endpoints = new_eps
            for t in dropped:
                # idle pooled connections close here; a sub-query already
                # in flight on this transport holds its connection checked
                # out and completes — that is the zero-drop half the
                # router owns during a drain
                try:
                    t.close()
                except Exception:   # noqa: BLE001 — best effort
                    pass
            self.membership_reloads += 1
            tel = _obs.current()
            if tel is not None:
                tel.event(
                    "membership",
                    seq=int(seq or 0),
                    members=len(new_eps),
                )
        self._membership_seq = seq

    def refresh(self) -> Optional[int]:
        """Health-check every endpoint, rebuild the per-shard replica
        sets, and advance the serving generation iff every healthy
        replica of every shard holds a newer common one. Never moves
        backward. With a membership file the endpoint set itself is
        reconciled first (elastic membership)."""
        if self._members_file:
            self._reload_membership()
        by_shard: Dict[int, List[Any]] = {}
        common: Optional[set] = None
        down = set()
        for t in self.endpoints:
            try:
                st = t.request({"family": "status"}, timeout=10.0)
            except Exception:   # noqa: BLE001 — endpoint down
                down.add(id(t))
                continue
            t.shard = int(st.get("shard", -1))
            t.depth = int(st.get("depth", 0))
            by_shard.setdefault(t.shard, []).append(t)
            gens = set(int(g) for g in st.get("generations", []))
            common = gens if common is None else (common & gens)
        with self._lock:
            self._by_shard = by_shard
            self._down = down
            if common:
                cand = max(common)
                if self._serving is None or cand > self._serving:
                    previous = self._serving
                    self._serving = cand
                    if previous is not None:
                        self.rollouts += 1
                        tel = _obs.current()
                        if tel is not None:
                            tel.event("rollout", step=int(cand))
        self._emit_freshness()
        return self._serving

    def _health_loop(self, interval: float) -> None:
        while not self._health_stop.wait(interval):
            try:
                self.refresh()
            except Exception:   # noqa: BLE001 — poller must live
                pass

    @property
    def serving_generation(self) -> Optional[int]:
        return self._serving

    def generation_age_s(self) -> Optional[float]:
        if self._serving is None:
            return None
        ts = self._table(self._serving).get("published_ts")
        if not isinstance(ts, (int, float)):
            return None
        return max(time.time() - float(ts), 0.0)

    def _emit_freshness(self) -> None:
        """One schema'd `freshness` sample — serving staleness (ROADMAP
        3a) as an event stream instead of a number that dies with the
        process. Emitted at every refresh and after each run_queries
        batch; no-op without telemetry."""
        tel = _obs.current()
        if tel is None or self._serving is None:
            return
        age = self.generation_age_s()
        if age is None:
            return
        tel.event(
            "freshness",
            generation_age_s=round(age, 3),
            step=int(self._serving),
            rollouts=int(self.rollouts),
        )

    # --------------------------------------------------------- dispatch
    def _deadline(self) -> Optional[float]:
        return getattr(self._deadline_local, "t", None)

    @staticmethod
    def _check_deadline(deadline: Optional[float]) -> None:
        if deadline is not None and time.perf_counter() >= deadline:
            raise _DeadlineExceeded()

    def _remaining(
        self, deadline: Optional[float], slack: float = 2.0
    ) -> float:
        """Wall budget left for waiting on an in-flight attempt: the
        attempt's own socket timeout plus slack when no deadline is set,
        else the remaining deadline plus slack (the attempt thread is
        itself bounded — the slack only covers its return)."""
        if deadline is None:
            return self.request_timeout_s + slack
        rem = deadline - time.perf_counter()
        if rem <= 0:
            raise _DeadlineExceeded()
        return rem + slack

    def _attempt(
        self,
        t: Any,
        shard: int,
        q: Dict[str, Any],
        deadline: Optional[float],
        tr: Optional[Dict[str, Any]],
        handle: Optional[Dict[str, Any]] = None,
        hedged: bool = False,
    ) -> Tuple[str, Any]:
        """One sub-query to one replica, bounded by min(request timeout,
        remaining deadline). Returns ("ok", answer), ("fail", why) — a
        transport failure, replica marked down — or ("skip", why) — a
        live replica that cannot serve this query (pruned generation,
        malformed answer)."""
        timeout = self.request_timeout_s
        if deadline is not None:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                raise _DeadlineExceeded()
            timeout = min(timeout, remaining)
        t0 = time.perf_counter()
        try:
            if handle is not None:
                res = t.request(q, timeout=timeout, handle=handle)
            else:
                res = t.request(q, timeout=timeout)
        except Exception as e:   # noqa: BLE001 — fail over
            if handle is not None and handle.get("cancelled"):
                # a hedge loser dying AFTER cancellation is the plan
                # working, not a sick replica — no down-mark, no counter
                return "cancelled", f"{type(e).__name__}: {e}"
            self.transport_failovers += 1
            with self._lock:
                self._down.add(id(t))
                if t in self._by_shard.get(shard, ()):
                    self._by_shard[shard].remove(t)
            return "fail", f"{type(e).__name__}: {e}"
        wire_s = time.perf_counter() - t0
        self._shard_lat.setdefault(shard, []).append(wire_s)
        self._wire_window.append(wire_s)
        if not isinstance(res, dict):
            return "skip", f"non-dict answer {type(res).__name__}"
        t.depth = int(res.get("depth", getattr(t, "depth", 0)))
        if res.get("error") == "unknown_generation":
            self.pruned_generation += 1
            return "skip", f"replica pruned generation {q.get('gen')}"
        pin = q.get("gen")
        if (
            pin is not None
            and "gen" in res
            and int(res["gen"]) != int(pin)
        ):
            # the tripwire the fleet tests assert ZERO on — an answer
            # from a generation the query was not pinned to
            self.mixed_generation += 1
        if tr is not None:
            hop: Dict[str, Any] = {
                "shard": int(shard), "wire_s": wire_s,
            }
            if hedged:
                hop["hedged"] = 1
            hb = res.get("hops")
            if isinstance(hb, (list, tuple)) and len(hb) == 5:
                # compact wire form (see serve.fleet): integer
                # microseconds [decode, queue, batch_wait, execute,
                # replica] — expanded to named float seconds here so
                # only the hot wire path pays for compactness
                hop["decode_s"] = hb[0] / 1e6
                hop["queue_s"] = hb[1] / 1e6
                hop["batch_wait_s"] = hb[2] / 1e6
                hop["execute_s"] = hb[3] / 1e6
                rs = hb[4] / 1e6
                hop["replica_s"] = rs
                # wire time the replica never saw: connect +
                # serialize + kernel/network transit
                hop["transport_s"] = max(wire_s - rs, 0.0)
            tr["hops"].append(hop)
        return "ok", res

    def _hedge_delay(self) -> Optional[float]:
        """The delay before duplicating a read sub-query: explicit when
        configured, else the p99 of the rolling wire-latency window —
        None (no hedge) until enough samples exist to derive one."""
        if self._hedge_delay_s > 0:
            return self._hedge_delay_s
        if len(self._wire_window) < self._hedge_min_samples:
            return None
        p99 = _percentile(list(self._wire_window), 99)
        return max(float(p99), 1e-3) if p99 is not None else None

    def _hedge_pool_get(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._hedge_pool is None:
                self._hedge_pool = ThreadPoolExecutor(
                    max_workers=32,
                    thread_name_prefix="bigclam-route-hedge",
                )
            return self._hedge_pool

    def _request_hedged(
        self,
        primary: Any,
        secondary: Any,
        q: Dict[str, Any],
        deadline: Optional[float],
        shard: int,
        tr: Optional[Dict[str, Any]],
        delay: float,
    ) -> Tuple[Optional[Dict[str, Any]], int, Optional[str]]:
        """Tail-latency hedging: dispatch to the primary; if no answer
        within `delay`, duplicate to the secondary and take whichever
        answers first, cancelling the loser (its socket is shut down so
        it stops consuming a connection). A primary that FAILS before
        the delay fast-forwards to the secondary — that is plain
        failover, only the duplicate-while-in-flight counts as hedged."""
        outq: "_queuemod.Queue" = _queuemod.Queue()
        handles = ({"cancelled": False}, {"cancelled": False})
        transports = (primary, secondary)

        def run(idx: int) -> None:
            try:
                kind, val = self._attempt(
                    transports[idx], shard, q, deadline, tr,
                    handle=handles[idx], hedged=bool(idx),
                )
            except _DeadlineExceeded:
                kind, val = "fail", "deadline exceeded"
            except Exception as e:   # noqa: BLE001 — thread must return
                kind, val = "fail", f"{type(e).__name__}: {e}"
            outq.put((idx, kind, val))

        pool = self._hedge_pool_get()
        pool.submit(run, 0)
        launched = 1
        pending = 1
        failures = 0
        last: Optional[str] = None
        wait = delay
        while pending:
            try:
                idx, kind, val = outq.get(timeout=wait)
            except _queuemod.Empty:
                if launched == 1:
                    self.hedged += 1
                    pool.submit(run, 1)
                    launched = 2
                    pending += 1
                    wait = self._remaining(deadline)
                    continue
                # both bounded attempts in flight past their budget —
                # only a blown deadline can get here
                raise _DeadlineExceeded()
            pending -= 1
            if kind == "ok":
                if launched == 2 and idx == 1:
                    self.hedge_wins += 1
                loser = 1 - idx
                if loser < launched:
                    handles[loser]["cancelled"] = True
                    cancel = getattr(transports[loser], "cancel", None)
                    if cancel is not None:
                        try:
                            cancel(handles[loser])
                        except Exception:   # noqa: BLE001 — best effort
                            pass
                return val, failures, None
            if kind == "fail":
                failures += 1
            last = val
            if launched == 1:
                # primary failed before the hedge delay: straight to
                # the secondary (failover, not a hedge)
                pool.submit(run, 1)
                launched = 2
                pending += 1
            wait = self._remaining(deadline)
        return None, failures, last

    def _send_once(
        self,
        shard: int,
        q: Dict[str, Any],
        deadline: Optional[float],
        tr: Optional[Dict[str, Any]],
    ) -> Tuple[Optional[Dict[str, Any]], int, Optional[str]]:
        """One pass over the shard's healthy replicas, least-loaded
        first (with an optional hedged first attempt). Returns (answer,
        transport-failure count, last failure reason)."""
        with self._lock:
            reps = list(self._by_shard.get(shard, ()))
        if not reps:
            return None, 0, f"no healthy replica for shard {shard}"
        reps.sort(key=lambda r: getattr(r, "depth", 0))
        failures = 0
        last: Optional[str] = None
        start = 0
        if (
            self._hedge
            and len(reps) >= 2
            and q.get("family") in _RETRY_FAMILIES
        ):
            delay = self._hedge_delay()
            if delay is not None:
                res, nfail, why = self._request_hedged(
                    reps[0], reps[1], q, deadline, shard, tr, delay
                )
                failures += nfail
                if res is not None:
                    return res, failures, None
                last = why
                start = 2
        for t in reps[start:]:
            self._check_deadline(deadline)
            kind, val = self._attempt(t, shard, q, deadline, tr)
            if kind == "ok":
                return val, failures, None
            if kind == "fail":
                failures += 1
            last = val
        return None, failures, last

    def _send(
        self, shard: int, q: Dict[str, Any]
    ) -> Dict[str, Any]:
        """One sub-query to the least-loaded healthy replica of a shard;
        a transport failure or an unknown_generation answer (the replica
        pruned the pinned generation) fails over to the next replica.
        When EVERY replica of the shard fails, idempotent read families
        get `retry_rounds` refresh+re-dispatch rounds (bounded by the
        query deadline) — the window in which a supervisor restart or a
        membership change heals the fleet; a sub-query that answers
        after any failure increments `retried` (a kill -9 mid-query
        surfaces as a retried answer, not a client error)."""
        deadline = self._deadline()
        fam = q.get("family")
        rounds = 1 + (
            self._retry_rounds if fam in _RETRY_FAMILIES else 0
        )
        tr = getattr(self._trace_local, "tr", None)
        if tr is not None:
            # stamp the trace marker at the ONE place every sub-query
            # passes through — replicas echo a `hops` block only when
            # they see it (off-path contract: untraced wire answers are
            # byte-identical to pre-trace builds)
            q = dict(q)
            q["trace"] = 1
        failures = 0
        last: Optional[str] = None
        for rnd in range(rounds):
            if rnd:
                # the whole replica set failed: one bounded chance for
                # the fleet to heal before the query errors — re-read
                # membership + health, small backoff within the deadline
                self._check_deadline(deadline)
                time.sleep(min(0.05 * rnd, 0.25))
                try:
                    self.refresh()
                except Exception:   # noqa: BLE001 — retry is best effort
                    pass
            res, nfail, why = self._send_once(shard, q, deadline, tr)
            failures += nfail
            if res is not None:
                if failures or rnd:
                    self.retried += 1
                    if tr is not None and tr["hops"]:
                        tr["hops"][-1]["retried"] = max(failures, 1)
                return res
            last = why
        raise RouterError(
            f"every replica of shard {shard} failed: {last}"
        )

    @staticmethod
    def _strip(res: Dict[str, Any]) -> Dict[str, Any]:
        return {
            k: v for k, v in res.items()
            if k not in ("gen", "depth", "cached", "not_owner", "hops")
        }

    def _route_communities(
        self, q: Dict[str, Any], gen: int
    ) -> Dict[str, Any]:
        u = int(q["u"])
        for s in self._owners_of_raw(u, gen):
            res = self._send(
                s, {"family": "communities_of", "u": u, "gen": gen}
            )
            if not res.get("not_owner"):
                return self._strip(res)
        return {"error": f"KeyError: 'unknown node id {u}'"}

    def _route_members(
        self, q: Dict[str, Any], gen: int
    ) -> Dict[str, Any]:
        c = int(q["c"])
        parts: List[np.ndarray] = []
        for s in self._table(gen)["shard_ids"]:
            res = self._send(
                s, {"family": "members_of", "c": c, "gen": gen}
            )
            if "error" in res:
                return self._strip(res)
            parts.append(np.asarray(res.get("members", []), np.int64))
        merged = (
            np.unique(np.concatenate(parts))
            if parts else np.zeros(0, np.int64)
        )
        return {"c": c, "members": [int(u) for u in merged]}

    def _gather_rows(
        self, rows: Sequence[int], gen: int
    ) -> List[List[float]]:
        """Dense K-vectors of GLOBAL internal rows, gathered by disjoint
        row range across shards, returned in the REQUESTED order (the
        fold-in's neighbor order must match the CSR order)."""
        buckets: Dict[int, List[int]] = {}
        for i, g in enumerate(rows):
            buckets.setdefault(
                self._shard_of_row(int(g), gen), []
            ).append(i)
        out: List[Optional[List[float]]] = [None] * len(rows)
        for s, idxs in buckets.items():
            res = self._send(
                s,
                {
                    "family": "rows_of",
                    "rows": [int(rows[i]) for i in idxs],
                    "gen": gen,
                },
            )
            if res.get("error") == "overloaded":
                raise _Shed()
            if "error" in res:
                raise RouterError(
                    f"rows_of on shard {s}: {res['error']}"
                )
            for i, r in zip(idxs, res["rows"]):
                out[i] = r
        return out   # type: ignore[return-value]

    def _route_suggest(
        self, q: Dict[str, Any], gen: int
    ) -> Dict[str, Any]:
        if "neighbors" in q:
            return self._route_suggest_explicit(q, gen)
        u = int(q["u"])
        phase1 = None
        owner = None
        for s in self._owners_of_raw(u, gen):
            res = self._send(
                s, {"family": "suggest_for", "u": u, "gen": gen}
            )
            if not res.get("not_owner"):
                phase1, owner = res, s
                break
        if phase1 is None:
            return {"error": f"KeyError: 'unknown node id {u}'"}
        if "error" in phase1:
            return self._strip(phase1)
        rows = self._gather_rows(phase1.get("needs_rows", []), gen)
        res = self._send(
            owner,
            {
                "family": "suggest_rows",
                "u": u,
                "gen": gen,
                "neighbor_rows": rows,
                "own_row": phase1.get("own_row"),
            },
        )
        return self._strip(res)

    def _route_suggest_explicit(
        self, q: Dict[str, Any], gen: int
    ) -> Dict[str, Any]:
        """suggest_for with an explicit raw-id neighbor list (the
        brand-new-node path): resolve each neighbor's dense row by
        probing its owner shards, then phase 2 on the query node's owner
        (or the least-loaded first shard for a node not in the graph)."""
        raw = [int(v) for v in q["neighbors"]]
        need: Dict[int, List[int]] = {}
        for u in raw:
            for s in self._owners_of_raw(u, gen):
                need.setdefault(s, []).append(u)
        rows_by_raw: Dict[int, List[float]] = {}
        for s, ids in need.items():
            res = self._send(
                s, {"family": "rows_of", "raw": ids, "gen": gen}
            )
            for key, row in res.get("raw_rows", {}).items():
                rows_by_raw[int(key)] = row
        missing = [u for u in raw if u not in rows_by_raw]
        if missing:
            return {
                "error": f"KeyError: 'unknown node id {missing[0]}'"
            }
        own_row = None
        owner = self._table(gen)["shard_ids"][0]
        if "u" in q:
            u = int(q["u"])
            for s in self._owners_of_raw(u, gen):
                res = self._send(
                    s, {"family": "rows_of", "raw": [u], "gen": gen}
                )
                got = res.get("raw_rows", {}).get(str(u))
                if got is not None:
                    own_row, owner = got, s
                    break
        sub = {
            "family": "suggest_rows",
            "gen": gen,
            "neighbor_rows": [rows_by_raw[u] for u in raw],
            "own_row": own_row,
        }
        if "u" in q:
            sub["u"] = int(q["u"])
        return self._strip(self._send(owner, sub))

    # ---------------------------------------------------------- queries
    def route(self, q: Dict[str, Any]) -> Dict[str, Any]:
        """One fully-routed query -> one answer with the single-process
        MembershipServer's answer shape. The serving generation is
        captured HERE and pinned through every sub-query — a rollout
        mid-query cannot mix generations in one answer."""
        gen = self._serving
        if gen is None:
            return {"error": "RouterError: no serving generation"}
        fam = q.get("family") if isinstance(q, dict) else None
        t0 = time.perf_counter()
        # per-query deadline, pinned here and read by every sub-send
        # (thread-local like the trace: route() runs one query per
        # worker thread end to end)
        self._deadline_local.t = (
            t0 + self._deadline_s if self._deadline_s > 0 else None
        )
        tr: Optional[Dict[str, Any]] = None
        if _obs.current() is not None:
            # tracing is exactly telemetry-installed: one dict + one
            # registry entry per query, nothing on the untraced path
            tr = {"id": new_trace_id(), "family": str(fam), "hops": []}
            self._trace_local.tr = tr
            with self._lock:
                self._inflight[tr["id"]] = t0
        try:
            if fam == "communities_of":
                res = self._route_communities(q, gen)
            elif fam == "members_of":
                res = self._route_members(q, gen)
            elif fam == "suggest_for":
                res = self._route_suggest(q, gen)
            else:
                res = {"error": f"KeyError: 'unknown family {fam!r}'"}
        except _Shed:
            res = {"error": "overloaded"}
        except _DeadlineExceeded:
            self.deadline_exceeded += 1
            res = {"error": "deadline_exceeded"}
        except Exception as e:   # noqa: BLE001 — per-query isolation
            res = {"error": f"{type(e).__name__}: {e}"}
        self._deadline_local.t = None
        if tr is not None:
            self._trace_local.tr = None
        lat = time.perf_counter() - t0
        exemplars = None
        with self._lock:
            if res.get("error") == "overloaded":
                self._shed += 1
            elif "error" in res:
                self._errors += 1
            if fam in self._latencies:
                self._latencies[fam].append(lat)
            if self._t_first is None or t0 < self._t_first:
                self._t_first = t0
            end = t0 + lat
            if self._t_last is None or end > self._t_last:
                self._t_last = end
            if tr is not None:
                self._inflight.pop(tr["id"], None)
                exemplars = self._absorb_trace_locked(tr, lat)
        if exemplars:
            self._emit_exemplars(exemplars)
        return res

    # ---------------------------------------------------------- tracing
    def _absorb_trace_locked(
        self, tr: Dict[str, Any], total_s: float
    ) -> Optional[List[Any]]:
        """Fold one completed trace into the hop accumulators + the
        slow-query exemplar heap (caller holds the lock). Returns the
        window's exemplar items when this trace closed a TRACE_WINDOW,
        else None — the caller emits them OUTSIDE the lock."""
        self._traced += 1
        wire = 0.0
        for hop in tr["hops"]:
            w = hop.get("wire_s")
            if isinstance(w, (int, float)):
                wire += float(w)
            per = self._shard_hops.setdefault(int(hop["shard"]), {})
            for name in _HOP_NAMES:
                v = hop.get(name + "_s")
                if not isinstance(v, (int, float)):
                    continue
                self._hop_sum[name] = self._hop_sum.get(name, 0.0) + v
                self._hop_n[name] = self._hop_n.get(name, 0) + 1
                acc = per.setdefault(name, [0.0, 0])
                acc[0] += v
                acc[1] += 1
        # sequential sub-sends: total == sum(wire) + merge exactly, so
        # merge (router-side work) is the closing residual
        merge_s = max(total_s - wire, 0.0)
        self._hop_sum["merge"] = self._hop_sum.get("merge", 0.0) + merge_s
        self._hop_n["merge"] = self._hop_n.get("merge", 0) + 1
        heap = self._trace_heap
        if len(heap) < TRACE_TOP or total_s > heap[0][0]:
            # only build the rounded exemplar record when this trace
            # actually enters the top-N — the common (fast) trace pays
            # one comparison here, not a dict rebuild
            rec = {
                "trace_id": tr["id"],
                "family": tr["family"],
                "total_s": round(total_s, 6),
                "merge_s": round(merge_s, 6),
                "hops": [
                    {
                        k: (round(v, 6) if isinstance(v, float) else v)
                        for k, v in hop.items()
                    }
                    for hop in tr["hops"]
                ],
            }
            self._trace_seq += 1
            item = (total_s, self._trace_seq, rec)
            if len(heap) < TRACE_TOP:
                heappush(heap, item)
            else:
                heappushpop(heap, item)
        self._trace_seen += 1
        if self._trace_seen < TRACE_WINDOW:
            return None
        heap, self._trace_heap = self._trace_heap, []
        self._trace_seen = 0
        return heap

    @staticmethod
    def _emit_exemplars(heap: List[Any]) -> None:
        tel = _obs.current()
        if tel is None:
            return
        for _, _, rec in sorted(heap, key=lambda it: -it[0]):
            tel.event("qtrace", **rec)

    def flush_traces(self) -> None:
        """Emit the current window's slow-query exemplars now (the end
        of a route run / router shutdown — a part-filled window must
        not die with the process)."""
        with self._lock:
            heap, self._trace_heap = self._trace_heap, []
            self._trace_seen = 0
        if heap:
            self._emit_exemplars(heap)

    def open_trace_count(self) -> int:
        """Routed queries currently in flight (traced) — embedded in
        heartbeat stall events ."""
        with self._lock:
            return len(self._inflight)

    def oldest_inflight_s(self) -> float:
        """Age of the oldest in-flight routed query (0.0 when idle) —
        the 'is one query wedged' number stall events carry."""
        with self._lock:
            if not self._inflight:
                return 0.0
            return time.perf_counter() - min(self._inflight.values())

    def run_queries(
        self,
        queries: Sequence[Dict[str, Any]],
        collect: bool = True,
    ) -> List[Optional[Dict[str, Any]]]:
        """Open-loop driver (the `cli route --queries` path): fan the
        queries over the worker pool, preserve order, never raise
        per-query."""
        futures = [self._pool.submit(self.route, q) for q in queries]
        out: List[Optional[Dict[str, Any]]] = []
        for fut in futures:
            res = fut.result()
            out.append(res if collect else None)
        tel = _obs.current()
        if tel is not None:
            tel.event(
                "route",
                queries=len(queries),
                shards=len(self._by_shard),
            )
            self._emit_freshness()
        return out

    # ------------------------------------------------------------ stats
    def reset_stats(self) -> None:
        with self._lock:
            self._latencies = {f: [] for f in FAMILIES}
            self._shard_lat = {}
            self._errors = 0
            self._shed = 0
            self._t_first = self._t_last = None
            # the self-healing counters are rate-verdicted per measured
            # pass (ledger), so a warmup reset clears them too
            self.retried = 0
            self.hedged = 0
            self.hedge_wins = 0
            self.deadline_exceeded = 0
            # warmup traces must not pollute the measured pass
            self._traced = 0
            self._hop_sum = {}
            self._hop_n = {}
            self._shard_hops = {}
            self._trace_heap = []
            self._trace_seen = 0

    def stats(self) -> Dict[str, Any]:
        """The router scoreboard, key-compatible with
        MembershipServer.stats() where the meaning coincides (so
        obs.ledger harvests both with one code path) plus the
        fleet-only axes: shards/replicas, per-shard latency tables, the
        rollout/mixed-generation counters, and the shed rate."""
        with self._lock:
            lats = [
                v for fam in FAMILIES for v in self._latencies[fam]
            ]
            by_family = {
                fam: len(self._latencies[fam])
                for fam in FAMILIES
                if self._latencies[fam]
            }
            shard_lat = {
                s: list(v) for s, v in self._shard_lat.items()
            }
            traced = self._traced
            hop_sum = dict(self._hop_sum)
            hop_n = dict(self._hop_n)
            shard_hops = {
                s: {k: (acc[0], acc[1]) for k, acc in per.items()}
                for s, per in self._shard_hops.items()
            }
            errors, shed = self._errors, self._shed
            t_first, t_last = self._t_first, self._t_last
            shards = len(self._by_shard)
            replicas = (
                len(
                    [
                        t for t in self.endpoints
                        if id(t) not in self._down
                    ]
                )
                // max(shards, 1)
            )
        total = len(lats)
        wall = (
            max(t_last - t_first, 1e-9)
            if t_first is not None and t_last is not None
            else 0.0
        )
        mix = "|".join(
            f"{fam}:{n / total:.2f}" for fam, n in by_family.items()
        )
        out = {
            "serve_queries": total,
            "serve_errors": errors,
            "serve_by_family": by_family,
            "serve_mix": mix,
            "serve_p50_s": _percentile(lats, 50),
            "serve_p99_s": _percentile(lats, 99),
            "serve_qps": (total / wall) if wall else None,
            "serve_shed": shed,
            "serve_shed_rate": (
                round(shed / (total + shed), 4)
                if (total + shed) else 0.0
            ),
            "serve_shards": shards,
            "serve_replicas": replicas,
            "serve_shard_stats": {
                str(s): {
                    "queries": len(v),
                    "p50_s": _percentile(v, 50),
                    "p99_s": _percentile(v, 99),
                    "qps": (
                        round(len(v) / wall, 2) if wall else None
                    ),
                }
                for s, v in sorted(shard_lat.items())
            },
            "serving_generation": self._serving,
            "snapshot_step": self._serving,
            "mixed_generation": self.mixed_generation,
            "pruned_generation": self.pruned_generation,
            "transport_failovers": self.transport_failovers,
            "rollouts": self.rollouts,
            "traced_queries": traced,
            # self-healing scoreboard : retried = sub-queries
            # that answered after at least one failure (the kill -9
            # drill's "not a client error" proof); the rates are what
            # the perf ledger verdicts
            "router_retries": self.retried,
            "hedged": self.hedged,
            "hedge_wins": self.hedge_wins,
            "hedged_rate": (
                round(self.hedged / total, 4) if total else 0.0
            ),
            "deadline_exceeded": self.deadline_exceeded,
            "deadline_exceeded_rate": (
                round(self.deadline_exceeded / total, 4) if total else 0.0
            ),
            "membership_reloads": self.membership_reloads,
        }
        # fleet-wide per-hop latency means (traced queries only): the
        # decomposition the ledger verdicts — a transport regression and
        # an execute regression are different findings
        for name in _HOP_NAMES + ("merge",):
            n = hop_n.get(name, 0)
            if n:
                out[f"serve_hop_{name}_s"] = round(
                    hop_sum.get(name, 0.0) / n, 6
                )
        for s, per in shard_hops.items():
            st = out["serve_shard_stats"].get(str(s))
            if st is not None and per:
                st["hops"] = {
                    name: round(tot / n, 6)
                    for name, (tot, n) in sorted(per.items())
                    if n
                }
        age = self.generation_age_s()
        if age is not None:
            out["generation_age_s"] = round(age, 3)
        for key in ("serve_p50_s", "serve_p99_s", "serve_qps"):
            if out[key] is not None:
                out[key] = round(out[key], 6)
        for st in out["serve_shard_stats"].values():
            for key in ("p50_s", "p99_s"):
                if st[key] is not None:
                    st[key] = round(st[key], 6)
        return out

    # -------------------------------------------------------- lifecycle
    def close(self) -> None:
        self.flush_traces()
        self._health_stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=10.0)
            self._health_thread = None
        self._pool.shutdown(wait=False)
        if self._hedge_pool is not None:
            self._hedge_pool.shutdown(wait=False)
        for t in self.endpoints:
            try:
                t.close()
            except Exception:   # noqa: BLE001 — best effort
                pass


class RouterServer:
    """`cli route --daemon` : the router itself as a
    long-lived tier on the SAME newline-framed JSON TCP wire the
    replicas speak — one query dict per line in, one answer dict per
    line out. Clients send the three public families verbatim; two
    control ops ride the same framing: `{"family": "status"}` answers
    router.stats() (the self-healing scoreboard) and `{"family":
    "stop"}` acks then shuts the daemon down — so `cli route --stop`
    pointed at a router daemon does exactly what it does to a replica.
    Per-connection threads call route() directly: client connections ARE
    the concurrency, no second worker pool."""

    def __init__(
        self, router: FleetRouter, host: str = "127.0.0.1", port: int = 0
    ):
        self.router = router
        self._stopped = threading.Event()
        outer = self

        class _Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for line in self.rfile:
                    line = line.strip()
                    if not line:
                        continue
                    q: Any = None
                    try:
                        q = json.loads(line)
                    except ValueError:
                        res: Dict[str, Any] = {"error": "bad json"}
                    else:
                        fam = (
                            q.get("family") if isinstance(q, dict) else None
                        )
                        if fam == "status":
                            res = outer.router.stats()
                        elif fam == "stop":
                            res = {"ok": True}
                        else:
                            res = outer.router.route(q)
                    try:
                        self.wfile.write(
                            (json.dumps(res) + "\n").encode()
                        )
                        self.wfile.flush()
                    except OSError:
                        return   # client went away mid-answer
                    if (
                        isinstance(q, dict)
                        and q.get("family") == "stop"
                    ):
                        # ack first, shut down from a fresh thread
                        # (shutdown() deadlocks called from a handler)
                        threading.Thread(
                            target=outer.close, daemon=True
                        ).start()
                        return

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True
            request_queue_size = 128

        self._srv = _Server((host, int(port)), _Handler)
        self.host, self.port = self._srv.server_address[:2]
        self._thread = threading.Thread(
            target=self._srv.serve_forever,
            name="bigclam-route-daemon",
            daemon=True,
        )
        self._thread.start()

    def serve_until_stopped(
        self, timeout: Optional[float] = None
    ) -> bool:
        return self._stopped.wait(timeout)

    def close(self) -> None:
        if self._stopped.is_set():
            return
        self._stopped.set()
        self._srv.shutdown()
        self._srv.server_close()
        self.router.close()
