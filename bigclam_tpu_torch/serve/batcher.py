# Copied from bigclam_tpu/serve/batcher.py (standard library only).
"""Request batcher with a latency budget.

Single-query device dispatch would waste the accelerator: a fold-in step
over one row costs the same launch overhead as over 64. The batcher
coalesces requests the way the trainers coalesce edges — the first
request in an empty queue opens a WINDOW of `budget_s` seconds; the batch
flushes when either `max_batch` requests have accumulated or the window
closes, whichever comes first. Under load the batch fills instantly
(throughput mode: amortized dispatch); when idle a lone query pays at
most the budget in added latency (the p99 knob `cli serve
--latency-budget-ms` turns).

Thread model: one flusher thread; submit() is thread-safe and returns a
Future. Handler exceptions fail that batch's futures, never the thread.
`drain()` blocks until the queue is empty AND no handler is mid-flight —
the hot-swap barrier (serve.server swaps snapshots between batches, so a
swap drains in-flight batches and drops zero queries).

Admission control: overload must degrade p99, not
OOM. Two watermarks, both off by default:

  * DEPTH — `max_depth` bounds the queue: a submit() finding the queue
    full fails its future IMMEDIATELY with OverloadedError (the caller
    gets a fast "overloaded" answer instead of a slot in an unbounded
    deque whose memory and wait time grow without limit);
  * DEADLINE — `shed_wait_s` bounds queue AGE: requests that waited
    longer than the watermark by the time their batch is taken are shed
    at flush (they would blow the latency SLO anyway; answering them
    late just steals capacity from requests that can still make it).

Shed counts (`shed_depth` / `shed_deadline`) and the live `depth()` ride
the server stats and telemetry, so an overload burst is a verdicted
shed-rate + bounded-p99 curve in the ledger.

jax-free: pure threading + deque; the handler decides what touches a
device.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, List, Optional


class OverloadedError(RuntimeError):
    """Request shed by admission control (queue past the depth/deadline
    watermark, or the door closed for a drain). Servers map this to a
    fast {"error": "overloaded"} answer — by design the CHEAPEST
    possible response."""


class BatcherStopped(RuntimeError):
    """The batcher shut down with this request still queued (or the
    submit arrived after stop). Typed so clients can tell "server going
    down" from overload or a handler bug — a fail-fast signal, never a
    hang. Graceful shutdown that must NOT strand requests is
    close_door() + drain() + stop()."""


class Future:
    """Minimal single-assignment result slot (no concurrent.futures
    executor semantics needed — the batcher owns the lifecycle)."""

    __slots__ = ("_ev", "_value", "_error", "t_submit", "t_taken", "t_done")

    def __init__(self):
        self._ev = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()
        # stamped when the flusher pops the request into a batch: splits
        # queue wait (submit->taken) from batch-window wait + execution
        # (taken->done) for the per-hop trace block
        self.t_taken: Optional[float] = None
        self.t_done: Optional[float] = None

    def set_result(self, value: Any) -> None:
        self._value = value
        self.t_done = time.perf_counter()
        self._ev.set()

    def set_error(self, error: BaseException) -> None:
        self._error = error
        self.t_done = time.perf_counter()
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._ev.wait(timeout):
            raise TimeoutError("request not completed within timeout")
        if self._error is not None:
            raise self._error
        return self._value

    @property
    def latency_s(self) -> Optional[float]:
        return (
            None if self.t_done is None else self.t_done - self.t_submit
        )


class Request:
    __slots__ = ("payload", "future")

    def __init__(self, payload: Any):
        self.payload = payload
        self.future = Future()


class RequestBatcher:
    """See module docstring. handler(batch: List[Request]) must set every
    request's future (the batcher backstops: an unset future after a
    clean handler return gets a RuntimeError, and a handler exception
    fails every still-unset future in the batch)."""

    def __init__(
        self,
        handler: Callable[[List[Request]], None],
        max_batch: int = 64,
        budget_s: float = 0.005,
        max_depth: int = 0,
        shed_wait_s: float = 0.0,
    ):
        self.handler = handler
        self.max_batch = max(int(max_batch), 1)
        self.budget_s = max(float(budget_s), 0.0)
        # admission control (module docstring): 0 = unbounded/off
        self.max_depth = max(int(max_depth), 0)
        self.shed_wait_s = max(float(shed_wait_s), 0.0)
        self._q: deque = deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._inflight = 0
        self._stop = False
        self._door_closed = False
        self._thread: Optional[threading.Thread] = None
        self.batches = 0
        self.flushed_full = 0       # batches flushed by max_batch
        self.flushed_deadline = 0   # batches flushed by the budget window
        self.shed_depth = 0         # submits rejected at the depth bound
        self.shed_deadline = 0      # requests shed stale at flush
        self.shed_door = 0          # submits rejected while draining
        self.depth_peak = 0         # high-water queue depth observed

    # ------------------------------------------------------- lifecycle
    def start(self) -> "RequestBatcher":
        if self._thread is None:
            self._stop = False
            self._thread = threading.Thread(
                target=self._loop, name="bigclam-serve-batcher", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Fail-fast shutdown: everything still QUEUED fails immediately
        with BatcherStopped — before the flusher is joined, so a wedged
        handler can never hold stranded futures hostage. The batch the
        handler is currently executing finishes normally (its futures
        belong to the handler). Callers that must not strand requests
        drain first: close_door() + drain() + stop()."""
        with self._cond:
            self._stop = True
            stranded = list(self._q)
            self._q.clear()
            self._cond.notify_all()
        for req in stranded:
            if not req.future.done():
                req.future.set_error(
                    BatcherStopped(
                        f"batcher stopped with {len(stranded)} "
                        "request(s) queued"
                    )
                )
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def close_door(self) -> None:
        """Stop admitting: every later submit() sheds fast with
        OverloadedError. This is the drain protocol's first step
        — already-queued and in-flight requests finish
        normally, drain() then observes a quiescent batcher, stop()
        finds nothing to strand."""
        with self._cond:
            self._door_closed = True

    @property
    def draining(self) -> bool:
        return self._door_closed

    # --------------------------------------------------------- clients
    def submit(self, payload: Any) -> Future:
        req = Request(payload)
        with self._cond:
            if self._stop or self._thread is None:
                raise BatcherStopped("batcher is not running")
            if self._door_closed:
                self.shed_door += 1
                req.future.set_error(
                    OverloadedError("admission door closed (draining)")
                )
                return req.future
            if self.max_depth and len(self._q) >= self.max_depth:
                # shed at the door (depth watermark): the future fails
                # NOW — callers see the same Future surface either way
                self.shed_depth += 1
                req.future.set_error(
                    OverloadedError(
                        f"queue depth {len(self._q)} at the "
                        f"max_depth={self.max_depth} watermark"
                    )
                )
                return req.future
            self._q.append(req)
            if len(self._q) > self.depth_peak:
                self.depth_peak = len(self._q)
            self._cond.notify_all()
        return req.future

    def depth(self) -> int:
        """Live queue depth (requests admitted, not yet taken into a
        batch) — the number heartbeat stall events and serve telemetry
        embed."""
        with self._lock:
            return len(self._q)

    def pending_payloads(self) -> List[Any]:
        """Snapshot of the queued payloads (per-family depth metrics —
        the server buckets them; O(depth) under the lock, called once
        per flushed batch)."""
        with self._lock:
            return [r.payload for r in self._q]

    @property
    def shed(self) -> int:
        return self.shed_depth + self.shed_deadline + self.shed_door

    def drain(self, timeout: float = 60.0) -> None:
        """Block until the queue is empty and no batch is executing —
        the hot-swap barrier. Requests submitted DURING a drain simply
        extend it; nothing is rejected or dropped."""
        deadline = time.perf_counter() + timeout
        with self._cond:
            while self._q or self._inflight:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    raise TimeoutError("batcher did not drain in time")
                self._cond.wait(remaining)

    # ----------------------------------------------------------- flush
    def _take_batch_locked(self) -> List[Request]:
        batch = []
        now = time.perf_counter()
        while self._q and len(batch) < self.max_batch:
            req = self._q.popleft()
            req.future.t_taken = now
            batch.append(req)
        return batch

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._stop:
                    self._cond.wait()
                if self._stop and not self._q:
                    return
                # window opens at the first queued request; fill until
                # max_batch or the deadline
                deadline = time.perf_counter() + self.budget_s
                while (
                    len(self._q) < self.max_batch and not self._stop
                ):
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                full = len(self._q) >= self.max_batch
                batch = self._take_batch_locked()
                if not batch:
                    # stop() failed + cleared the queue out from under
                    # the open window — nothing left to execute
                    return
                self._inflight += 1
                self.batches += 1
                if full:
                    self.flushed_full += 1
                else:
                    self.flushed_deadline += 1
            if self.shed_wait_s > 0.0:
                # deadline watermark: requests older than shed_wait_s by
                # flush time would blow the SLO anyway — shed them fast
                # and spend the batch slot on requests that can make it
                now = time.perf_counter()
                fresh: List[Request] = []
                for req in batch:
                    if now - req.future.t_submit > self.shed_wait_s:
                        self.shed_deadline += 1
                        req.future.set_error(
                            OverloadedError(
                                "request waited past the "
                                f"shed_wait_s={self.shed_wait_s:.3f} "
                                "watermark"
                            )
                        )
                    else:
                        fresh.append(req)
                batch = fresh
                if not batch:
                    with self._cond:
                        self._inflight -= 1
                        self._cond.notify_all()
                    continue
            try:
                self.handler(batch)
                for req in batch:
                    if not req.future.done():
                        req.future.set_error(
                            RuntimeError("handler left request unanswered")
                        )
            except BaseException as e:   # noqa: BLE001 — thread must live
                for req in batch:
                    if not req.future.done():
                        req.future.set_error(e)
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()
