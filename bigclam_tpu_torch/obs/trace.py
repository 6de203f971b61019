"""Hierarchical span tracing: WHERE the time went. The port's one tracing
system.

Port of bigclam_tpu/obs/trace.py. A `span` is a named, nested interval:

    with span("fit_loop"):
        with span("dispatch", emit=False):
            ...

Spans nest by a per-thread stack: a span's PATH is its parent's path plus
its own name ("fit/fit_loop/dispatch" when the CLI's "fit" stage encloses
the loop).

WHEN SPANS RECORD: while a RunTelemetry is installed, while any
torch.profiler capture is live, or inside a `recording()` scope. Otherwise
`span()` returns one shared no-op object — no event, no table, no stack
touch: the off path is the telemetry's None check, the scope count and
the profiler's own flag.

ONE TABLE: a recording span folds into the in-memory table of per-path
totals (host seconds, device milliseconds, count); `count(name, v)` adds
to a named counter beside it (an int, or a device tensor summed on the
device with no sync). `totals()` reads both, `reset()` empties them. The
run report's span section (obs.telemetry) and the benchmark's per-layer
readers read this table. A span with `emit=True` also writes a `span`
event through the installed telemetry; per-iteration phases use
`emit=False`: exact totals, no per-occurrence event.

HOST AND DEVICE CLOCKS: a span's seconds are host wall time. On CUDA the
host enqueues a step's kernels and returns; it blocks where it reads the
LLH back, so the fit loop's `fit_loop/sync` holds the device time, any
waits and the read back. `span(name, device=d)` also times the span on
the device: a pair of pooled CUDA events on the current stream of `d`
(wall time on the CPU). Pairs are resolved where the stream has drained:
`settle()`, which the fit loop calls after its LLH read, takes the pairs
whose end event has completed (`query()`), and never synchronizes;
`totals()` synchronizes once, to take the rest.

PROFILER ALIGNMENT: while a capture is live every recording span also
opens a torch.profiler.record_function named by its path, so its range
lies on the capture's clock with the device operations.
`step_annotation` marks one profiled step the same way.

THREAD MODEL: the span stack is per-thread (plain dict keyed by thread id;
list push/pop are GIL-atomic); the table takes one lock. `open_spans()`
snapshots every thread's open stack — the stall heartbeat embeds it so a
stall report answers "stuck in which phase".

CLOSE INVARIANTS: closes are exception-safe (the context manager records
the interval with ok=False and still pops). A close that finds younger
spans still open above it repairs the stack — the abandoned entries are
dropped and counted in the table's `orphans`.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from typing import Dict, Iterator, List

from bigclam_tpu_torch.obs import telemetry as _telemetry

# thread id -> stack of open span PATHS (innermost last)
_STACKS: Dict[int, List[str]] = {}

# the table: path -> [host seconds, device ms, count, device-timed count];
# counter name -> int or device tensor; spans dropped by a stack repair
_LOCK = threading.Lock()
_SPANS: Dict[str, list] = {}
_COUNTERS: Dict[str, object] = {}
_ORPHANS = {"n": 0}
# device-timed closes awaiting their events: (path, device index, start,
# end); past _PENDING_CAP a close settles them itself
_PENDING: list = []
_PENDING_CAP = 4096
# device index -> CUDA events free for reuse
_POOL: Dict[int, list] = {}
# open recording() scopes
_SCOPES = {"open": 0}


def capture_active() -> bool:
    """Is a torch.profiler capture live (any capture, whoever started it)?"""
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


def enabled() -> bool:
    """Do spans and counters record here: a telemetry installed, a
    recording() scope open or a profiler capture live?"""
    return (_telemetry.current() is not None or _SCOPES["open"] > 0
            or capture_active())


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans and counters inside the block, with no telemetry and no
    profiler."""
    with _LOCK:
        _SCOPES["open"] += 1
    try:
        yield
    finally:
        with _LOCK:
            _SCOPES["open"] -= 1


def fold(path: str, seconds: float, orphans: int = 0) -> None:
    """Add one closed span's host seconds and count to the table."""
    with _LOCK:
        row = _SPANS.get(path)
        if row is None:
            row = _SPANS[path] = [0.0, 0.0, 0, 0]
        row[0] += seconds
        row[2] += 1
        _ORPHANS["n"] += orphans


def _fold_device(path: str, ms: float) -> None:
    with _LOCK:
        row = _SPANS.get(path)
        if row is None:
            row = _SPANS[path] = [0.0, 0.0, 0, 0]
        row[1] += ms
        row[3] += 1


def count(name: str, value) -> None:
    """Add `value` (an int, or a tensor summed where it lives, with no
    sync) to counter `name`. Callers check enabled() first: a counter
    records whenever it is called."""
    with _LOCK:
        prev = _COUNTERS.get(name, 0)
        if isinstance(prev, int):
            # a new object: never the caller's tensor, which add_ would write
            _COUNTERS[name] = value + prev
        else:
            prev.add_(value)


def _record_event(device):
    """A pooled timing event recorded on the current stream of `device`:
    (device index, event)."""
    import torch

    stream = torch.cuda.current_stream(device)
    pool = _POOL.get(stream.device_index)
    ev = pool.pop() if pool else torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return stream.device_index, ev


def settle(wait: bool = False) -> None:
    """Resolve the pending device-timed closes whose end event has
    completed into the table (all of them with `wait`, after one
    synchronize a device), returning their events to the pool. Without
    `wait` it never blocks: the fit loop calls it after its LLH read,
    where the stream has drained up to the step."""
    if not _PENDING:
        return
    with _LOCK:
        pending = _PENDING[:]
        del _PENDING[:]
    if wait:
        import torch

        for idx in sorted({p[1] for p in pending}):
            torch.cuda.synchronize(idx)
    keep = []
    for item in pending:
        path, idx, e0, e1 = item
        if wait or e1.query():
            _fold_device(path, e0.elapsed_time(e1))
            _POOL.setdefault(idx, []).extend((e0, e1))
        else:
            keep.append(item)
    if keep:
        with _LOCK:
            _PENDING[:0] = keep


def totals() -> dict:
    """The table, read: {"spans": {path: {"host_s", "device_ms" (None for
    a span never timed on a device), "count"}}, "counters": {name: int},
    "orphans": n}. Synchronizes the devices with pending events or
    tensor counters."""
    settle(wait=True)
    with _LOCK:
        spans = {p: {"host_s": r[0], "device_ms": r[1] if r[3] else None,
                     "count": r[2]} for p, r in _SPANS.items()}
        counters = dict(_COUNTERS)
        orphans = _ORPHANS["n"]
    return {"spans": spans, "counters": {k: int(v) for k, v in counters.items()},
            "orphans": orphans}


def reset() -> None:
    """Empty the table (spans, counters, orphans, pending closes)."""
    with _LOCK:
        _SPANS.clear()
        _COUNTERS.clear()
        _ORPHANS["n"] = 0
        del _PENDING[:]


def _record_function(name: str):
    """torch.profiler.record_function(name), entered; None when torch is
    not loaded or the API refuses."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        ann = torch.profiler.record_function(name)
        ann.__enter__()
        return ann
    except Exception:
        return None


class _NullSpan:
    """The span where spans do not record: one shared instance, no state,
    no work."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **fields) -> None:
        pass


NULL_SPAN = _NullSpan()


class _Annotation:
    """A record_function scope as a context manager that never raises."""

    __slots__ = ("name", "_ann")

    def __init__(self, name: str):
        self.name = name
        self._ann = None

    def __enter__(self):
        self._ann = _record_function(self.name)
        return self

    def __exit__(self, et, ev, tb):
        if self._ann is not None:
            try:
                self._ann.__exit__(et, ev, tb)
            except Exception:
                pass
        return False

    def set(self, **fields) -> None:
        pass


def step_annotation(step_num: int, name: str = "train"):
    """A torch.profiler.record_function scope named "<name>#<step_num>"
    for one profiled step (`cli profile` wraps each timed step in one, so
    the captured timeline groups a step's kernels under it); the no-op
    span when torch is not loaded."""
    if "torch" not in sys.modules:
        return NULL_SPAN
    return _Annotation(f"{name}#{int(step_num)}")


def _complete(tel, path: str, seconds: float, ok: bool, emit: bool,
              fields: dict, orphans: int = 0) -> None:
    """A closed span into the table: through the telemetry's sink (which
    also writes its event) where one is installed."""
    if tel is not None:
        tel.span_complete(path, seconds, ok=ok, emit=emit, fields=fields,
                          orphans=orphans)
    else:
        fold(path, seconds, orphans)


class Span:
    """One open span (use via `span(...)`, not directly). Context-manager
    only; `set(**fields)` attaches extra fields to the close event."""

    __slots__ = ("_tel", "name", "emit", "fields", "device", "path", "_t0",
                 "_ann", "_ev")

    def __init__(self, tel, name: str, emit: bool, device, fields: dict):
        self._tel = tel
        self.name = name
        self.emit = emit
        self.fields = fields
        self.device = device
        self.path = name
        self._t0 = 0.0
        self._ann = None
        self._ev = None

    def set(self, **fields) -> None:
        self.fields.update(fields)

    def __enter__(self) -> "Span":
        tid = threading.get_ident()
        stack = _STACKS.get(tid)
        if stack is None:
            stack = _STACKS.setdefault(tid, [])
        self.path = f"{stack[-1]}/{self.name}" if stack else self.name
        stack.append(self.path)
        if capture_active():
            self._ann = _record_function(self.path)
        if self.device is not None and self.device.type == "cuda":
            self._ev = _record_event(self.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        dt = time.perf_counter() - self._t0
        end = _record_event(self.device) if self._ev is not None else None
        if self._ann is not None:
            try:
                self._ann.__exit__(et, ev, tb)
            except Exception:
                pass
        orphans = 0
        stack = _STACKS.get(threading.get_ident())
        if stack and stack[-1] == self.path:
            stack.pop()
        elif stack and self.path in stack:
            # younger spans were entered and never exited: repair — drop
            # them (counted), then pop ourselves
            idx = len(stack) - 1 - stack[::-1].index(self.path)
            orphans = len(stack) - idx - 1
            del stack[idx:]
        _complete(self._tel, self.path, dt, et is None, self.emit, self.fields,
                  orphans)
        if end is not None:
            (idx, e0), e1 = self._ev, end[1]
            with _LOCK:
                _PENDING.append((self.path, idx, e0, e1))
            if len(_PENDING) > _PENDING_CAP:
                settle()
        elif self.device is not None:
            _fold_device(self.path, dt * 1e3)
        return False


def span(name: str, emit: bool = True, device=None, **fields):
    """Open a span named `name`: the shared no-op object unless spans
    record (enabled()) — the zero-cost contract.

    `emit=False` keeps exact per-path totals but writes no per-occurrence
    event (for per-iteration phases). `device` (a torch.device) times the
    span on that device too. Extra keyword `fields` ride the close
    event."""
    tel = _telemetry.current()
    if tel is None and not _SCOPES["open"] and not capture_active():
        return NULL_SPAN
    return Span(tel, name, emit, device, fields)


def add_span(name: str, seconds: float, emit: bool = True, **fields) -> None:
    """Record an already-measured interval as a span completion at the
    current stack position (loops that time themselves still land in the
    span taxonomy). No-op when spans do not record."""
    if not enabled():
        return
    stack = _STACKS.get(threading.get_ident())
    path = f"{stack[-1]}/{name}" if stack else name
    _complete(_telemetry.current(), path, seconds, True, emit, fields)


_TRACE_ID = {"n": 0}
_TRACE_ID_LOCK = threading.Lock()


def new_trace_id() -> str:
    """Process-unique compact trace id ("<pid hex>-<seq hex>"):
    counter-based, short, orderable within a process."""
    with _TRACE_ID_LOCK:
        _TRACE_ID["n"] += 1
        n = _TRACE_ID["n"]
    return f"{os.getpid():x}-{n:x}"


def open_spans() -> List[str]:
    """Snapshot of every thread's open span paths, innermost last per
    thread — what the stall heartbeat embeds in `stall` events."""
    out: List[str] = []
    for stack in list(_STACKS.values()):
        out.extend(list(stack))
    return out


def current_path() -> str:
    """The calling thread's innermost open span path ('' when none)."""
    stack = _STACKS.get(threading.get_ident())
    return stack[-1] if stack else ""
