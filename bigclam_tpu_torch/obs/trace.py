"""Hierarchical span tracing: WHERE the time went.

Port of bigclam_tpu/obs/trace.py. A `span` is a named, nested wall-clock
interval:

    with span("fit_loop"):
        with span("dispatch", emit=False):
            ...

Spans nest by a per-thread stack: a span's PATH is its parent's path plus
its own name ("fit/fit_loop/dispatch" when the CLI's "fit" stage encloses
the loop). Two sinks, both on the installed RunTelemetry:

* running per-path totals (seconds + counts) — always, one dict update
  under the telemetry lock; these feed the run report's span table;
* a `span` event in events.jsonl on close — only for `emit=True` spans.
  The fit loop's per-iteration phases use `emit=False`: exact totals, no
  per-occurrence event.

A span is host wall time. On CUDA the host enqueues a step's kernels and
returns; it blocks where it reads the LLH back, so the fit loop's
`fit_loop/sync` span holds the device time, any waits and the read back,
as in the JAX package. No span synchronizes the device itself: that would
change the step time it measures.

COST CONTRACT: with telemetry off, `span()` returns one shared no-op
object — no event, no dict, no stack touch (the off path is a
current()-is-None check).

PROFILER ALIGNMENT: while a capture is live (utils.profiling.trace flags
it: `--profile-dir`, `cli profile`), every span also opens a
torch.profiler.record_function with its path, so the captured timeline
carries the span names; without a capture no span touches the profiler.
`step_annotation` marks one profiled step the same way.

THREAD MODEL: the span stack is per-thread (plain dict keyed by thread id;
list push/pop are GIL-atomic). `open_spans()` snapshots every thread's
open stack — the stall heartbeat embeds it so a stall report answers
"stuck in which phase".

CLOSE INVARIANTS: closes are exception-safe (the context manager records
the interval with ok=False and still pops). A close that finds younger
spans still open above it repairs the stack — the abandoned entries are
dropped and counted in the telemetry's span_orphans counter.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List

from bigclam_tpu_torch.obs import telemetry as _telemetry

# thread id -> stack of open span PATHS (innermost last)
_STACKS: Dict[int, List[str]] = {}

# profiler-capture refcount, flipped by utils.profiling.trace (every
# capture of the port goes through it): spans open record_function
# annotations only while it is positive
_CAPTURE = {"active": 0}


def capture_started() -> None:
    _CAPTURE["active"] += 1


def capture_stopped() -> None:
    _CAPTURE["active"] = max(_CAPTURE["active"] - 1, 0)


def capture_active() -> bool:
    return _CAPTURE["active"] > 0


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
    """The telemetry-off span: one shared instance, no state, no work."""

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


class Span:
    """One open span (use via `span(...)`, not directly). Context-manager
    only; `set(**fields)` attaches extra fields to the close event."""

    __slots__ = ("_tel", "name", "emit", "fields", "path", "_t0", "_ann")

    def __init__(self, tel, name: str, emit: bool, fields: dict):
        self._tel = tel
        self.name = name
        self.emit = emit
        self.fields = fields
        self.path = name
        self._t0 = 0.0
        self._ann = None

    def set(self, **fields) -> None:
        self.fields.update(fields)

    def __enter__(self) -> "Span":
        tid = threading.get_ident()
        stack = _STACKS.get(tid)
        if stack is None:
            stack = _STACKS.setdefault(tid, [])
        self.path = f"{stack[-1]}/{self.name}" if stack else self.name
        stack.append(self.path)
        if _CAPTURE["active"]:
            self._ann = _record_function(self.path)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        dt = time.perf_counter() - self._t0
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
        self._tel.span_complete(
            self.path, dt, ok=et is None, emit=self.emit,
            fields=self.fields, orphans=orphans,
        )
        return False


def span(name: str, emit: bool = True, **fields):
    """Open a span named `name` under the installed telemetry.

    Returns the shared no-op object when telemetry is off — the zero-cost
    contract. `emit=False` keeps exact per-path totals but writes no
    per-occurrence event (for per-iteration phases). Extra keyword
    `fields` ride the close event."""
    tel = _telemetry.current()
    if tel is None:
        return NULL_SPAN
    return Span(tel, name, emit, fields)


def add_span(name: str, seconds: float, emit: bool = True, **fields) -> None:
    """Record an already-measured interval as a span completion at the
    current stack position (loops that time themselves still land in the
    span taxonomy). No-op when off."""
    tel = _telemetry.current()
    if tel is None:
        return
    stack = _STACKS.get(threading.get_ident())
    path = f"{stack[-1]}/{name}" if stack else name
    tel.span_complete(path, seconds, ok=True, emit=emit, fields=fields)


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
