"""RunTelemetry: the run-scoped telemetry object every entry point threads
through.

Port of bigclam_tpu/obs/telemetry.py. The event log (`events.jsonl`), the
run report (`run_report.json`) and their layout are the JAX package's, so
its jax-free schema validator and `cli report` read a port run. What
differs on the card:

* **One writer.** The port runs single-controller (one process drives
  every card of a mesh), so process 0 writes; there is no gate to defer.

* **Device memory from torch.cuda.** Watermarks read
  `torch.cuda.memory_stats` (current and peak allocated bytes) and
  `max_memory_allocated` of every card torch has initialized, on the
  thread that calls `watermark` — never from the heartbeat thread, and
  never initializing CUDA: a CPU run reports no devices.

* **Compile counters count builds.** The port compiles its CUDA kernels
  with nvcc (ops/build.py) and its host library with g++
  (graph/native); each build or load is a `compile` event with its
  seconds (`note_compile`), counted in the report under the JAX keys
  (`backend_compiles`: builds; `by_key`: per library). There is no
  jax.monitoring listener, and a train step compiles nothing
  (`step_builds` 0).

* **No modeled memory.** `hbm_modeled_bytes` waits for obs/memory.py;
  the report leaves it out rather than guess.

* **Thread safety.** The heartbeat emits from its own thread; event writes
  and counter updates take one lock.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, TextIO

from bigclam_tpu_torch.obs.schema import SCHEMA_VERSION
from bigclam_tpu_torch.utils.profiling import current_rss_bytes, peak_rss_bytes

EVENTS_NAME = "events.jsonl"
REPORT_NAME = "run_report.json"

_CURRENT: Optional["RunTelemetry"] = None


def current() -> Optional["RunTelemetry"]:
    """The installed telemetry, or None when observability is off — the
    whole off-path cost at instrumentation sites is this None check."""
    return _CURRENT


def install(tel: "RunTelemetry") -> "RunTelemetry":
    global _CURRENT
    _CURRENT = tel
    return tel


def uninstall(tel: Optional["RunTelemetry"] = None) -> None:
    """Clear the slot (only if `tel` still owns it, when given)."""
    global _CURRENT
    if tel is None or _CURRENT is tel:
        _CURRENT = None


def note_compile(name: str, seconds: float, cached: bool = False) -> None:
    """Record one build or load of compiled code (the nvcc kernel library,
    the g++ host library) in the installed telemetry; no-op when off."""
    tel = _CURRENT
    if tel is not None:
        tel.compile_complete(name, seconds, cached=cached)


def _json_default(obj):
    """numpy scalars/arrays slip into event fields from callers (an int
    from a manifest, an accept histogram) — serialize them as their
    Python values instead of crashing the event log mid-run."""
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:
        return obj.item()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return str(obj)


def _finite_safe(obj):
    """Replace non-finite floats with their repr strings ("nan", "inf",
    "-inf") recursively. json.dumps would otherwise write literal NaN —
    not JSON — and the one event that carries a NaN by design is the
    nonfinite sentinel's, exactly the line strict consumers (jq, log
    pipelines) must be able to parse."""
    import math as _math

    if isinstance(obj, float):
        return obj if _math.isfinite(obj) else repr(obj)
    if isinstance(obj, dict):
        return {k: _finite_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite_safe(v) for v in obj]
    if hasattr(obj, "item") or hasattr(obj, "tolist"):
        return _finite_safe(_json_default(obj))
    return obj


def _resolve_run_id(directory: str) -> str:
    """One run id per telemetry DIRECTORY: the first process to os.link
    its candidate onto `run_id` wins (atomic on POSIX), everyone else
    reads the winner. A dir reused across runs keeps its id — one
    telemetry dir = one run is the contract (events append; a resume
    after a crash correlates under the same id)."""
    path = os.path.join(directory, "run_id")
    rid = f"{int(time.time()):x}-{os.urandom(3).hex()}"
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w") as f:
            f.write(rid)
        os.link(tmp, path)
        return rid
    except OSError:
        pass                    # somebody else claimed it (or no link())
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    for _ in range(100):        # winner may still be mid-write
        try:
            with open(path) as f:
                got = f.read().strip()
            if got:
                return got
        except OSError:
            pass
        time.sleep(0.01)
    return rid


def _process_index() -> int:
    """The port runs single-controller: one process, index 0."""
    return 0


def _cuda_devices() -> list:
    """The cards torch has initialized (none on a CPU run): reading them
    must never be what initializes CUDA."""
    torch = sys.modules.get("torch")
    if torch is None:
        return []
    try:
        if not torch.cuda.is_initialized():
            return []
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    except Exception:
        return []


def _fingerprint() -> Dict[str, Any]:
    """Host/device identity of the run: backend `cuda` and the card's name
    where a card was initialized, else `cpu`."""
    import socket

    fp: Dict[str, Any] = {
        "host": socket.gethostname(),
        "platform": sys.platform,
        "backend": "cpu",
        "device_kind": "cpu",
        "devices": 0,
    }
    devs = _cuda_devices()
    if devs:
        import torch

        fp["backend"] = "cuda"
        fp["devices"] = len(devs)
        fp["device_kind"] = torch.cuda.get_device_name(devs[0])
    return fp


class RunTelemetry:
    """One run = one instance = one telemetry directory.

    Usage (the CLI pattern)::

        tel = RunTelemetry(dir, entry="fit", heartbeat_s=args.heartbeat_s,
                           quiet=args.quiet)
        with tel:                       # install() + finalize() on exit
            ... run ...
            tel.set_final({"llh": ...})

    Artifacts: `events.jsonl` and `run_report.json`.
    """

    def __init__(
        self,
        directory: str,
        entry: str = "",
        heartbeat_s: float = 0.0,
        quiet: bool = False,
        heartbeat_escalate: int = 0,
    ):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.entry = entry
        self.run_id = _resolve_run_id(directory)
        self.quiet = quiet
        self.started_unix = time.time()
        self._t0 = time.perf_counter()
        self._lock = threading.RLock()
        self._fh: Optional[TextIO] = open(
            os.path.join(directory, EVENTS_NAME), "a"
        )
        self._finalized = False
        self.event_counts: Dict[str, int] = {}
        self.stage_seconds: Dict[str, float] = {}
        self.stage_counts: Dict[str, int] = {}
        # span sinks (obs.trace): per-path running totals — the run
        # report's span table reads these
        self.span_seconds: Dict[str, float] = {}
        self.span_counts: Dict[str, int] = {}
        self.span_orphans = 0
        # per-step wall-clock samples (sec_per_iter forwarded by the
        # MetricsLogger sink)
        self._step_secs: List[float] = []
        # model health: last `health` event payload + per-check anomaly
        # counts, folded in by event() — the heartbeat embeds last_health
        # into stall reports (a stall then says "diverging", not just
        # "silent") and the run report grows a health section
        self.last_health: Optional[Dict[str, Any]] = None
        self.health_samples = 0
        self.anomaly_counts: Dict[str, int] = {}
        # the last fit-loop sync-span duration, for stall context
        self.last_sync_s: Optional[float] = None
        # tag -> number of watermark samples; dev -> running max stats;
        # the last snapshot, which the heartbeat thread embeds in stall
        # events without reading the device itself
        self.watermark_tags: Dict[str, int] = {}
        self.device_peak: Dict[str, Dict[str, Optional[int]]] = {}
        self.last_devices: List[dict] = []
        self.compiles: Dict[str, Any] = {
            "backend_compiles": 0,
            "backend_compile_s": 0.0,
            "loads": 0,
            "step_builds": 0,
            "by_key": {},
        }
        self.final: Dict[str, Any] = {}
        self.heartbeat = None
        if heartbeat_s and heartbeat_s > 0:
            from bigclam_tpu_torch.obs.heartbeat import Heartbeat

            self.heartbeat = Heartbeat(
                self, heartbeat_s, echo=not quiet,
                escalate_after=heartbeat_escalate,
            ).start()
        self.event("start", entry=entry)

    # ------------------------------------------------------------- events
    def event(self, kind: str, **fields) -> None:
        """Append one schema event (obs.schema). Thread-safe."""
        elapsed = time.perf_counter() - self._t0
        rec = {
            "v": SCHEMA_VERSION,
            "run": self.run_id,
            "pid": _process_index(),
            "t": round(elapsed, 4),
            # wall clock for external correlation; elapsed_s (monotonic)
            # is the ordering/duration field
            "ts": round(time.time(), 3),
            "elapsed_s": round(elapsed, 6),
            "kind": kind,
            **fields,
        }
        try:
            line = json.dumps(rec, default=_json_default, allow_nan=False)
        except ValueError:       # a non-finite float somewhere in fields
            line = json.dumps(
                _finite_safe(rec), default=_json_default, allow_nan=False
            )
        with self._lock:
            self.event_counts[kind] = self.event_counts.get(kind, 0) + 1
            if kind == "health":
                self.last_health = dict(fields)
                self.health_samples += 1
            elif kind == "anomaly":
                check = str(fields.get("check", "?"))
                self.anomaly_counts[check] = (
                    self.anomaly_counts.get(check, 0) + 1
                )
            if self._fh is not None:
                self._fh.write(line + "\n")
                self._fh.flush()

    # -------------------------------------------------------------- sinks
    def stage_complete(self, name: str, seconds: float) -> None:
        """StageProfile sink: stage wall-clock + a memory watermark at the
        stage boundary + a heartbeat beat."""
        with self._lock:
            self.stage_seconds[name] = (
                self.stage_seconds.get(name, 0.0) + seconds
            )
            self.stage_counts[name] = self.stage_counts.get(name, 0) + 1
        self.event("stage", name=name, seconds=round(seconds, 4))
        self.watermark(f"stage:{name}")
        if self.heartbeat is not None:
            self.heartbeat.beat(stage=name)

    def metric_record(self, record: Dict[str, Any]) -> None:
        """MetricsLogger sink: per-step records land as `step` events,
        other records (sweep per-K lines) as `metric`. The logger's own
        relative "t" / wall "ts" are dropped — telemetry stamps its own."""
        fields = {k: v for k, v in record.items() if k not in ("t", "ts")}
        kind = "step" if "iter" in fields else "metric"
        if kind == "step":
            sec = fields.get("sec_per_iter")
            if isinstance(sec, (int, float)):
                with self._lock:
                    self._step_secs.append(float(sec))
        self.event(kind, **fields)

    def span_complete(
        self,
        path: str,
        seconds: float,
        ok: bool = True,
        emit: bool = True,
        fields: Optional[Dict[str, Any]] = None,
        orphans: int = 0,
    ) -> None:
        """obs.trace sink: fold one closed span into the per-path totals
        and (emit=True) write its `span` event. Must stay cheap — the fit
        loop closes several emit=False spans per iteration."""
        with self._lock:
            self.span_seconds[path] = (
                self.span_seconds.get(path, 0.0) + seconds
            )
            self.span_counts[path] = self.span_counts.get(path, 0) + 1
            if orphans:
                self.span_orphans += orphans
            if path.endswith("fit_loop/sync"):
                self.last_sync_s = round(seconds, 6)
        if emit:
            payload = dict(fields) if fields else {}
            if not ok:
                payload["ok"] = False
            self.event(
                "span",
                name=path.rsplit("/", 1)[-1],
                path=path,
                seconds=round(seconds, 6),
                **payload,
            )

    def step_beat(self, it: int, llh: float) -> None:
        """Fit-loop heartbeat hook (run_fit_loop): progress only, no event
        — step events arrive via the MetricsLogger sink when one is wired."""
        if self.heartbeat is not None:
            self.heartbeat.beat(iter=int(it), llh=float(llh))

    # ------------------------------------------------------------- memory
    def device_memory_snapshot(self) -> List[dict]:
        """Per-card allocator statistics right now (torch.cuda.memory_stats:
        current and peak allocated bytes, the card's total); [] with no
        card initialized."""
        devs = _cuda_devices()
        if not devs:
            return []
        import torch

        out = []
        for d in devs:
            try:
                stats = torch.cuda.memory_stats(d)
                limit = torch.cuda.get_device_properties(d).total_memory
            except Exception:
                stats, limit = {}, None
            out.append(
                {
                    "device": str(d),
                    "bytes_in_use": stats.get("allocated_bytes.all.current"),
                    "peak_bytes_in_use": torch.cuda.max_memory_allocated(d),
                    "bytes_limit": limit,
                }
            )
        return out

    def watermark(self, tag: str) -> List[dict]:
        """Sample device memory, fold into the per-device running peaks,
        and emit a `memory` event. Called at stage boundaries (the sink)
        on the thread that runs the stages."""
        devices = self.device_memory_snapshot()
        if not devices:
            return []
        with self._lock:
            self.last_devices = devices
            self.watermark_tags[tag] = self.watermark_tags.get(tag, 0) + 1
            for d in devices:
                peak = self.device_peak.setdefault(
                    d["device"],
                    {"bytes_in_use": None, "peak_bytes_in_use": None,
                     "bytes_limit": d["bytes_limit"]},
                )
                for key in ("bytes_in_use", "peak_bytes_in_use"):
                    v = d[key]
                    if v is not None and (
                        peak[key] is None or v > peak[key]
                    ):
                        peak[key] = v
        self.event("memory", tag=tag, devices=devices)
        return devices

    # ------------------------------------------------------------ compile
    def compile_complete(self, name: str, seconds: float,
                         cached: bool = False) -> None:
        """One build (cached=False) or load of an already-built library
        (cached=True), as a `compile` event."""
        with self._lock:
            entry = self.compiles["by_key"].setdefault(
                name, {"builds": 0, "compiles": 0, "loads": 0, "seconds": 0.0}
            )
            if cached:
                self.compiles["loads"] += 1
                entry["loads"] += 1
            else:
                self.compiles["backend_compiles"] += 1
                self.compiles["backend_compile_s"] = round(
                    self.compiles["backend_compile_s"] + seconds, 4
                )
                entry["builds"] += 1
                entry["compiles"] += 1
            entry["seconds"] = round(entry["seconds"] + seconds, 4)
        self.event("compile", name=name, seconds=round(seconds, 4),
                   cached=bool(cached))

    def compile_count(self) -> int:
        """The headline compile counter: builds of compiled code."""
        return self.compiles["backend_compiles"]

    # ------------------------------------------------------------- report
    def set_final(self, outcome: Dict[str, Any]) -> None:
        """Entry-point outcome embedded in the run report (fit LLH, sweep
        chosen K, ...)."""
        self.final.update(outcome)

    def report(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "v": SCHEMA_VERSION,
                "run": self.run_id,
                "pid": _process_index(),
                "processes": 1,
                "entry": self.entry,
                "started_unix": round(self.started_unix, 3),
                "wall_s": round(time.perf_counter() - self._t0, 3),
                "stages": {
                    "seconds": {
                        k: round(v, 3)
                        for k, v in self.stage_seconds.items()
                    },
                    "counts": dict(self.stage_counts),
                },
                "spans": {
                    "seconds": {
                        k: round(v, 4)
                        for k, v in self.span_seconds.items()
                    },
                    "counts": dict(self.span_counts),
                    "orphans": self.span_orphans,
                },
                "steps_timed": len(self._step_secs),
                "health": {
                    "samples": self.health_samples,
                    "last": (
                        dict(self.last_health)
                        if self.last_health is not None
                        else None
                    ),
                    "anomalies": dict(self.anomaly_counts),
                },
                "fingerprint": _fingerprint(),
                "memory": {
                    "host_rss_bytes": current_rss_bytes(),
                    "host_rss_peak_bytes": peak_rss_bytes(),
                    "device_peak": {
                        k: dict(v) for k, v in self.device_peak.items()
                    },
                    "watermark_tags": dict(self.watermark_tags),
                },
                "compiles": {
                    **{k: v for k, v in self.compiles.items()
                       if k != "by_key"},
                    "by_key": {
                        k: dict(v)
                        for k, v in self.compiles["by_key"].items()
                    },
                    "count": self.compile_count(),
                },
                "heartbeat": {
                    "deadline_s": (
                        self.heartbeat.deadline_s
                        if self.heartbeat is not None
                        else None
                    ),
                    "stalls": (
                        self.heartbeat.stalls
                        if self.heartbeat is not None
                        else 0
                    ),
                    "escalations": (
                        self.heartbeat.escalations
                        if self.heartbeat is not None
                        else 0
                    ),
                },
                "events": dict(self.event_counts),
                "final": dict(self.final),
            }

    def report_path(self) -> str:
        return os.path.join(self.directory, REPORT_NAME)

    def finalize(self) -> Dict[str, Any]:
        """Stop the heartbeat, take a last watermark, emit `end`, write
        the run report, close the log. Idempotent."""
        with self._lock:
            if self._finalized:
                return self.report()
            self._finalized = True
        if self.heartbeat is not None:
            self.heartbeat.stop()
        self.watermark("final")
        self.event(
            "end", wall_s=round(time.perf_counter() - self._t0, 3)
        )
        rep = self.report()
        tmp = self.report_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(_finite_safe(rep), f, indent=1, sort_keys=True,
                      default=_json_default, allow_nan=False)
        os.replace(tmp, self.report_path())
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
        return rep

    # ------------------------------------------------------- context mgmt
    def __enter__(self) -> "RunTelemetry":
        install(self)
        return self

    def __exit__(self, *exc) -> None:
        try:
            self.finalize()
        finally:
            uninstall(self)
