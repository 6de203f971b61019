"""Stall heartbeat: a daemon thread that notices when NOTHING completes.

Port of bigclam_tpu/obs/heartbeat.py. Fit iterations and stage
completions call `beat()`, and when no beat lands within `deadline_s` the
thread emits a `stall` event — last known progress, how long the run has
been silent, host RSS, the open span stack, the last health sample, and
the last device-memory snapshot the main thread took — to the telemetry
event log (always) and to stderr (unless the run is quiet).

The thread reads host state only. It never calls into CUDA (the device
snapshot it embeds is the one the main thread sampled last), so a stall
report cannot itself block on a wedged card. It samples, it never
interrupts: repeated stalls re-emit once per deadline, so a long hang
produces a timeline, not one line.

ESCALATION: with `escalate_after=N`, the Nth CONSECUTIVE stall (no beat in
between) additionally emits ONE `stall_escalated` event and invokes
`on_escalate` (the resilience supervisor's hook, which can abort-and-retry
the attempt for host-side stalls). One escalation per silence episode: a
beat resets the consecutive counter and re-arms it.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Optional


class Heartbeat:
    """Daemon watchdog bound to a RunTelemetry (`telemetry.event` is the
    sink; it is thread-safe). It checks four times a deadline; `stop()`
    joins the thread."""

    def __init__(
        self,
        telemetry,
        deadline_s: float,
        echo: bool = True,
        escalate_after: int = 0,
        on_escalate=None,
    ):
        self.telemetry = telemetry
        self.deadline_s = float(deadline_s)
        self.echo = echo
        self.poll_s = max(self.deadline_s / 4.0, 0.01)
        self.stalls = 0
        self.escalate_after = int(escalate_after)
        self.on_escalate = on_escalate
        self.escalations = 0
        self._consecutive = 0
        self._last_beat = time.monotonic()
        self._last_emit = self._last_beat
        self._progress: dict = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Heartbeat":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="bigclam-heartbeat", daemon=True
            )
            self._thread.start()
        return self

    def beat(self, **progress) -> None:
        """Record forward progress (called from the fit loop / stage sink;
        must stay cheap — two attribute writes under a lock)."""
        with self._lock:
            self._last_beat = time.monotonic()
            self._last_emit = self._last_beat
            self._consecutive = 0       # progress re-arms escalation
            if progress:
                self._progress = progress

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(self.poll_s * 4, 1.0))
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            now = time.monotonic()
            with self._lock:
                silent = now - self._last_beat
                since_emit = now - self._last_emit
                progress = dict(self._progress)
            if silent < self.deadline_s or since_emit < self.deadline_s:
                continue
            with self._lock:
                self._last_emit = now
            self._emit(silent, progress)

    def _emit(self, silent_s: float, progress: dict) -> None:
        from bigclam_tpu_torch.obs import trace as _trace
        from bigclam_tpu_torch.utils.profiling import current_rss_bytes

        self.stalls += 1
        with self._lock:
            self._consecutive += 1
            consecutive = self._consecutive
        rss = current_rss_bytes()
        # host state only: the main thread's last device snapshot, the
        # open span stack ("stuck in WHICH phase"), the last health sample
        # ("diverging" vs "wedged") and the last sync-span duration
        tel = self.telemetry
        devices = list(tel.last_devices)
        spans = _trace.open_spans()
        health, sync_s = tel.last_health, tel.last_sync_s
        self.telemetry.event(
            "stall",
            silent_s=round(silent_s, 3),
            rss_bytes=rss,
            progress=progress,
            devices=devices,
            spans=spans,
            health=health,
            sync_s=sync_s,
        )
        if self.echo:
            where = f"; open span: {spans[-1]}" if spans else ""
            print(
                f"[bigclam] STALL: no step/stage completed for "
                f"{silent_s:.0f}s (deadline {self.deadline_s:g}s); "
                f"last progress: {progress or 'none'}; "
                f"rss {rss >> 20} MiB{where}",
                file=sys.stderr,
                flush=True,
            )
        if self.escalate_after and consecutive == self.escalate_after:
            self.escalations += 1
            self.telemetry.event(
                "stall_escalated",
                stalls=consecutive,
                silent_s=round(silent_s, 3),
                progress=progress,
                spans=spans,
                health=health,
                sync_s=sync_s,
            )
            if self.echo:
                print(
                    f"[bigclam] STALL ESCALATED after {consecutive} "
                    f"consecutive deadline(s)",
                    file=sys.stderr,
                    flush=True,
                )
            cb = self.on_escalate
            if cb is not None:
                try:
                    cb({"silent_s": silent_s, "stalls": consecutive,
                        "progress": progress})
                except Exception as e:
                    # the watchdog keeps watching, and the failure is
                    # reported, not dropped
                    err = f"{type(e).__name__}: {e}"
                    self.telemetry.event("note", what="on_escalate failed",
                                         error=err)
                    print(f"[bigclam] heartbeat: on_escalate failed: {err}",
                          file=sys.stderr, flush=True)
