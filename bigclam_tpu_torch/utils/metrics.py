"""Structured per-step metrics: JSONL records + stderr echo.

Port of bigclam_tpu/utils/metrics.py. Every step emits a structured
record — iteration, LLH, relative change, wall-clock, edges/sec, the
accepted-step histogram — appended to a JSONL file (`--metrics`) and/or
echoed to stderr, and forwarded to the run telemetry as a `step` event.
Under a process group only rank 0 writes and echoes; every rank still
forwards to its own telemetry.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Optional, TextIO


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True):
        """The file opens at the FIRST log call, and "t" is seconds since
        that call: the CLI builds the logger before loading the graph, and
        a construction-stamped t0 would fold graph-load and model-build
        time into the first step's "t". That setup time is reported once
        as "load_s" on the first record instead."""
        self.path = path
        self.echo = echo
        self._fh: Optional[TextIO] = None
        self._opened = False
        self._created = time.perf_counter()
        self._t0: Optional[float] = None
        self.load_s: Optional[float] = None
        self._last_t: Optional[float] = None
        self._last_llh: Optional[float] = None

    def _open(self) -> None:
        if self._opened:
            return
        self._opened = True
        self._t0 = time.perf_counter()
        self.load_s = round(self._t0 - self._created, 4)
        # decided at the first record, once the group is joined
        from bigclam_tpu_torch.utils.dist import is_primary

        if not is_primary():
            self.path, self.echo = None, False
        if self.path:
            self._fh = open(self.path, "a")

    def log(self, record: Dict[str, Any]) -> None:
        first = not self._opened
        self._open()
        # "t" is MONOTONIC (perf_counter) and is what durations derive
        # from; "ts" is the wall clock for correlating with external logs
        record = {
            "t": round(time.perf_counter() - self._t0, 4),
            "ts": round(time.time(), 3),
            **record,
        }
        if first:
            record["load_s"] = self.load_s
        line = json.dumps(record)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.echo:
            print(line, file=sys.stderr)
        from bigclam_tpu_torch.obs import telemetry as _obs

        tel = _obs.current()
        if tel is not None:
            tel.metric_record(record)

    def step_callback(
        self,
        num_directed_edges: int,
        chips: int = 1,
        path: str = "",
        num_nodes: int = 0,
    ):
        """A fit-loop callback(it, llh, extras) that logs iter/LLH/dllh/
        edges-per-sec and — when the loop supplies it — the accepted-step
        histogram + acceptance rate (a fit whose line search collapses to
        tiny steps or rejects everything must be visible in the JSONL).

        `path` is the trainer's engaged kernel path (model.engaged_path) so
        the records say which kernels ran. `num_nodes` (real, unpadded)
        turns the histogram into an exact acceptance rate: padding rows can
        only land in the rejected slot."""

        def cb(it: int, llh: float, extras: Optional[Dict] = None) -> None:
            now = time.perf_counter()
            rec: Dict[str, Any] = {"iter": it, "llh": llh}
            if path:
                rec["path"] = path
            if self._last_llh not in (None, 0.0):
                rec["rel_dllh"] = abs(1.0 - llh / self._last_llh)
            if self._last_t is not None:
                dt = now - self._last_t
                rec["sec_per_iter"] = round(dt, 4)
                if dt > 0:
                    rec["edges_per_sec_per_chip"] = round(
                        num_directed_edges / dt / chips, 1
                    )
            if extras and extras.get("accept_hist") is not None:
                hist = list(extras["accept_hist"])
                accepted = int(sum(hist[:-1]))
                # slot order: one count per cfg.step_candidates entry
                # (descending eta), final slot = no-accepted-step rows
                rec["accept_hist"] = hist
                if num_nodes > 0:
                    rec["accept_rate"] = round(accepted / num_nodes, 4)
            self._last_t = now
            self._last_llh = llh
            self.log(rec)

        return cb

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
