"""Stage timing and host memory of the port's entry points.

The parts of bigclam_tpu/utils/profiling.py the port needs so far:
`StageProfile` (wall-clock stage buckets that forward to the run
telemetry) and the host RSS probes. The profiler capture (`trace`),
`step_time` and `overlap_report` come with `--profile-dir`.
"""

from __future__ import annotations

import contextlib
from typing import Iterator


class StageProfile:
    """Per-stage wall clock of a host-driven schedule (`cli fit`: graph,
    model_build, seeding, upload, fit, extract).

    Re-entering a stage accumulates (stages are wall-clock buckets, not a
    call tree).

    SINK of the run telemetry layer (bigclam_tpu_torch.obs): every
    completed stage is also a span of the same name and forwards (name,
    seconds) to the installed RunTelemetry — which logs a `stage` event,
    samples a device-memory watermark at the stage boundary, and beats the
    stall heartbeat. With telemetry off the forward is one None check.
    """

    def __init__(self) -> None:
        self.seconds: dict = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        import time

        from bigclam_tpu_torch.obs import trace as _trace

        with _trace.span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self.seconds[name] = self.seconds.get(name, 0.0) + dt
                _telemetry_stage(name, dt)


def _telemetry_stage(name: str, seconds: float) -> None:
    """Forward a completed stage to the installed RunTelemetry."""
    from bigclam_tpu_torch.obs import telemetry

    tel = telemetry.current()
    if tel is not None:
        tel.stage_complete(name, seconds)


def current_rss_bytes() -> int:
    """This process's resident set right now (/proc/self/statm; Linux)."""
    try:
        import os

        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return peak_rss_bytes()        # no /proc: lifetime peak as fallback


def peak_rss_bytes() -> int:
    """Process-lifetime peak RSS (ru_maxrss; KiB on Linux)."""
    import resource
    import sys

    scale = 1024 if sys.platform != "darwin" else 1
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * scale
