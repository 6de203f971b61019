"""Profiler capture, stage timing and host memory of the port's entry
points.

Port of bigclam_tpu/utils/profiling.py: `trace` (a torch.profiler capture
where the JAX package takes a jax.profiler one), `StageProfile`
(wall-clock stage buckets that forward to the run telemetry),
`IngestProfile` (the graph store's stages with host RSS samples), the
host RSS probes, `step_time` (synchronizing the card),
`comm_hidden_fraction` and `overlap_report` (the ring's overlapped
against serial rotation); and the port's own `part` and `step_split`,
which time the named parts of a step on the card through the span tracer
(obs.trace).
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Iterator, List, Optional

# files a capture writes into its directory
TRACE_NAME = "trace.json"
TABLE_NAME = "key_averages.txt"
KERNELS_NAME = "kernels.json"


class NoDeviceKernelsError(RuntimeError):
    """A capture on a card recorded no CUDA kernel: the profiler did not
    see the device, and an empty trace must not pass for one."""


def _device_time_us(evt, self_only: bool = True) -> float:
    """An event's device time in microseconds, under either attribute name
    torch has used (device_* since 2.4, cuda_* before)."""
    names = (("self_device_time_total", "self_cuda_time_total") if self_only
             else ("device_time_total", "cuda_time_total"))
    for name in names:
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def device_kernels(prof, top: int = 0) -> List[dict]:
    """The captured device activity (CUDA kernels and copies with device
    time of their own; ops and the annotations' device ranges are not
    kernels) by device time, largest first: [{"name", "device_ms",
    "calls"}]."""
    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        if (getattr(evt, "device_type", DeviceType.CUDA) != DeviceType.CUDA
                or getattr(evt, "is_user_annotation", False)):
            continue
        us = _device_time_us(evt)
        if us > 0:
            rows.append({"name": evt.key, "device_ms": round(us / 1e3, 6),
                         "calls": int(evt.count)})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows[:top] if top else rows


class Capture:
    """What `trace` yields: after the block, `prof` is the
    torch.profiler.profile object and `kernels` device_kernels(prof)."""

    def __init__(self):
        self.prof = None
        self.kernels: List[dict] = []


@contextlib.contextmanager
def trace(log_dir: Optional[str], require_device: Optional[bool] = None
          ) -> Iterator[Optional[Capture]]:
    """Capture a torch.profiler trace of the block into log_dir: the
    chrome trace (trace.json), the key_averages table (key_averages.txt)
    and the device kernels by time (kernels.json). No-op (yields None)
    when log_dir is None. CUDA activity is captured when a card is
    present; with `require_device` (default: when a card is present) a
    capture that recorded no CUDA kernel raises NoDeviceKernelsError
    after the files are written. Spans (obs.trace) record and open
    record_function annotations while the capture is live."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    if require_device is None:
        require_device = cuda
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    cap = Capture()
    with profile(activities=activities) as prof:
        try:
            yield cap
        finally:
            if cuda:
                torch.cuda.synchronize()
    cap.prof = prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_NAME))
    sort = "self_cuda_time_total" if cuda else "self_cpu_time_total"
    try:
        table = prof.key_averages().table(sort_by=sort, row_limit=50)
    except Exception:
        table = prof.key_averages().table(row_limit=50)
    with open(os.path.join(log_dir, TABLE_NAME), "w") as f:
        f.write(table)
    cap.kernels = device_kernels(prof)
    with open(os.path.join(log_dir, KERNELS_NAME), "w") as f:
        json.dump(cap.kernels, f, indent=1)
    if require_device and not cap.kernels:
        raise NoDeviceKernelsError(
            f"the torch.profiler capture in {log_dir} recorded no CUDA "
            "kernel (CUDA activity requested: "
            f"{cuda}); the profiler did not see the device"
        )


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
        self.counts: dict = {}

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

    def add_seconds(self, name: str, s: float) -> None:
        """Accumulate into a stage bucket without the context manager (for
        loops whose body already lives inside another `with`); the seconds
        also land in the span breakdown and the telemetry."""
        from bigclam_tpu_torch.obs import trace as _trace

        self.seconds[name] = self.seconds.get(name, 0.0) + s
        _trace.add_span(name, s)
        _telemetry_stage(name, s)

    def count(self, name: str, inc: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + inc

    def report(self) -> dict:
        return {
            "seconds": {k: round(v, 3) for k, v in self.seconds.items()},
            "counts": dict(self.counts),
        }


class IngestProfile(StageProfile):
    """StageProfile + host-RSS tracking for the streaming ingest pipeline
    (graph/store.compile_graph_cache and apply_delta; surfaced by `cli
    ingest`). Copied from bigclam_tpu/utils/profiling.py.

    `sample_rss()` is called at chunk/bucket granularity inside the
    compile stages, so the reported peak is the footprint of the
    out-of-core build where its transients live. The report records the
    baseline taken at construction, the sampled peak, their delta (the
    ingest's own footprint), and the process-lifetime ru_maxrss.
    `count("raw_edges", m)` at the parse sites feeds the edges/sec
    figures. Scope: THIS process only (spawned parse workers are not
    counted)."""

    def __init__(self) -> None:
        super().__init__()
        self.rss_baseline = current_rss_bytes()
        self.rss_peak = self.rss_baseline

    def sample_rss(self) -> int:
        rss = current_rss_bytes()
        if rss > self.rss_peak:
            self.rss_peak = rss
        return rss

    def report(self) -> dict:
        rep = super().report()
        rep["rss"] = {
            "baseline_bytes": self.rss_baseline,
            "peak_sampled_bytes": self.rss_peak,
            "delta_bytes": self.rss_peak - self.rss_baseline,
            "process_peak_bytes": peak_rss_bytes(),
        }
        # "scan" is the parse stage; the all-stage sum is the end-to-end
        # pipeline rate (edges_per_sec, its alias)
        total_s = sum(self.seconds.values())
        parse_s = self.seconds.get("scan", 0.0)
        edges = self.counts.get("raw_edges", 0)
        if edges and total_s > 0:
            rep["edges_per_sec"] = round(edges / total_s, 1)
            rep["edges_per_sec_end_to_end"] = rep["edges_per_sec"]
        if edges and parse_s > 0:
            rep["edges_per_sec_parse"] = round(edges / parse_s, 1)
        return rep


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


def _sync(state) -> None:
    """Wait for the card(s) holding the state's F (a tensor or shards)."""
    import torch

    from bigclam_tpu_torch.parallel.mesh import state_blocks

    for t in state_blocks(state.F):
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)


def step_time(step_fn, state, steps: int = 5, warmup: int = 1) -> float:
    """Wall-clock seconds per training step: `warmup` un-timed steps, then
    `steps` chained steps (the state threads through, so the measurement
    covers the real dependency chain), synchronizing the card before and
    after."""
    import time

    for _ in range(max(warmup, 0)):
        state = step_fn(state)
    _sync(state)
    t0 = time.perf_counter()
    for _ in range(max(steps, 1)):
        state = step_fn(state)
    _sync(state)
    return (time.perf_counter() - t0) / max(steps, 1)


def comm_hidden_fraction(overlap_s: float, serial_s: float) -> float:
    """Fraction of the serial step time the overlapped schedule
    eliminated: (serial - overlap) / serial, clamped at 0."""
    if serial_s <= 0:
        return 0.0
    return round(max(1.0 - overlap_s / serial_s, 0.0), 4)


def overlap_report(model, state, steps: int = 5, warmup: int = 1) -> dict:
    """Time a ring trainer's step under both rotation schedules
    (cfg.ring_overlap on and off, parallel.ring.RingRotation) and report
    the communication-hiding win. Rebuilds the model's step with the flag
    toggled and restores the original cfg and step afterwards.

    `distinct_devices` rides beside the fraction: on a mesh that repeats
    one card every hop is a no-op, so there is nothing to hide and the
    fraction is noise around 0.

    Returns {"sec_per_step": {"overlap": s, "serial": s},
             "comm_hidden_fraction": f, "distinct_devices": d}."""
    from bigclam_tpu_torch.obs import trace as _trace

    cfg0 = model.cfg
    times = {}
    with _trace.span("ring_overlap_probe") as probe:
        try:
            for name, flag in (("overlap", True), ("serial", False)):
                with _trace.span(name):
                    model.cfg = cfg0.replace(ring_overlap=flag)
                    model.rebuild_step()
                    times[name] = step_time(model._step, state, steps,
                                            warmup)
        finally:
            model.cfg = cfg0
            model.rebuild_step()
        rep = {
            "sec_per_step": {k: round(v, 6) for k, v in times.items()},
            "comm_hidden_fraction": comm_hidden_fraction(
                times["overlap"], times["serial"]
            ),
            "distinct_devices": len(set(str(d) for d in model.devices)),
        }
        probe.set(**rep)
    return rep


# --- the parts of a step, timed on the card ---------------------------------


def part(name: str, device):
    """The span (obs.trace) of one named part of a step, timed on the
    current stream of `device` (wall time on the CPU): the mesh steps
    (parallel/sharded.py and parallel/ring.py mark dots, k_psum, consume,
    tails, gather, rotation (the ring's hops alone) and finish, none inside
    another) and the one-chip sparse step (models/sparse.py). The shared
    no-op unless spans record."""
    from bigclam_tpu_torch.obs.trace import span

    return span(name, emit=False, device=device)


@contextlib.contextmanager
def step_split() -> Iterator[dict]:
    """Record the parts of the steps run inside the block (an
    obs.trace.recording() scope); on exit the yielded dict holds
    milliseconds per part name, summed over the part's paths (the card is
    synchronized first). Parts on one card's one stream add up to its
    busy time; a ring hop on side streams is timed where it is issued and
    where the first device's stream waits for it."""
    from bigclam_tpu_torch.obs import trace as _trace

    out: dict = {}
    before = _trace.totals()["spans"]
    try:
        with _trace.recording():
            yield out
    finally:
        for path, row in _trace.totals()["spans"].items():
            was = before.get(path, {"device_ms": 0.0, "count": 0})
            if row["device_ms"] is not None and row["count"] > was["count"]:
                name = path.rsplit("/", 1)[-1]
                out[name] = (out.get(name, 0.0) + row["device_ms"]
                             - (was["device_ms"] or 0.0))
