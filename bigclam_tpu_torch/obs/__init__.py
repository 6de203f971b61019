"""Run observability of the port: what happened, where the time went, and
what the optimizer is doing.

Port of bigclam_tpu/obs: the event schema (schema.py, the JAX version
and kinds), the run telemetry (telemetry.py: events.jsonl,
run_report.json, device-memory watermarks from torch.cuda, build and step
build counts), hierarchical spans (trace.py), the stall heartbeat
(heartbeat.py), the model-health monitor (health.py), the comms and memory
models of the port's own steps with the capacity preflight (comms.py,
memory.py), the perf ledger (ledger.py) and the renderers of `cli report`
and `cli watch` (report.py, watch.py). The layout of every artifact is the
JAX package's, so either package's `report` and `perf` read the other's
directories and ledgers.
"""

from bigclam_tpu_torch.obs.health import DEFAULTS as HEALTH_DEFAULTS
from bigclam_tpu_torch.obs.health import HealthMonitor, run_detectors
from bigclam_tpu_torch.obs.heartbeat import Heartbeat
from bigclam_tpu_torch.obs.schema import (
    EVENT_KINDS,
    SCHEMA_VERSION,
    validate_event,
    validate_events_file,
)
from bigclam_tpu_torch.obs.telemetry import (
    RunTelemetry,
    current,
    install,
    note_compile,
    note_step_build,
    uninstall,
)
from bigclam_tpu_torch.obs.trace import open_spans, span

__all__ = [
    "EVENT_KINDS",
    "HEALTH_DEFAULTS",
    "HealthMonitor",
    "Heartbeat",
    "RunTelemetry",
    "SCHEMA_VERSION",
    "current",
    "install",
    "note_compile",
    "note_step_build",
    "open_spans",
    "run_detectors",
    "span",
    "uninstall",
    "validate_event",
    "validate_events_file",
]
