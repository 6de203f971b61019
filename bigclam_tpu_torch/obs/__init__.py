"""Run observability of the port: what happened, where the time went, and
what the optimizer is doing.

Port of the core of bigclam_tpu/obs: the event schema (schema.py, the JAX
version and kinds), the run telemetry (telemetry.py: events.jsonl,
run_report.json, device-memory watermarks from torch.cuda, build counts),
hierarchical spans (trace.py), the stall heartbeat (heartbeat.py) and the
model-health monitor (health.py). The perf ledger, the memory and comms
models, `report` and `watch` are not ported yet; the JAX package's
jax-free validator and `cli report` read a port run's directory.
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
    "open_spans",
    "run_detectors",
    "span",
    "uninstall",
    "validate_event",
    "validate_events_file",
]
