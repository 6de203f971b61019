"""Fault-tolerant fit orchestration: detection -> recovery.

Port of bigclam_tpu/resilience (the modules are copies; they touch no
device):

* faults.py      — deterministic seeded fault injection (kill / delay /
                   NaN / truncate / corrupt) at instrumented sites, driven
                   by tests, chip_smoke.py and BIGCLAM_FAULTS
* retry.py       — classified (transient vs fatal) retry with seeded
                   exponential backoff, emitting retry/recovered/gave_up
                   telemetry events
* supervisor.py  — whole-fit retry that resumes from checkpoints, the
                   stall-escalation abort hook, and the resume lineage
                   record behind `cli fit --resume auto`

The in-loop recovery lives where the loop lives: non-finite ROLLBACK in
models.bigclam.run_fit_loop (a device snapshot refreshed in place and the
step-scale cut), checkpoint payload crc + corruption-safe rotation in
utils.checkpoint.
"""

from bigclam_tpu_torch.resilience.faults import (
    FaultPlan,
    current_plan,
    install_plan,
    maybe_fire,
)
from bigclam_tpu_torch.resilience.retry import (
    FatalError,
    RetryPolicy,
    TransientError,
    call_with_retry,
    classify,
)
from bigclam_tpu_torch.resilience.supervisor import (
    StallEscalation,
    Supervisor,
    read_lineage,
    record_resume,
)

__all__ = [
    "FatalError",
    "FaultPlan",
    "RetryPolicy",
    "StallEscalation",
    "Supervisor",
    "TransientError",
    "call_with_retry",
    "classify",
    "current_plan",
    "install_plan",
    "maybe_fire",
    "read_lineage",
    "record_resume",
]
