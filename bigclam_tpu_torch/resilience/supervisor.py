"""Retry/backoff supervisor + resume lineage.

Copied from bigclam_tpu/resilience/supervisor.py.

The Supervisor is the orchestration shim between the CLI entry points and
the work they run: graph loads, checkpoint I/O, and whole fit attempts go
through `call`/`run_fit`, which retries transient-classified failures with
backoff (retry.py) and converts the heartbeat's stall escalation into a
retryable abort. A fit retried this way re-enters `model.fit(...,
checkpoints=...)` and therefore RESUMES from the newest valid checkpoint —
retry is recovery, not repetition.

Stall escalation: the watchdog thread (obs.heartbeat) cannot cancel a
wedged collective, but a HOST-side stall (a hung filesystem read, a
deadlocked spawn pool) is interruptible. With `abort_on_stall=True` the
supervisor's escalation hook raises KeyboardInterrupt in the main thread
(`_thread.interrupt_main`), `run_fit` converts it to a transient
StallEscalation, and the attempt retries/resumes. Default off: for device
stalls interruption cannot help, and the escalated event alone is the
right behavior.

Resume lineage: every `--resume auto` that actually restores appends an
attempt record to `resume_lineage.json` in the telemetry directory — the
run id (shared across attempts through the run-id claim file), a fresh
attempt id, the resumed step, and the wall time — and emits a `resume`
event. The JAX package's `cli report` (jax-free) renders the chain.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from bigclam_tpu_torch.resilience.retry import (
    RetryPolicy,
    call_with_retry,
    classify,
)

LINEAGE_NAME = "resume_lineage.json"


class StallEscalation(RuntimeError):
    """The stall watchdog escalated and aborted this attempt (transient:
    the retried attempt resumes from the newest checkpoint)."""


def classify_with_escalation(exc: BaseException) -> str:
    if isinstance(exc, StallEscalation):
        return "transient"
    return classify(exc)


class Supervisor:
    """Wraps fallible stages with classified retry and owns the heartbeat
    escalation hook. One per entry-point invocation."""

    def __init__(
        self,
        policy: Optional[RetryPolicy] = None,
        abort_on_stall: bool = False,
    ):
        self.policy = policy or RetryPolicy()
        self.abort_on_stall = abort_on_stall
        self.escalations = 0
        self._escalated = threading.Event()

    # ------------------------------------------------------------ wiring
    def attach(self, telemetry) -> "Supervisor":
        """Register as the stall-escalation sink of `telemetry`'s
        heartbeat (no-op when telemetry/heartbeat is off)."""
        hb = getattr(telemetry, "heartbeat", None)
        if hb is not None:
            hb.on_escalate = self._on_escalate
        return self

    def _on_escalate(self, info: dict) -> None:
        # called from the watchdog thread
        self.escalations += 1
        self._escalated.set()
        if self.abort_on_stall:
            import _thread

            _thread.interrupt_main()

    # ------------------------------------------------------------- calls
    def call(self, site: str, fn: Callable):
        """Retry `fn` under the policy (transient errors only)."""
        return call_with_retry(
            fn, site, self.policy, classify_fn=classify_with_escalation
        )

    def run_fit(self, fit_fn: Callable, site: str = "fit"):
        """Run a whole fit attempt under retry. The attempt closure should
        re-enter model.fit with its CheckpointManager so a retried attempt
        resumes instead of restarting."""

        def attempt():
            self._escalated.clear()
            try:
                return fit_fn()
            except KeyboardInterrupt:
                if self._escalated.is_set():
                    raise StallEscalation(
                        "stall watchdog escalated; aborting this attempt "
                        "for a resumed retry"
                    ) from None
                raise

        return self.call(site, attempt)


# --------------------------------------------------------------------------
# resume lineage
# --------------------------------------------------------------------------


def read_lineage(directory: str) -> List[Dict[str, Any]]:
    path = os.path.join(directory, LINEAGE_NAME)
    try:
        with open(path) as f:
            out = json.load(f)
        return out if isinstance(out, list) else []
    except (OSError, ValueError):
        return []


def record_resume(
    directory: Optional[str],
    resumed_step: int,
    run_id: Optional[str] = None,
    extra: Optional[dict] = None,
) -> Optional[dict]:
    """Append one attempt record to the lineage file (primary process
    only; the port runs single-controller, so that is this process) and
    emit a `resume` event. `directory` None (no telemetry dir) still emits
    the event when telemetry is active elsewhere; returns the record."""
    from bigclam_tpu_torch.obs import telemetry as _obs

    tel = _obs.current()
    if run_id is None and tel is not None:
        run_id = tel.run_id
    entry = {
        "attempt_id": os.urandom(3).hex(),
        "run": run_id,
        "resumed_step": int(resumed_step),
        "unix": round(time.time(), 3),
        **(extra or {}),
    }
    if tel is not None:
        tel.event(
            "resume",
            step=int(resumed_step),
            attempt_id=entry["attempt_id"],
            prev_attempts=(
                len(read_lineage(directory)) if directory else 0
            ),
        )
    if directory and _obs._process_index() == 0:
        lineage = read_lineage(directory)
        lineage.append(entry)
        path = os.path.join(directory, LINEAGE_NAME)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(lineage, f, indent=1)
        os.replace(tmp, path)
    return entry
