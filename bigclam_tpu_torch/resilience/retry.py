"""Classified retry with exponential backoff.

Copied from bigclam_tpu/resilience/retry.py (same taxonomy, same seeded
backoff stream, so both packages back off identically).

Error taxonomy (DESIGN.md "Failure model & recovery"): an I/O hiccup on a
shared filesystem, a slow-to-appear coordinator, or an injected transient
is worth retrying with backoff; a config/shape mismatch, a checksum that
fails identically every read, or an exhausted rollback budget is NOT — the
retry would deterministically reproduce it. `classify` encodes that split,
call sites can extend it (the supervisor classifies its stall-escalation
interrupt as transient), and every attempt/outcome is emitted under the
telemetry schema (`retry` / `recovered` / `gave_up`) so `cli report`
can render a run's recovery history.

Backoff is exponential with DETERMINISTIC jitter: the jitter stream is
seeded from (policy.seed, site), so two runs of the same plan back off
identically — chaos tests stay reproducible — while distinct sites (and
distinct-seed runs) still decorrelate.
"""

from __future__ import annotations

import dataclasses
import time
import zipfile
import zlib
from typing import Callable, Optional

import numpy as np


class TransientError(RuntimeError):
    """Explicitly transient-classified wrapper for call sites."""


class FatalError(RuntimeError):
    """Explicitly fatal-classified wrapper (never retried)."""


# exception types worth a retry: environmental, usually self-healing
_TRANSIENT_TYPES = (
    OSError, EOFError, ConnectionError, TimeoutError, InterruptedError,
    zlib.error, zipfile.BadZipFile,
)


def classify(exc: BaseException) -> str:
    """"transient" or "fatal" (see module docstring). FileNotFoundError is
    deliberately transient: on shared filesystems a just-renamed checkpoint
    or shard can lag visibility across hosts by seconds."""
    if isinstance(exc, FatalError):
        return "fatal"
    if isinstance(exc, TransientError):
        return "transient"
    if isinstance(exc, _TRANSIENT_TYPES):
        return "transient"
    return "fatal"


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Per-class attempt budgets + backoff shape. `transient_attempts` is
    the TOTAL attempt count (1 = no retry); fatal errors get exactly
    `fatal_attempts` (default 1: fail fast, the retry would reproduce)."""

    transient_attempts: int = 3
    fatal_attempts: int = 1
    base_s: float = 0.05
    factor: float = 2.0
    max_s: float = 5.0
    jitter: float = 0.5
    seed: int = 0

    def attempts_for(self, cls: str) -> int:
        return max(
            self.transient_attempts if cls == "transient"
            else self.fatal_attempts,
            1,
        )

    def backoff_s(self, failure_index: int, rng) -> float:
        base = min(self.base_s * self.factor ** failure_index, self.max_s)
        return base * (1.0 + self.jitter * float(rng.random()))


def call_with_retry(
    fn: Callable,
    site: str,
    policy: Optional[RetryPolicy] = None,
    classify_fn: Callable[[BaseException], str] = classify,
    sleep: Callable[[float], None] = time.sleep,
):
    """Run `fn()` under the policy, emitting retry/recovered/gave_up
    telemetry events tagged with `site`. Raises the final error after the
    class budget is exhausted (or immediately for fatal classes)."""
    from bigclam_tpu_torch.obs import telemetry as _obs

    policy = policy or RetryPolicy()
    rng = np.random.default_rng([policy.seed, zlib.crc32(site.encode())])
    failures = 0
    while True:
        tel = _obs.current()
        try:
            out = fn()
        except Exception as e:
            cls = classify_fn(e)
            failures += 1
            err = f"{type(e).__name__}: {e}"[:300]
            if failures >= policy.attempts_for(cls):
                if tel is not None:
                    tel.event(
                        "gave_up", site=site, attempts=failures,
                        error=err, error_class=cls,
                    )
                raise
            back = policy.backoff_s(failures - 1, rng)
            if tel is not None:
                tel.event(
                    "retry", site=site, attempt=failures,
                    backoff_s=round(back, 4), error=err, error_class=cls,
                )
            sleep(back)
            continue
        if failures and tel is not None:
            tel.event("recovered", site=site, attempts=failures + 1)
        return out
