"""Deterministic fault-injection harness.

Copied from bigclam_tpu/resilience/faults.py: the same plan format, env var,
sites and matching, so one plan drives both packages.

The recovery paths this package adds (retry, rollback, quarantine,
auto-resume) are only trustworthy if tests and the chaos gate can drive the
REAL failure paths on demand — a preemption that only ever happens on a
cluster is a recovery path that has never run. This module injects seeded,
deterministic faults at instrumented sites:

    fit.step           every run_fit_loop iteration (ctx: it)
    checkpoint.save    after each CheckpointManager.save (ctx: step, path)
    store.load_shard   before each shard blob read (ctx: shard, path)
    replica.start      a fleet replica process about to serve (ctx:
                       member, shard) — a kill here is a crash loop, the
                       supervisor's quarantine drill
    replica.answer_write
                       a replica about to write one answer frame (ctx:
                       member, shard, family) — the wire-fault kinds below
                       fire here (serve.fleet applies them)
    wire.connect       the router about to dial a replica endpoint (ctx:
                       endpoint) — connect_refuse fires here

Fault kinds:

    kill               SIGKILL this process (true preemption: no handlers,
                       no atexit — exactly what a preemption looks like)
    delay              sleep `seconds` on the host (straggler / slow DCN
                       hop approximation) before the site proceeds
    nan_inject         the fit loop poisons F[index] with NaN (drives the
                       non-finite rollback path end to end)
    truncate_checkpoint / corrupt_checkpoint
                       applied by checkpoint.save to the just-renamed file
                       (a lost page-cache writeback / silent bit flip)
    corrupt_shard      applied by store.load_shard to the shard's indices
                       blob before the crc check (drives quarantine)
    connect_refuse     wire.connect raises ConnectionRefusedError (the
                       endpoint's process is gone; the router must fail
                       over, not error)
    torn_frame         replica.answer_write emits HALF the answer frame
                       then hangs up (a peer killed mid-write) — the
                       router's bounded reader must discard + retry
    garbage_line       replica.answer_write emits a non-JSON line (framing
                       corruption) — same recovery contract
    stall              replica.answer_write sleeps `seconds` BEFORE
                       writing (a wedged replica) — the router's read
                       timeout must bound it, then fail over

A plan is a JSON spec: ``{"seed": 0, "faults": [{"kind": "kill", "site":
"fit.step", "at": 5}, ...]}``. Each fault fires ONCE (consumed); matching
is deterministic: ``at`` matches the site's iteration (fit.step) or its
0-based hit count (other sites); any other spec key that a site passes as
context must match exactly (e.g. ``shard``/``step``); an optional ``pid``
restricts the fault to one process of a multi-controller run.

Activation: ``install_plan(FaultPlan.from_spec(...))`` in-process, or the
``BIGCLAM_FAULTS`` env var (inline JSON, or ``@/path/to/plan.json``) so
subprocess tests and the chaos gate drive CLI entry points. With no plan
installed every site costs one module-dict lookup.

This module touches no device: the one device fault (nan_inject) is
APPLIED by the fit loop (to a clone of F), not here — this module only
matches specs and mutates files/processes. The port has the sites fit.step
and checkpoint.save; the others name the JAX package's serving and store
sites, so a plan written for it still parses here.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

ENV_VAR = "BIGCLAM_FAULTS"

# spec keys with harness-level meaning; everything else is a context match
_RESERVED = {"kind", "site", "at", "pid", "seconds", "frac", "offset",
             "index"}

_STATE: Dict[str, Any] = {"plan": None, "env_checked": False}


class FaultPlan:
    """A consumable, seeded list of fault specs (see module docstring)."""

    def __init__(self, faults: List[dict], seed: int = 0):
        self.faults = [dict(f) for f in faults]
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.fired: List[dict] = []
        self._consumed = [False] * len(self.faults)
        self._hits: Dict[str, int] = {}
        for f in self.faults:
            if "kind" not in f or "site" not in f:
                raise ValueError(f"fault spec needs kind+site: {f!r}")

    @classmethod
    def from_spec(cls, spec: dict) -> "FaultPlan":
        return cls(spec.get("faults", []), seed=spec.get("seed", 0))

    @classmethod
    def from_env(cls, value: Optional[str] = None) -> Optional["FaultPlan"]:
        raw = os.environ.get(ENV_VAR) if value is None else value
        if not raw:
            return None
        if raw.startswith("@"):
            with open(raw[1:]) as f:
                raw = f.read()
        return cls.from_spec(json.loads(raw))

    def _matches(self, spec: dict, site: str, n: int, ctx: dict) -> bool:
        if spec["site"] != site:
            return False
        if spec.get("pid") is not None:
            if _process_index() != int(spec["pid"]):
                return False
        if "at" in spec:
            anchor = ctx["it"] if "it" in ctx else n
            if int(anchor) != int(spec["at"]):
                return False
        for key, val in spec.items():
            if key in _RESERVED or key not in ctx:
                continue
            if ctx[key] != val:
                return False
        return True

    def fire(self, site: str, **ctx) -> Optional[dict]:
        """The first unconsumed spec matching this site hit, or None.
        Consumes the spec, emits a `fault_injected` telemetry event, and
        applies the site-independent kinds (kill/delay) in place."""
        n = self._hits.get(site, 0)
        self._hits[site] = n + 1
        for i, spec in enumerate(self.faults):
            if self._consumed[i] or not self._matches(spec, site, n, ctx):
                continue
            self._consumed[i] = True
            self.fired.append(spec)
            _event(site, spec, ctx)
            kind = spec["kind"]
            if kind == "kill":
                print(
                    f"[bigclam] FAULT kill at {site} "
                    f"(ctx={_small(ctx)}): SIGKILL",
                    file=sys.stderr,
                    flush=True,
                )
                import signal

                os.kill(os.getpid(), signal.SIGKILL)
            if kind == "delay":
                time.sleep(float(spec.get("seconds", 0.05)))
            return dict(spec)
        return None

    def apply_to_file(self, spec: dict, path: str) -> None:
        """Mutate `path` per a truncate_*/corrupt_* spec (deterministic:
        offsets default to mid-file; fractions to 0.5)."""
        size = os.path.getsize(path)
        kind = spec["kind"]
        if kind.startswith("truncate"):
            keep = int(size * float(spec.get("frac", 0.5)))
            with open(path, "r+b") as f:
                f.truncate(keep)
            return
        if kind.startswith("corrupt"):
            offset = int(spec.get("offset", max(size // 2, 0)))
            offset = min(max(offset, 0), max(size - 1, 0))
            with open(path, "r+b") as f:
                f.seek(offset)
                b = f.read(1) or b"\x00"
                f.seek(offset)
                f.write(bytes([b[0] ^ 0xFF]))
            return
        raise ValueError(f"fault kind {kind!r} is not a file fault")


def _small(ctx: dict) -> dict:
    return {k: v for k, v in ctx.items() if isinstance(v, (int, str, float))}


def _process_index() -> int:
    from bigclam_tpu_torch.obs.telemetry import _process_index as pidx

    return pidx()


def _event(site: str, spec: dict, ctx: dict) -> None:
    from bigclam_tpu_torch.obs import telemetry as _obs

    tel = _obs.current()
    if tel is not None:
        tel.event(
            "fault_injected", site=site, fault=spec["kind"],
            spec={k: v for k, v in spec.items()}, **_small(ctx),
        )


def install_plan(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install (or with None, clear) the process-wide plan. Clearing also
    resets the env latch so a later install/env change is honored."""
    _STATE["plan"] = plan
    _STATE["env_checked"] = plan is not None
    return plan


def current_plan() -> Optional[FaultPlan]:
    plan = _STATE["plan"]
    if plan is None and not _STATE["env_checked"]:
        _STATE["env_checked"] = True
        plan = FaultPlan.from_env()
        _STATE["plan"] = plan
    return plan


def maybe_fire(site: str, **ctx) -> Optional[dict]:
    """The instrumented-site entry point: near-free when no plan is active
    (one dict lookup), else FaultPlan.fire."""
    plan = _STATE["plan"]
    if plan is None:
        if _STATE["env_checked"]:
            return None
        plan = current_plan()
        if plan is None:
            return None
    return plan.fire(site, **ctx)


def apply_file_fault(spec: dict, path: str) -> None:
    """Module-level convenience for sites: apply a file fault using the
    installed plan's determinism (falls back to a throwaway plan when the
    spec arrived without one — offsets are explicit or mid-file anyway)."""
    plan = _STATE["plan"] or FaultPlan([])
    plan.apply_to_file(spec, path)
