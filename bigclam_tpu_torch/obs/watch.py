# Copied from bigclam_tpu/obs/watch.py (imports renamed to bigclam_tpu_torch).
"""`cli watch <telemetry-dir>`: a live terminal tailer for a running (or
finished) fit, rendered from events.jsonl alone (ISSUE 8).

`cli report` is a post-mortem; watch answers "is this 30-minute pod fit
healthy RIGHT NOW" from any host that can read the telemetry directory —
no jax, no run access. Each refresh re-reads the event log (append-only,
single writer, line-framed — a torn last line is skipped by the decoder)
and renders:

* unicode sparklines over the trailing `health` samples: LLH, grad norm,
  update norm, membership churn (plus support churn / cap occupancy on
  sparse runs) — the optimizer's vital signs at a glance
* the step counter / LLH trajectory from `step` events when the run has
  a metrics sink wired, fit progress from the health samples otherwise
* fired anomalies, stalls, rollbacks, and the run's last event age (a
  growing age with no stall event yet is the earliest hang signal)

Dependency-free and read-only by design (the data-prep-host contract of
obs.report). `once=True` renders a single frame and returns — the mode
tests and CI use; the live loop redraws every `interval` seconds and
exits on its own when an `end` event lands (the run finalized) or on
Ctrl-C.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence

from bigclam_tpu_torch.obs.report import load_events, run_duration_s
from bigclam_tpu_torch.obs.telemetry import EVENTS_NAME

BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(vals: Sequence[float], width: int = 48) -> str:
    """Trailing `width` values as a unicode block sparkline (constant
    series render mid-scale; non-finite samples render as '!' — the
    blow-up must be visible, not crash the tailer)."""
    import math

    vals = list(vals)[-width:]
    if not vals:
        return ""
    finite = [v for v in vals if isinstance(v, (int, float))
              and math.isfinite(v)]
    if not finite:
        return "!" * len(vals)
    lo, hi = min(finite), max(finite)
    span = hi - lo
    out = []
    for v in vals:
        if not (isinstance(v, (int, float)) and math.isfinite(v)):
            out.append("!")
        elif span <= 0:
            out.append(BLOCKS[3])
        else:
            idx = int((v - lo) / span * (len(BLOCKS) - 1))
            out.append(BLOCKS[max(0, min(idx, len(BLOCKS) - 1))])
    return "".join(out)


def _series(events: List[dict], kind: str, field: str) -> List[float]:
    out = []
    for e in events:
        if e.get("kind") != kind:
            continue
        v = e.get(field)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out.append(float(v))
        elif isinstance(v, str) and v in ("nan", "inf", "-inf"):
            out.append(float(v))    # strict-JSON stringified non-finite
    return out


def _fmt(v: Optional[float]) -> str:
    if v is None:
        return "-"
    return f"{v:.6g}"


def render_frame(directory: str, width: int = 48) -> str:
    """One watch frame (pure render; the loop and the CLI --once mode
    both call this)."""
    return _render_events(directory, load_events(directory), width)


def _render_events(
    directory: str, events: Optional[List[dict]], width: int
) -> str:
    if events is None:
        return (
            f"{directory}: no {EVENTS_NAME} yet (run not started, or a "
            "non-primary process dir)"
        )
    lines: List[str] = []
    start = next((e for e in events if e.get("kind") == "start"), {})
    # None while the log holds no decodable timestamped line yet (empty
    # file / torn first write) — the startup window watch exists to cover
    dur = run_duration_s(events)
    ended = any(e.get("kind") == "end" for e in events)
    lines.append(
        f"run {start.get('run', '?')}  entry={start.get('entry', '?')}  "
        f"events {len(events)}  elapsed "
        + ("-" if dur is None else f"{dur:.1f}s")
        + ("  [finalized]" if ended else "")
    )

    steps = [e for e in events if e.get("kind") == "step"]
    health = [e for e in events if e.get("kind") == "health"]
    prog = steps[-1] if steps else (health[-1] if health else None)
    if prog is not None:
        llh = prog.get("llh")
        lines.append(
            f"iter {prog.get('iter', '?')}  llh "
            f"{llh if isinstance(llh, str) else _fmt(llh)}"
        )

    def spark_row(label: str, series: List[float]) -> None:
        if not series:
            return
        lines.append(
            f"  {label:<12} {sparkline(series, width):<{width}} "
            f"last {_fmt(series[-1])}"
        )

    src = health if health else steps
    spark_row("llh", _series(src, src[0]["kind"], "llh") if src else [])
    if health:
        spark_row("grad_norm", _series(health, "health", "grad_norm"))
        spark_row("update_norm", _series(health, "health", "update_norm"))
        spark_row("churn", _series(health, "health", "churn"))
        spark_row("support_churn",
                  _series(health, "health", "support_churn"))
        spark_row("cap_occ", _series(health, "health", "cap_occupancy"))
        spark_row("step_eff", _series(health, "health", "step_eff"))
    else:
        lines.append(
            "  (no health samples — run with --health-every N > 0)"
        )
    if steps:
        spark_row("sec/iter", _series(steps, "step", "sec_per_iter"))

    # collective-traffic + balance snapshot (obs.comms): per-MODEL site
    # sets, a re-emitted model (reset_model on its first event — the
    # sparse cap refinement can flip the collective mode) replaces its
    # previous sites; latest balance skew — the "is the interconnect/
    # work-split sane" line
    comms_by_model = {}
    for e in events:
        if e.get("kind") != "comms" or not isinstance(
            e.get("bytes_per_step"), (int, float)
        ):
            continue
        model = str(e.get("model", "?"))
        if e.get("reset_model"):
            comms_by_model[model] = {}
        comms_by_model.setdefault(model, {})[
            str(e.get("site", "?"))
        ] = float(e["bytes_per_step"])
    if comms_by_model:
        from bigclam_tpu_torch.obs.report import _fmt_bytes

        sites = [
            v for m in comms_by_model.values() for v in m.values()
        ]
        lines.append(
            f"  comms {_fmt_bytes(int(sum(sites)))}/step modeled over "
            f"{len(sites)} site(s)"
        )
    # memory model vs measured headroom (obs.memory, ISSUE 12): the
    # modeled per-device HBM (memory_model events, reset_model replace
    # semantics like comms) against the latest watermark's measured
    # in-use + the device limit — "will this fit" rendered live
    mem_by_model = {}
    for e in events:
        if e.get("kind") != "memory_model" or e.get("scope") == "host":
            continue
        if not isinstance(e.get("bytes"), (int, float)):
            continue
        model = str(e.get("model", "?"))
        if e.get("reset_model"):
            mem_by_model[model] = {}
        mem_by_model.setdefault(model, {})[
            str(e.get("buffer", "?"))
        ] = float(e["bytes"])
    if mem_by_model:
        from bigclam_tpu_torch.obs.report import _fmt_bytes

        modeled = sum(
            v for bufs in mem_by_model.values() for v in bufs.values()
        )
        measured = limit = None
        for e in reversed(events):
            if e.get("kind") == "memory" and e.get("devices"):
                vals = [
                    d.get("bytes_in_use") for d in e["devices"]
                    if isinstance(d.get("bytes_in_use"), (int, float))
                ]
                lims = [
                    d.get("bytes_limit") for d in e["devices"]
                    if isinstance(d.get("bytes_limit"), (int, float))
                ]
                if vals:
                    measured = max(vals)
                if lims:
                    limit = max(lims)
                break
        line = f"  hbm modeled {_fmt_bytes(int(modeled))}/device"
        if measured is not None:
            line += f"  measured {_fmt_bytes(int(measured))}"
        if limit:
            line += (
                f"  headroom {_fmt_bytes(int(limit - modeled))}"
                f" of {_fmt_bytes(int(limit))}"
            )
        lines.append(line)
    balances = [e for e in events if e.get("kind") == "balance"]
    if balances:
        b = balances[-1]
        skew = b.get("skew")
        lines.append(
            f"  balance {b.get('what')}: skew "
            f"{skew if isinstance(skew, (int, float)) else '?'}x "
            f"(max {b.get('max')} vs mean {b.get('mean')})"
        )
    # serving generation age + queue depth (ISSUE 18 satellite): the
    # newest serve batch carries wall-clock-since-publish and the live
    # admission queue — "how stale is serving" and "how loaded" as
    # rendered numbers, refreshed every frame
    serves = [e for e in events if e.get("kind") == "serve"]
    if serves:
        s = serves[-1]
        parts = [f"serving gen {s.get('step', '?')}"]
        if isinstance(s.get("gen_age_s"), (int, float)):
            parts.append(f"age {s['gen_age_s']:.1f}s")
        if isinstance(s.get("queue_depth"), (int, float)):
            parts.append(f"queue depth {int(s['queue_depth'])}")
        lines.append("  " + "  ".join(parts))
    anomalies = [e for e in events if e.get("kind") == "anomaly"]
    for a in anomalies:
        it = a.get("iter")
        where = "build" if isinstance(it, int) and it < 0 else f"iter {it}"
        lines.append(f"  ANOMALY {a.get('check')} at {where}")
    stalls = [e for e in events if e.get("kind") == "stall"]
    if stalls:
        s = stalls[-1]
        lines.append(
            f"  STALLS {len(stalls)} (last: silent {s.get('silent_s')}s"
            + (f", open span {s['spans'][-1]}" if s.get("spans") else "")
            + ")"
        )
    rollbacks = sum(1 for e in events if e.get("kind") == "rollback")
    if rollbacks:
        lines.append(f"  rollbacks {rollbacks}")
    if not ended and events:
        # staleness from the file's side, not the event clock: how long
        # since the writer last appended anything
        try:
            age = time.time() - os.path.getmtime(
                os.path.join(directory, EVENTS_NAME)
            )
            lines.append(f"  last write {age:.0f}s ago")
        except OSError:
            pass
    return "\n".join(lines)


def watch(
    directory: str,
    interval: float = 2.0,
    once: bool = False,
    width: int = 48,
    max_frames: int = 0,
    out=None,
) -> int:
    """The watch loop. Returns 0, or 1 when `once` finds no event log.
    `max_frames` bounds the loop for tests (0 = until end/Ctrl-C)."""
    import sys

    out = out or sys.stdout
    frames = 0
    while True:
        # one read+decode per refresh: the same event list feeds the
        # frame AND the run-ended exit test
        events = load_events(directory)
        frame = _render_events(directory, events, width)
        if once:
            print(frame, file=out)
            return 0 if os.path.exists(
                os.path.join(directory, EVENTS_NAME)
            ) else 1
        # ANSI clear + home keeps the frame stable in a terminal; piped
        # output just sees frame separators
        if getattr(out, "isatty", lambda: False)():
            print("\x1b[2J\x1b[H", end="", file=out)
        print(frame, file=out, flush=True)
        frames += 1
        if events is not None and any(
            e.get("kind") == "end" for e in events
        ):
            return 0
        if max_frames and frames >= max_frames:
            return 0
        try:
            time.sleep(max(interval, 0.1))
        except KeyboardInterrupt:
            return 0


# ------------------------------------------------------------------ fleet
def render_fleet_frame(root: str, width: int = 48) -> str:
    """One live frame over a fleet root (ISSUE 19): ROOT's
    subdirectories are member telemetry dirs (obs.report.fleet_dirs) —
    the router's and every replica's. Same tolerance contract as the
    single-dir tailer: a member with no events.jsonl yet renders as a
    placeholder row, torn lines are skipped by the decoder."""
    from bigclam_tpu_torch.obs.report import load_fleet

    return _render_fleet_members(root, load_fleet(root), width)


def _render_fleet_members(root, members, width: int) -> str:
    if not members:
        return (
            f"{root}: no member telemetry dirs yet (expected the "
            "router's and each replica's --telemetry-dir as "
            "subdirectories)"
        )
    lines = [f"fleet {root}: {len(members)} member(s)"]
    for m in members:
        name, entry, events = m["name"], m["entry"], m["events"]
        if events is None:
            lines.append(f"  {name} [{entry}]: no events.jsonl yet")
            continue
        ended = any(e.get("kind") == "end" for e in events)
        parts = [f"events {len(events)}"]
        fresh = [e for e in events if e.get("kind") == "freshness"]
        if fresh:
            f0 = fresh[-1]
            age = f0.get("generation_age_s")
            parts.append(
                f"gen {f0.get('step', '?')}"
                + (
                    f" age {age:.1f}s"
                    if isinstance(age, (int, float)) else ""
                )
            )
        else:
            serves = [e for e in events if e.get("kind") == "serve"]
            if serves:
                s = serves[-1]
                parts.append(f"gen {s.get('step', '?')}")
                if isinstance(s.get("gen_age_s"), (int, float)):
                    parts.append(f"age {s['gen_age_s']:.1f}s")
                if isinstance(s.get("queue_depth"), (int, float)):
                    parts.append(
                        f"queue depth {int(s['queue_depth'])}"
                    )
        rollouts = sum(
            1 for e in events if e.get("kind") == "rollout"
        )
        if rollouts:
            parts.append(f"rollouts {rollouts}")
        stalls = [e for e in events if e.get("kind") == "stall"]
        if stalls:
            s = stalls[-1]
            stall_part = f"STALLS {len(stalls)}"
            if isinstance(s.get("open_traces"), int):
                stall_part += (
                    f" (open traces {s['open_traces']}, oldest "
                    f"{s.get('oldest_inflight_s', '?')}s)"
                )
            parts.append(stall_part)
        if ended:
            parts.append("[finalized]")
        else:
            try:
                age = time.time() - os.path.getmtime(
                    os.path.join(m["dir"], EVENTS_NAME)
                )
                parts.append(f"last write {age:.0f}s ago")
            except OSError:
                pass
        lines.append(f"  {name} [{entry}]: " + "  ".join(parts))
        if entry == "fleet":
            # supervisor member (ISSUE 20): per-slot lifecycle state
            # from the LAST membership event's roster — a live chaos
            # drill shows up/restarting/quarantined/draining as it runs
            restarts = sum(
                1 for e in events
                if e.get("kind") == "replica_restart"
            )
            quar = sum(
                1 for e in events
                if e.get("kind") == "replica_quarantined"
            )
            if restarts or quar:
                lines.append(
                    f"    supervision: {restarts} restart(s), "
                    f"{quar} quarantined"
                )
            last = next(
                (
                    e for e in reversed(events)
                    if e.get("kind") == "membership"
                    and isinstance(e.get("roster"), list)
                ),
                None,
            )
            for r in (last or {}).get("roster", []):
                if isinstance(r, dict):
                    lines.append(
                        f"    {str(r.get('id', '?')):<8} shard "
                        f"{r.get('shard', '?')}  "
                        f"{str(r.get('state', '?')):<12} "
                        f"restarts {r.get('restarts', 0)}"
                    )
        # the router member's slow-query exemplar trail (qtrace events):
        # end-to-end ms of the top-N traces per window as a sparkline —
        # a widening tail is visible live, before any report runs
        qt = [
            float(e["total_s"]) * 1e3
            for e in events
            if e.get("kind") == "qtrace"
            and isinstance(e.get("total_s"), (int, float))
        ]
        if qt:
            lines.append(
                f"    slow traces  {sparkline(qt, width):<{width}} "
                f"last {qt[-1]:.3g}ms"
            )
        fr = [
            float(e["generation_age_s"])
            for e in fresh
            if isinstance(e.get("generation_age_s"), (int, float))
        ]
        if len(fr) >= 2:
            lines.append(
                f"    gen age s    {sparkline(fr, width):<{width}} "
                f"last {fr[-1]:.1f}s"
            )
    return "\n".join(lines)


def watch_fleet(
    root: str,
    interval: float = 2.0,
    once: bool = False,
    width: int = 48,
    max_frames: int = 0,
    out=None,
) -> int:
    """The fleet watch loop (`cli watch --fleet`). Returns 0, or 1 when
    `once` finds no member dirs; the live loop exits once every member
    has finalized (each log carries an `end` event)."""
    import sys

    from bigclam_tpu_torch.obs.report import load_fleet

    out = out or sys.stdout
    frames = 0
    while True:
        members = load_fleet(root)
        frame = _render_fleet_members(root, members, width)
        if once:
            print(frame, file=out)
            return 0 if members else 1
        if getattr(out, "isatty", lambda: False)():
            print("\x1b[2J\x1b[H", end="", file=out)
        print(frame, file=out, flush=True)
        frames += 1
        if members and all(
            m["events"] is not None
            and any(e.get("kind") == "end" for e in m["events"])
            for m in members
        ):
            return 0
        if max_frames and frames >= max_frames:
            return 0
        try:
            time.sleep(max(interval, 0.1))
        except KeyboardInterrupt:
            return 0
