# Copied from bigclam_tpu/obs/report.py (imports renamed to bigclam_tpu_torch).
"""Render a telemetry directory human-readable (`cli report`) and merge
per-process run reports.

A multi-controller run leaves `run_report.json` (process 0) plus
`run_report.p<i>.json` siblings — each written independently at finalize,
with no cross-process synchronization. Merging happens HERE, at read time:
stage seconds are reported per process (wall-clock buckets across
processes do not add — every process spans the same wall time), device
peaks union (each process only sees its own addressable devices), and
compile counts sum (each process compiles its own executables).
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, List, Optional, Tuple

from bigclam_tpu_torch.obs.schema import summarize_kinds, validate_events_file
from bigclam_tpu_torch.obs.telemetry import EVENTS_NAME, REPORT_NAME


def _report_pid(path: str) -> int:
    """NUMERIC pid from a run_report filename: lexical sort put p10 before
    p2, which scrambled merge order (and any per-pid rendering) past nine
    processes."""
    base = os.path.basename(path)
    if base == REPORT_NAME:
        return 0
    m = re.match(r"run_report\.p(\d+)\.json$", base)
    return int(m.group(1)) if m else 1 << 30


def _pid_key(pid: str) -> int:
    """Same numeric ordering for the string pid keys of the merged
    per-pid dicts (p2 before p10)."""
    return int(pid) if pid.isdigit() else 1 << 30


def load_reports(directory: str) -> List[dict]:
    """Every run_report*.json in the dir, primary first then by NUMERIC
    pid (p2 before p10)."""
    paths = sorted(
        glob.glob(os.path.join(directory, "run_report*.json")),
        key=lambda p: (_report_pid(p), p),
    )
    out = []
    for p in paths:
        with open(p) as f:
            out.append(json.load(f))
    return out


def _event_order(e: dict) -> float:
    """Merge-order key: the MONOTONIC elapsed_s. The `t` fallback is
    defensive, for malformed lines missing it (schema validation still
    reports those — v1 logs are rejected, not silently read; pinned by
    test). Never the wall-clock `ts` — a clock jump must not reorder the
    timeline."""
    v = e.get("elapsed_s", e.get("t", 0.0))
    return v if isinstance(v, (int, float)) else 0.0


def load_events(directory: str) -> Optional[List[dict]]:
    """events.jsonl decoded and STABLY ordered by elapsed_s: the heartbeat
    thread and the main thread stamp their events before taking the write
    lock, so adjacent lines can land microseconds out of order — the
    stable sort repairs that while preserving file order for equal
    timestamps (multi-writer interleave contract, tested)."""
    path = os.path.join(directory, EVENTS_NAME)
    if not os.path.exists(path):
        return None
    events = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    events.append(json.loads(line))
                except ValueError:
                    events.append({"kind": "?", "unparsed": line[:80]})
    # events without a numeric elapsed_s — the "?" placeholders for
    # corrupt lines, exactly the ones whose FILE position is the evidence
    # — inherit the previous event's key so they stay next to their
    # neighbors; the stable sort then only repairs real out-of-order
    # stamps (heartbeat-thread interleave)
    last = 0.0
    keyed = []
    for e in events:
        v = e.get("elapsed_s", e.get("t"))
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            last = float(v)
        keyed.append((last, e))
    keyed.sort(key=lambda kv: kv[0])    # stable: ties keep file order
    return [e for _, e in keyed]


def run_duration_s(events: List[dict]) -> Optional[float]:
    """Run duration from MONOTONIC event times (first -> last elapsed_s).
    The report quotes this instead of subtracting wall clocks, so an NTP
    step mid-run cannot corrupt the figure (ISSUE 6 satellite)."""
    stamped = [
        _event_order(e)
        for e in events
        if isinstance(e.get("elapsed_s", e.get("t")), (int, float))
    ]
    if not stamped:
        return None
    return max(stamped) - min(stamped)


def span_coverage(report: dict) -> Optional[float]:
    """Fraction of the run's wall time attributed by TOP-LEVEL spans
    (paths without a '/'): children re-count their parents' time, so only
    depth-0 spans sum against the wall. The telemetry smoke gates this at
    >= 0.95 — unattributed time is the regression this layer exists to
    prevent."""
    spans = (report.get("spans", {}) or {}).get("seconds", {}) or {}
    wall = report.get("wall_s")
    if not wall:
        return None
    top = sum(v for k, v in spans.items() if "/" not in k)
    return top / float(wall)


def merge_reports(reports: List[dict]) -> dict:
    """One cross-process view of a run (see module docstring for the
    per-field merge rules)."""
    if not reports:
        return {}
    merged = {
        "run": reports[0].get("run"),
        "entry": reports[0].get("entry"),
        "processes_reported": len(reports),
        "processes_expected": max(
            int(r.get("processes", 1) or 1) for r in reports
        ),
        "wall_s": max(float(r.get("wall_s", 0.0)) for r in reports),
        "stages_by_pid": {
            str(r.get("pid", "?")): r.get("stages", {}).get("seconds", {})
            for r in reports
        },
        "spans_by_pid": {
            str(r.get("pid", "?")): r.get("spans", {}).get("seconds", {})
            for r in reports
        },
        "span_orphans": sum(
            int(r.get("spans", {}).get("orphans", 0)) for r in reports
        ),
        "stalls": sum(
            int(r.get("heartbeat", {}).get("stalls", 0)) for r in reports
        ),
        "final": reports[0].get("final", {}),
    }
    # model health (ISSUE 8): sample counts and anomaly tallies SUM
    # across processes (each process's monitor watches the same global
    # optimizer state, but only its own report records what it saw); the
    # last-snapshot payload is the primary's (its events.jsonl carries
    # the authoritative event stream)
    health = {
        "samples": sum(
            int((r.get("health", {}) or {}).get("samples", 0))
            for r in reports
        ),
        "last": (reports[0].get("health", {}) or {}).get("last"),
        "anomalies": {},
    }
    for r in reports:
        for check, n in ((r.get("health", {}) or {}).get(
            "anomalies", {}
        ) or {}).items():
            health["anomalies"][check] = (
                health["anomalies"].get(check, 0) + int(n)
            )
    merged["health"] = health
    # collective-traffic accounting (obs.comms, ISSUE 10): the primary's
    # modeled bytes/step table (every process compiles the same SPMD
    # step, so the models agree; the primary's event log is
    # authoritative), plus the per-pid fit-loop sync totals — the raw
    # signal behind the straggler detector (a host everyone waits on has
    # the SMALLEST sync total; its peers' balloon)
    merged["comms"] = next(
        (
            r.get("comms")
            for r in reports
            if (r.get("comms", {}) or {}).get("sites")
        ),
        None,
    )
    # memory model (obs.memory, ISSUE 12): every process bakes the same
    # SPMD step, so the models agree — the first report carrying one is
    # authoritative (same rule as comms)
    merged["memory_model"] = next(
        (
            (r.get("memory", {}) or {}).get("modeled")
            for r in reports
            if (r.get("memory", {}) or {}).get("modeled")
        ),
        None,
    )
    from bigclam_tpu_torch.obs.comms import sync_seconds

    sync_by_pid = {}
    for r in reports:
        s = sync_seconds(r)
        if s > 0:
            sync_by_pid[str(r.get("pid", "?"))] = round(s, 4)
    merged["sync_by_pid"] = sync_by_pid
    device_peak: Dict[str, dict] = {}
    compiles = {"count": 0, "backend_compiles": 0, "step_builds": 0,
                "backend_compile_s": 0.0, "by_key": {}}
    events: Dict[str, int] = {}
    for r in reports:
        for dev, stats in r.get("memory", {}).get("device_peak", {}).items():
            seen = device_peak.setdefault(dev, dict(stats))
            for key in ("bytes_in_use", "peak_bytes_in_use"):
                v = stats.get(key)
                if v is not None and (
                    seen.get(key) is None or v > seen[key]
                ):
                    seen[key] = v
        comp = r.get("compiles", {})
        for key in ("count", "backend_compiles", "step_builds"):
            compiles[key] += int(comp.get(key, 0))
        compiles["backend_compile_s"] = round(
            compiles["backend_compile_s"]
            + float(comp.get("backend_compile_s", 0.0)),
            4,
        )
        for key, stats in comp.get("by_key", {}).items():
            agg = compiles["by_key"].setdefault(
                key, {"builds": 0, "compiles": 0}
            )
            agg["builds"] += int(stats.get("builds", 0))
            agg["compiles"] += int(stats.get("compiles", 0))
        for kind, n in r.get("events", {}).items():
            events[kind] = events.get(kind, 0) + int(n)
    merged["device_peak"] = device_peak
    merged["compiles"] = compiles
    merged["events"] = events
    return merged


def _load_lineage(directory: str) -> List[dict]:
    """resume_lineage.json written by resilience.supervisor.record_resume
    (--resume auto); [] when absent/unreadable."""
    try:
        with open(os.path.join(directory, "resume_lineage.json")) as f:
            out = json.load(f)
        return out if isinstance(out, list) else []
    except (OSError, ValueError):
        return []


def _fmt_bytes(v: Optional[float]) -> str:
    """The ONE byte formatter of the obs rendering layer (report, watch,
    and obs.memory's preflight all import it — two formatters for the
    same quantities would drift)."""
    if v is None:
        return "-"
    v = float(v)
    if v >= 1 << 30:
        return f"{v / (1 << 30):.2f} GiB"
    if v >= 1 << 20:
        return f"{v / (1 << 20):.1f} MiB"
    if v >= 1 << 10:
        return f"{v / (1 << 10):.1f} KiB"
    return f"{v:.0f} B"


def render_json(directory: str) -> Tuple[dict, int]:
    """(machine-readable report object, error count) — `cli report
    --json` for CI consumption (ISSUE 8 satellite). Same inputs and the
    same error accounting as render(), so the exit-code contract is
    unchanged: errors > 0 ⇔ nonzero exit, anomalies/stalls are findings.
    The object is strict JSON (no NaN/Infinity: events already went
    through telemetry's _finite_safe at write time, and the merged
    reports were serialized the same way)."""
    reports = load_reports(directory)
    events = load_events(directory)
    if not reports and events is None:
        return {"directory": directory, "error": "no telemetry artifacts",
                "errors": 1}, 1
    errors = 0
    merged = merge_reports(reports)
    if merged and merged["processes_reported"] < merged["processes_expected"]:
        errors += 1
    if merged and merged["events"].get("gave_up", 0):
        errors += 1
    if merged and merged.get("span_orphans"):
        errors += 1
    schema_errors: List[str] = []
    n_events = 0
    if events is not None:
        n_events, schema_errors = validate_events_file(
            os.path.join(directory, EVENTS_NAME)
        )
        errors += len(schema_errors)
    anomalies = [
        {k: v for k, v in e.items()
         if k not in ("v", "run", "pid", "t", "ts")}
        for e in (events or [])
        if e.get("kind") == "anomaly"
    ]
    # report-time host-skew findings (obs.comms, ISSUE 10): stragglers
    # are only visible ACROSS the per-process reports, so they cannot be
    # events — they join the anomalies list here, tagged with their
    # source. Findings, never exit-code errors (same contract as the
    # event-sourced anomalies).
    from bigclam_tpu_torch.obs.comms import detect_host_skew

    anomalies.extend(
        {**f, "source": "report"} for f in detect_host_skew(reports)
    )
    recovery_kinds = (
        "retry", "recovered", "gave_up", "rollback", "quarantine",
        "resume", "fault_injected", "stall_escalated",
    )
    out = {
        "directory": directory,
        "merged": merged,
        "events": {
            "count": n_events,
            "kinds": summarize_kinds(events or []),
            "duration_s": run_duration_s(events or []),
        },
        "health": (merged or {}).get("health", {}),
        # resolved edge-kernel paths (ISSUE 13): one entry per trainer
        # build — CI can refuse a run whose path silently fell back
        "kernel_paths": [
            {
                "model": e.get("model"),
                "path": e.get("path"),
                "reason": e.get("reason", ""),
            }
            for e in (events or [])
            if e.get("kind") == "model_build" and e.get("path")
        ],
        "comms": (merged or {}).get("comms"),
        "memory_model": (merged or {}).get("memory_model"),
        "sync_by_pid": (merged or {}).get("sync_by_pid", {}),
        "anomalies": anomalies,
        "recovery": {
            k: (merged or {}).get("events", {}).get(k, 0)
            for k in recovery_kinds
            if (merged or {}).get("events", {}).get(k, 0)
        },
        "resume_lineage": _load_lineage(directory),
        "schema_errors": schema_errors[:50],
        "errors": errors,
    }
    return out, errors


def render(directory: str) -> Tuple[str, int]:
    """(human-readable report text, error count). Errors are schema
    violations in events.jsonl plus a missing-artifact note; the CLI maps
    error count > 0 to a nonzero exit so CI can gate on a telemetry dir."""
    lines: List[str] = []
    errors = 0
    reports = load_reports(directory)
    events = load_events(directory)
    if not reports and events is None:
        return f"{directory}: no telemetry artifacts found", 1

    merged = merge_reports(reports)
    if merged:
        lines.append(
            f"run {merged['run']}  entry={merged['entry']}  "
            f"wall {merged['wall_s']:.1f}s  "
            f"processes {merged['processes_reported']}"
            f"/{merged['processes_expected']}"
        )
        if merged["processes_reported"] < merged["processes_expected"]:
            errors += 1
            lines.append(
                "  WARNING: fewer per-process reports than processes — "
                "a process died before finalize"
            )
        # --- resolved edge-kernel paths (ISSUE 13 satellite): every
        # trainer build states which implementation compiled (fused /
        # split / xla) and WHY a fallback fell back — a silent XLA
        # fallback must be visible here, not only on a stderr line
        # nobody watched
        builds = [
            e for e in (events or [])
            if e.get("kind") == "model_build" and e.get("path")
        ]
        if builds:
            lines.append("")
            lines.append("kernel paths (model builds):")
            for e in builds:
                why = f"  ({e['reason']})" if e.get("reason") else ""
                lines.append(
                    f"  {e.get('model', '?'):<28} {e['path']}{why}"
                )
        lines.append("")
        lines.append("stage seconds (per process):")
        for pid, stages in sorted(
            merged["stages_by_pid"].items(), key=lambda kv: _pid_key(kv[0])
        ):
            if not stages:
                lines.append(f"  p{pid}: (none)")
                continue
            total = sum(stages.values())
            lines.append(f"  p{pid}: total {total:.1f}s")
            for name, secs in sorted(
                stages.items(), key=lambda kv: -kv[1]
            ):
                pct = 100.0 * secs / total if total else 0.0
                lines.append(f"    {name:<20} {secs:>9.2f}s  {pct:5.1f}%")
        # --- per-span time breakdown (obs.trace, ISSUE 6): hierarchical
        # attribution; only TOP-LEVEL spans sum against the wall (children
        # re-count their parents), and the coverage line says how much of
        # the run the taxonomy attributed at all.
        for pid, spans in sorted(
            merged["spans_by_pid"].items(), key=lambda kv: _pid_key(kv[0])
        ):
            if not spans:
                continue
            rep_for_pid = next(
                (r for r in reports if str(r.get("pid", "?")) == pid),
                reports[0],
            )
            counts = rep_for_pid.get("spans", {}).get("counts", {})
            lines.append("")
            lines.append(f"span breakdown (p{pid}):")
            top_total = sum(v for k, v in spans.items() if "/" not in k)
            for path in sorted(
                spans, key=lambda p: (p.split("/")[0], p)
            ):
                depth = path.count("/")
                secs = spans[path]
                pct = (
                    100.0 * secs / top_total
                    if depth == 0 and top_total
                    else None
                )
                name = path.rsplit("/", 1)[-1]
                lines.append(
                    f"  {'  ' * depth}{name:<{max(24 - 2 * depth, 4)}}"
                    f" {secs:>10.3f}s"
                    + (f"  {pct:5.1f}%" if pct is not None else "       ")
                    + f"  x{counts.get(path, 0)}"
                )
            wall = float(rep_for_pid.get("wall_s", 0.0) or 0.0)
            if wall:
                lines.append(
                    f"  top-level spans cover {top_total:.1f}s = "
                    f"{100.0 * top_total / wall:.1f}% of wall {wall:.1f}s"
                )
        if merged.get("span_orphans"):
            errors += 1
            lines.append(
                f"  SPAN ORPHANS: {merged['span_orphans']} span(s) were "
                "abandoned without close (tracer repaired the stack)"
            )

        lines.append("")
        lines.append("device memory watermarks (max over samples):")
        if merged["device_peak"]:
            for dev, stats in sorted(merged["device_peak"].items()):
                lines.append(
                    f"  {dev:<24} in_use {_fmt_bytes(stats.get('bytes_in_use')):>10}  "
                    f"peak {_fmt_bytes(stats.get('peak_bytes_in_use')):>10}  "
                    f"limit {_fmt_bytes(stats.get('bytes_limit')):>10}"
                )
        else:
            lines.append(
                "  (none sampled — CPU backend or device telemetry off)"
            )

        # --- static memory model (obs.memory, ISSUE 12): modeled
        # per-device HBM by component next to the measured watermarks
        # above, and the per-stage host-RSS model with its dominant
        # stage named — the capacity story `cli preflight` predicts,
        # rendered from what the run actually baked.
        mm = merged.get("memory_model") or {}
        if mm.get("buffers"):
            lines.append("")
            lines.append(
                "memory model (per device, modeled): "
                f"{_fmt_bytes(int(mm.get('hbm_bytes_per_device', 0)))}"
                f" ({_fmt_bytes(int(mm.get('addressable_bytes', 0)))}"
                " addressable state+graph)"
            )
            for cat, b in sorted(
                (mm.get("by_category") or {}).items(),
                key=lambda kv: -kv[1],
            ):
                lines.append(f"  {cat:<12} {_fmt_bytes(int(b)):>12}")
            for name, b in sorted(
                (mm.get("buffers") or {}).items(), key=lambda kv: -kv[1]
            )[:8]:
                lines.append(
                    f"    {name:<30} {_fmt_bytes(int(b)):>12}"
                )
            # modeled vs measured headroom, when the allocator reported
            # watermarks (TPU; the CPU fake reports none)
            measured = [
                v for v in (
                    (stats.get("peak_bytes_in_use")
                     or stats.get("bytes_in_use"))
                    for stats in merged["device_peak"].values()
                )
                if isinstance(v, (int, float))
            ]
            if measured:
                peak = max(measured)
                modeled = float(mm.get("hbm_bytes_per_device", 0) or 0)
                lines.append(
                    f"  measured peak {_fmt_bytes(int(peak))} vs "
                    f"modeled {_fmt_bytes(int(modeled))}"
                    + (
                        f" (measured/modeled {peak / modeled:.2f}x)"
                        if modeled
                        else ""
                    )
                )
        if mm.get("host_stages"):
            lines.append("")
            dom = mm.get("host_dominant_stage")
            lines.append(
                "host RSS model (per stage, modeled peak "
                f"{_fmt_bytes(int(mm.get('host_rss_bytes') or 0))}):"
            )
            for stage, b in sorted(
                mm["host_stages"].items(), key=lambda kv: -kv[1]
            ):
                mark = "  <- dominant (host-global O(N*K) F0, " \
                    "ROADMAP 1a)" if stage == dom and stage == "f0_init" \
                    else ("  <- dominant" if stage == dom else "")
                lines.append(
                    f"  {stage:<12} {_fmt_bytes(int(b)):>12}{mark}"
                )
        comp = merged["compiles"]
        lines.append("")
        lines.append(
            f"compiles: {comp['count']} "
            f"(backend {comp['backend_compiles']}, "
            f"{comp['backend_compile_s']:.1f}s; "
            f"step builds {comp['step_builds']})"
        )
        for key, stats in sorted(comp["by_key"].items()):
            lines.append(
                f"  {key:<40} builds {stats['builds']}  "
                f"compiles {stats['compiles']}"
            )
        if merged["stalls"]:
            # stalls are a finding, not a schema error — reported, not
            # counted into the exit code
            lines.append("")
            lines.append(f"STALLS: {merged['stalls']} heartbeat deadline(s) hit")

        # --- collective traffic + host skew (obs.comms, ISSUE 10) ---
        comms = merged.get("comms") or {}
        if comms.get("sites"):
            lines.append("")
            lines.append(
                "collective traffic (modeled): "
                f"{_fmt_bytes(int(comms.get('bytes_per_step', 0)))}"
                f"/step over {len(comms['sites'])} site(s)"
            )
            for site, b in sorted(
                comms["sites"].items(), key=lambda kv: -kv[1]
            )[:10]:
                lines.append(
                    f"  {site:<34} {_fmt_bytes(int(b)):>10}/step"
                )
        sync = merged.get("sync_by_pid") or {}
        if len(sync) >= 2:
            ordered = sorted(sync.items(), key=lambda kv: kv[1])
            (lo_pid, lo_s), (hi_pid, hi_s) = ordered[0], ordered[-1]
            lines.append("")
            lines.append(
                "per-iteration sync totals: "
                + "  ".join(
                    f"p{pid} {s:.2f}s" for pid, s in sorted(
                        sync.items(), key=lambda kv: _pid_key(kv[0])
                    )
                )
                + f"  (skew p{hi_pid}/p{lo_pid} "
                f"{hi_s / max(lo_s, 1e-9):.1f}x)"
            )
        from bigclam_tpu_torch.obs.comms import detect_host_skew

        for f in detect_host_skew(reports):
            # a finding, like the event anomalies — never an exit error
            lines.append(
                f"  STRAGGLER: p{f['pid']} (host {f['host']}) — "
                f"{f['rule']} rule"
                + (
                    f", sync {f['sync_s']}s vs peers "
                    f"{f['peers_sync_s']}s"
                    if f["rule"] == "waiters"
                    else f", unattributed loop time {f['overhead_s']}s "
                    f"vs peers {f['peers_overhead_s']}s"
                )
            )

        # --- recovery history (ISSUE 5): retries, rollbacks, quarantines,
        # injected faults, escalations, resume lineage. A gave_up means the
        # run ENDED in an unrecovered failure: counted into the exit code.
        recovery_kinds = (
            "retry", "recovered", "gave_up", "rollback", "quarantine",
            "resume", "fault_injected", "stall_escalated",
        )
        rec_counts = {
            k: merged["events"].get(k, 0)
            for k in recovery_kinds
            if merged["events"].get(k, 0)
        }
        lineage = _load_lineage(directory)
        if rec_counts or lineage:
            lines.append("")
            lines.append(
                "recovery: "
                + (json.dumps(rec_counts) if rec_counts else "(clean)")
            )
            for e in (events or []):
                kind = e.get("kind")
                if kind == "gave_up":
                    lines.append(
                        f"  GAVE UP at {e.get('site')}: "
                        f"{e.get('attempts')} attempt(s), "
                        f"{e.get('error', '?')}"
                    )
                elif kind == "rollback":
                    lines.append(
                        f"  rollback #{e.get('rollbacks')} at iter "
                        f"{e.get('iter')} -> iter {e.get('resume_iter')} "
                        f"(step_scale {e.get('step_scale')})"
                    )
                elif kind == "quarantine":
                    lines.append(
                        f"  quarantined shard {e.get('shard')} "
                        f"(rebuilt, crc restamped: "
                        f"{e.get('crc_restamped')})"
                    )
            if lineage:
                lines.append(
                    f"  resume lineage: {len(lineage)} resumed attempt(s)"
                )
                for a in lineage:
                    lines.append(
                        f"    attempt {a.get('attempt_id')} run "
                        f"{a.get('run')} resumed at step "
                        f"{a.get('resumed_step')}"
                    )
            if merged["events"].get("gave_up", 0):
                errors += 1
                lines.append(
                    "  ERROR: run ended in gave_up (retry budget exhausted)"
                )

        # --- model health (ISSUE 8): the optimizer's last vital signs +
        # fired anomaly detectors. Anomalies are FINDINGS, not schema
        # errors — they never touch the exit code (gave_up stays the only
        # outcome-level error).
        health = merged.get("health", {}) or {}
        if health.get("samples") or health.get("anomalies"):
            lines.append("")
            lines.append(f"model health: {health.get('samples', 0)} sample(s)")
            last = health.get("last") or {}
            if last:
                parts = []
                for key in (
                    "llh", "grad_norm", "update_norm", "step_eff",
                    "accept_frac", "top_share", "churn", "support_churn",
                    "cap_occupancy",
                ):
                    v = last.get(key)
                    if isinstance(v, (int, float)):
                        parts.append(f"{key} {v:.4g}")
                    elif isinstance(v, str):      # strict-JSON "inf"/"nan"
                        parts.append(f"{key} {v}")
                dead = last.get("dead_comms")
                active = last.get("active_comms")
                if dead is not None and active is not None:
                    parts.append(f"dead {dead}/{int(dead) + int(active)}")
                lines.append(
                    f"  last (iter {last.get('iter', '?')}): "
                    + "  ".join(parts)
                )
            anomalies = health.get("anomalies") or {}
            if anomalies:
                lines.append(
                    "  ANOMALIES: "
                    + ", ".join(
                        f"{check} x{n}" for check, n in sorted(
                            anomalies.items()
                        )
                    )
                )
                for e in (events or []):
                    if e.get("kind") != "anomaly":
                        continue
                    detail = {
                        k: v for k, v in e.items()
                        if k not in ("v", "run", "pid", "t", "ts",
                                     "elapsed_s", "kind", "check", "iter")
                    }
                    lines.append(
                        f"    {e.get('check')} at iter {e.get('iter')}: "
                        + json.dumps(detail)
                    )
            else:
                lines.append("  anomalies: none")
            comm = [
                e for e in (events or []) if e.get("kind") == "sparse_comm"
            ]
            if comm:
                c = comm[-1]
                lines.append(
                    f"  sparse collectives: cap {c.get('comm_cap')} "
                    f"mode {c.get('comm_mode')} "
                    f"(sized from {c.get('touched_per_shard')} touched/"
                    f"shard, K={c.get('k')}, M={c.get('m')}, "
                    f"dp={c.get('dp')})"
                )
                if isinstance(last.get("exchanged_max"), (int, float)):
                    lines.append(
                        f"    exchanged-ids high-water "
                        f"{int(last['exchanged_max'])} of cap "
                        f"{c.get('comm_cap')}"
                    )
        # --- membership serving (ISSUE 14): the query scoreboard of a
        # `cli serve` run — latency percentiles, throughput, cache hit
        # rate, hot-swaps. Figures come from the final outcome (what the
        # perf ledger records); batch/swap counts from the events.
        final = merged.get("final") or {}
        if final.get("serve_queries"):
            lines.append("")
            lines.append(
                f"serving: {final['serve_queries']} queries "
                f"({final.get('serve_errors', 0)} error(s)) "
                f"over {merged['events'].get('serve', 0)} batch(es)"
            )
            parts = []
            for key, label in (
                ("serve_p50_s", "p50"), ("serve_p99_s", "p99"),
            ):
                v = final.get(key)
                if isinstance(v, (int, float)):
                    parts.append(f"{label} {v * 1e3:.3g} ms")
            if isinstance(final.get("serve_qps"), (int, float)):
                parts.append(f"{final['serve_qps']:.4g} qps")
            if isinstance(final.get("cache_hit_rate"), (int, float)):
                parts.append(
                    f"cache hit rate {final['cache_hit_rate']:.2%}"
                )
            if parts:
                lines.append("  " + "  ".join(parts))
            if final.get("serve_mix"):
                lines.append(f"  mix: {final['serve_mix']}")
            swaps = merged["events"].get("snapshot_swap", 0)
            if swaps or final.get("snapshot_swaps"):
                lines.append(
                    f"  hot-swaps: {swaps or final.get('snapshot_swaps')} "
                    f"(serving snapshot step "
                    f"{final.get('snapshot_step', '?')})"
                )
            # serving fleet (ISSUE 18): shed/overload, generation age,
            # and the per-shard p99 table of a routed (`cli route`) run
            if final.get("serve_shed"):
                lines.append(
                    f"  shed: {final['serve_shed']} "
                    f"({final.get('serve_shed_rate', 0):.2%} of offered "
                    "load) — admission control"
                )
            if isinstance(final.get("generation_age_s"), (int, float)):
                lines.append(
                    f"  generation age: {final['generation_age_s']:.1f}s "
                    "since publish"
                )
            if final.get("serve_shards"):
                lines.append(
                    f"  fleet: {final['serve_shards']} shard(s) x "
                    f"{final.get('serve_replicas', '?')} replica(s), "
                    f"serving generation "
                    f"{final.get('serving_generation', '?')}, "
                    f"{final.get('rollouts', 0)} rollout(s), "
                    f"{final.get('mixed_generation', 0)} mixed-generation "
                    "answer(s)"
                )
            # failover tripwires (ISSUE 19 satellite): counters that used
            # to live only in the router's stats() dict and die with the
            # process — rendered whenever the router recorded them
            if (
                "transport_failovers" in final
                or "pruned_generation" in final
            ):
                lines.append(
                    f"  failovers: {final.get('transport_failovers', 0)} "
                    "transport, "
                    f"{final.get('pruned_generation', 0)} "
                    "pruned-generation"
                )
            # per-hop latency decomposition (ISSUE 19 tentpole): the
            # cross-process trace means — where a routed query's time
            # went, fleet-wide
            hop_parts = []
            for hop in ("transport", "decode", "queue", "batch_wait",
                        "execute", "merge"):
                v = final.get(f"serve_hop_{hop}_s")
                if isinstance(v, (int, float)):
                    hop_parts.append(f"{hop} {v * 1e3:.3g}ms")
            if hop_parts:
                lines.append(
                    "  per-hop mean: " + "  ".join(hop_parts)
                    + f"  (over {final.get('traced_queries', '?')} "
                    "traced)"
                )
            shard_stats = final.get("serve_shard_stats") or {}
            if isinstance(shard_stats, dict) and shard_stats:
                lines.append(
                    "  shard    queries      p50 ms      p99 ms       qps"
                )
                for s, st in sorted(
                    shard_stats.items(), key=lambda kv: int(kv[0])
                ):
                    if not isinstance(st, dict):
                        continue
                    p50 = st.get("p50_s")
                    p99 = st.get("p99_s")
                    qps = st.get("qps")
                    lines.append(
                        f"  {s:>5} {st.get('queries', 0):>10} "
                        + (
                            f"{p50 * 1e3:>11.3f} "
                            if isinstance(p50, (int, float))
                            else f"{'-':>11} "
                        )
                        + (
                            f"{p99 * 1e3:>11.3f} "
                            if isinstance(p99, (int, float))
                            else f"{'-':>11} "
                        )
                        + (
                            f"{qps:>9.1f}"
                            if isinstance(qps, (int, float))
                            else f"{'-':>9}"
                        )
                    )
                for s, st in sorted(
                    shard_stats.items(), key=lambda kv: int(kv[0])
                ):
                    hops = (
                        st.get("hops") if isinstance(st, dict) else None
                    )
                    if isinstance(hops, dict) and hops:
                        lines.append(
                            f"    shard {s} hops: " + "  ".join(
                                f"{k} {v * 1e3:.3g}ms"
                                for k, v in hops.items()
                                if isinstance(v, (int, float))
                            )
                        )
        if merged["final"]:
            lines.append("")
            lines.append("final: " + json.dumps(merged["final"]))

    if events is not None:
        n, schema_errors = validate_events_file(
            os.path.join(directory, EVENTS_NAME)
        )
        errors += len(schema_errors)
        lines.append("")
        lines.append(
            f"events.jsonl: {n} events "
            + json.dumps(summarize_kinds(events))
        )
        dur = run_duration_s(events)
        if dur is not None:
            # monotonic, by construction: first->last elapsed_s, never a
            # wall-clock subtraction
            lines.append(f"  event timeline: {dur:.3f}s (monotonic)")
        if schema_errors:
            lines.append(f"  SCHEMA ERRORS ({len(schema_errors)}):")
            lines.extend(f"    {e}" for e in schema_errors[:20])
        steps = [
            e for e in events
            if e.get("kind") == "step"
            and isinstance(e.get("llh"), (int, float))
        ]
        if steps:
            first, last = steps[0], steps[-1]
            lines.append(
                f"  steps: {len(steps)}  iter {first.get('iter')}→"
                f"{last.get('iter')}  llh {first.get('llh'):.6g}→"
                f"{last.get('llh'):.6g}"
            )
        stalls = [e for e in events if e.get("kind") == "stall"]
        for s in stalls[:5]:
            where = s.get("spans") or []
            lines.append(
                f"  stall at t={s.get('elapsed_s', s.get('t'))}s: "
                f"silent {s.get('silent_s')}s, "
                f"last progress {s.get('progress')}"
                + (f", open span {where[-1]}" if where else "")
            )
    elif merged and merged["events"].get("start"):
        lines.append("")
        lines.append(
            "events.jsonl: absent (non-primary dir? events are written by "
            "process 0 only)"
        )
    return "\n".join(lines), errors


# ------------------------------------------------------------------ fleet
# Fleet-wide aggregation (ISSUE 19 tentpole): `cli report --fleet ROOT` /
# `cli watch --fleet ROOT` treat ROOT as a parent directory whose
# SUBDIRECTORIES are member telemetry dirs — the router's and every
# replica's --telemetry-dir side by side. Merging is read-time and
# tolerant by construction: a missing replica dir is simply not a member,
# an empty or torn events.jsonl decodes to what it holds (load_events),
# and a member mid-run (events, no run_report yet) contributes its live
# event stream with an empty final.


def fleet_dirs(root: str) -> List[str]:
    """Member telemetry dirs of a fleet root: immediate subdirectories
    holding an events.jsonl or any run_report*.json, sorted by name."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        if not os.path.isdir(d):
            continue
        if os.path.exists(os.path.join(d, EVENTS_NAME)) or glob.glob(
            os.path.join(d, "run_report*.json")
        ):
            out.append(d)
    return out


def load_fleet(root: str) -> List[dict]:
    """One record per member dir: name, entry (report first, start event
    fallback), final outcome, decoded events (None when the log is
    absent). Unreadable reports are treated as not-yet-written — a
    member can be rendered mid-run."""
    members = []
    for d in fleet_dirs(root):
        try:
            reports = load_reports(d)
        except (OSError, ValueError):
            reports = []
        events = load_events(d)
        rep = reports[0] if reports else {}
        entry = rep.get("entry")
        if not entry and events:
            start = next(
                (e for e in events if e.get("kind") == "start"), {}
            )
            entry = start.get("entry")
        members.append({
            "dir": d,
            "name": os.path.basename(d.rstrip(os.sep)),
            "entry": entry or "?",
            "final": rep.get("final") or {},
            "finalized": bool(reports),
            "events": events,
        })
    return members


def _fleet_router(members: List[dict]) -> Optional[dict]:
    """The router member: entry == "route", or (synthesized dirs) the
    member whose final carries the per-shard stats table."""
    for m in members:
        if m["entry"] == "route":
            return m
    for m in members:
        if m["final"].get("serve_shard_stats"):
            return m
    return None


def _fleet_supervision(members: List[dict]) -> Optional[dict]:
    """Supervisor state (ISSUE 20): from the `fleet` entry's final
    outcome when it finalized, else the roster of its LAST membership
    event (the supervisor publishes one per state change, with the
    per-member id/shard/state/restarts riding as the `roster` extra) —
    so a LIVE fleet renders up/restarting/quarantined/draining per
    member mid-drill."""
    sup = next((m for m in members if m["entry"] == "fleet"), None)
    if sup is None:
        return None
    f = sup["final"] or {}
    roster = None
    if isinstance(f.get("fleet_members"), dict):
        roster = [
            dict(
                (v if isinstance(v, dict) else {}), id=str(mid)
            )
            for mid, v in sorted(f["fleet_members"].items())
        ]
    if roster is None:
        last = next(
            (
                e for e in reversed(sup["events"] or [])
                if e.get("kind") == "membership"
                and isinstance(e.get("roster"), list)
            ),
            None,
        )
        if last is not None:
            roster = [
                r for r in last["roster"] if isinstance(r, dict)
            ]
    events = sup["events"] or []
    restarts = f.get("replica_restarts")
    if not isinstance(restarts, int):
        restarts = sum(
            1 for e in events if e.get("kind") == "replica_restart"
        )
    quarantined = f.get("quarantined")
    if not isinstance(quarantined, int):
        quarantined = sum(
            1 for e in events
            if e.get("kind") == "replica_quarantined"
        )
    return {
        "dir": sup["name"],
        "finalized": sup["finalized"],
        "replica_restarts": restarts,
        "quarantined": quarantined,
        "members": roster or [],
    }


def render_fleet_json(root: str) -> Tuple[dict, int]:
    """Machine-readable fleet view: member roster, the router's final
    scoreboard verbatim, and replica finals grouped by shard. Exit-code
    errors only when ROOT yields no members at all."""
    members = load_fleet(root)
    errors = 0 if members else 1
    router = _fleet_router(members)
    by_shard: Dict[str, List[dict]] = {}
    for m in members:
        if m is router or (
            m["entry"] not in ("serve", "?") and "shard" not in m["final"]
        ):
            continue
        if "shard" not in m["final"] and m["entry"] != "serve":
            continue
        f = m["final"]
        s = f.get("shard")
        key = str(s) if isinstance(s, int) else "?"
        by_shard.setdefault(key, []).append({
            "name": m["name"],
            "finalized": m["finalized"],
            "queries": f.get("queries"),
            "errors": f.get("errors"),
            "shed": f.get("shed"),
            "depth_peak": f.get("depth_peak"),
            "generations": f.get("generations"),
            "gen_age_s": f.get("gen_age_s"),
            "events": (
                len(m["events"]) if m["events"] is not None else None
            ),
            "stalls": sum(
                1 for e in (m["events"] or [])
                if e.get("kind") == "stall"
            ),
        })
    obj = {
        "root": root,
        "members": [
            {
                "name": m["name"],
                "entry": m["entry"],
                "finalized": m["finalized"],
                "events": (
                    len(m["events"]) if m["events"] is not None else None
                ),
            }
            for m in members
        ],
        "router": (router["final"] or None) if router else None,
        "router_dir": router["name"] if router else None,
        "replicas": dict(sorted(by_shard.items())),
        "supervision": _fleet_supervision(members),
    }
    return obj, errors


def render_fleet(root: str) -> Tuple[str, int]:
    """Human fleet view: per-shard p50/p99/QPS from the router next to
    each replica's own queue/shed/generation figures, the per-hop
    latency decomposition, freshness, and the failover tripwires — one
    screen answering 'which tier, which shard'."""
    obj, errors = render_fleet_json(root)
    if not obj["members"]:
        return (
            f"{root}: no member telemetry dirs (expected the router's "
            "and each replica's --telemetry-dir as subdirectories)",
            errors,
        )
    lines = [f"fleet {root}: {len(obj['members'])} member dir(s)"]
    for m in obj["members"]:
        lines.append(
            f"  {m['name']} [{m['entry']}]  "
            + (
                f"{m['events']} event(s)" if m["events"] is not None
                else "no events.jsonl"
            )
            + ("" if m["finalized"] else "  [running]")
        )
    rf = obj["router"] or {}
    if rf:
        lines.append("")
        parts = [f"router: {rf.get('serve_queries', 0)} queries"]
        for key, label in (
            ("serve_p50_s", "p50"), ("serve_p99_s", "p99"),
        ):
            v = rf.get(key)
            if isinstance(v, (int, float)):
                parts.append(f"{label} {v * 1e3:.3g} ms")
        if isinstance(rf.get("serve_qps"), (int, float)):
            parts.append(f"{rf['serve_qps']:.4g} qps")
        if rf.get("serve_shed"):
            parts.append(f"shed {rf['serve_shed']}")
        lines.append("  ".join(parts))
        lines.append(
            f"  generations: serving {rf.get('serving_generation', '?')}"
            + (
                f", age {rf['generation_age_s']:.1f}s"
                if isinstance(rf.get("generation_age_s"), (int, float))
                else ""
            )
            + f", {rf.get('rollouts', 0)} rollout(s), "
            f"{rf.get('mixed_generation', 0)} mixed, "
            f"{rf.get('pruned_generation', 0)} pruned-gen failover(s), "
            f"{rf.get('transport_failovers', 0)} transport failover(s)"
        )
        hop_parts = []
        for hop in ("transport", "decode", "queue", "batch_wait",
                    "execute", "merge"):
            v = rf.get(f"serve_hop_{hop}_s")
            if isinstance(v, (int, float)):
                hop_parts.append(f"{hop} {v * 1e3:.3g}ms")
        if hop_parts:
            lines.append(
                "  per-hop mean: " + "  ".join(hop_parts)
                + f"  (over {rf.get('traced_queries', '?')} traced)"
            )
        heal_parts = []
        for key, label in (
            ("router_retries", "retried"),
            ("hedged", "hedged"),
            ("hedge_wins", "hedge wins"),
            ("deadline_exceeded", "deadline exceeded"),
            ("membership_reloads", "membership reloads"),
        ):
            v = rf.get(key)
            if isinstance(v, int) and v:
                heal_parts.append(f"{label} {v}")
        if heal_parts:
            lines.append("  self-healing: " + "  ".join(heal_parts))
    sup = obj.get("supervision")
    if sup:
        lines.append("")
        lines.append(
            f"supervisor [{sup['dir']}]: "
            f"{sup['replica_restarts']} restart(s), "
            f"{sup['quarantined']} quarantined"
            + ("" if sup["finalized"] else "  [running]")
        )
        for r in sup["members"]:
            lines.append(
                f"  {r.get('id', '?'):<8} shard "
                f"{r.get('shard', '?')}  "
                f"{str(r.get('state', '?')):<12} "
                f"restarts {r.get('restarts', 0)}"
            )
    shard_stats = rf.get("serve_shard_stats") or {}
    shard_keys = sorted(
        set(shard_stats) | set(obj["replicas"]),
        key=lambda s: (not s.isdigit(), int(s) if s.isdigit() else 0),
    )
    if shard_keys:
        lines.append("")
        lines.append(
            "  shard    queries      p50 ms      p99 ms       qps"
            "  replicas      shed  depth pk"
        )
        for s in shard_keys:
            st = shard_stats.get(s) or {}
            reps = obj["replicas"].get(s) or []
            p50, p99, qps = (
                st.get("p50_s"), st.get("p99_s"), st.get("qps")
            )
            shed = sum(
                int(r["shed"]) for r in reps
                if isinstance(r.get("shed"), int)
            )
            dpk = max(
                (
                    int(r["depth_peak"]) for r in reps
                    if isinstance(r.get("depth_peak"), int)
                ),
                default=None,
            )
            lines.append(
                f"  {s:>5} {st.get('queries', 0):>10} "
                + (
                    f"{p50 * 1e3:>11.3f} "
                    if isinstance(p50, (int, float)) else f"{'-':>11} "
                )
                + (
                    f"{p99 * 1e3:>11.3f} "
                    if isinstance(p99, (int, float)) else f"{'-':>11} "
                )
                + (
                    f"{qps:>9.1f}"
                    if isinstance(qps, (int, float)) else f"{'-':>9}"
                )
                + f" {len(reps):>9}"
                + f" {shed:>9}"
                + (f" {dpk:>9}" if dpk is not None else f" {'-':>9}")
            )
            hops = st.get("hops")
            if isinstance(hops, dict) and hops:
                lines.append(
                    f"    shard {s} hops: " + "  ".join(
                        f"{k} {v * 1e3:.3g}ms"
                        for k, v in hops.items()
                        if isinstance(v, (int, float))
                    )
                )
            for r in reps:
                lines.append(
                    f"    replica {r['name']}: "
                    f"{r.get('queries', '?')} queries, "
                    f"{r.get('errors', 0) or 0} error(s), "
                    f"shed {r.get('shed', 0) or 0}"
                    + (
                        f", gen age {r['gen_age_s']:.1f}s"
                        if isinstance(r.get("gen_age_s"), (int, float))
                        else ""
                    )
                    + (
                        f", STALLS {r['stalls']}" if r.get("stalls")
                        else ""
                    )
                    + ("" if r["finalized"] else "  [running]")
                )
    return "\n".join(lines), errors
