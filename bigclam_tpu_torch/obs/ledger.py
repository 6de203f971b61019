# Copied from bigclam_tpu/obs/ledger.py (imports renamed to bigclam_tpu_torch).
"""Persistent perf-regression ledger (ISSUE 6 tentpole, part b).

BENCH_*.json artifacts exist but nothing compares run N against run N-1 —
a perf regression lands silently. This module gives every telemetry-
carrying run a compact, schema'd perf record appended to a ledger JSONL
(one line per run, append-only, human-diffable), and a diff that compares
the latest run against its MATCHED baseline with noise bands:

    BIGCLAM_PERF_LEDGER=perf/ledger.jsonl python -m bigclam_tpu.cli fit ...
    python -m bigclam_tpu.cli perf diff --ledger perf/ledger.jsonl

Record fields (LEDGER_VERSION 1): run id, wall-clock ts, entry point,
host/platform/backend/device fingerprint, config digest (sha1 over the
run's step_cfg_key digests — the compile by_key labels), step-time
percentiles (p10/p50/p90/p99 over the per-iteration sec_per_iter samples
the MetricsLogger sink forwarded), eps p50, hbm_frac (when the entry
recorded one — bench), compile count, per-span second totals (obs.trace),
and the final LLH.

BASELINE MATCHING: a record's baseline is the MOST RECENT EARLIER record
with the same (entry, cfg_digest, workload, backend, device_kind, host)
— a step time is only comparable against the same work on the same
hardware; runs with a different K, kernel-path config, or chip never
match, and neither do runs over different GRAPHS: cfg_digest is
config-only (step_cfg_key excludes the graph), so the workload axis is
the (n, edges, k) triple the entry points stamp into the run's `final`
outcome (fit/profile stamp all three; sweep and bench stamp n/edges only
— sweep's chosen_k is a noisy OUTPUT and bench's headline graph carries
no single K — and axes an entry does not record match on the Nones).
The affiliation representation ("dense" | "sparse", + sparse_m) is part
of the key too: a sparse top-M run does O(M) work per edge where dense
does O(K), so a same-K cross-baseline would be meaningless ("dense"
normalizes to None so pre-field dense records keep matching). A
run re-recorded into the same ledger (`perf record` after an
auto-append) is never its own baseline.

NOISE BANDS: the regression threshold is max(tolerance, rel spread of
either run), where a run's spread is (step_p90 - step_p50)/step_p50 — a
run whose own timing wobbles 30% cannot be failed by a 25% band. `diff`
VERDICTS on step_p50 and eps_p50 (or wall_s for steploss runs) and on
hbm_frac when both runs recorded one; step_p99 (a single sample on short
runs), compile growth, and per-span deltas are reported as findings, not
failures (the compile-flatness pin lives in tests/test_telemetry.py).

jax-free: the ledger must be writable/diffable on data-prep hosts and in
CI without an accelerator.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

LEDGER_ENV = "BIGCLAM_PERF_LEDGER"
LEDGER_VERSION = 1
DEFAULT_PATH = os.path.join("perf", "ledger.jsonl")

_NUM = (int, float)
# field -> allowed types; None-able numerics are (type..., type(None))
_RECORD_SCHEMA = {
    "lv": (int,),
    "run": (str,),
    "ts": _NUM,
    "entry": (str,),
    "host": (str,),
    "cfg_digest": (str,),
    "wall_s": _NUM,
    "steps": (int,),
    "compiles": (int,),
    "spans": (dict,),
}


def _percentile(vals: Sequence[float], q: float) -> Optional[float]:
    """Nearest-rank percentile over a copy; None on empty input."""
    if not vals:
        return None
    s = sorted(vals)
    idx = min(int(round(q / 100.0 * (len(s) - 1))), len(s) - 1)
    return s[idx]


def validate_record(rec: Any) -> List[str]:
    """Schema errors for one ledger record; [] when valid."""
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]
    errors = []
    for field, types in _RECORD_SCHEMA.items():
        if field not in rec:
            errors.append(f"missing field {field!r}")
        elif not isinstance(rec[field], types) or isinstance(
            rec[field], bool
        ):
            errors.append(
                f"{field!r} is {type(rec[field]).__name__}, "
                f"want {'/'.join(t.__name__ for t in types)}"
            )
    if not errors and rec["lv"] != LEDGER_VERSION:
        errors.append(f"ledger version {rec['lv']} != {LEDGER_VERSION}")
    return errors


def build_record(
    report: Dict[str, Any],
    step_secs: Optional[Sequence[float]] = None,
    step_eps: Optional[Sequence[float]] = None,
    note: str = "",
) -> Dict[str, Any]:
    """One ledger record from a finalized run report (+ the per-step
    timing samples RunTelemetry collected from the MetricsLogger sink)."""
    fp = report.get("fingerprint", {}) or {}
    keys = sorted((report.get("compiles", {}) or {}).get("by_key", {}))
    digest = (
        hashlib.sha1("|".join(keys).encode()).hexdigest()[:12]
        if keys
        else "none"
    )
    final = report.get("final", {}) or {}
    secs = [float(v) for v in (step_secs or [])]
    eps = [float(v) for v in (step_eps or [])]
    rec: Dict[str, Any] = {
        "lv": LEDGER_VERSION,
        "run": str(report.get("run", "")),
        "ts": round(time.time(), 3),
        "entry": str(report.get("entry", "")),
        "host": str(fp.get("host", "")),
        "platform": fp.get("platform"),
        "backend": fp.get("backend"),
        "device_kind": fp.get("device_kind"),
        "devices": fp.get("devices"),
        "cfg_digest": digest,
        "cfg_keys": keys,
        # workload identity (see module docstring): the graph/K the entry
        # point recorded in its final outcome — part of the match key,
        # because cfg_digest alone cannot tell two graphs apart
        "n": final.get("n"),
        "edges": final.get("edges"),
        "k": final.get("k"),
        # affiliation-state representation (ISSUE 7): a sparse top-M run
        # and a dense run at the same K do different work per edge —
        # match_key refuses the cross-baseline even when an entry point
        # leaves these unset in its final outcome (None == dense by
        # construction: the sparse trainers always stamp them)
        "representation": final.get("representation"),
        "sparse_m": final.get("sparse_m"),
        # resolved edge-kernel path (ISSUE 13 satellite): fused / split /
        # xla-fallback as the entry point stamped it (cli fit/profile
        # stamp "kernel_path", bench stamps "path"). Part of the match
        # key: a run whose kernels silently fell back to XLA must never
        # baseline against a fused run — the 7.66M-vs-27.4M round-1
        # capture artifact, now structurally impossible
        "kernel_path": final.get("kernel_path") or final.get("path"),
        # execution shape (ISSUE 10 satellite): a 2-proc run must never
        # baseline against a single-proc run of the same cfg on the same
        # box (each process times only its shard's work), and a (4,1)
        # mesh does different collective work than (2,2) at equal device
        # count — both join the match key. `processes` comes from the
        # run report (jax.process_count at finalize); `mesh` is the
        # "dpxtp" string the sharded entry points stamp into their final
        # outcome (None on single-chip runs — matches on the None)
        "processes": int(report.get("processes", 1) or 1),
        "mesh": final.get("mesh"),
        # node-axis partition (ISSUE 16): a 2D (rows, cols) closure-
        # gather run moves a fraction of the 1D all-gather's bytes at
        # equal device count — its step times and comms totals must
        # never baseline against a 1D run of the same cfg/mesh. None
        # (1D entry points that predate the stamp) matches only None
        "partition": final.get("partition"),
        # 2D neighbor-grad exchange mode (ISSUE 17): a closure run ships
        # cap-sized touched-row buffers where a dense run psums the full
        # row band — comms totals and step times are not comparable, so
        # the mode joins the match key. None (1D runs and pre-r21
        # records) matches only None
        "grad_exchange": final.get("grad_exchange"),
        "wall_s": float(report.get("wall_s", 0.0) or 0.0),
        "steps": len(secs),
        "step_p10": _round6(_percentile(secs, 10)),
        "step_p50": _round6(_percentile(secs, 50)),
        "step_p90": _round6(_percentile(secs, 90)),
        "step_p99": _round6(_percentile(secs, 99)),
        "eps_p50": _round6(_percentile(eps, 50)),
        "compiles": int((report.get("compiles", {}) or {}).get("count", 0)),
        "hbm_frac": final.get("hbm_frac"),
        "overlap_frac": final.get("overlap_frac"),
        "spans": {
            k: round(float(v), 4)
            for k, v in (report.get("spans", {}) or {})
            .get("seconds", {})
            .items()
        },
        "final_llh": final.get("llh"),
    }
    # collective-traffic accounting (obs.comms, ISSUE 10): the modeled
    # bytes/step total + per-site table of the run's compiled steps —
    # `cli perf diff` VERDICTS on the total (a layout/padding change that
    # silently inflates wire traffic is a regression even at flat step
    # time on a small testbed), per-site deltas ride the record for the
    # human diff. None when the run built no sharded trainer.
    comms = report.get("comms", {}) or {}
    comms_sites = comms.get("sites") or {}
    rec["comms_bytes_per_step"] = (
        round(float(comms.get("bytes_per_step", 0.0)), 1)
        if comms_sites
        else None
    )
    rec["comms_sites"] = {
        k: round(float(v), 1) for k, v in comms_sites.items()
    }
    # convergence figures (ISSUE 8): a fit that still lands the same LLH
    # but needs 3x the iterations — or stops with a grad norm an order of
    # magnitude hotter — is a regression `cli perf diff` must catch even
    # when per-step time is flat. iters_to_tol is the entry's recorded
    # iteration count (fit converged at conv_tol; max_iters runs record
    # the cap — same cfg, still comparable); final_grad_norm comes from
    # the run's last health sample (None with health off).
    iters = final.get("iters")
    rec["iters_to_tol"] = int(iters) if isinstance(iters, _NUM) and not (
        isinstance(iters, bool)
    ) else None
    health = report.get("health", {}) or {}
    last_health = health.get("last") or {}
    # non-finite -> None: the pack legitimately goes inf/nan mid-blow-up
    # (schema.py), but the ledger line must stay strict JSON, and the
    # `cli perf record` path (reading the finite-safed on-disk report,
    # where non-finite is the string "inf") already records None — the
    # finalize auto-append must agree
    gn = last_health.get("grad_norm")
    rec["final_grad_norm"] = (
        _round6(float(gn))
        if isinstance(gn, _NUM) and math.isfinite(float(gn))
        else None
    )
    rec["anomalies"] = sum(
        int(v) for v in (health.get("anomalies", {}) or {}).values()
    )
    # memory accounting (obs.memory, ISSUE 12): the modeled per-device
    # HBM total and per-host RSS peak of the run's trainer builds —
    # VERDICTED by `cli perf diff`, so a layout/padding/state change
    # that silently inflates memory fails CI exactly like a perf or
    # comms regression (the CPU testbed's step time cannot see it; the
    # pod's HBM can). An explicit final stamp (bench pins the headline
    # model's figure next to its measured peak) wins over the report
    # accumulation, which sums every model the run built.
    mem = (report.get("memory", {}) or {}).get("modeled") or {}
    hbm = final.get("hbm_modeled_bytes")
    if not isinstance(hbm, _NUM) or isinstance(hbm, bool):
        hbm = mem.get("hbm_bytes_per_device")
    rec["hbm_modeled_bytes"] = (
        round(float(hbm), 1)
        if isinstance(hbm, _NUM) and not isinstance(hbm, bool) and hbm > 0
        else None
    )
    host_rss = mem.get("host_rss_bytes")
    rec["host_rss_modeled_bytes"] = (
        round(float(host_rss), 1)
        if isinstance(host_rss, _NUM)
        and not isinstance(host_rss, bool)
        and host_rss > 0
        else None
    )
    # membership serving (ISSUE 14 satellite): a serve run's record
    # carries the latency/throughput scoreboard the server stamped into
    # its final outcome — `cli perf diff` VERDICTS serve_p99_s and
    # serve_qps (the serving SLO axes; unlike the trainer's step_p99,
    # serve p99 is computed over hundreds of per-request samples, so it
    # is a stable gate figure), cache_hit_rate rides as a finding. The
    # entry point ("serve") is already the first element of match_key,
    # so a serve record can never cross-baseline a fit record; serve_mix
    # (the query-family ratio string) joins the key below because two
    # runs with different family mixes do different work per query.
    for field in ("serve_p50_s", "serve_p99_s", "serve_qps"):
        v = final.get(field)
        rec[field] = (
            _round6(float(v))
            if isinstance(v, _NUM) and not isinstance(v, bool)
            else None
        )
    sq = final.get("serve_queries")
    rec["serve_queries"] = (
        int(sq) if isinstance(sq, _NUM) and not isinstance(sq, bool)
        else None
    )
    chr_ = final.get("cache_hit_rate")
    rec["cache_hit_rate"] = (
        _round6(float(chr_))
        if isinstance(chr_, _NUM) and not isinstance(chr_, bool)
        else None
    )
    mix = final.get("serve_mix")
    rec["serve_mix"] = str(mix) if mix else None
    # serving fleet (ISSUE 18 satellite): shards × replicas join the
    # match key (a 2×2 fleet's p99 is not a single-process baseline —
    # None on non-fleet records matches only None, the usual rebaseline
    # rule) and the shed rate is VERDICTED (an admission-control
    # regression that sheds 10x more traffic at flat p99 must fail)
    for field in ("serve_shards", "serve_replicas", "serve_shed"):
        v = final.get(field)
        rec[field] = (
            int(v) if isinstance(v, _NUM) and not isinstance(v, bool)
            else None
        )
    sr = final.get("serve_shed_rate")
    rec["serve_shed_rate"] = (
        _round6(float(sr))
        if isinstance(sr, _NUM) and not isinstance(sr, bool)
        else None
    )
    # distributed query tracing + freshness (ISSUE 19): the router's
    # per-hop latency decomposition means and the serving generation age
    # land as first-class record fields so `cli perf diff` can VERDICT
    # them — "the router got slower" (merge/transport up) and "shard N's
    # replica got slower" (queue/execute up) become distinguishable
    # regressions instead of one conflated p99, and "how stale is
    # serving" (ROADMAP 3a) gets a baseline. None (untraced / non-route
    # records) skips the checks as usual.
    for field in (
        "serve_hop_transport_s",
        "serve_hop_decode_s",
        "serve_hop_queue_s",
        "serve_hop_batch_wait_s",
        "serve_hop_execute_s",
        "serve_hop_merge_s",
        "generation_age_s",
    ):
        v = final.get(field)
        rec[field] = (
            _round6(float(v))
            if isinstance(v, _NUM) and not isinstance(v, bool)
            else None
        )
    # self-healing fleet (ISSUE 20): the failure-path scoreboard.
    # replica_restarts comes from the supervisor's final (`cli fleet
    # up`), the rest from the router's. The rates are VERDICTED by
    # `cli perf diff` — a fleet that suddenly retries 10x more often,
    # hedges most of its traffic, or blows deadlines it used to make is
    # regressing even at flat p99 (the retries ARE hiding the latency).
    for field in ("hedged_rate", "deadline_exceeded_rate"):
        v = final.get(field)
        rec[field] = (
            _round6(float(v))
            if isinstance(v, _NUM) and not isinstance(v, bool)
            else None
        )
    for field in ("replica_restarts", "router_retries"):
        v = final.get(field)
        rec[field] = (
            int(v) if isinstance(v, _NUM) and not isinstance(v, bool)
            else None
        )
    # incremental refit (ISSUE 15): cost ratio vs the last full fit and
    # the touched fraction — both VERDICTED by `cli perf diff` (a refit
    # silently re-touching the whole graph, or costing as much as the
    # full fit it exists to avoid, is a regression even at flat step
    # time). The `refit` entry point (match_key element 0) keeps these
    # records from ever cross-baselining a fit or serve record.
    for field in ("refit_cost_ratio", "touched_frac"):
        v = final.get(field)
        rec[field] = (
            _round6(float(v))
            if isinstance(v, _NUM) and not isinstance(v, bool)
            else None
        )
    rr = final.get("refit_rounds")
    rec["refit_rounds"] = (
        int(rr) if isinstance(rr, _NUM) and not isinstance(rr, bool)
        else None
    )
    if note:
        rec["note"] = note
    return rec


def _round6(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(v, 6)


def match_key(rec: Dict[str, Any]) -> Tuple:
    """Baseline identity: same entry + config + workload + representation
    + hardware + host (see module docstring). "dense" normalizes to None
    so records from entry points that never stamp a representation in
    their final outcome (always dense — the sparse trainers always
    stamp) match explicitly-stamped dense records; sparse records never
    match either. Note this does NOT resurrect pre-r11 baselines: the
    new config fields changed cfg_digest for every run, so old records
    stop matching on the digest regardless — by design, cfg-schema
    changes rebaseline."""
    rep = rec.get("representation")
    return (
        rec.get("entry"),
        rec.get("cfg_digest"),
        rec.get("n"),
        rec.get("edges"),
        rec.get("k"),
        None if rep == "dense" else rep,
        rec.get("sparse_m"),
        rec.get("backend"),
        rec.get("device_kind"),
        rec.get("host"),
        # execution shape (ISSUE 10 satellite): before these, a 2-proc
        # run silently baselined against a single-proc run on the same
        # box, and (4,1) against (2,2). Pre-field records carry None and
        # stop matching new ones — by design, the same rebaseline rule
        # as every match-key widening
        rec.get("processes"),
        rec.get("mesh"),
        # node-axis partition (ISSUE 16): 1d vs 2d runs do different
        # collective work at equal mesh size — None (pre-r20 records)
        # matches only None, the usual rebaseline rule
        rec.get("partition"),
        # 2D grad-exchange mode (ISSUE 17): closure vs dense backward
        # collectives move different bytes — None (1D / pre-r21 records)
        # matches only None, the usual rebaseline rule
        rec.get("grad_exchange"),
        # the resolved edge-kernel path (ISSUE 13): fused vs split vs
        # xla runs do different per-edge work — None (pre-r17 records /
        # entry points that never stamp it) matches only None, the same
        # rebaseline rule as every match-key widening
        rec.get("kernel_path"),
        # serving workload identity (ISSUE 14 satellite): the entry
        # point (element 0) already splits serve from fit — a serve p99
        # baseline can never cross-match a fit step-time baseline — and
        # the query-family mix splits serve runs whose per-query work
        # differs (a fold-in-heavy load is not comparable to a read-only
        # load at equal QPS). None (non-serve entries) matches None
        rec.get("serve_mix"),
        # fleet shape (ISSUE 18 satellite): a routed 2-shard × 2-replica
        # run does different per-query work (scatter-gather, TCP hops)
        # than a single-process server — fleet and single-process
        # records never cross-baseline. None matches None as usual
        rec.get("serve_shards"),
        rec.get("serve_replicas"),
    )


class PerfLedger:
    """Append-only JSONL of perf records; unparsable lines are skipped at
    read time (counted in .load_errors) so one corrupt line cannot take
    down the gate."""

    def __init__(self, path: str = DEFAULT_PATH):
        self.path = path
        self.load_errors = 0

    def append(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
        return rec

    def load(self) -> List[Dict[str, Any]]:
        self.load_errors = 0
        out: List[Dict[str, Any]] = []
        try:
            fh = open(self.path)
        except OSError:
            return out
        with fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    self.load_errors += 1
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
                else:
                    self.load_errors += 1
        return out

    def latest(
        self, records: Optional[List[dict]] = None, run: Optional[str] = None
    ) -> Optional[Dict[str, Any]]:
        records = self.load() if records is None else records
        if run is not None:
            for rec in reversed(records):
                if rec.get("run") == run:
                    return rec
            return None
        return records[-1] if records else None

    def baseline_for(
        self, rec: Dict[str, Any], records: Optional[List[dict]] = None
    ) -> Optional[Dict[str, Any]]:
        """Most recent EARLIER record with rec's match key (ledger order =
        append order; a record never baselines against itself or anything
        appended after it)."""
        records = self.load() if records is None else records
        key = match_key(rec)
        best = None
        for other in records:
            if other is rec or (
                other.get("run") == rec.get("run")
                and other.get("ts") == rec.get("ts")
            ):
                break
            if other.get("run") == rec.get("run"):
                # the same run re-recorded (auto-append + `perf record`
                # on the same dir stamps a fresh ts): identical step
                # samples, so it can never be its own baseline
                continue
            if match_key(other) == key:
                best = other
        return best


def maybe_append_env(
    report: Dict[str, Any],
    step_secs: Optional[Sequence[float]] = None,
    step_eps: Optional[Sequence[float]] = None,
    path: Optional[str] = None,
) -> Optional[Dict[str, Any]]:
    """RunTelemetry.finalize hook: append this run's record when an
    explicit ledger `path` was wired (cli --perf-ledger) or
    BIGCLAM_PERF_LEDGER names one. Primary process only (one record per
    run, like events.jsonl)."""
    path = path or os.environ.get(LEDGER_ENV)
    if not path or int(report.get("pid", 0)) != 0:
        return None
    rec = build_record(report, step_secs, step_eps)
    return PerfLedger(path).append(rec)


def record_from_dir(directory: str, note: str = "") -> Dict[str, Any]:
    """Build a record from a finished telemetry directory (`cli perf
    record`): the primary run report + per-step timings recovered from the
    step events in events.jsonl."""
    from bigclam_tpu_torch.obs.report import load_events, load_reports

    reports = load_reports(directory)
    if not reports:
        raise FileNotFoundError(f"{directory}: no run_report*.json")
    events = load_events(directory) or []
    secs = [
        float(e["sec_per_iter"])
        for e in events
        if e.get("kind") == "step"
        and isinstance(e.get("sec_per_iter"), _NUM)
    ]
    eps = [
        float(e["edges_per_sec_per_chip"])
        for e in events
        if e.get("kind") == "step"
        and isinstance(e.get("edges_per_sec_per_chip"), _NUM)
    ]
    return build_record(reports[0], secs, eps, note=note)


# ------------------------------------------------------------------- diff
def _rel_spread(rec: Dict[str, Any]) -> float:
    p50, p90 = rec.get("step_p50"), rec.get("step_p90")
    if not p50 or not p90:
        return 0.0
    return max((p90 - p50) / p50, 0.0)


def diff_records(
    base: Dict[str, Any], new: Dict[str, Any], tolerance: float = 0.25
) -> Dict[str, Any]:
    """Compare `new` against its baseline `base` (see module docstring for
    band/verdict rules). Returns a JSON-ready dict; "regression" is the
    gate verdict `cli perf diff` maps to a nonzero exit."""
    band = max(float(tolerance), _rel_spread(base), _rel_spread(new))
    checks: List[Dict[str, Any]] = []
    state = {"regression": False}

    def check(metric, bval, nval, worse_if_higher=True, band_mult=1.0,
              verdicted=True):
        if not isinstance(bval, _NUM) or not isinstance(nval, _NUM) or not bval:
            checks.append(
                {"metric": metric, "base": bval, "new": nval,
                 "skipped": True}
            )
            return
        ratio = nval / bval
        b = band * band_mult
        bad = ratio > 1.0 + b if worse_if_higher else ratio < 1.0 - b
        checks.append(
            {
                "metric": metric,
                "base": bval,
                "new": nval,
                "ratio": round(ratio, 4),
                "band": round(b, 4),
                "regression": bad,
                "verdicted": verdicted,
            }
        )
        if bad and verdicted:
            state["regression"] = True

    if new.get("steps") and base.get("steps"):
        check("step_p50", base.get("step_p50"), new.get("step_p50"))
        # p99 is a SINGLE sample on short runs (one GC pause or page fault
        # owns it): reported with a doubled band, never verdicted — the
        # gate verdict rides the median and throughput
        check("step_p99", base.get("step_p99"), new.get("step_p99"),
              band_mult=2.0, verdicted=False)
        check("eps_p50", base.get("eps_p50"), new.get("eps_p50"),
              worse_if_higher=False)
    elif isinstance(new.get("serve_p99_s"), _NUM) and isinstance(
        base.get("serve_p99_s"), _NUM
    ):
        # serving runs (ISSUE 14): the SLO axes are tail latency and
        # throughput. serve_p99 is a percentile over per-request samples
        # (hundreds per run), not the trainer's single-sample step_p99 —
        # it is VERDICTED, which is the whole point of the serve gate's
        # ledger baseline. Cache hit rate is a finding (worse_if_higher
        # False, not verdicted): a mix change legitimately moves it
        check("serve_p99_s", base["serve_p99_s"], new["serve_p99_s"])
        check("serve_p50_s", base.get("serve_p50_s"),
              new.get("serve_p50_s"))
        check("serve_qps", base.get("serve_qps"), new.get("serve_qps"),
              worse_if_higher=False)
        check("cache_hit_rate", base.get("cache_hit_rate"),
              new.get("cache_hit_rate"), worse_if_higher=False,
              verdicted=False)
        # fleet shed rate (ISSUE 18 satellite): admission control
        # shedding materially more of the load at flat p99 is a
        # capacity regression — verdicted on router records (check()
        # itself skips when the baseline shed nothing)
        check("serve_shed_rate", base.get("serve_shed_rate"),
              new.get("serve_shed_rate"))
        # per-hop decomposition (ISSUE 19): verdicted separately so the
        # diff NAMES the slow hop. Hop means are micro-quantities over
        # traced samples — noisier than the aggregate p99 — so they get
        # a wider band (2x the p50->p90-spread-widened tolerance)
        for hop in ("transport", "decode", "queue", "batch_wait",
                    "execute", "merge"):
            field = f"serve_hop_{hop}_s"
            check(field, base.get(field), new.get(field), band_mult=2.0)
        # freshness (ROADMAP 3a): serving a materially older generation
        # than baseline is a staleness regression — the publish cadence
        # broke, not the query path. Wall-clock age is scheduler-noisy,
        # hence the widest band
        check("generation_age_s", base.get("generation_age_s"),
              new.get("generation_age_s"), band_mult=4.0)
        # self-healing rates (ISSUE 20): verdicted when the baseline
        # exercised them (check() skips a zero/None baseline — a
        # fault-free baseline cannot band a chaos run). Retries going UP
        # at flat p99 means the fleet is failing more and hiding it;
        # hedges going up means the tail got heavier; deadline misses
        # are client-visible errors.
        check("router_retries", base.get("router_retries"),
              new.get("router_retries"))
        check("hedged_rate", base.get("hedged_rate"),
              new.get("hedged_rate"))
        check("deadline_exceeded_rate",
              base.get("deadline_exceeded_rate"),
              new.get("deadline_exceeded_rate"))
    else:
        # steploss entries (ingest, report-only runs): wall time is the
        # only comparable figure
        check("wall_s", base.get("wall_s"), new.get("wall_s"))
    if isinstance(base.get("hbm_frac"), _NUM) and isinstance(
        new.get("hbm_frac"), _NUM
    ):
        check("hbm_frac", base["hbm_frac"], new["hbm_frac"],
              worse_if_higher=False)
    # collective-traffic verdicts (obs.comms, ISSUE 10): modeled
    # bytes/step growing past the band is a layout regression the
    # step-time checks cannot see on a small testbed (the wire cost
    # scales with the pod, the CPU fake's doesn't); a shrinking overlap
    # fraction means rotation hops stopped hiding behind compute
    if isinstance(base.get("comms_bytes_per_step"), _NUM) and isinstance(
        new.get("comms_bytes_per_step"), _NUM
    ):
        check("comms_bytes_per_step", base["comms_bytes_per_step"],
              new["comms_bytes_per_step"])
    if isinstance(base.get("overlap_frac"), _NUM) and isinstance(
        new.get("overlap_frac"), _NUM
    ):
        check("overlap_frac", base["overlap_frac"], new["overlap_frac"],
              worse_if_higher=False)
    # memory verdicts (obs.memory, ISSUE 12): modeled per-device HBM or
    # modeled host-RSS growing past the band is a capacity regression —
    # invisible to step time on a small testbed, fatal on the pod whose
    # HBM the config was sized against
    if isinstance(base.get("hbm_modeled_bytes"), _NUM) and isinstance(
        new.get("hbm_modeled_bytes"), _NUM
    ):
        check("hbm_modeled_bytes", base["hbm_modeled_bytes"],
              new["hbm_modeled_bytes"])
    if isinstance(
        base.get("host_rss_modeled_bytes"), _NUM
    ) and isinstance(new.get("host_rss_modeled_bytes"), _NUM):
        check("host_rss_modeled_bytes", base["host_rss_modeled_bytes"],
              new["host_rss_modeled_bytes"])
    # incremental-refit verdicts (ISSUE 15): refit_cost_ratio growing
    # past the band means the warm-start stopped saving work vs the
    # full fit it replaces; touched_frac growing means a delta of the
    # same shape started touching more of the graph (halo/discovery
    # regression). Both only exist on `refit` entries, which the match
    # key (entry element 0) keeps disjoint from fit/serve baselines.
    if isinstance(base.get("refit_cost_ratio"), _NUM) and isinstance(
        new.get("refit_cost_ratio"), _NUM
    ):
        check("refit_cost_ratio", base["refit_cost_ratio"],
              new["refit_cost_ratio"])
    if isinstance(base.get("touched_frac"), _NUM) and isinstance(
        new.get("touched_frac"), _NUM
    ):
        check("touched_frac", base["touched_frac"],
              new["touched_frac"])
    # fleet supervision verdict (ISSUE 20): a `cli fleet up` record
    # whose restart count grew past the band means replicas are dying
    # more than the matched baseline drill — a stability regression the
    # router's retry counters can mask. check() skips a zero baseline
    # (a clean run cannot band a chaos drill).
    if isinstance(base.get("replica_restarts"), _NUM) and isinstance(
        new.get("replica_restarts"), _NUM
    ):
        check("replica_restarts", base["replica_restarts"],
              new["replica_restarts"])
    # convergence verdicts (ISSUE 8): iteration count to tolerance is
    # VERDICTED (same cfg + workload + seed ⇒ deterministic up to float
    # summation order — growth past the band is a real optimizer
    # regression, not timing noise); the final grad norm is reported as a
    # finding (its scale is workload-dependent)
    if isinstance(base.get("iters_to_tol"), _NUM) and isinstance(
        new.get("iters_to_tol"), _NUM
    ):
        check("iters_to_tol", base["iters_to_tol"], new["iters_to_tol"])
    if isinstance(base.get("final_grad_norm"), _NUM) and isinstance(
        new.get("final_grad_norm"), _NUM
    ):
        check("final_grad_norm", base["final_grad_norm"],
              new["final_grad_norm"], verdicted=False)

    # findings (reported, never verdicted): compile growth + span deltas
    compile_growth = int(new.get("compiles", 0)) - int(
        base.get("compiles", 0)
    )
    deltas = []
    bspans, nspans = base.get("spans", {}) or {}, new.get("spans", {}) or {}
    for path in sorted(set(bspans) & set(nspans)):
        bs, ns = float(bspans[path]), float(nspans[path])
        if bs > 0:
            deltas.append(
                {"path": path, "base_s": bs, "new_s": ns,
                 "ratio": round(ns / bs, 4)}
            )
    deltas.sort(key=lambda d: -d["ratio"])
    # per-site comms deltas (findings — the verdict rides the total):
    # which collective site grew is the actionable half of a bytes/step
    # regression
    comms_deltas = []
    bc = base.get("comms_sites", {}) or {}
    nc = new.get("comms_sites", {}) or {}
    for site in sorted(set(bc) & set(nc)):
        bs, ns = float(bc[site]), float(nc[site])
        if bs > 0 and ns != bs:
            comms_deltas.append(
                {"site": site, "base_bytes": bs, "new_bytes": ns,
                 "ratio": round(ns / bs, 4)}
            )
    comms_deltas.sort(key=lambda d: -d["ratio"])
    return {
        "base_run": base.get("run"),
        "new_run": new.get("run"),
        "band": round(band, 4),
        "checks": checks,
        "regression": state["regression"],
        "compile_growth": compile_growth,
        "span_deltas": deltas[:8],
        "comms_deltas": comms_deltas[:8],
        # finding, not a verdict: anomaly events in the new run (the
        # detectors already said WHAT; the diff just surfaces that the
        # baseline was clean and the new run was not)
        "anomalies_new": int(new.get("anomalies", 0) or 0),
        "anomalies_base": int(base.get("anomalies", 0) or 0),
    }


def render_diff(d: Dict[str, Any]) -> str:
    lines = [
        f"perf diff: run {d['new_run']} vs baseline {d['base_run']} "
        f"(noise band {d['band']:.0%})"
    ]
    for c in d["checks"]:
        if c.get("skipped"):
            lines.append(
                f"  {c['metric']:<10} skipped "
                f"(base={c['base']} new={c['new']})"
            )
            continue
        verdict = (
            "REGRESSION"
            if c["regression"] and c.get("verdicted", True)
            else ("slow (not verdicted)" if c["regression"] else "ok")
        )
        lines.append(
            f"  {c['metric']:<10} base {c['base']:<12g} new {c['new']:<12g}"
            f" ratio {c['ratio']:.3f} (band {c['band']:.0%})  {verdict}"
        )
    if d.get("compile_growth"):
        lines.append(
            f"  note: compile count changed by {d['compile_growth']:+d}"
        )
    if d.get("anomalies_new") and not d.get("anomalies_base"):
        lines.append(
            f"  note: {d['anomalies_new']} health anomaly event(s) in the "
            "new run (baseline was clean) — see `cli report`"
        )
    hot = [s for s in d.get("span_deltas", []) if s["ratio"] > 1.0]
    if hot:
        lines.append("  slowest-growing spans:")
        for s in hot[:3]:
            lines.append(
                f"    {s['path']:<32} {s['base_s']:.3f}s -> "
                f"{s['new_s']:.3f}s ({s['ratio']:.2f}x)"
            )
    grew = [c for c in d.get("comms_deltas", []) if c["ratio"] > 1.0]
    if grew:
        lines.append("  collective sites moving more bytes/step:")
        for c in grew[:3]:
            lines.append(
                f"    {c['site']:<32} {c['base_bytes']:.0f} -> "
                f"{c['new_bytes']:.0f} B/step ({c['ratio']:.2f}x)"
            )
    lines.append(
        "  verdict: " + ("REGRESSION" if d["regression"] else "PASS")
    )
    return "\n".join(lines)
