"""The events.jsonl schema: one flat JSON object per line, validated by a
dependency-free checker (the rules below ARE the schema).

Copied from bigclam_tpu/obs/schema.py: the same SCHEMA_VERSION and event
kinds, so the JAX package's validator and `cli report` read the port's
events. The port writes a subset of the kinds (no serving, store or
collective events yet).

Base fields on EVERY event:

    v          int     schema version (SCHEMA_VERSION)
    run        str     run id — one RunTelemetry instance = one run
    pid        int     process index (the rank; 0 before/without a group)
    t          float   seconds since the RunTelemetry was created
                       (kept from v1; same clock as elapsed_s)
    ts         float   wall-clock unix time (time.time) — for correlating
                       with external logs ONLY; never compute durations
                       from it (NTP steps / clock jumps corrupt them)
    elapsed_s  float   MONOTONIC seconds since the RunTelemetry was
                       created (time.perf_counter) — the ordering and
                       duration field consumers must use (obs.report does)
    kind       str     one of EVENT_KINDS

Kind-specific REQUIRED fields are listed in EVENT_KINDS; extra fields are
always allowed (events stay extensible without a schema bump — consumers
must ignore unknown keys). Unknown kinds are invalid: the smoke gate exists
to catch a producer drifting from this file.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

# v2: base fields ts + elapsed_s on every event; new `span` kind
SCHEMA_VERSION = 2

_NUM = (int, float)

# kind -> {required_field: allowed types}
EVENT_KINDS = {
    "start": {"entry": (str,)},            # run began (entry = fit/sweep/...)
    "end": {"wall_s": _NUM},               # run finalized
    "step": {"iter": (int,), "llh": _NUM},  # one optimizer iteration
    "metric": {},                          # non-step MetricsLogger record
    "stage": {"name": (str,), "seconds": _NUM},   # stage completed
    "memory": {"tag": (str,), "devices": (list,)},  # device-mem watermark
    "checkpoint": {"step": (int,)},        # checkpoint saved
    "restore": {"step": (int,)},           # checkpoint restored
    "compile": {"name": (str,), "seconds": _NUM},  # backend compile observed
    "model_build": {"model": (str,), "path": (str,)},  # trainer compiled
    "distributed_init": {"processes": (int,)},
    "cycle": {"cycle": (int,), "llh": _NUM},   # quality annealing cycle
    "stall": {"silent_s": _NUM, "rss_bytes": (int,)},  # heartbeat deadline hit
    "stall_escalated": {"stalls": (int,)},  # N consecutive stalls: watchdog
                                            # escalated (obs.heartbeat)
    "nonfinite": {"iter": (int,)},         # non-finite LLH sentinel fired
    "ingest": {"edges": (int,)},           # graph cache compiled
    "graph_load": {"source": (str,)},      # graph materialized on host
    "note": {},                            # freeform annotation
    # --- resilience (bigclam_tpu/resilience) ---
    "fault_injected": {"site": (str,), "fault": (str,)},  # harness fired
    "retry": {"site": (str,), "attempt": (int,)},   # transient failure,
                                                    # backing off
    "recovered": {"site": (str,), "attempts": (int,)},  # retry succeeded
    "gave_up": {"site": (str,), "attempts": (int,)},    # budget exhausted
                                                    # (cli report exits 1)
    "rollback": {"iter": (int,), "rollbacks": (int,)},  # non-finite LLH:
                                                    # state rolled back to
                                                    # the last finite
                                                    # snapshot, step cut
    "quarantine": {"shard": (int,)},       # crc-failed shard moved aside
                                           # and rebuilt from source
    "resume": {"step": (int,)},            # --resume auto restored a run
    # --- tracing & perf ledger (obs.trace / obs.ledger) ---
    "span": {"name": (str,), "path": (str,), "seconds": _NUM},
    # one closed span: `path` is the slash-joined nesting
    # ("fit/fit_loop/dispatch"), `name` its last segment; per-iteration
    # spans aggregate into the run report instead of emitting (emit=False)
    # --- model-health diagnostics (ops.diagnostics / obs.health).
    # Only `iter` is REQUIRED on `health`: every other payload field
    # (llh, grad_norm, ...) is a float that can legitimately go non-
    # finite mid-blow-up, and strict-JSON serialization then stringifies
    # it ("inf"/"nan" — telemetry._finite_safe), which a numeric
    # requirement would reject exactly on the events this layer exists
    # to capture.
    "health": {"iter": (int,)},            # one device health-pack sample
    "anomaly": {"check": (str,), "iter": (int,)},  # detector fired
                                           # (divergence / plateau /
                                           # oscillation / dead_communities
                                           # / cap_pressure)
    "sparse_comm": {"comm_cap": (int,), "comm_mode": (str,)},
    # sparse-collective layout committed at model build (cap, static
    # sparse-vs-psum mode, the touched-count it was sized from); the
    # PER-STEP occupancy/fallback counters ride `health` events
    # --- collective-traffic accounting (obs.comms) ---
    "comms": {"site": (str,), "op": (str,), "bytes_per_step": _NUM},
    # one collective site of a just-built train step (static bytes/step
    # model; payload/count/participants/phase/axis ride as extra fields).
    # Re-emitted when the layout changes (sparse cap refinement) — the
    # run report keeps the LAST model per site
    "balance": {"what": (str,), "max": _NUM, "mean": _NUM},
    # per-shard work-balance snapshot at model build (shard edge counts,
    # tile-pad waste): max/mean/skew/cv + the arg-max shard. Crossing
    # the imbalance threshold additionally fires an `anomaly` event
    # (check="imbalance", iter=-1 — build-time, not an iteration)
    # --- membership serving (the JAX package's serve) ---
    "serve": {"family": (str,), "batch": (int,), "seconds": _NUM},
    # one flushed request batch (family = sorted "|"-joined families in
    # the batch, per-family counts ride as n_<family> extras, `step` the
    # serving snapshot generation); per-request latencies aggregate into
    # the stats the entry stamps into `final` (serve_p99_s etc.) so the
    # perf ledger verdicts serving p99 like step time
    "snapshot_swap": {"step": (int,)},
    # a running server hot-swapped to a newly published snapshot
    # (utils.checkpoint publish/latest; `previous` = the old generation)
    # --- sharded serving fleet (serve.fleet / serve.router) ---
    "fleet_publish": {"step": (int,), "shards": (int,)},
    # one fleet generation published (per-shard archives + manifest,
    # utils.checkpoint.publish_fleet_next); `bytes` may ride as an extra
    "rollout": {"step": (int,)},
    # the router flipped the fleet-wide serving generation — only after
    # EVERY healthy replica of EVERY shard reported `step` loaded
    "route": {"queries": (int,), "shards": (int,)},
    # one routed query batch (FleetRouter.run_queries); aggregates land
    # in `final` under the same serve_* keys as `cli serve`, plus
    # serve_shards/serve_replicas/serve_shard_stats/mixed_generation
    # --- distributed query tracing + freshness ---
    "qtrace": {"trace_id": (str,), "family": (str,), "total_s": _NUM},
    # one slow-query exemplar: the full cross-process trace of a routed
    # query — `hops` (list of per-sub-send dicts with shard / wire_s /
    # decode_s / queue_s / batch_wait_s / execute_s) and `merge_s`
    # (router-side time not spent on the wire) ride as extras. The
    # router keeps the top-N slowest traces per window (serve.router
    # TRACE_WINDOW/TRACE_TOP) so the log stays bounded under load
    "freshness": {"generation_age_s": _NUM},
    # serving staleness sample (ROADMAP 3a): wall-clock seconds since
    # the serving generation was published, emitted by the router at
    # refresh and at batch completion; `step` (the serving generation)
    # and `rollouts` ride as extras. Aggregates land in `final` as
    # generation_age_s, which the perf ledger VERDICTS
    # --- self-healing serving fleet (serve.supervise) ---
    "replica_restart": {"member": (str,), "shard": (int,)},
    # the supervisor is respawning a replica slot after an unplanned
    # exit (restart-on-exit with RetryPolicy backoff); `restarts` (the
    # slot's lifetime respawn count) rides as an extra
    "replica_quarantined": {"member": (str,), "shard": (int,)},
    # crash-loop detection fired: more than quarantine_after consecutive
    # failures parked the slot — the fleet degrades to its surviving
    # replicas instead of burning CPU on a doomed respawn loop
    # (`failures` rides as an extra)
    "membership": {"seq": (int,), "members": (int,)},
    # the membership document changed: the supervisor published seq N
    # with `members` live entries (`roster` — id/shard/state/restarts
    # per member — rides as an extra on supervisor-emitted events), or
    # the router reconciled its endpoint set against it
    # --- incremental graph deltas ---
    "delta_ingest": {"edges_added": (int,), "touched_shards": (int,)},
    # one applied edge delta (GraphStore.apply_delta): directed edges
    # added, how many shard ranges were rebuilt (touched_frac /
    # delta_seq / phi_rebaked ride as extras). Untouched shard blobs
    # are byte-identical by contract
    "refit": {"touched": (int,), "rounds": (int,)},
    # one warm-start incremental refit (models.refit.warm_start_refit):
    # delta-touched rows, block-coordinate rounds run; refit_nodes /
    # touched_frac / escalated / converged / foldin_iters ride as
    # extras. An escalation additionally fires `anomaly` events
    # (source="refit") carrying the detector findings
    # --- memory accounting (obs.memory) ---
    "memory_model": {"buffer": (str,), "bytes": _NUM},
    # one buffer of a trainer's static memory model, baked at step
    # build: scope="device" rows are per-device HBM (category state /
    # graph / scratch / transient / collective), scope="host" rows are
    # the per-stage host-RSS model (stage + dominant flag). Re-emitted
    # models REPLACE their site set via reset_model on the batch's
    # first event, exactly like `comms`. Live-vs-model drift past the
    # band fires an `anomaly` event (check="memory_drift", iter=-1)
}

_BASE = {
    "v": (int,), "run": (str,), "pid": (int,), "t": _NUM,
    "ts": _NUM, "elapsed_s": _NUM, "kind": (str,),
}


def validate_event(event) -> List[str]:
    """Schema errors for one decoded event dict; [] when valid."""
    errors: List[str] = []
    if not isinstance(event, dict):
        return [f"event is {type(event).__name__}, not an object"]
    for field, types in _BASE.items():
        if field not in event:
            errors.append(f"missing base field {field!r}")
        elif not isinstance(event[field], types) or isinstance(
            event[field], bool
        ):
            errors.append(
                f"{field!r} is {type(event[field]).__name__}, "
                f"want {'/'.join(t.__name__ for t in types)}"
            )
    if errors:
        return errors
    if event["v"] != SCHEMA_VERSION:
        errors.append(f"schema version {event['v']} != {SCHEMA_VERSION}")
    kind = event["kind"]
    required = EVENT_KINDS.get(kind)
    if required is None:
        return errors + [f"unknown kind {kind!r}"]
    for field, types in required.items():
        if field not in event:
            errors.append(f"kind {kind!r} missing field {field!r}")
        elif not isinstance(event[field], types) or isinstance(
            event[field], bool
        ):
            errors.append(
                f"{kind}.{field} is {type(event[field]).__name__}, "
                f"want {'/'.join(t.__name__ for t in types)}"
            )
    return errors


def validate_events_file(path: str) -> Tuple[int, List[str]]:
    """(number of events, errors) for a whole events.jsonl; every line must
    parse as JSON and validate. Error strings carry 1-based line numbers."""
    import json

    n = 0
    errors: List[str] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            n += 1
            try:
                event = json.loads(line)
            except ValueError as e:
                errors.append(f"line {lineno}: not JSON ({e})")
                continue
            errors.extend(
                f"line {lineno}: {msg}" for msg in validate_event(event)
            )
    return n, errors


def summarize_kinds(events: Iterable[dict]) -> dict:
    """{kind: count} over decoded events (report + rendering helper)."""
    out: dict = {}
    for e in events:
        k = e.get("kind", "?")
        out[k] = out.get(k, 0) + 1
    return out
