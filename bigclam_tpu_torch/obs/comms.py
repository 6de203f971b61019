"""Collective-traffic accounting of the port's mesh steps, and host-skew
observability.

The jax-free parts are copied from bigclam_tpu/obs/comms.py (`Site`,
`CommsModel`, `balance_stats`, `owner_pid`, the emitters and the
report-time skew detector, bit for bit); the step models and the wire
conventions are the port's own, because its collectives are not JAX's:

* **psum** (parallel/sharded.py `psum`): every other shard sends its
  partial to mesh position 0, which sums them in shard order and sends the
  total back to every other position: 2 * s * (p - 1) bytes for an s-byte
  partial over p positions. **pmax** (parallel/sparse_collectives.py
  `pmax`) moves the same bytes.
* **all_gather** (`all_gather`): every position receives the p - 1 other
  shards: p * (p - 1) * s bytes. The tensors are made once per DISTINCT
  device, so on a mesh that repeats a device nothing moves; the model
  prices mesh positions all the same, so its figure does not depend on
  whether a device repeats.
* **ppermute** (parallel/ring.py `RingRotation` hop): every position
  receives its successor's rotating shard: p * s bytes a hop, and a
  rotation of p phases makes p - 1 hops (the hop that would only bring
  each shard home is not made).
* **all_to_all** and **psum_scatter** (parallel/twod.py: the closure
  exchange, the touched-rows grad exchange, the candidate and LLH
  scatters): an s-byte buffer a position, split in p slices, of which
  every position receives the p - 1 slices meant for it from the others:
  (p - 1) * s bytes. A 2D site runs once per group of its axis (C groups
  of R positions over rows, R of C over cols), so its count is the JAX
  count times the groups, and the port's total is p times the JAX
  model's per-device figure.

`bytes_per_step` is the TOTAL over mesh positions (not per device, as the
JAX model prices it): a single-controller mesh's counter sees every
transfer (on a multi-process mesh a rank's counter sees the psums' and
gathers' every position, and only its own ring hops). Axes of size 1
cost nothing.

**Reconciliation.** The three helpers report the payload bytes they pass
between mesh positions, per site, to the counter `counting()` installs
(`count(site, nbytes)`; one None check when none is installed, so the
step pays nothing otherwise). The mesh trainers' `comms_measured(state)`
runs one step under a counter and re-prices the model from the counted
bytes (`CommsModel.remeasure_totals`): equal to the model when the model
describes the step. The health pack's few scalars move by `.to` outside
the helpers and are neither modeled nor counted.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

_NUM = (int, float)

# bucket/shard skew past this multiple of the mean marks the layout as
# imbalance-anomalous (parallel.ring's RING_IMBALANCE_FACTOR shares it)
IMBALANCE_FACTOR = 4.0

# report-time host-skew detector thresholds (detect_host_skew); host-side
# knobs like obs.health.DEFAULTS — deliberately NOT config fields
DEFAULTS: Dict[str, float] = {
    "straggler_factor": 3.0,    # max/min skew of the per-pid signal
    "straggler_floor_s": 0.05,  # absolute seconds floor (noise guard)
}


def wire_bytes(op: str, payload_bytes: float, participants: int) -> float:
    """Bytes ONE occurrence of a port collective moves between mesh
    positions, for a `payload_bytes` array per position over
    `participants` positions (see the module docstring)."""
    p = max(int(participants), 1)
    if p <= 1:
        return 0.0
    if op == "all_gather":
        return float(payload_bytes) * p * (p - 1)
    if op == "ppermute":
        return float(payload_bytes) * p
    if op in ("psum", "pmax"):
        return 2.0 * float(payload_bytes) * (p - 1)
    if op in ("all_to_all", "psum_scatter"):
        return float(payload_bytes) * (p - 1)
    raise ValueError(f"unknown collective op {op!r}")


@dataclasses.dataclass(frozen=True)
class Site:
    """One collective site of a train step.

    payload_bytes: the array bytes one position contributes to one
    occurrence; count: occurrences per optimizer step; phase: which part
    of the step issues it (gather / reduce / rotate)."""

    site: str
    op: str
    payload_bytes: float
    count: float
    participants: int
    phase: str
    axis: str

    @property
    def bytes_per_step(self) -> float:
        return wire_bytes(self.op, self.payload_bytes, self.participants) \
            * self.count

    def to_fields(self) -> Dict[str, Any]:
        return {
            "site": self.site,
            "op": self.op,
            "bytes_per_step": round(self.bytes_per_step, 1),
            "payload_bytes": round(float(self.payload_bytes), 1),
            "count": round(float(self.count), 4),
            "participants": int(self.participants),
            "phase": self.phase,
            "axis": self.axis,
        }


@dataclasses.dataclass(frozen=True)
class CommsModel:
    """The static bytes-per-step model one trainer baked at step build."""

    family: str                  # sharded | ring | sparse | twod
    model: str                   # trainer class name
    sites: Tuple[Site, ...]
    params: Dict[str, Any]       # the shape arithmetic inputs

    def bytes_per_step(self) -> float:
        return sum(s.bytes_per_step for s in self.sites)

    def site_bytes(self) -> Dict[str, float]:
        return {s.site: round(s.bytes_per_step, 1) for s in self.sites}

    def remeasure(self, payloads: Dict[str, float]) -> "CommsModel":
        """A copy with the named sites' payloads replaced by measured
        bytes; unnamed sites keep their modeled payloads."""
        sites = tuple(
            dataclasses.replace(
                s, payload_bytes=float(payloads[s.site])
            )
            if s.site in payloads
            else s
            for s in self.sites
        )
        return dataclasses.replace(self, sites=sites)

    def remeasure_totals(self, per_step: Dict[str, float]) -> "CommsModel":
        """A copy re-priced from COUNTED bytes a step per site (the
        counter's totals): each named site's payload becomes the one that
        moves exactly that many bytes under its op and count; a site the
        counter never saw moved nothing. Sites the counter saw that the
        model lacks are added, so unmodeled traffic shows."""
        payloads = {}
        for s in self.sites:
            per = wire_bytes(s.op, 1.0, s.participants) * s.count
            got = float(per_step.get(s.site, 0.0))
            payloads[s.site] = got / per if per else 0.0
        out = self.remeasure(payloads)
        extra = tuple(
            Site(name, "psum", b / 2.0, 1, 2, "unmodeled", "nodes")
            for name, b in sorted(per_step.items())
            if name not in payloads
        )
        return dataclasses.replace(out, sites=out.sites + extra)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "family": self.family,
            "model": self.model,
            "bytes_per_step": round(self.bytes_per_step(), 1),
            "sites": [s.to_fields() for s in self.sites],
            "params": dict(self.params),
        }


def _scalar_payload(llh_itemsize: int, num_candidates: int) -> float:
    """The per-step scalar psums every family shares: the shards' LLH
    partials (accumulation dtype) and the (num_candidates + 1,) int32
    accepted-step histograms."""
    return llh_itemsize + (num_candidates + 1) * 4


def _k_sites(family: str, n_loc: int, dp: int, tp: int, itemsize: int,
             num_candidates: int, edges: int, phases: int) -> List[Site]:
    """The psums over the k axis of a tp > 1 step (parallel/sharded.py
    `kpsum`): per node row and phase the per-edge partial dots x and the
    (S, E) candidate dots of the edges it sweeps, and per row once the
    (3 + 2S, n_loc) row dots of the node and Armijo tails. Edge counts
    differ per shard, so x and xc are priced at the mean over the dp
    phases x rows; the totals are exact. None at tp = 1."""
    if tp <= 1:
        return []
    per = float(edges) / max(dp * phases, 1) * itemsize
    occ = dp * phases
    return [
        Site(f"{family}/psum_k_x", "psum", per, occ, tp, "reduce", "k"),
        Site(f"{family}/psum_k_xc", "psum", per * num_candidates, occ, tp,
             "reduce", "k"),
        Site(f"{family}/psum_k_rows", "psum",
             (3 + 2 * num_candidates) * n_loc * itemsize, dp, tp, "reduce",
             "k"),
    ]


def sharded_step_model(
    n_pad: int,
    k_pad: int,
    dp: int,
    itemsize: int,
    num_candidates: int,
    llh_itemsize: Optional[int] = None,
    model: str = "ShardedBigClamModel",
    tp: int = 1,
    edges: int = 0,
) -> CommsModel:
    """Collective sites of the port's all-gather step (parallel/sharded.py
    `make_sharded_train_step`, `make_tp_train_step` and `finish_step`):
    the F all-gather at the top of the step (one per column block), the
    sumF psums at the top and after the update (per column block), the LLH
    and histogram psums, and at tp > 1 the psums over k (_k_sites; `edges`
    the graph's directed edges)."""
    n_loc = n_pad // max(dp, 1)
    k_loc = k_pad // max(tp, 1)
    sites = [
        Site("sharded/all_gather_F", "all_gather",
             n_loc * k_loc * itemsize, tp, dp, "gather", "nodes"),
        Site("sharded/psum_sumF", "psum",
             k_loc * itemsize, 2 * tp, dp, "reduce", "nodes"),
        Site("sharded/psum_scalars", "psum",
             _scalar_payload(llh_itemsize or itemsize, num_candidates), 1,
             dp, "reduce", "nodes"),
    ] + _k_sites("sharded", n_loc, dp, tp, itemsize, num_candidates, edges, 1)
    return CommsModel(
        family="sharded", model=model, sites=tuple(sites),
        params={"n_pad": n_pad, "k_pad": k_pad, "dp": dp, "tp": tp,
                "itemsize": itemsize},
    )


def ring_step_model(
    n_pad: int,
    k_pad: int,
    dp: int,
    itemsize: int,
    num_candidates: int,
    llh_itemsize: Optional[int] = None,
    model: str = "RingBigClamModel",
    tp: int = 1,
    edges: int = 0,
) -> CommsModel:
    """Collective sites of the port's ring step (parallel/ring.py
    `make_ring_train_step`, `make_ring_tp_step`): two rotations a step
    (gradient pass, candidate pass) of dp - 1 hops each, every hop moving
    one (n_pad/dp, k_pad/tp) block into each position; the sumF psums at
    the top of the step and after the update; the LLH and histogram psums;
    at tp > 1 the psums over k of each (row, phase) bucket (_k_sites).
    Against the all-gather's dp (dp - 1) shards a step the ring moves
    2 dp (dp - 1): twice the bytes, for a peak of two shards a device
    instead of all of F."""
    n_loc = n_pad // max(dp, 1)
    k_loc = k_pad // max(tp, 1)
    sites = [
        Site("ring/ppermute_F_rot", "ppermute",
             n_loc * k_loc * itemsize, 2 * (dp - 1) * tp if dp > 1 else 0, dp,
             "rotate", "nodes"),
        Site("ring/psum_sumF", "psum",
             k_loc * itemsize, 2 * tp, dp, "reduce", "nodes"),
        Site("ring/psum_scalars", "psum",
             _scalar_payload(llh_itemsize or itemsize, num_candidates), 1,
             dp, "reduce", "nodes"),
    ] + _k_sites("ring", n_loc, dp, tp, itemsize, num_candidates, edges, dp)
    return CommsModel(
        family="ring", model=model, sites=tuple(sites),
        params={"n_pad": n_pad, "k_pad": k_pad, "dp": dp, "tp": tp,
                "itemsize": itemsize},
    )


def sparse_step_model(
    n_pad: int,
    m: int,
    k_pad: int,
    dp: int,
    itemsize: int,
    num_candidates: int,
    cap: int,
    mode: str,
    support_every: int = 1,
    llh_itemsize: Optional[int] = None,
    model: str = "SparseShardedBigClamModel",
) -> CommsModel:
    """Collective sites of the sparse sharded step (parallel/
    sparse_sharded.py, parallel/sparse_collectives.py), JAX's site names
    and payloads: the member exchange scales with M, not K (the
    post-support id/weight gather every step, the support pass's
    pre-update gather every support_every steps); the sumF allreduce
    moves the fixed (cap,) id/value buffers in 'sparse' mode (the cap,
    not the touched count, is the wire cost) and the (k_pad,) psum in
    'dense' mode; the touched-count pmax and the LLH/histogram psum run
    in both."""
    from bigclam_tpu_torch.parallel.sparse_collectives import (
        exchange_payload_bytes,
    )

    n_loc = n_pad // max(dp, 1)
    row_bytes = m * (4 + itemsize)          # int32 id + weight per slot
    sup = max(int(support_every), 1)
    sites = [
        Site("sparse/all_gather_members", "all_gather",
             n_loc * row_bytes, 1.0 + 1.0 / sup, dp, "gather", "nodes"),
        Site("sparse/psum_scalars", "psum",
             _scalar_payload(llh_itemsize or itemsize, num_candidates), 1,
             dp, "reduce", "nodes"),
    ]
    if mode == "sparse":
        sites.append(Site(
            "sparse/allreduce_touched", "all_gather",
            exchange_payload_bytes(cap, itemsize), 2, dp,
            "exchange", "nodes",
        ))
    else:
        sites.append(Site(
            "sparse/psum_sumF", "psum", k_pad * itemsize, 2, dp,
            "reduce", "nodes",
        ))
    sites.append(Site(
        "sparse/pmax_touched_count", "pmax", 4, 2, dp, "exchange", "nodes",
    ))
    return CommsModel(
        family="sparse", model=model, sites=tuple(sites),
        params={"n_pad": n_pad, "m": m, "k_pad": k_pad, "dp": dp,
                "itemsize": itemsize, "cap": cap, "mode": mode,
                "support_every": sup},
    )


def twod_step_model(
    n_pad: int,
    k_pad: int,
    rows: int,
    cols: int,
    itemsize: int,
    num_candidates: int,
    closure_cap: int = 1,
    llh_itemsize: Optional[int] = None,
    model: str = "TwoDShardedBigClamModel",
    row_bytes: Optional[float] = None,
    grad_exchange: str = "dense",
    grad_cap: int = 0,
    fused: bool = False,
) -> CommsModel:
    """Collective sites of the port's 2D step (parallel/twod.py), JAX's
    site names and payloads: the row group's source-row all-gather over
    cols, the capped closure all-to-all over rows, the grad reduction over
    cols (the dense psum of the (n_row, K) band, or the touched-rows
    exchange: two all-to-alls of (cols, grad_cap, K) buffers, the pmax of
    the counts over cols and the counters' pmax over rows; nothing at
    grad_cap 0), the psum_scatters of the candidate and LLH sums, the
    sumF psums and the scalars. `row_bytes` overrides the per-row width of
    the gather and the closure exchange (the preflight's sparse pricing).
    A site over one axis runs once per group of the other (count x
    groups); the health pack's scalars are not modeled (they move outside
    the helpers). `fused` changes compute, not collectives."""
    p = max(rows * cols, 1)
    n_blk = n_pad // p
    n_row = cols * n_blk
    rb = float(row_bytes) if row_bytes else float(k_pad * itemsize)
    li = llh_itemsize or itemsize
    sites = [
        Site("twod/allgather_srcF", "all_gather", n_blk * rb, rows, cols,
             "gather", "cols"),
        Site("twod/alltoall_closure", "all_to_all", rows * closure_cap * rb,
             cols, rows, "exchange", "rows"),
    ]
    if grad_exchange == "closure":
        if grad_cap > 0:
            sites += [
                Site("twod/alltoall_grad_closure", "all_to_all",
                     cols * grad_cap * k_pad * itemsize, 2 * rows, cols,
                     "exchange", "cols"),
                Site("twod/pmax_grad_count", "pmax", 4, rows, cols,
                     "exchange", "cols"),
                Site("twod/pmax_grad_count_rows", "pmax", 4, 2 * cols, rows,
                     "exchange", "rows"),
            ]
    else:
        sites.append(Site("twod/psum_grad", "psum", n_row * k_pad * itemsize,
                          rows, cols, "reduce", "cols"))
    sites += [
        Site("twod/psum_scatter_cand", "psum_scatter",
             num_candidates * n_row * itemsize, rows, cols, "reduce", "cols"),
        Site("twod/psum_scatter_nbr_llh", "psum_scatter", n_row * li, rows,
             cols, "reduce", "cols"),
        Site("twod/psum_sumF", "psum", k_pad * itemsize, 2, p, "reduce",
             "mesh"),
        Site("twod/psum_scalars", "psum", _scalar_payload(li, num_candidates),
             1, p, "reduce", "mesh"),
    ]
    return CommsModel(
        family="twod", model=model, sites=tuple(sites),
        params={"n_pad": n_pad, "k_pad": k_pad, "rows": rows, "cols": cols,
                "itemsize": itemsize, "closure_cap": closure_cap,
                "grad_exchange": grad_exchange, "grad_cap": grad_cap,
                "fused": bool(fused)},
    )


def twod_fallback_model(model: CommsModel) -> CommsModel:
    """The 2D model of a step whose row groups fell back to the dense psum
    (JAX `twod_measured`): the touched-rows exchange site priced as the
    psum of the row band it became, under the same name."""
    rows = int(model.params.get("rows", 1))
    cols = int(model.params.get("cols", 1))
    n_row = cols * (int(model.params.get("n_pad", 0)) // max(rows * cols, 1))
    dense = Site("twod/alltoall_grad_closure", "psum",
                 n_row * int(model.params.get("k_pad", 0))
                 * int(model.params.get("itemsize", 4)), rows, cols,
                 "exchange", "cols")
    return dataclasses.replace(model, sites=tuple(
        dense if s.site == dense.site else s for s in model.sites))


def sparse_measured(model: CommsModel, state) -> Dict[str, Any]:
    """Reconcile the sparse model against the RUNTIME exchange counters
    riding the state (comm_ids = max touched ids over shards, comm_dense =
    the step summed sumF by the dense psum), JAX's keys: the member-gather
    payload from the live shards, the occupancy (exchanged <= cap), and
    the allreduce's wire bytes a step, the dense psum's when it fell
    back (here under the port's wire conventions)."""
    from bigclam_tpu_torch.parallel.sparse_collectives import (
        exchange_payload_bytes,
    )

    cap = int(model.params.get("cap", 0))
    itemsize = int(model.params.get("itemsize", 4))
    k_pad = int(model.params.get("k_pad", 0))
    dp = int(model.params.get("dp", 1))
    exchanged = int(state.comm_ids)
    fell_back = bool(int(state.comm_dense))
    ids, w = state.ids, state.F
    ids0 = ids[0] if isinstance(ids, tuple) else ids
    w0 = w[0] if isinstance(w, tuple) else w
    payloads = {"sparse/all_gather_members": float(
        ids0.numel() * ids0.element_size() + w0.numel() * w0.element_size())}
    if fell_back:
        measured_exchange = 2 * wire_bytes("psum", k_pad * itemsize, dp)
    else:
        measured_exchange = 2 * wire_bytes(
            "all_gather", exchange_payload_bytes(cap, itemsize), dp
        )
    return {
        "payloads": payloads,
        "exchanged_ids": exchanged,
        "dense_fallback": fell_back,
        "cap": cap,
        "occupancy": exchanged / max(cap, 1),
        "exchange_bytes_per_step": round(measured_exchange, 1),
    }


# --------------------------------------------------------- reconciliation
class CommsCounter:
    """Payload bytes the collective helpers passed between mesh
    positions, per site."""

    def __init__(self) -> None:
        self.bytes: Dict[str, float] = {}

    def add(self, site: str, nbytes: float) -> None:
        self.bytes[site] = self.bytes.get(site, 0.0) + float(nbytes)


_COUNTER: Dict[str, Optional[CommsCounter]] = {"on": None}


def count(site: str, nbytes: float) -> None:
    """Add `nbytes` at `site` to the installed counter; no-op when none
    is installed (the helpers call this on every collective)."""
    ctr = _COUNTER["on"]
    if ctr is not None:
        ctr.add(site, nbytes)


def counting_on() -> bool:
    return _COUNTER["on"] is not None


@contextlib.contextmanager
def counting() -> Iterator[CommsCounter]:
    """Install a fresh counter for the block (nesting restores the outer
    one)."""
    prev, ctr = _COUNTER["on"], CommsCounter()
    _COUNTER["on"] = ctr
    try:
        yield ctr
    finally:
        _COUNTER["on"] = prev


def measured_step(cm: CommsModel, step, state):
    """Run `step(state)` once under a counter; returns (the model re-priced
    from the counted bytes, the new state)."""
    with counting() as ctr:
        new_state = step(state)
    return cm.remeasure_totals(ctr.bytes), new_state


# ------------------------------------------------------ balance / skew
def balance_stats(counts: Sequence[float]) -> Dict[str, Any]:
    """Skew statistics over per-shard work counts (directed edges, tile
    slots): max, mean (floored at 1 like the ring heuristic), skew =
    max/mean, cv, and the arg-max shard — what the `balance` events and
    the imbalance anomaly carry."""
    vals = [float(v) for v in counts]
    if not vals:
        return {"max": 0.0, "mean": 1.0, "skew": 0.0, "cv": 0.0,
                "argmax": -1}
    mx = max(vals)
    mean = max(sum(vals) / len(vals), 1.0)
    var = sum((v - mean) ** 2 for v in vals) / len(vals)
    return {
        "max": mx,
        "mean": round(mean, 2),
        "skew": round(mx / mean, 3),
        "cv": round(math.sqrt(var) / mean, 4),
        "argmax": max(range(len(vals)), key=lambda i: vals[i]),
    }


def owner_pid(shard: int, num_shards: int, process_count: int) -> int:
    """Owning process of a store/trainer shard under the process-major
    contiguous layout (multihost.host_shard_ids): host h of H owns
    shards [h*S/H, (h+1)*S/H)."""
    pc = max(int(process_count), 1)
    s = max(int(num_shards), 1)
    return min(int(shard) * pc // s, pc - 1)


# ----------------------------------------------------------- emission
def emit_model(cm: CommsModel) -> None:
    """One `comms` event per collective site of a just-built step (plus
    the run-report/ledger accumulation RunTelemetry.event folds in).
    The FIRST event of the batch carries reset_model=True: a re-emitted
    model (the sparse cap refinement can flip the whole collective MODE)
    must REPLACE its previous site set in every consumer, or a stale
    site from the abandoned layout inflates bytes/step forever. No-op
    with telemetry off."""
    from bigclam_tpu_torch.obs import telemetry as _obs

    tel = _obs.current()
    if tel is None:
        return
    for i, s in enumerate(cm.sites):
        tel.event("comms", model=cm.model, family=cm.family,
                  reset_model=1 if i == 0 else 0, **s.to_fields())


def emit_balance(what: str, stats: Dict[str, Any], **fields) -> None:
    """One `balance` event (shard edge-count skew, tile-pad waste). The
    skew itself is a finding for the report/watch; crossing
    IMBALANCE_FACTOR is the anomaly (emit_imbalance_anomaly)."""
    from bigclam_tpu_torch.obs import telemetry as _obs

    tel = _obs.current()
    if tel is None:
        return
    payload = {k: v for k, v in stats.items()}
    payload.update(fields)
    tel.event("balance", what=what, **payload)


def emit_shard_balance(
    what: str,
    counts: Sequence[float],
    num_shards: int,
    process_count: int = 1,
    hint: str = "",
    **fields,
) -> Dict[str, Any]:
    """The one balance-emission path every sharded trainer build goes
    through: a `balance` event with the skew stats (+ any tile-pad-waste
    fields), and — past IMBALANCE_FACTOR — the imbalance anomaly naming
    the worst shard and its owning process. Returns the stats either
    way (telemetry off included) so callers can reuse them."""
    stats = balance_stats(counts)
    emit_balance(what, stats, **fields)
    if stats["skew"] > IMBALANCE_FACTOR:
        emit_imbalance_anomaly(
            what, stats["max"], stats["mean"],
            worst_shard=stats["argmax"],
            host=owner_pid(stats["argmax"], num_shards, process_count),
            hint=hint,
        )
    return stats


def emit_imbalance_anomaly(
    what: str,
    max_count: float,
    mean: float,
    worst_shard: Optional[int] = None,
    host: Optional[int] = None,
    hint: str = "",
) -> None:
    """The `_warn_imbalance_counts` stderr line as a first-class anomaly
    event (check="imbalance", build-time: iter=-1) naming the worst
    shard and — when ownership is known — the host that holds it, so the
    report, `cli watch`, and `cli perf diff`'s anomaly count all see
    what used to scroll past on stderr."""
    from bigclam_tpu_torch.obs import telemetry as _obs

    tel = _obs.current()
    if tel is None:
        return
    fields: Dict[str, Any] = {
        "what": what,
        "max": float(max_count),
        "mean": round(float(mean), 2),
        "factor": round(float(max_count) / max(float(mean), 1e-9), 2),
    }
    if worst_shard is not None:
        fields["worst_shard"] = int(worst_shard)
    if host is not None:
        fields["host_pid"] = int(host)
    if hint:
        fields["hint"] = hint
    tel.event("anomaly", check="imbalance", iter=-1, **fields)


# --------------------------------------------- report-time skew detector
def _pid_of(report: Dict[str, Any]) -> str:
    return str(report.get("pid", "?"))


def _host_of(report: Dict[str, Any]) -> str:
    return str((report.get("fingerprint", {}) or {}).get("host", "?"))


def sync_seconds(report: Dict[str, Any]) -> float:
    """Total fit-loop sync-span seconds of one per-process report (the
    host block on the step's scalar LLH — device compute + in-step
    collective waits + D2H are indistinguishable from the host, so this
    IS the 'waiting on the gang' phase)."""
    spans = (report.get("spans", {}) or {}).get("seconds", {}) or {}
    return sum(
        float(v) for k, v in spans.items() if k.endswith("fit_loop/sync")
    )


def loop_overhead_seconds(report: Dict[str, Any]) -> float:
    """Seconds the fit stage spent OUTSIDE the per-iteration phase spans
    (dispatch/sync/callback/checkpoint/extract_F): host-side work the
    taxonomy does not attribute — GC, a slow filesystem, a planted
    per-host delay. The overhead rule of detect_host_skew keys on this
    because a straggler's slowness lives exactly here (its own sync is
    SHORT — everyone else waits on it)."""
    spans = (report.get("spans", {}) or {}).get("seconds", {}) or {}
    parents = {
        k.split("/fit_loop/")[0]
        for k in spans
        if "/fit_loop/" in k
    }
    if not parents and any(k.startswith("fit_loop/") for k in spans):
        parents = {""}
    total = 0.0
    for parent in parents:
        prefix = f"{parent}/fit_loop/" if parent else "fit_loop/"
        phase_sum = sum(
            float(v) for k, v in spans.items() if k.startswith(prefix)
        )
        parent_total = float(spans.get(parent, phase_sum)) if parent \
            else phase_sum
        total += max(parent_total - phase_sum, 0.0)
    return total


def detect_host_skew(
    reports: List[Dict[str, Any]],
    thresholds: Optional[Dict[str, float]] = None,
) -> List[Dict[str, Any]]:
    """Straggler findings over the merged per-process run reports (pure;
    deterministic thresholds — DEFAULTS). Two rules, at most one finding:

    * waiters: one pid's sync total is a straggler_factor below its
      peers' (they sat in the collective waiting on it) — fire naming
      the MINIMUM-sync pid.
    * overhead: one pid's unattributed fit-loop time dwarfs its peers'
      (host-side slowness: the planted `delay` fault, GC, slow I/O) —
      fire naming the MAXIMUM-overhead pid.

    Both need >= 2 per-process reports; a single-process run can still
    exercise them through synthesized fake-host reports (the tier-1
    path on jax versions whose 2-proc worker modes skip)."""
    th = {**DEFAULTS, **(thresholds or {})}
    factor = float(th["straggler_factor"])
    floor = float(th["straggler_floor_s"])
    per = [
        (r, sync_seconds(r), loop_overhead_seconds(r)) for r in reports
    ]
    per = [(r, s, o) for r, s, o in per if s > 0.0 or o > 0.0]
    if len(per) < 2:
        return []
    out: List[Dict[str, Any]] = []
    sync = {(_pid_of(r)): s for r, s, _ in per}
    # --- waiters rule ---
    syncs = sorted(per, key=lambda t: t[1])
    lo_r, lo_s, _ = syncs[0]
    hi_r, hi_s, _ = syncs[-1]
    if (
        lo_s > 0.0
        and hi_s - lo_s > floor
        and hi_s > factor * max(lo_s, 1e-9)
    ):
        out.append({
            "check": "straggler",
            "rule": "waiters",
            "pid": int(lo_r.get("pid", 0)),
            "host": _host_of(lo_r),
            "sync_s": round(lo_s, 4),
            "peers_sync_s": round(hi_s, 4),
            "skew": round(hi_s / max(lo_s, 1e-9), 2),
            "sync_by_pid": {k: round(v, 4) for k, v in sync.items()},
        })
        return out
    # --- overhead rule ---
    ovh = sorted(per, key=lambda t: t[2])
    top_r, _, top_o = ovh[-1]
    second_o = ovh[-2][2]
    if top_o > floor and top_o > factor * max(second_o, floor):
        out.append({
            "check": "straggler",
            "rule": "overhead",
            "pid": int(top_r.get("pid", 0)),
            "host": _host_of(top_r),
            "overhead_s": round(top_o, 4),
            "peers_overhead_s": round(second_o, 4),
            "overhead_by_pid": {
                _pid_of(r): round(o, 4) for r, _, o in per
            },
        })
    return out
