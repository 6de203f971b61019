"""Memory accounting of the port: static device-memory models, live
reconciliation and the capacity preflight.

The jax-free parts are copied from bigclam_tpu/obs/memory.py (`Buffer`,
`MemoryModel` with `reconcile`, `HostStage`, `HostModel`,
`host_rss_model` and its helpers, the emitters and `render_preflight`,
bit for bit); the per-family device models, the live measurement, the
device table and `preflight` are the port's own, built from the port's
buffers:

* no tile layout: the CUDA kernels read the CSR (indptr, indices) and the
  plain sweeps its int64 src/dst views; the K-blocked paths add the
  reverse-edge index, `pallas_vmem` the edge chunks' runs;
* no donation (`cfg.donate_state` has no port use): a step allocates its
  F_new beside the F it reads;
* K padded to 32 (K blocks above 1,024), rows not padded (dense);
* the rollback snapshot (cfg.rollback_budget > 0) is a full clone of the
  state (models/bigclam.py `run_fit_loop`).

Categories as in the JAX model: `state` and `graph` are the long-lived
tensors the model holds (the exact reconciliation target: on any device
`measured_device_bytes` of the live tensors equals the modeled bytes),
`scratch` the initial state the fit's callers hold through the fit, the
rollback snapshot and the cadence-only health pack,
`transient` a step's temporaries (F_new, the gradient, the K-blocked
paths' per-edge x and xc at 68 B an edge in float32, the plain sweeps'
edge-chunk gathers, a mesh's gathered F and rotating shards).

Mesh models are per DEVICE and count what the device holds: every mesh
position placed on it, one sumF and one gathered F per distinct device
(`psum` and `all_gather` make one tensor per device), the scalars on the
first device. On a mesh of one repeated card that is every shard, which
is what the card's allocator sees; the model reports the busiest device.

Allocator figures differ from the model: `torch.cuda.memory_allocated`
rounds each block up (512 B), and small torch temporaries of a step
(column sums, the histogram, the LLH reduction) are not modeled.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

from bigclam_tpu_torch.obs.comms import CommsModel

# (HEALTH_LEN,) float32 health pack (ops.diagnostics.HEALTH_LEN; pinned
# equal by tests/test_torch_memory.py)
HEALTH_LEN = 14

# live-vs-model reconciliation band of the addressable bytes: exact on
# every device (storage bytes of the live tensors), so the band only
# leaves room for a model that prices a buffer approximately
DEFAULTS: Dict[str, float] = {
    "drift_frac": 0.02,
}

# preflight verdicts keep this fraction of device memory free for the
# allocator's rounding and caching and the unmodeled torch temporaries
HBM_HEADROOM_FRAC = 0.08

# device memory of the cards the preflight knows: the card alone, under
# the name torch.cuda.get_device_name gives, with the bytes
# torch.cuda.get_device_properties(0).total_memory read on it (when a card
# is present, `device_hbm_bytes` reads the card instead of this row)
DEVICE_HBM_BYTES: Dict[str, int] = {
    "NVIDIA H100 80GB HBM3": 85_017_493_504,
}

CATEGORIES = ("state", "graph", "scratch", "transient", "collective")
# categories whose buffers are long-lived tensors — the exact
# reconciliation target
ADDRESSABLE = ("state", "graph")


def device_hbm_bytes(kind: str) -> int:
    """Device memory of the card named `kind`: read from the card when
    this process sees one of that name, else the table's row. Raises
    KeyError for a kind the table lacks (the preflight refuses it rather
    than guess)."""
    import sys

    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            if torch.cuda.is_available():
                for i in range(torch.cuda.device_count()):
                    if torch.cuda.get_device_name(i) == kind:
                        return int(
                            torch.cuda.get_device_properties(i).total_memory
                        )
        except Exception:
            pass
    if kind not in DEVICE_HBM_BYTES:
        raise KeyError(kind)
    return DEVICE_HBM_BYTES[kind]


@dataclasses.dataclass(frozen=True)
class Buffer:
    """One live device buffer of a compiled train step (per-DEVICE
    bytes; `count` for repeated buffers like the ring's rotation pair)."""

    name: str
    bytes: float
    category: str = "state"
    count: float = 1.0
    note: str = ""

    @property
    def total_bytes(self) -> float:
        return float(self.bytes) * float(self.count)

    def to_fields(self) -> Dict[str, Any]:
        out = {
            "buffer": self.name,
            "bytes": round(self.total_bytes, 1),
            "category": self.category,
            "count": round(float(self.count), 2),
        }
        if self.note:
            out["note"] = self.note
        return out


@dataclasses.dataclass(frozen=True)
class MemoryModel:
    """The static per-device HBM model one trainer baked at step build."""

    family: str                  # dense | sharded | ring | sparse
    model: str                   # trainer class name
    buffers: Tuple[Buffer, ...]
    params: Dict[str, Any]       # the shape arithmetic inputs

    def hbm_bytes(self) -> float:
        """Modeled per-device HBM peak: every category, scratch and
        transients included — the capacity/preflight figure."""
        return sum(b.total_bytes for b in self.buffers)

    def addressable_bytes(self) -> float:
        """The state + graph categories only — the long-lived buffers
        `measured_device_bytes` can sum exactly (the reconciliation
        target; exact on the CPU fake)."""
        return sum(
            b.total_bytes for b in self.buffers
            if b.category in ADDRESSABLE
        )

    def category_bytes(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for b in self.buffers:
            out[b.category] = out.get(b.category, 0.0) + b.total_bytes
        return {k: round(v, 1) for k, v in out.items()}

    def buffer_bytes(self) -> Dict[str, float]:
        return {b.name: round(b.total_bytes, 1) for b in self.buffers}

    def reconcile(
        self, measured_bytes: float, band: Optional[float] = None
    ) -> Dict[str, Any]:
        """Modeled addressable bytes vs the LIVE per-device sum (see
        measured_device_bytes). drift > band means a buffer the model
        does not know is resident (leak / retained snapshot); drift <
        -band means the model prices a buffer that does not exist
        (stale arithmetic). Pure — emit_drift_anomaly turns a bad
        verdict into the anomaly event."""
        band = DEFAULTS["drift_frac"] if band is None else float(band)
        modeled = self.addressable_bytes()
        drift = (float(measured_bytes) - modeled) / max(modeled, 1.0)
        return {
            "model": self.model,
            "family": self.family,
            "modeled_bytes": round(modeled, 1),
            "measured_bytes": round(float(measured_bytes), 1),
            "drift_frac": round(drift, 6),
            "band": band,
            "ok": abs(drift) <= band,
            "hbm_modeled_bytes": round(self.hbm_bytes(), 1),
        }

    def to_dict(self) -> Dict[str, Any]:
        return {
            "family": self.family,
            "model": self.model,
            "hbm_bytes": round(self.hbm_bytes(), 1),
            "addressable_bytes": round(self.addressable_bytes(), 1),
            "by_category": self.category_bytes(),
            "buffers": [b.to_fields() for b in self.buffers],
            "params": dict(self.params),
        }


@dataclasses.dataclass(frozen=True)
class HostStage:
    """One stage of the per-host RSS model (stages are sequential, so
    the host peak is the max stage, not the sum)."""

    stage: str
    bytes: float
    note: str = ""


@dataclasses.dataclass(frozen=True)
class HostModel:
    stages: Tuple[HostStage, ...]

    def peak_bytes(self) -> float:
        return max((s.bytes for s in self.stages), default=0.0)

    def dominant(self) -> Optional[HostStage]:
        if not self.stages:
            return None
        return max(self.stages, key=lambda s: s.bytes)

    def stage_bytes(self) -> Dict[str, float]:
        return {s.stage: round(s.bytes, 1) for s in self.stages}

    def to_dict(self) -> Dict[str, Any]:
        dom = self.dominant()
        return {
            "host_rss_bytes": round(self.peak_bytes(), 1),
            "dominant_stage": dom.stage if dom else None,
            "stages": [
                {"stage": s.stage, "bytes": round(s.bytes, 1),
                 **({"note": s.note} if s.note else {})}
                for s in self.stages
            ],
        }


# ----------------------------------------------------- state arithmetic
def scalar_state_bytes(llh_itemsize: int, num_candidates: int) -> float:
    """The scalars a TrainState carries on the first device: the 0-d LLH
    and the (S+1,) int32 accepted-step histogram (the iteration counter is
    a host int)."""
    return llh_itemsize + (num_candidates + 1) * 4


def dense_state_buffers(
    rows: int, k_pad: int, itemsize: int, num_candidates: int,
    sumf_copies: int = 1, scalars: bool = True,
) -> List[Buffer]:
    """Bytes of the dense TrainState on one device: `rows` rows of F (a
    whole F, or the shards of the mesh positions it holds), one sumF per
    distinct device, the scalars on the first device."""
    out = [
        Buffer("state/F", rows * k_pad * itemsize, "state"),
        Buffer("state/sumF", k_pad * itemsize, "state", count=sumf_copies),
    ]
    if scalars:
        out.append(Buffer(
            "state/scalars", scalar_state_bytes(itemsize, num_candidates),
            "state",
        ))
    return out


def sparse_state_buffers(
    rows: int, m: int, k_pad: int, itemsize: int, num_candidates: int,
    scalars: bool = True, counters: bool = False,
) -> List[Buffer]:
    """Bytes of the SparseTrainState on one device: `rows` rows of (M)
    weights and int32 member ids (the whole state, or the row shards of
    the mesh positions it holds), the (K,) sumF, the scalars on the first
    device (+ the sharded step's two int32 exchange counters)."""
    out = [
        Buffer("state/weights", rows * m * itemsize, "state"),
        Buffer("state/member_ids", rows * m * 4, "state"),
        Buffer("state/sumF", k_pad * itemsize, "state"),
    ]
    if scalars:
        out.append(Buffer(
            "state/scalars", scalar_state_bytes(itemsize, num_candidates),
            "state"))
    if scalars and counters:
        out.append(Buffer("state/comm_counters", 8, "state",
                          note="comm_ids, comm_dense"))
    return out


def _graph_buffers(graph_bytes: Dict[str, float]) -> List[Buffer]:
    return [
        Buffer(name, float(b), "graph")
        for name, b in sorted(graph_bytes.items())
    ]


def _total(buffers: Sequence[Buffer]) -> float:
    return sum(b.total_bytes for b in buffers)


def _scratch_buffers(state_bytes: float, rollback: bool,
                     health_on: bool) -> List[Buffer]:
    out = [Buffer(
        "scratch/initial_state", state_bytes, "scratch",
        note="the state a fit starts from, held by its callers through the "
             "fit (fit_state's frames; cli fit keeps it for its retries)",
    )]
    if rollback:
        out.append(Buffer(
            "scratch/rollback_snapshot", state_bytes, "scratch",
            note="cfg.rollback_budget: a device clone of the state "
                 "(run_fit_loop)",
        ))
    if health_on:
        out.append(Buffer(
            "scratch/health_pack", HEALTH_LEN * 4, "scratch",
            note="rides the state on cfg.health_every cadence steps only",
        ))
    return out


def collective_buffers(comms: Optional[CommsModel]) -> List[Buffer]:
    """The largest single-occurrence psum payload the step sums on the
    first device (priced from the comms Sites; the all-gather's and the
    ring's receive buffers are the transients named after them)."""
    if comms is None:
        return []
    best = None
    for s in comms.sites:
        if s.op == "psum" and s.participants > 1 and (
            best is None or s.payload_bytes > best.payload_bytes
        ):
            best = s
    if best is None:
        return []
    return [Buffer(
        "collective/psum_total", best.payload_bytes, "collective",
        note=f"the summed partial on the first device ({best.site})",
    )]


# ------------------------------------------------------- family builders
DENSE_PATHS = ("csr_fused", "csr", "csr_fused_kb", "csr_grouped_kb",
               "pallas_vmem", "xla")


def step_transients(
    path: str,
    rows: int,
    k_pad: int,
    itemsize: int,
    num_candidates: int,
    directed_edges: int,
    chunk: int,
    llh_itemsize: Optional[int] = None,
    positions: int = 1,
) -> List[Buffer]:
    """The temporaries of one dense step on kernel path `path` over `rows`
    rows of F (per mesh position; `positions` of them on the device, the
    steps of a mesh keep every position's F_new and gradient until the
    step ends):

    * every path: F_new and the gradient (n, K_pad), the node LLH;
    * `csr_fused`: kernel A writes both, and the (S, n) acceptance mask;
    * `csr`: the (S, n) candidate LLH of kernel C;
    * `csr_fused_kb` / `csr_grouped_kb`: the per-edge dots x (E,) and the
      candidate dots xc (S, E), 68 B an edge in float32, and the mask;
    * `pallas_vmem` / `xla`: the neighbour-gradient accumulator beside
      the gradient, the (S, n) candidate sums, and the plain sweeps'
      gathers of one edge chunk: about three (chunk, K_pad) arrays."""
    if path not in DENSE_PATHS:
        raise ValueError(f"unknown kernel path {path!r} (one of {DENSE_PATHS})")
    li = llh_itemsize or itemsize
    fk = rows * k_pad * itemsize
    s = num_candidates
    out = [
        Buffer("transient/F_new", fk, "transient", count=positions),
        Buffer("transient/grad", fk, "transient", count=positions),
        Buffer("transient/node_llh", rows * li, "transient", count=positions),
    ]
    if path in ("csr_fused", "csr_fused_kb", "csr_grouped_kb"):
        out.append(Buffer("transient/accept_mask", s * rows, "transient",
                          count=positions))
    if path == "csr":
        out.append(Buffer("transient/candidates", s * rows * itemsize,
                          "transient", count=positions,
                          note="(S, n) candidate LLH of kernel C"))
    if path in ("csr_fused_kb", "csr_grouped_kb"):
        out.append(Buffer(
            "transient/edge_x", directed_edges * itemsize, "transient",
            note="per-edge dots F_u.F_v over every K block",
        ))
        out.append(Buffer(
            "transient/edge_xc", s * directed_edges * itemsize, "transient",
            note="(S, E) candidate dots",
        ))
    if path in ("pallas_vmem", "xla"):
        out.append(Buffer("transient/grad_accumulator", fk, "transient",
                          count=positions,
                          note="neighbour sums before the -sumF + F fold"))
        out.append(Buffer("transient/candidates", s * rows * li,
                          "transient", count=positions))
        out.append(Buffer(
            "transient/edge_chunk", 3.0 * min(chunk, directed_edges)
            * k_pad * itemsize, "transient",
            note="the plain sweeps' (chunk, K) gathers of one edge chunk",
        ))
    return out


def dense_memory_model(
    n: int,
    k_pad: int,
    itemsize: int,
    num_candidates: int,
    graph_bytes: Dict[str, float],
    path: str,
    directed_edges: int,
    chunk: int = 1 << 20,
    health_on: bool = False,
    rollback: bool = False,
    llh_itemsize: Optional[int] = None,
    model: str = "BigClamModel",
) -> MemoryModel:
    """Single-device dense trainer (models.bigclam.BigClamModel) on kernel
    path `path`."""
    state = dense_state_buffers(n, k_pad, itemsize, num_candidates)
    buffers = (
        state
        + _graph_buffers(graph_bytes)
        + _scratch_buffers(_total(state), rollback, health_on)
        + step_transients(path, n, k_pad, itemsize, num_candidates,
                          directed_edges, chunk, llh_itemsize)
    )
    return MemoryModel(
        family="dense", model=model, buffers=tuple(buffers),
        params={"n_pad": n, "k_pad": k_pad, "itemsize": itemsize,
                "path": path, "rollback": rollback},
    )


def sparse_memory_model(
    n_pad: int,
    m: int,
    k_pad: int,
    itemsize: int,
    num_candidates: int,
    graph_bytes: Dict[str, float],
    directed_edges: int,
    chunk: int = 1 << 20,
    health_on: bool = False,
    rollback: bool = False,
    model: str = "SparseBigClamModel",
    dp: int = 1,
    positions: int = 1,
    first_device: bool = True,
    gathers: int = 0,
    comms: Optional[CommsModel] = None,
) -> MemoryModel:
    """Sparse top-M trainers (models.sparse, parallel.sparse_sharded), for
    one device holding `positions` of the dp mesh positions (1 on one
    device): state, gradient and candidates scale with M, not K.
    Transients per position: the new weights and the gradient (n_loc, M),
    the support update's new ids and weights, the (S, n_loc) candidate
    sums; and the member lookups of one edge chunk (ids and weights of
    both ends and the looked-up weights, (chunk, M) each). On a mesh the
    gathered (n_pad, M) id/weight pair, one per distinct device
    (`gathers`), is the dominant transient, the scalars and the exchange
    counters sit on the first device, and a psum total there is priced
    from the comms model. The exchange's (dp, K) combine buffers are not
    priced (under 1 MB at K = 8,385 and dp = 8)."""
    dp = max(int(dp), 1)
    n_loc = n_pad // dp
    state = sparse_state_buffers(positions * n_loc, m, k_pad, itemsize,
                                 num_candidates, scalars=first_device,
                                 counters=dp > 1)
    nm = n_loc * m
    ch = min(chunk, directed_edges)
    buffers = (
        state
        + _graph_buffers(graph_bytes)
        + _scratch_buffers(_total(state), rollback, health_on)
        + ([Buffer(
            "transient/members_allgather", n_pad * m * (4 + itemsize),
            "transient", count=gathers,
            note="the gathered member ids and weights, one per distinct "
                 "device",
        )] if gathers else [])
        + [
            Buffer("transient/weights_new", nm * itemsize, "transient",
                   count=positions),
            Buffer("transient/grad", nm * itemsize, "transient",
                   count=positions),
            Buffer("transient/support_update", nm * (4 + itemsize),
                   "transient", count=positions,
                   note="the admitted ids and weights"),
            Buffer("transient/candidates", num_candidates * n_loc * itemsize,
                   "transient", count=positions),
            Buffer("transient/member_chunk", ch * m * (3 * 4 + 2 * itemsize),
                   "transient",
                   note="one edge chunk's member-lookup gathers"),
        ]
        + (collective_buffers(comms) if first_device else [])
    )
    params = {"n_pad": n_pad, "m": m, "k_pad": k_pad,
              "itemsize": itemsize, "rollback": rollback}
    if dp > 1:
        params.update(dp=dp, positions=positions)
    return MemoryModel(
        family="sparse", model=model, buffers=tuple(buffers), params=params,
    )


def tp_tails_buffers(tp: int, n_loc: int, k_loc: int,
                     itemsize: int) -> List[Buffer]:
    """At tp > 1 the tails run in torch (parallel.sharded
    armijo_tail_select_tp), one column block after another: two
    (n_loc, K_loc) temporaries at a time (a candidate step's clamped row
    and its product with sumF - F + it), whatever the positions."""
    if tp <= 1:
        return []
    return [Buffer("transient/tp_tails", n_loc * k_loc * itemsize, "transient",
                   count=2, note="the torch tails' two block temporaries")]


def sharded_memory_model(
    n_pad: int,
    k_pad: int,
    dp: int,
    itemsize: int,
    num_candidates: int,
    graph_bytes: Dict[str, float],
    path: str,
    directed_edges: int,
    positions: int = 1,
    first_device: bool = True,
    gathers: int = 1,
    chunk: int = 1 << 20,
    health_on: bool = False,
    rollback: bool = False,
    comms: Optional[CommsModel] = None,
    model: str = "ShardedBigClamModel",
    tp: int = 1,
) -> MemoryModel:
    """All-gather trainer (parallel.sharded), for one device holding
    `positions` mesh positions (1 on distinct cards, dp tp on a repeated
    one) and, when `first_device`, the scalars: its blocks of F, one sumF,
    one gathered (n_pad, k_pad) column block per column block it holds
    (`gathers`: 0 only when the mesh has one node shard), and each
    position's step temporaries. `k_pad` is a position's columns (K_loc
    at tp > 1, whose steps run the TP split: the callers price them as
    `csr_grouped_kb`'s per-edge dots, and tp_tails_buffers adds the torch
    tails'). Graph bytes are the device's own shard CSRs (each shard keeps
    its own length)."""
    n_loc = n_pad // max(dp, 1)
    state = dense_state_buffers(positions * n_loc, k_pad, itemsize,
                                num_candidates, scalars=first_device)
    buffers = (
        state
        + _graph_buffers(graph_bytes)
        + _scratch_buffers(_total(state), rollback, health_on)
        + ([Buffer(
            "transient/F_allgather", n_pad * k_pad * itemsize, "transient",
            count=gathers,
            note="the gathered F, one per distinct device",
        )] if gathers else [])
        + step_transients(path, n_loc, k_pad, itemsize, num_candidates,
                          directed_edges, chunk, positions=positions)
        + tp_tails_buffers(tp, n_loc, k_pad, itemsize)
        + (collective_buffers(comms) if first_device else [])
    )
    return MemoryModel(
        family="sharded", model=model, buffers=tuple(buffers),
        params={"n_pad": n_pad, "k_pad": k_pad, "dp": dp, "tp": tp,
                "itemsize": itemsize, "positions": positions,
                "path": path, "rollback": rollback},
    )


def ring_memory_model(
    n_pad: int,
    k_pad: int,
    dp: int,
    itemsize: int,
    num_candidates: int,
    graph_bytes: Dict[str, float],
    positions: int = 1,
    first_device: bool = True,
    remote_successors: int = 0,
    overlap: bool = True,
    health_on: bool = False,
    rollback: bool = False,
    comms: Optional[CommsModel] = None,
    model: str = "RingBigClamModel",
    tp: int = 1,
    tp_split: bool = False,
    bucket_edges: int = 0,
) -> MemoryModel:
    """Ring trainer (parallel.ring), for one device holding `positions`
    mesh positions: its shards, one sumF, the scalars on the first
    device, its ring buckets (each of its own length, no padding), and per
    position the rotation's accumulators (neighbour gradient, gradient,
    (S, n_loc) candidate sums, F_new). The rotating shard is a copy only
    where a position's successor sits on another device
    (`remote_successors`), two with the overlapped hop in flight; on a
    repeated card it IS the other shard's F, and costs nothing. `k_pad`
    is a position's columns (K_loc at tp > 1). The TP split's phases
    (`tp_split`: the K-blocked paths, every path at tp > 1) add the
    largest bucket's per-edge dots x and candidate dots xc
    (`bucket_edges`)."""
    n_loc = n_pad // max(dp, 1)
    fk = n_loc * k_pad * itemsize
    state = dense_state_buffers(positions * n_loc, k_pad, itemsize,
                                num_candidates, scalars=first_device)
    copies = remote_successors * (2.0 if overlap else 1.0)
    buffers = (
        state
        + _graph_buffers(graph_bytes)
        + _scratch_buffers(_total(state), rollback, health_on)
        + ([Buffer(
            "transient/ring_rotation", fk, "transient", count=copies,
            note="received rotating shards"
                 + (" + the hop in flight (ring_overlap)" if overlap else ""),
        )] if copies else [])
        + [
            Buffer("transient/grad_accumulator", fk, "transient",
                   count=positions),
            Buffer("transient/grad", fk, "transient", count=positions),
            Buffer("transient/candidates",
                   num_candidates * n_loc * itemsize, "transient",
                   count=positions),
            Buffer("transient/F_new", fk, "transient", count=positions),
            Buffer("transient/node_llh", n_loc * itemsize, "transient",
                   count=positions),
        ]
        + ([
            Buffer("transient/edge_x", bucket_edges * itemsize, "transient",
                   note="a phase bucket's per-edge dots"),
            Buffer("transient/edge_xc", num_candidates * bucket_edges
                   * itemsize, "transient",
                   note="a phase bucket's (S, E) candidate dots"),
        ] if tp_split else [])
        + tp_tails_buffers(tp, n_loc, k_pad, itemsize)
        + (collective_buffers(comms) if first_device else [])
    )
    return MemoryModel(
        family="ring", model=model, buffers=tuple(buffers),
        params={"n_pad": n_pad, "k_pad": k_pad, "dp": dp, "tp": tp,
                "itemsize": itemsize, "positions": positions,
                "overlap": overlap, "rollback": rollback},
    )


def twod_memory_model(
    n_pad: int,
    k_pad: int,
    rows: int,
    cols: int,
    itemsize: int,
    num_candidates: int,
    graph_bytes: Dict[str, float],
    closure_cap: int = 1,
    health_on: bool = False,
    rollback: bool = False,
    comms: Optional[CommsModel] = None,
    model: str = "TwoDShardedBigClamModel",
    path: str = "xla_2d",
    grad_exchange: str = "dense",
    grad_cap: int = 0,
    positions: int = 1,
    first_device: bool = True,
    row_groups: int = 1,
    edges: int = 0,
    chunk: int = 1 << 20,
    llh_itemsize: Optional[int] = None,
) -> MemoryModel:
    """2D edge-block trainer (parallel.twod), for one device holding
    `positions` mesh positions of `row_groups` processor rows (1 and 1 on
    distinct cards): the O(N * K) gathered F of the 1D schedule is
    replaced by the row group's source rows (`transient/F_rowgather`, one
    a row group, C > 1) and each position's CAPPED closure table
    (`transient/closure_recv`, rows * cap rows), JAX's buffers.

    The step's transients, per position, in three phases that do not
    overlap (the model takes the largest; `transient/later_phase_excess`
    holds what a later phase adds over the first):

    * sweep and exchange: the closure table, the (C * n_blk, K) neighbour
      gradient (`transient/grad_row`) and the (S, C * n_blk) candidate
      sums; the K-blocked dots x (E,) of one edge block; the plain sweeps'
      chunk gathers; with the touched-rows exchange the routing buffers
      (JAX's formula) and the exchanged (n_row, K) result
      (`transient/grad_closure_exchange`) of the positions of one row
      group; a dense psum's total is the collective buffer;
    * the candidate sweep: the closure tables, the folded gradients (one
      a row group after a dense psum on one device, else one a position)
      and the K-blocked candidate dots xc (S, E);
    * the tails: the folded gradients and F_new.

    At C = 1 on the kernel paths a position runs kernel A (or the
    K-blocked windows and the node pass) as the 1D all-gather step does:
    its transients are step_transients' on `csr_fused` (`csr_fused_kb`),
    beside the closure tables."""
    p = max(rows * cols, 1)
    n_blk = n_pad // p
    n_row = cols * n_blk
    rb = float(k_pad * itemsize)
    s = num_candidates
    li = llh_itemsize or itemsize
    closure_grad = grad_exchange == "closure" and cols > 1
    state = dense_state_buffers(positions * n_blk, k_pad, itemsize, s,
                                scalars=first_device)
    if first_device and closure_grad:
        state.append(Buffer("state/comm_counters", 8, "state",
                            note="comm_ids, comm_dense"))
    closures = Buffer(
        "transient/closure_recv", rows * closure_cap * rb, "transient",
        count=positions,
        note="capped closure table (rows * cap dst rows) of each position",
    )
    gather = ([Buffer(
        "transient/F_rowgather", cols * n_blk * rb, "transient",
        count=row_groups,
        note="processor row's src rows — 1/rows of the 1D F_allgather",
    )] if cols > 1 else [])
    if cols == 1 and path != "xla_2d":
        steps = step_transients(
            "csr_fused_kb" if path == "csr_fused_2d_kb" else "csr_fused",
            n_blk, k_pad, itemsize, s, edges, chunk, positions=positions)
        transients = [closures] + steps
    else:
        per_group = max(positions // max(row_groups, 1), 1)
        first = [
            closures,
            Buffer("transient/grad_row", n_row * rb, "transient",
                   count=positions,
                   note="row-group gradient before the cols reduction"),
            Buffer("transient/nbr_llh", n_row * li, "transient",
                   count=positions),
        ]
        if closure_grad and grad_cap > 0:
            first.append(Buffer(
                "transient/grad_closure_exchange",
                cols * grad_cap * rb + n_blk * rb + n_row * rb,
                "transient", count=per_group,
                note="touched-rows grad exchange of one row group, per "
                     "position: the (cols, cap, K) staging of one phase "
                     "(JAX prices send and receive apart), the (n_blk, K) "
                     "phase-A accumulator and the (n_row, K) result",
            ))
        if path == "csr_fused_2d_kb":
            first.append(Buffer("transient/edge_x", edges * itemsize,
                                "transient",
                                note="one edge block's per-edge dots"))
        if path == "xla_2d":
            first.append(Buffer(
                "transient/edge_chunk", 3.0 * min(chunk, max(edges, 1)) * rb,
                "transient",
                note="the plain sweeps' (chunk, K) gathers of one edge chunk",
            ))
        phase_a = _total(first)
        folded = (positions if closure_grad or cols == 1 else row_groups) * n_row * rb
        cands = positions * s * n_row * li
        phase_b = closures.total_bytes + folded + cands + (
            s * edges * itemsize if path == "csr_fused_2d_kb" else 0.0)
        phase_c = folded + positions * (n_blk * rb + s * n_blk * li
                                        + 2 * n_blk * li)
        transients = first + [Buffer(
            "transient/later_phase_excess",
            max(0.0, phase_b - phase_a, phase_c - phase_a), "transient",
            note="what the candidate sweep (folded gradients, candidate "
                 "sums, xc) or the tails (F_new) hold beyond the first phase",
        )]
    buffers = (
        state
        + _graph_buffers(graph_bytes)
        + _scratch_buffers(_total(state), rollback, health_on)
        + gather
        + transients
        + (collective_buffers(comms) if first_device else [])
    )
    return MemoryModel(
        family="twod", model=model, buffers=tuple(buffers),
        params={"n_pad": n_pad, "k_pad": k_pad, "rows": rows, "cols": cols,
                "itemsize": itemsize, "closure_cap": closure_cap,
                "path": path, "grad_exchange": grad_exchange,
                "grad_cap": grad_cap, "positions": positions,
                "rollback": rollback},
    )


# -------------------------------------------------------- host RSS model
def ingest_rss_bytes(
    chunk_bytes: int, n: int, directed_edges: int, num_shards: int
) -> float:
    """The ingest pipeline's explicit RSS budget — the SAME formula
    scripts/ingest_bench.py gates INGEST_r07 against (12 B of tokenizer
    transients per chunk byte + 6x the largest scatter bucket + 4x the
    int64 raw-id table + a 96 MiB allocator floor), now also a model
    stage instead of only a gate constant."""
    bucket_bytes = 16 * directed_edges // max(num_shards, 1)
    idtable_bytes = 8 * n
    return float(
        12 * chunk_bytes + 6 * bucket_bytes + 4 * idtable_bytes
        + (96 << 20)
    )


def f0_init_rss_bytes(n: int, k: int, n_pad: int, k_pad: int,
                      itemsize: int) -> float:
    """The host-global O(N*K) F0 init: the float64 (N, K) init array
    (seeding / random_init_F), the padded float64 staging copy
    (init_state), and the dtype cast handed to the device upload. THE
    dominant host term on the in-memory trainers — the store-native
    trainers now default to the PER-HOST row-keyed counter init
    (ISSUE 15 satellite, ROADMAP 1a closed there:
    rowkeyed_f0_rss_bytes), and only an explicit host-global F0 upload
    (conductance seeding) still pays this."""
    return float(n * k * 8 + n_pad * k_pad * (8 + itemsize))


def rowkeyed_f0_rss_bytes(n_pad: int, k_pad: int, itemsize: int,
                          processes: int) -> float:
    """The PER-HOST row-keyed counter init (ISSUE 15 satellite /
    ROADMAP 1a): each host materializes only its own padded row range —
    the float64 local block (rowkeyed_init_rows + zero staging) plus
    the dtype cast handed to make_array_from_process_local_data. The
    uint64 counter lattice is freed before the cast, so it shares the
    same budget term."""
    rows_local = n_pad / max(processes, 1)
    return float(rows_local * k_pad * (8 + itemsize))


def host_rss_model(
    n: int,
    directed_edges: int,
    k: int,
    itemsize: int,
    n_pad: int = 0,
    k_pad: int = 0,
    store_native: bool = False,
    processes: int = 1,
    num_shards: int = 1,
    chunk_bytes: int = 0,
    representation: str = "dense",
    sparse_m: int = 0,
    rowkeyed_f0: Optional[bool] = None,
) -> HostModel:
    """Per-stage host-RSS model of a fit entry (per HOST, not per
    device). Stages are sequential; the peak is the max stage.

    `rowkeyed_f0` (default: follows store_native) prices the `f0_init`
    stage at the PER-HOST row-keyed counter init the store-backed
    trainers now default to (ISSUE 15 satellite — O(N_loc*K); the
    dominant flag then moves to the arg-max remaining stage, typically
    `extract`, which stays host-global). With it False the stage is the
    host-global O(N*K) upload (the in-memory trainers, and store-native
    runs seeded from an explicit host-global F0 — conductance seeding's
    init_F is still a host-global array, the open remainder of
    ROADMAP 1a)."""
    n_pad = n_pad or n
    k_pad = k_pad or k
    p = max(processes, 1)
    stages: List[HostStage] = []
    if chunk_bytes:
        stages.append(HostStage(
            "ingest",
            ingest_rss_bytes(chunk_bytes, n, directed_edges, num_shards),
            note="chunk + scatter bucket + id table (the INGEST_r07 "
                 "budget); O(chunk), never O(file)",
        ))
    if store_native:
        stages.append(HostStage(
            "shard_load",
            (directed_edges / p) * 12.0 + 8.0 * (n / p + num_shards),
            note="this host's shard slice + local edge-block build "
                 "(O(shard) — no global CSR)",
        ))
    else:
        # full Graph on the host: indices (2E int32) + indptr int64 +
        # the materialized src/dst directed-edge views the edge
        # builders read (int32 each)
        stages.append(HostStage(
            "graph_load",
            directed_edges * 12.0 + 8.0 * (n + 1),
            note="global CSR + src/dst edge views (host-global)",
        ))
    stages.append(HostStage(
        "seeding", 24.0 * n,
        note="conductance phi/degree/order arrays (O(N))",
    ))
    if rowkeyed_f0 is None:
        rowkeyed_f0 = store_native
    if representation == "sparse" and sparse_m:
        f0 = float(n * k * 8 + n_pad * sparse_m * (8 + itemsize + 4))
        note = (
            "dense (N, K) float64 F0 sparsified to top-M host-side — "
            "the dense staging is still O(N*K) (ROADMAP 1a)"
        )
    elif rowkeyed_f0:
        f0 = rowkeyed_f0_rss_bytes(n_pad, k_pad, itemsize, p)
        note = (
            "per-host row-keyed counter F0 init (ISSUE 15: O(N_loc*K), "
            "ROADMAP 1a closed on the store-native path; an explicit "
            "host-global F0 — conductance seeding — re-opens it)"
        )
    else:
        f0 = f0_init_rss_bytes(n, k, n_pad, k_pad, itemsize)
        note = (
            "host-global O(N*K) F0 init + padded staging — the "
            "dominant host term (ROADMAP 1a: closed for store-native "
            "random inits via the per-host row-keyed counter init; "
            "this in-memory/explicit-F0 path still pays it)"
        )
    stages.append(HostStage("f0_init", f0, note=note))
    stages.append(HostStage(
        "extract", n * k * (8.0 + itemsize),
        note="fetched (N, K) F + float64 staging at extract_F",
    ))
    return HostModel(stages=tuple(stages))


# --------------------------------------------------------- reconciliation
def _tensors(obj) -> list:
    """The tensors in obj (a tensor, None, or nested tuples/lists/dicts
    of them)."""
    if obj is None:
        return []
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        out = []
        for x in obj:
            out.extend(_tensors(x))
        return out
    if hasattr(obj, "untyped_storage"):
        return [obj]
    return []


def _storages(objs, seen: set):
    """(device, bytes) of each storage of the tensors in objs not yet in
    `seen` (which it updates): a tensor, its views and a shard read by
    several positions share one storage."""
    for t in _tensors(objs):
        st = t.untyped_storage()
        key = (str(t.device), st.data_ptr(), st.nbytes())
        if key not in seen:
            seen.add(key)
            yield str(t.device), float(st.nbytes())


def measured_device_bytes(objs: Sequence[Any]) -> float:
    """Exact bytes of the given live tensors on the busiest device: the
    storage bytes of every distinct storage, grouped by device, MAX over
    devices (the capacity figure)."""
    per_dev: Dict[str, float] = {}
    for dev, b in _storages(list(objs), set()):
        per_dev[dev] = per_dev.get(dev, 0.0) + b
    return max(per_dev.values()) if per_dev else 0.0


def bytes_by_name(arrays: Dict[str, Any]) -> Dict[str, float]:
    """{name: storage bytes} of a model's named tensors (a name may hold a
    tensor, None, or nested tuples/lists of tensors), each storage counted
    once, under the first name that holds it; names holding none are left
    out."""
    seen: set = set()
    out: Dict[str, float] = {}
    for name, obj in arrays.items():
        total = sum(b for _, b in _storages(obj, seen))
        if total:
            out[name] = total
    return out


# ------------------------------------------------------------- emission
def emit_model(
    mm: MemoryModel, host: Optional[HostModel] = None
) -> None:
    """One `memory_model` event per device buffer (+ one per host stage
    when a host model rides along). The FIRST device event of the batch
    carries reset_model=True — a re-emitted model (quality mode /
    rollback rebuilds, the sparse cap refinement) REPLACES its previous
    buffer set in every consumer, exactly the obs.comms contract. No-op
    with telemetry off."""
    from bigclam_tpu_torch.obs import telemetry as _obs

    tel = _obs.current()
    if tel is None:
        return
    for i, b in enumerate(mm.buffers):
        tel.event(
            "memory_model", model=mm.model, family=mm.family,
            scope="device", reset_model=1 if i == 0 else 0,
            **b.to_fields(),
        )
    if host is not None:
        dom = host.dominant()
        for j, st in enumerate(host.stages):
            fields: Dict[str, Any] = {
                "model": mm.model,
                "family": mm.family,
                "scope": "host",
                "reset_model": 1 if j == 0 else 0,
                "buffer": f"host/{st.stage}",
                "stage": st.stage,
                "bytes": round(st.bytes, 1),
                "category": "host",
            }
            if st.note:
                fields["note"] = st.note
            if dom is not None and st.stage == dom.stage:
                fields["dominant"] = 1
            tel.event("memory_model", **fields)


def emit_drift_anomaly(recon: Dict[str, Any]) -> None:
    """A failed reconciliation as a first-class anomaly event
    (check="memory_drift", build/probe-time: iter=-1): the live
    addressable bytes disagree with the model past the band — a leaked
    or retained buffer (positive drift) or stale model arithmetic
    (negative). No-op with telemetry off."""
    from bigclam_tpu_torch.obs import telemetry as _obs

    tel = _obs.current()
    if tel is None:
        return
    tel.event(
        "anomaly", check="memory_drift", iter=-1,
        model=recon.get("model"),
        modeled_bytes=recon.get("modeled_bytes"),
        measured_bytes=recon.get("measured_bytes"),
        drift_frac=recon.get("drift_frac"),
        band=recon.get("band"),
        hint="retained/leaked device buffer (positive drift) or stale "
             "model arithmetic (negative)",
    )


def _round_up(x: int, m: int) -> int:
    m = max(int(m), 1)
    return ((int(x) + m - 1) // m) * m


# ------------------------------------------------------------- preflight
# the port's kernel geometry (ops.csr_kernels.MAX_K, models.bigclam
# CSR_K_MULTIPLE, k_block_plan and mesh_k_plan; pinned equal by the tests):
# kept here so the preflight imports no torch
MAX_K = 1024
CSR_K_MULTIPLE = 32


def k_block_plan(k: int, csr_k_block: int = 0) -> Tuple[int, int]:
    """(kc, k_pad) of the CSR paths (models.bigclam.k_block_plan)."""
    k32 = _round_up(k, CSR_K_MULTIPLE)
    if csr_k_block > 0:
        return csr_k_block, _round_up(k32, csr_k_block)
    if k32 <= MAX_K:
        return 0, k32
    n_kb = -(-k32 // MAX_K)
    kc = _round_up(-(-k32 // n_kb), CSR_K_MULTIPLE)
    return kc, n_kb * kc


def mesh_k_plan(k: int, tp: int, csr_k_block: int = 0) -> Tuple[int, int]:
    """(kc, k_pad) of a mesh with the kernels (models.bigclam.mesh_k_plan):
    K pads to a multiple of 32 tp, and each block's K_loc takes
    k_block_plan's windows."""
    k_loc = _round_up(k, CSR_K_MULTIPLE * tp) // tp
    kc, k_loc = k_block_plan(k_loc, csr_k_block)
    return kc, k_loc * tp


def edge_chunk_bound(edge_chunk: int, cols: int, itemsize: int) -> int:
    """The plain sweeps' edge chunk (ops.objective.edge_chunk_bound)."""
    return min(max(edge_chunk, 1), max((1 << 30) // max(cols * itemsize, 1),
                                       1024))


def csr_graph_bytes(rows: int, edges: int, rev: bool = False) -> Dict[str, float]:
    """The DeviceCSR of `rows` rows and `edges` directed edges: int64
    indptr, int32 indices, int64 src and dst (+ the int32 reverse-edge
    index of the K-blocked paths)."""
    out = {
        "graph/csr_indptr": 8.0 * (rows + 1),
        "graph/csr_indices": 4.0 * edges,
        "graph/csr_src": 8.0 * edges,
        "graph/csr_dst": 8.0 * edges,
    }
    if rev:
        out["graph/csr_rev"] = 4.0 * edges
    return out


def preflight(
    n: int,
    directed_edges: int,
    k: int,
    dp: int = 1,
    tp: int = 1,
    itemsize: int = 4,
    num_candidates: int = 16,
    representation: str = "dense",
    sparse_m: int = 64,
    support_every: int = 1,
    schedule: str = "allgather",
    health_every: int = 10,
    rollback: bool = True,
    edge_chunk: int = 1 << 20,
    shard_edge_counts: Optional[Sequence[int]] = None,
    device_hbm_bytes: float = 0.0,
    host_ram_bytes: float = 0.0,
    processes: int = 1,
    chunk_bytes: int = 0,
    csr_k_block: int = 0,
    store_native: bool = False,
    partition: str = "1d",
    replica_cols: int = 1,
    closure_pair_counts: Optional[Sequence[Sequence[int]]] = None,
) -> Dict[str, Any]:
    """The capacity verdict of `cli preflight` for the port's paths: the
    memory and comms models the trainer would bake, from workload numbers
    alone, for a target of dp distinct cards (one mesh position each) on
    the path the card takes by default: `csr_fused` (`csr_fused_kb`
    above K = 1,024) on one card and on the all-gather mesh, the ring's
    `csr_ring_fused`, `sparse_merge_pallas`. Returns the JAX preflight's
    keys: the component breakdown, a fits-or-doesn't verdict naming the
    binding constraint, and the knobs that relax it. Raises ValueError
    naming why for what no trainer runs (a sparse mesh with tp > 1 or
    the ring schedule). On a mesh K pads to a multiple of 32 tp and each
    block's K_loc takes its own K blocks (`mesh_k_plan`): the K-blocked
    paths where K_loc exceeds a warp's row, the TP split at tp > 1. A
    sparse (dp, 1) mesh is priced as the JAX preflight prices it: a cap of
    8 M member rows, the sparse exchange below half of K
    (`sparse_merge_pallas_spall`), else the psum (`_psum`).

    partition="2d" prices the 2D edge-block trainer on a (dp / C, C) grid
    of distinct cards (C = replica_cols) on the path a card takes,
    `csr_fused_2d` (`csr_fused_2d_kb` above K = 1,024) with the
    touched-rows grad exchange at C > 1, as the JAX preflight prices its
    combined config: the closure cap and the grad cap from the cache's
    baked closure pair counts when given (exact upper bounds), else the
    coupon-collector estimate on a uniform random graph. A 1d verdict that
    does not fit on four or more cards names `--partition 2d
    --replica-cols C`, C the cheapest grid by the baked pair counts when
    given, else the square-root heuristic."""
    from bigclam_tpu_torch.obs import comms as _comms

    dp, tp = max(int(dp), 1), max(int(tp), 1)
    sparse = representation == "sparse"
    partition = str(partition or "1d")
    cols2 = max(int(replica_cols), 1)
    if partition not in ("1d", "2d"):
        raise ValueError(f"unknown partition {partition!r} (1d or 2d)")
    if partition == "2d":
        if sparse:
            raise ValueError(
                "partition=2d runs the dense-F closure-gather schedule; the "
                "sparse representation shards members over the 1d node axis "
                "— price --representation sparse on the 1d mesh"
            )
        if schedule == "ring":
            raise ValueError(
                "partition=2d is its own closure-gather schedule — "
                "drop --schedule ring"
            )
        if tp != 1:
            raise ValueError(
                "partition=2d requires tp == 1 (the k axis rides the "
                "2d mesh unsharded)"
            )
        if dp % cols2:
            raise ValueError(
                f"replica_cols={cols2} does not divide the {dp}-chip "
                "mesh"
            )
    if sparse and tp > 1:
        raise ValueError(
            "the sparse representation does not shard the K axis "
            f"(mesh has tp={tp}): member rows are M-wide regardless of K "
            "— use a (dp, 1) mesh"
        )
    if sparse and dp > 1 and schedule == "ring":
        raise ValueError(
            "--schedule ring is not supported with --representation sparse "
            "(the sparse exchange is an M-column all_gather + sparse "
            "allreduce)"
        )
    if schedule not in ("allgather", "ring"):
        raise ValueError(f"unknown schedule {schedule!r}")
    notes: List[str] = []
    m = max(1, min(int(sparse_m), int(k))) if sparse else 0
    if sparse:
        kc, k_pad, path = 0, int(k), "sparse_merge_pallas"
    else:
        mesh = dp > 1 or tp > 1
        if mesh:
            kc, k_pad = mesh_k_plan(int(k), tp, csr_k_block)
        else:
            kc, k_pad = k_block_plan(int(k), csr_k_block)
        path = "csr_fused_kb" if kc else "csr_fused"
        if mesh and schedule == "ring":
            path = "csr_ring_fused_kb" if kc else "csr_ring_fused"
    mesh = dp > 1 or tp > 1
    n_pad = _round_up(max(n, dp), dp) if mesh else int(n)
    if shard_edge_counts:
        max_shard = max(int(c) for c in shard_edge_counts)
        counts_known = True
    else:
        max_shard = int(math.ceil(directed_edges / dp * (1.15 if dp > 1
                                                         else 1.0)))
        counts_known = False
        if dp > 1:
            notes.append(
                "per-shard edge counts estimated (uniform split +15%)"
            )
    health_on = int(health_every or 0) > 0
    comms = None
    if partition == "2d":
        rows2 = dp // cols2
        kc, k_pad = mesh_k_plan(int(k), 1, csr_k_block)
        path = "csr_fused_2d_kb" if kc else "csr_fused_2d"
        n_pad = _round_up(max(n, dp), dp)
        n_blk = n_pad // dp
        pairs = (closure_pair_counts if closure_pair_counts
                 and len(closure_pair_counts) == dp else None)
        cap2 = _closure_cap(pairs, rows2, cols2, n_blk, directed_edges)
        gx2 = "closure" if cols2 > 1 else "dense"
        gcap2 = 0
        if cols2 > 1:
            if pairs:
                gcap2 = max(n_blk if int(c) < 0 else min(int(c), n_blk)
                            for row in pairs for c in row)
            else:
                gcap2 = _touched_estimate(directed_edges / max(dp * cols2, 1),
                                          n_blk)
            gcap2 = max(min(gcap2, n_blk), 1)
        if not pairs:
            notes.append(
                "closure rows estimated (coupon-collector, uniform random "
                "graph) — bake closures (`cli ingest`) and pass the cache "
                "for exact pair counts"
            )
        n_row = cols2 * n_blk
        graph = {
            "graph/edge_block_indptr": 8.0 * (n_row + 1),
            "graph/edge_block_indices": 4.0 * max_shard,
            "graph/edge_block_src": 8.0 * max_shard,
            "graph/edge_block_dst": 8.0 * max_shard,
            "graph/closure_send_idx": 8.0 * rows2 * cap2,
        }
        if cols2 > 1:
            graph["graph/grad_tables"] = 16.0 * cols2 * gcap2 + 4.0
        comms = _comms.twod_step_model(
            n_pad, k_pad, rows2, cols2, itemsize, num_candidates,
            closure_cap=cap2, grad_exchange=gx2, grad_cap=gcap2, fused=True,
        ) if dp > 1 else None
        mm = twod_memory_model(
            n_pad, k_pad, rows2, cols2, itemsize, num_candidates, graph,
            closure_cap=cap2, health_on=health_on, rollback=rollback,
            comms=comms, path=path, grad_exchange=gx2, grad_cap=gcap2,
            edges=max_shard,
            chunk=edge_chunk_bound(edge_chunk, k_pad, itemsize),
        )
        notes.append(
            f"2d priced at the combined config: kernel_path {path} (the "
            "closure table feeds the kernels' destination rows) + "
            f"grad_exchange={gx2}"
            + (f" (cap {gcap2} touched rows/peer)" if cols2 > 1 else "")
        )
    elif sparse:
        block_rows = 1024
        n_pad = _round_up(max(n, dp), 8 * dp)
        n_loc = n_pad // dp
        graph = csr_graph_bytes(n_loc if dp > 1 else n, max_shard)
        graph["graph/support_blocks"] = (
            max_shard * 1.1 * (8.0 + itemsize)
        )
        notes.append(
            f"support blocks priced at +10% block padding (block_b <= "
            f"{block_rows})"
        )
        if dp > 1:
            # the JAX preflight's cap guess: 8 member rows' worth of ids
            cap = min(_round_up(max(8 * m, 8), 8), k_pad)
            mode = "sparse" if cap < 0.5 * k_pad else "dense"
            path += "_spall" if mode == "sparse" else "_psum"
            comms = _comms.sparse_step_model(
                n_pad, m, k_pad, dp, itemsize, num_candidates, cap, mode,
                support_every=support_every,
            )
        mm = sparse_memory_model(
            n_pad, m, k_pad, itemsize, num_candidates, graph, max_shard,
            chunk=edge_chunk_bound(edge_chunk, m, itemsize),
            health_on=health_on, rollback=rollback,
            model="SparseShardedBigClamModel" if dp > 1
            else "SparseBigClamModel",
            dp=dp, gathers=1 if dp > 1 else 0, comms=comms,
        )
    elif not mesh:
        graph = csr_graph_bytes(n, directed_edges, rev=bool(kc))
        mm = dense_memory_model(
            n, k_pad, itemsize, num_candidates, graph, path, directed_edges,
            chunk=edge_chunk_bound(edge_chunk, k_pad, itemsize),
            health_on=health_on, rollback=rollback,
        )
    else:
        n_loc = n_pad // dp
        k_loc = k_pad // tp
        split = tp > 1 or bool(kc)
        if schedule == "ring":
            max_bucket = int(math.ceil(max_shard / dp))
            graph = {
                "graph/ring_buckets": dp * (8.0 * (n_loc + 1)
                                            + 4.0 * n_loc)
                + 20.0 * max_bucket * dp,
            }
            comms = _comms.ring_step_model(n_pad, k_pad, dp, itemsize,
                                           num_candidates, tp=tp,
                                           edges=directed_edges)
            mm = ring_memory_model(
                n_pad, k_loc, dp, itemsize, num_candidates, graph,
                remote_successors=1 if dp > 1 else 0, health_on=health_on,
                rollback=rollback, comms=comms, tp=tp, tp_split=split,
                bucket_edges=max_bucket,
            )
            notes.append(
                "ring buckets priced at the balanced distribution"
            )
        else:
            graph = csr_graph_bytes(n_loc, max_shard)
            comms = _comms.sharded_step_model(n_pad, k_pad, dp, itemsize,
                                              num_candidates, tp=tp,
                                              edges=directed_edges)
            mm = sharded_memory_model(
                n_pad, k_loc, dp, itemsize, num_candidates, graph,
                "csr_grouped_kb" if tp > 1 else path, max_shard, health_on=health_on, rollback=rollback,
                comms=comms, gathers=1 if dp > 1 else 0, tp=tp,
            )

    host = host_rss_model(
        n, directed_edges, k, itemsize, n_pad=n_pad, k_pad=k_pad,
        store_native=store_native, processes=processes,
        num_shards=max(dp, 1), chunk_bytes=chunk_bytes,
        representation=representation, sparse_m=m,
    )

    # --- verdict: which constraint binds? ---
    hbm = mm.hbm_bytes()
    host_peak = host.peak_bytes()
    hbm_budget = float(device_hbm_bytes) * (1.0 - HBM_HEADROOM_FRAC) \
        if device_hbm_bytes else 0.0
    fits_hbm = not hbm_budget or hbm <= hbm_budget
    fits_host = not host_ram_bytes or host_peak <= float(host_ram_bytes)
    fits = fits_hbm and fits_host
    binding = None
    if not fits_hbm and not fits_host:
        binding = (
            "hbm"
            if hbm / max(hbm_budget, 1.0)
            >= host_peak / max(float(host_ram_bytes), 1.0)
            else "host_rss"
        )
    elif not fits_hbm:
        binding = "hbm"
    elif not fits_host:
        binding = "host_rss"

    # --- the knobs that relax the binding constraint ---
    knobs: List[str] = []
    cat = mm.category_bytes()
    if not fits_hbm:
        if not sparse and (k_pad * itemsize) > 256:
            m_hint = max(min(64, k // 4), 1)
            knobs.append(
                f"--representation sparse --sparse-m {m_hint}: state, "
                "gradient and candidates scale with M, not K "
                f"(state {_fmt_bytes(cat.get('state', 0))} -> "
                f"~{_fmt_bytes(n * m_hint * (4 + itemsize))} ids+weights)"
            )
        if not sparse and dp < 64:
            knobs.append(
                f"--mesh {dp * 2},{tp}: per-device state, graph and step "
                "temporaries shrink ~1/dp (the gathered F does not)"
            )
        if not sparse and tp < 64:
            knobs.append(
                f"--mesh {dp},{tp * 2}: every per-device F-sized buffer, the "
                "gathered F included, shrinks ~1/tp (psums of the per-edge "
                "dots over k added)"
            )
        if not sparse and dp > 1 and schedule != "ring":
            knobs.append(
                "--schedule ring: two rotating shards replace the full "
                "per-device F gather "
                f"({_fmt_bytes(mm.buffer_bytes().get('transient/F_allgather', 0))})"
            )
        if partition == "1d" and dp * tp >= 4:
            knobs.append(_replica_cols_knob(
                n, k_pad, dp * tp, itemsize, num_candidates, sparse, m,
                closure_pair_counts, mm))
        if kc:
            notes.append(
                f"K={k} runs the K-blocked kernels (kc {kc}, k_pad "
                f"{k_pad}, K_loc {k_pad // tp})"
            )
    if not fits_host:
        dom = host.dominant()
        knobs.append(
            "the binding host stage is "
            + (dom.stage if dom is not None else "?")
            + (": --store-native (a shard file per mesh position) drops the "
               "host-global graph" if not store_native and dp > 1 else
               ": no port knob relaxes it")
        )

    return {
        "workload": {
            "n": int(n),
            "directed_edges": int(directed_edges),
            "k": int(k),
            "representation": representation,
            **({"sparse_m": m} if sparse else {}),
            "mesh": f"{dp}x{tp}",
            "partition": partition,
            **({"replica_cols": cols2, "grad_exchange": gx2}
               if partition == "2d" else {}),
            "kernel_path": path,
            "k_pad": int(k_pad),
            "schedule": schedule,
            "store_native": bool(store_native),
            "itemsize": itemsize,
            "shard_counts_known": counts_known,
        },
        "device": mm.to_dict(),
        "host": host.to_dict(),
        "comms_bytes_per_step": (
            round(comms.bytes_per_step(), 1) if comms is not None else 0.0
        ),
        "hbm_bytes_per_device": round(hbm, 1),
        "hbm_budget_bytes": round(hbm_budget, 1),
        "host_rss_bytes": round(host_peak, 1),
        "host_ram_bytes": round(float(host_ram_bytes), 1),
        "fits": fits,
        "fits_hbm": fits_hbm,
        "fits_host": fits_host,
        "binding": binding,
        "knobs": knobs,
        "notes": notes,
    }


def _touched_estimate(edges_per_pair: float, n_blk: int) -> int:
    """Rows of an n_blk block that edges_per_pair uniform random edges
    touch (the coupon-collector estimate of the JAX preflight)."""
    return int(math.ceil(n_blk * (1.0 - math.exp(-edges_per_pair
                                                 / max(n_blk, 1)))))


def _closure_cap(pairs, rows: int, cols: int, n_blk: int,
                 directed_edges: int) -> int:
    """The closure cap of a (rows, cols) grid: from the baked pair counts
    (store shard s -> block b; the row group's summed counts, -1 an
    overflowed pair, clamped to n_blk), else the coupon-collector
    estimate."""
    if not pairs:
        cap = _touched_estimate(directed_edges / max(rows * rows * cols, 1),
                                n_blk)
        return max(min(cap, n_blk), 1)
    cap = 0
    for i in range(rows):
        for b in range(rows * cols):
            tot, over = 0, False
            for s in range(i * cols, (i + 1) * cols):
                c = int(pairs[s][b])
                if c < 0:
                    over = True
                    break
                tot += c
            cap = max(cap, n_blk if over else min(tot, n_blk))
    return max(min(cap, n_blk), 1)


def _replica_cols_knob(n: int, k_pad: int, p: int, itemsize: int,
                       num_candidates: int, sparse: bool, m: int, pairs,
                       mm: "MemoryModel") -> str:
    """The `--partition 2d --replica-cols C` knob of a 1d verdict that
    does not fit (JAX preflight's): C the cheapest grid by the closure
    exchange priced from the baked pair counts when given, else the
    largest divisor of p up to its square root."""
    from bigclam_tpu_torch.obs import comms as _comms

    c_hint = int(math.isqrt(p))
    while c_hint > 1 and p % c_hint:
        c_hint -= 1
    c_src = "sqrt heuristic"
    if pairs and len(pairs) == p:
        n_blk = _round_up(max(n, p), p) // p
        row_b = m * (4.0 + itemsize) if sparse else float(k_pad * itemsize)
        best = None
        for c_try in range(1, p):
            if p % c_try:
                continue
            r_try = p // c_try
            cap_t = _closure_cap(pairs, r_try, c_try, n_blk, 0)
            closure = c_try > 1 and not sparse
            bps = _comms.twod_step_model(
                n_blk * p, m if sparse else k_pad, r_try, c_try, itemsize,
                num_candidates, closure_cap=cap_t, row_bytes=row_b,
                grad_exchange="closure" if closure else "dense",
                grad_cap=cap_t if closure else 0, fused=not sparse,
            ).bytes_per_step()
            if best is None or bps < best[1]:
                best = (c_try, bps)
        if best is not None:
            c_hint = best[0]
            c_src = "cheapest grid by baked closure pair counts"
    gname = "transient/members_allgather" if sparse else "transient/F_allgather"
    gb = mm.buffer_bytes().get(gname, 0)
    return (
        f"--partition 2d --replica-cols {c_hint} (mesh {p},1; {c_src}): the "
        f"O(N) {'member' if sparse else 'F'} gather ({_fmt_bytes(gb)}) shrinks "
        "to the processor row's 1/rows slice plus the capped closure exchange"
    )


def _fmt_bytes(v: float) -> str:
    # the shared obs byte formatter (obs.report)
    from bigclam_tpu_torch.obs.report import _fmt_bytes as fmt

    return fmt(v)


def render_preflight(p: Dict[str, Any]) -> str:
    """Human rendering of a preflight() verdict (`cli preflight`)."""
    w = p["workload"]
    lines = [
        f"preflight: N={w['n']}  2E={w['directed_edges']}  K={w['k']}"
        f"  {w['representation']}"
        + (f" M={w['sparse_m']}" if w.get("sparse_m") else "")
        + f"  mesh {w['mesh']}  schedule {w['schedule']}"
        + ("  store-native" if w["store_native"] else "")
        + (
            f"  partition 2d(cols={w.get('replica_cols', 1)})"
            f" {w.get('kernel_path', '')}"
            f" grad_exchange={w.get('grad_exchange', '')}"
            if w.get("partition") == "2d"
            else ""
        ),
        "",
        f"per-device HBM (modeled): {_fmt_bytes(p['hbm_bytes_per_device'])}"
        + (
            f"  vs budget {_fmt_bytes(p['hbm_budget_bytes'])}"
            f" ({'fits' if p['fits_hbm'] else 'DOES NOT FIT'})"
            if p["hbm_budget_bytes"]
            else "  (no device budget given: --device-kind or --hbm-gb)"
        ),
    ]
    for cat, b in sorted(
        p["device"]["by_category"].items(), key=lambda kv: -kv[1]
    ):
        lines.append(f"  {cat:<12} {_fmt_bytes(b):>12}")
    top = sorted(
        p["device"]["buffers"], key=lambda b: -b["bytes"]
    )[:6]
    for b in top:
        lines.append(
            f"    {b['buffer']:<28} {_fmt_bytes(b['bytes']):>12}"
        )
    lines.append("")
    lines.append(
        f"per-host RSS (modeled peak): {_fmt_bytes(p['host_rss_bytes'])}"
        + (
            f"  vs {_fmt_bytes(p['host_ram_bytes'])}"
            f" ({'fits' if p['fits_host'] else 'DOES NOT FIT'})"
            if p["host_ram_bytes"]
            else ""
        )
    )
    dom = p["host"].get("dominant_stage")
    for s in p["host"]["stages"]:
        mark = "  <- dominant" if s["stage"] == dom else ""
        lines.append(
            f"  {s['stage']:<12} {_fmt_bytes(s['bytes']):>12}{mark}"
        )
    if p["comms_bytes_per_step"]:
        lines.append("")
        lines.append(
            "collective traffic (modeled): "
            f"{_fmt_bytes(p['comms_bytes_per_step'])}/step"
        )
    lines.append("")
    verdict = "FITS" if p["fits"] else (
        f"DOES NOT FIT (binding: {p['binding']})"
    )
    lines.append(f"verdict: {verdict}")
    for knob in p["knobs"]:
        lines.append(f"  knob: {knob}")
    for note in p["notes"]:
        lines.append(f"  note: {note}")
    return "\n".join(lines)


def serve_preflight(
    n: int,
    directed_edges: int,
    k: int,
    shards: int = 1,
    replicas: int = 1,
    representation: str = "dense",
    sparse_m: int = 64,
    itemsize: int = 4,
    cache_slots: int = 64,
    avg_memberships: float = 2.0,
    qps_target: float = 0.0,
    qps_per_replica: float = 9000.0,
    host_ram_bytes: float = 0.0,
) -> Dict[str, Any]:
    """The serving-fleet capacity verdict (`cli preflight --serve`, a
    copy of the JAX package's host pricing): price one replica of one
    shard —
    snapshot rows (sparse-aware: M member slots per row, never a
    densified N*K block), the load-time inverted index, the hot-community
    cache, and the suggest adjacency slice — then the fleet total
    (shards × replicas), against a per-replica RAM budget and a
    `--qps-target`. The QPS capacity baseline (`qps_per_replica`)
    defaults to the JAX package's figure (kept so both verdicts agree;
    it is not a measurement of the port); pass a replica measurement
    for a calibrated verdict."""
    shards = max(int(shards), 1)
    replicas = max(int(replicas), 1)
    sparse = representation == "sparse"
    m = max(1, min(int(sparse_m), int(k))) if sparse else 0
    rows = -(-int(n) // shards)                      # ceil rows/shard
    # --- one shard's snapshot archive, loaded ---
    if sparse:
        row_bytes = m * (4.0 + itemsize)             # ids(i32) + w
    else:
        row_bytes = float(k) * itemsize              # dense F row
    snapshot = rows * (row_bytes + 8.0) + float(k) * itemsize
    # rows + raw_ids(i64) + the global sumF vector every shard carries
    # --- the load-time inverted index (community -> member raw ids) ---
    pairs = rows * max(float(avg_memberships), 0.0)
    index = pairs * 8.0 + (k + 1) * 8.0 + rows * 8.0
    # comm_members(i64) + comm_indptr + the sorted raw-id row map
    # --- the Zipf-aware hot-community cache (resident member lists) ---
    avg_members = (n * max(float(avg_memberships), 0.0)) / max(k, 1)
    cache = min(int(cache_slots), int(k)) * avg_members * 8.0
    # --- the suggest adjacency slice (CSR over the shard's rows) ---
    adjacency = (rows + 1) * 8.0 + (directed_edges / shards) * 4.0
    per_replica = snapshot + index + cache + adjacency
    fleet_total = per_replica * shards * replicas
    # --- throughput: node-routed families hit ONE shard, so shards
    # multiply capacity; members_of fans out to every shard, so its
    # capacity is replicas × the per-replica figure alone ---
    qps_capacity = shards * replicas * float(qps_per_replica)
    qps_members = replicas * float(qps_per_replica)
    fits_ram = (
        per_replica <= float(host_ram_bytes) if host_ram_bytes else True
    )
    fits_qps = (
        qps_capacity >= float(qps_target) if qps_target else True
    )
    fits = fits_ram and fits_qps
    binding = None if fits else ("host_ram" if not fits_ram else "qps")
    knobs: List[str] = []
    if not fits_ram:
        if not sparse:
            knobs.append(
                f"--representation sparse --sparse-m {min(64, k)}: "
                f"snapshot rows shrink ~K/M "
                f"({_fmt_bytes(rows * row_bytes)} -> "
                f"{_fmt_bytes(rows * min(64, k) * (4.0 + itemsize))} "
                "per replica)"
            )
        knobs.append(
            f"--serve-shards {shards * 2}: per-replica snapshot bytes "
            "halve (rows/shard halve)"
        )
        if cache_slots > 8:
            knobs.append(
                f"--cache-slots {max(cache_slots // 4, 8)}: resident "
                f"member lists drop {_fmt_bytes(cache)} -> "
                f"{_fmt_bytes(max(cache_slots // 4, 8) * avg_members * 8.0)}"
            )
    if not fits_qps:
        need = -(-int(qps_target) // max(int(shards * qps_per_replica), 1))
        knobs.append(
            f"--serve-replicas {max(need, replicas + 1)}: QPS capacity "
            "scales linearly with replicas"
        )
    notes = [
        "avg memberships/node estimated at "
        f"{avg_memberships:g} (index + cache sizing); pass "
        "--avg-memberships from a fitted health pack for exact figures",
        "interpreter + numpy baseline RSS excluded (model covers the "
        "snapshot-dependent bytes only)",
        f"members_of scatter-gathers every shard: its capacity is "
        f"{qps_members:,.0f} qps (replicas x per-replica), not the "
        "node-routed figure",
    ]
    return {
        "workload": {
            "n": int(n),
            "directed_edges": int(directed_edges),
            "k": int(k),
            "representation": representation,
            **({"sparse_m": m} if sparse else {}),
            "serve_shards": shards,
            "serve_replicas": replicas,
            "cache_slots": int(cache_slots),
            "itemsize": itemsize,
        },
        "per_replica": {
            "snapshot_bytes": round(snapshot, 1),
            "index_bytes": round(index, 1),
            "cache_bytes": round(cache, 1),
            "adjacency_bytes": round(adjacency, 1),
            "total_bytes": round(per_replica, 1),
        },
        "fleet_total_bytes": round(fleet_total, 1),
        "qps_capacity": round(qps_capacity, 1),
        "qps_capacity_members": round(qps_members, 1),
        "qps_target": float(qps_target),
        "host_ram_bytes": round(float(host_ram_bytes), 1),
        "fits": fits,
        "fits_ram": fits_ram,
        "fits_qps": fits_qps,
        "binding": binding,
        "knobs": knobs,
        "notes": notes,
    }


def render_serve_preflight(p: Dict[str, Any]) -> str:
    """Human rendering of a serve_preflight() verdict."""
    w = p["workload"]
    r = p["per_replica"]
    lines = [
        f"serve preflight: N={w['n']}  2E={w['directed_edges']}"
        f"  K={w['k']}  {w['representation']}"
        + (f" M={w['sparse_m']}" if w.get("sparse_m") else "")
        + f"  fleet {w['serve_shards']} shard(s) x "
        f"{w['serve_replicas']} replica(s)",
        "",
        f"per-replica RSS (modeled): {_fmt_bytes(r['total_bytes'])}"
        + (
            f"  vs {_fmt_bytes(p['host_ram_bytes'])}"
            f" ({'fits' if p['fits_ram'] else 'DOES NOT FIT'})"
            if p["host_ram_bytes"]
            else ""
        ),
    ]
    for key, label in (
        ("snapshot_bytes", "snapshot"),
        ("index_bytes", "inverted index"),
        ("adjacency_bytes", "adjacency"),
        ("cache_bytes", "hot cache"),
    ):
        lines.append(f"  {label:<16} {_fmt_bytes(r[key]):>12}")
    lines.append(
        f"fleet total ({w['serve_shards']}x{w['serve_replicas']}): "
        f"{_fmt_bytes(p['fleet_total_bytes'])}"
    )
    lines.append("")
    lines.append(
        f"QPS capacity (node-routed): {p['qps_capacity']:,.0f}"
        + (
            f"  vs target {p['qps_target']:,.0f}"
            f" ({'fits' if p['fits_qps'] else 'DOES NOT FIT'})"
            if p["qps_target"]
            else "  (no --qps-target given)"
        )
    )
    lines.append("")
    verdict = "FITS" if p["fits"] else (
        f"DOES NOT FIT (binding: {p['binding']})"
    )
    lines.append(f"verdict: {verdict}")
    for knob in p["knobs"]:
        lines.append(f"  knob: {knob}")
    for note in p["notes"]:
        lines.append(f"  note: {note}")
    return "\n".join(lines)
