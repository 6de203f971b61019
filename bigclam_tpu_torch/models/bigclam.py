"""The BigCLAM model on a torch device: state, train step, fit loop.

Port of the dense single-device core of bigclam_tpu/models/bigclam.py.
One outer iteration is

    grad/LLH pass  ->  16-candidate Armijo pass  ->  masked Jacobi update

on one of six kernel paths, named as in the JAX package:

* `csr_fused`      — one launch of the fused superstep kernel per
  iteration (ops.fused; the default wherever the CSR kernels engage and
  K fits one warp's row, round_up(K, 32) <= 1024);
* `csr`            — the split pair: the gradient kernel, then the
  candidate kernel, then the selection in torch (ops.csr_kernels);
* `csr_fused_kb`   — large K: the K-blocked edge terms over windows of
  kc <= 1024 columns (ops.kblocked; the -sumF + F fold in the gradient
  kernel), then the node pass (neighbour candidate sums, node tail, Armijo
  tails and selection in one kernel, `cand_select_from_x`). Taken by
  itself above K = 1024, or for any K with cfg.csr_k_block > 0;
* `csr_grouped_kb` — its split twin (csr_fused=False): the same four
  kernels with the fold done in torch;
* `pallas_vmem`    — the non-CSR step: the plain torch grad/LLH sweep, then
  the candidate pass with its edge terms from the CUDA kernel
  csrc/candidate_edge_terms.cu (ops.edge_kernels), one launch per edge
  chunk, then the Armijo tails and selection in one kernel
  (ops.linesearch.armijo_update_kernel);
* `xla`            — the plain torch edge sweeps (ops.objective /
  ops.linesearch), chunked over edges.

Auto mode (cfg.use_pallas_csr=None) engages the CSR kernels on `cuda` and
resolves to `xla` on `cpu`; use_pallas_csr=True on `cpu` runs the CSR
paths on the kernels' plain versions. Where the CSR kernels do not engage,
`pick_candidates_impl` chooses between `pallas_vmem` and `xla` by the
same rule on cfg.use_pallas. The LLH each step reports is the
LLH of its INPUT F, so the fit loop stops with the previous state when
the relative LLH change falls below conv_tol.

The CUDA kernels read the graph's CSR directly, so rows are never padded
(n_pad == N). K is padded to a multiple of 32 on the CSR paths (warp-wide
rows), and on the K-blocked paths further to a whole number of K blocks
(`k_block_plan`); padding columns stay zero only with min_f == 0, which is
checked.
"""

from __future__ import annotations

import dataclasses
import inspect
import math
import os
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.ops import diagnostics as dx
from bigclam_tpu_torch.ops.csr_kernels import (
    MAX_K,
    KernelKLimitError,
    candidates_csr,
    grad_llh_csr,
    kernel_supports,
)
from bigclam_tpu_torch.ops.edge_kernels import (
    CandidateKernelError,
    candidates_pass_kernel,
    with_runs,
)
from bigclam_tpu_torch.ops.fused import fused_superstep
from bigclam_tpu_torch.ops.kblocked import cand_select_from_x, kblocked_terms, with_rev
from bigclam_tpu_torch.ops.linesearch import (
    accept_stats,
    armijo_select,
    armijo_update,
    armijo_update_kernel,
    candidates_pass,
)
from bigclam_tpu_torch.ops.objective import (
    EdgeChunks,
    accum_dtype,
    edge_chunk_bound,
    grad_llh,
)
from bigclam_tpu_torch.utils.device import resolve_device, resolve_dtype
from bigclam_tpu_torch.utils.dist import is_primary

# CSR-path K padding: whole 32-column warp steps per row
CSR_K_MULTIPLE = 32


class TrainState(NamedTuple):
    F: torch.Tensor            # (N, K_pad)
    sumF: torch.Tensor         # (K_pad,)
    llh: torch.Tensor          # scalar: LLH of the PREVIOUS F
    it: int                    # iteration counter
    # (S+1,) int32 accepted-step histogram of the update that produced
    # this state (ops.linesearch.accept_stats); zeros at init
    accept_hist: torch.Tensor
    # (ops.diagnostics.HEALTH_LEN,) float32 health pack of the update that
    # produced this state, on cfg.health_every cadence iterations; None
    # otherwise and always with health off
    health: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class FitResult:
    F: np.ndarray       # (N, K) — un-padded
    sumF: np.ndarray    # (K,)
    llh: float
    num_iters: int
    llh_history: tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def csr_want_reason(cfg: BigClamConfig, device: torch.device) -> tuple[bool, str]:
    """Should the CSR kernels engage? Auto = on for cuda devices; the
    reason says why not when they do not."""
    want = cfg.use_pallas_csr
    if want is None:
        want = device.type == "cuda"
    if want:
        return True, ""
    if cfg.use_pallas_csr is False:
        return False, "use_pallas_csr=False"
    return False, f"auto: device {device.type!r} is not cuda"


def pick_candidates_impl(
    cfg: BigClamConfig, device: torch.device, dtype: torch.dtype
) -> tuple[str, str]:
    """The candidate pass of the non-CSR step: (path, reason), path
    `pallas_vmem` (ops.edge_kernels.candidates_pass_kernel) or `xla`
    (ops.linesearch.candidates_pass); reason says why not `pallas_vmem`.

    The rule of bigclam_tpu/models/bigclam.py `pick_candidates_impl`:
    cfg.use_pallas None = on for cuda devices, True = require (on the CPU
    the kernel's plain version runs, in any dtype), False = `xla`. On cuda
    the kernel takes what `kernel_supports` allows; anything else is
    refused with CandidateKernelError, in auto mode too: the plain `xla`
    step runs on the card only when use_pallas=False asks for it."""
    want = cfg.use_pallas
    if want is None:
        want = device.type == "cuda"
    if not want:
        if cfg.use_pallas is False:
            return "xla", "use_pallas=False"
        return "xla", f"auto: device {device.type!r} is not cuda"
    if device.type == "cuda":
        reason = kernel_supports(cfg, dtype)
        if reason:
            raise CandidateKernelError(
                f"use_pallas={cfg.use_pallas}: the candidate edge-terms kernel "
                f"cannot run: {reason}; use_pallas=False selects the plain "
                "`xla` step"
            )
    return "pallas_vmem", ""


def csr_fused_want(cfg: BigClamConfig) -> bool:
    """The fused superstep engages wherever the CSR kernels do, unless
    csr_fused=False asks for the split pair."""
    return cfg.csr_fused is not False


def k_block_plan(num_communities: int, csr_k_block: int = 0) -> tuple[int, int]:
    """(kc, k_pad) of the CSR paths: kc columns per K block (0: one pass
    over whole rows) and the padded K.

    csr_k_block > 0 forces K blocks of that width (the JAX package's test
    hook, bigclam_tpu/models/bigclam.py:1328-1331): k_pad =
    round_up(round_up(K, 32), kc). Otherwise rows of round_up(K, 32) <=
    MAX_K columns take the single-pass kernels, and wider ones the fewest
    blocks of at most MAX_K columns, each a multiple of 32: K = 3,000
    gives (1024, 3072), K = 1,100 gives (576, 1152)."""
    k32 = _round_up(num_communities, CSR_K_MULTIPLE)
    if csr_k_block > 0:
        return csr_k_block, _round_up(k32, csr_k_block)
    if k32 <= MAX_K:
        return 0, k32
    n_kb = -(-k32 // MAX_K)
    kc = _round_up(-(-k32 // n_kb), CSR_K_MULTIPLE)
    return kc, n_kb * kc


def mesh_k_plan(num_communities: int, tp: int, kernels: bool,
                csr_k_block: int = 0) -> tuple:
    """(kc, k_pad) of a (dp, tp) mesh: with the kernels K pads to a multiple
    of 32 tp, so each block's K_loc is a whole number of warp steps, and
    k_block_plan then cuts K_loc into windows (kc > 0: the
    K-blocked paths; 0: one window of K_loc, a warp's row at most where
    tp = 1 takes the single-pass kernels). The JAX package pads to 128 tp
    for the TPU's lanes. Without the kernels K pads to a multiple of tp."""
    if not kernels:
        return 0, _round_up(num_communities, tp)
    k_loc = _round_up(num_communities, CSR_K_MULTIPLE * tp) // tp
    kc, k_loc = k_block_plan(k_loc, csr_k_block)
    return kc, k_loc * tp


def check_k_block(kc: int, device: torch.device) -> None:
    """The CUDA kernels take windows of at most MAX_K columns; only an
    explicit csr_k_block can ask for more (the CPU plain versions take any
    width)."""
    if device.type == "cuda" and kc > MAX_K:
        raise KernelKLimitError(
            f"csr_k_block={kc} exceeds the K-blocked CUDA kernels' window of "
            f"{MAX_K} columns; leave csr_k_block at 0 and the model picks "
            "the K blocks itself (csr_fused_kb above K = 1024)"
        )


# --- host initializers (copied bit-identically from the JAX package) -----


def random_init_F(g, cfg: BigClamConfig, seed: Optional[int] = None) -> np.ndarray:
    """Bernoulli(0.5) {0,1} init, the reference's random-row distribution."""
    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    return rng.integers(
        0, 2, size=(g.num_nodes, cfg.num_communities)
    ).astype(np.float64)


# row-keyed counter RNG: splitmix64 finalizer constants
_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_M1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_M2 = np.uint64(0x94D049BB133111EB)
_ROW_MIX = np.uint64(0xA24BAED4963EE407)


def _splitmix64_vec(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over a uint64 array (wrapping)."""
    z = x + _SM_GAMMA
    z = (z ^ (z >> np.uint64(30))) * _SM_M1
    z = (z ^ (z >> np.uint64(27))) * _SM_M2
    return z ^ (z >> np.uint64(31))


def rowkeyed_init_rows(lo: int, hi: int, k: int, seed: int) -> np.ndarray:
    """Bernoulli(0.5) {0,1} float64 rows [lo, hi) of the row-keyed counter
    init: entry (r, c) is a pure function of (seed, r, c)."""
    if hi <= lo:
        return np.empty((0, k), dtype=np.float64)
    base = _splitmix64_vec(np.asarray(seed, dtype=np.uint64).reshape(1))
    rows = np.arange(lo, hi, dtype=np.uint64)[:, None]
    cols = np.arange(k, dtype=np.uint64)[None, :]
    z = _splitmix64_vec((rows * _ROW_MIX + cols) ^ base)
    return ((z >> np.uint64(63)) & np.uint64(1)).astype(np.float64)


def rowkeyed_init_F(g, cfg: BigClamConfig, seed: Optional[int] = None) -> np.ndarray:
    """Host-global (N, K) row-keyed init."""
    return rowkeyed_init_rows(
        0, g.num_nodes, cfg.num_communities,
        cfg.seed if seed is None else seed,
    )


# --- train step and fit loop ---------------------------------------------


def _rel_change(new: float, old: float) -> float:
    """|1 - new/old|, with old == 0.0 converged iff new is also 0."""
    if old == 0.0:
        return 0.0 if new == 0.0 else float("inf")
    return abs(1.0 - new / old)


def make_train_step(
    csr, edges: EdgeChunks, cfg: BigClamConfig, path: str, kc: int = 0
) -> Callable[[TrainState], TrainState]:
    """The one-iteration update on kernel path `path` (kc: the K block of
    the K-blocked paths)."""
    cand_impl = candidates_pass_kernel if path == "pallas_vmem" else candidates_pass
    select_impl = armijo_update_kernel if path == "pallas_vmem" else armijo_update

    def health(state, F_new, sumF_new, grad, hist):
        # the health pack on cadence iterations (ops.diagnostics); None
        # otherwise, with no work
        return dx.health_pack(cfg, state.it, state.F, F_new, sumF_new, hist,
                              grad=grad)

    def fused_step(state: TrainState) -> TrainState:
        F = state.F
        F_new, grad, node_llh, ok = fused_superstep(F, state.sumF, csr, cfg)
        llh = node_llh.to(accum_dtype(cfg, F)).sum()
        sumF_new, hist = F_new.sum(dim=0), accept_stats(ok)
        return TrainState(
            F=F_new, sumF=sumF_new, llh=llh.to(F.dtype),
            it=state.it + 1, accept_hist=hist,
            health=health(state, F_new, sumF_new, grad, hist),
        )

    def split_step(state: TrainState) -> TrainState:
        F, sumF = state.F, state.sumF
        grad, node_llh = grad_llh_csr(F, sumF, csr, cfg)
        cand = candidates_csr(F, grad, sumF, csr, cfg)
        F_new, sumF_new, hist = armijo_select(
            F, grad, node_llh, cand, cfg, with_stats=True
        )
        return TrainState(
            F=F_new, sumF=sumF_new, llh=node_llh.sum(), it=state.it + 1,
            accept_hist=hist,
            health=health(state, F_new, sumF_new, grad, hist),
        )

    def xla_step(state: TrainState) -> TrainState:
        F, sumF = state.F, state.sumF
        grad, node_llh = grad_llh(F, sumF, edges, cfg)
        cand_nbr = cand_impl(F, grad, edges, cfg)
        F_new, sumF_new, hist = select_impl(
            F, sumF, grad, node_llh, cand_nbr, cfg, with_stats=True
        )
        return TrainState(
            F=F_new, sumF=sumF_new, llh=node_llh.sum(), it=state.it + 1,
            accept_hist=hist,
            health=health(state, F_new, sumF_new, grad, hist),
        )

    def kblocked_step(state: TrainState) -> TrainState:
        # large K: the edge terms from the K-blocked kernels, then the node
        # pass (neighbour candidate sums, node tail, Armijo tails and
        # selection in one kernel); the column sums and the histogram in
        # torch, as in fused_step
        F, sumF = state.F, state.sumF
        grad, llh_nbr, xc = kblocked_terms(
            F, sumF, csr, cfg, kc, fold=path == "csr_fused_kb"
        )
        F_new, node_llh, ok = cand_select_from_x(xc, F, sumF, grad, llh_nbr, csr, cfg)
        sumF_new, hist = F_new.sum(dim=0), accept_stats(ok)
        return TrainState(
            F=F_new, sumF=sumF_new, llh=node_llh.sum(), it=state.it + 1,
            accept_hist=hist,
            health=health(state, F_new, sumF_new, grad, hist),
        )

    steps = {
        "csr_fused": fused_step, "csr": split_step,
        "csr_fused_kb": kblocked_step, "csr_grouped_kb": kblocked_step,
        "pallas_vmem": xla_step, "xla": xla_step,
    }
    return steps[path]


def clone_state(state):
    """A device copy of a train state (tensors cloned, tuples of shards
    and NamedTuples rebuilt, ints and None kept): the rollback snapshot,
    never a reference to a tensor a later step could write."""
    if isinstance(state, torch.Tensor):
        return state.clone()
    if isinstance(state, tuple):
        parts = [clone_state(x) for x in state]
        return type(state)(*parts) if hasattr(state, "_fields") else tuple(parts)
    return state


def refresh_state(twin, state):
    """`state` copied INTO `twin`'s tensors where the shapes agree
    (Tensor.copy_: the same buffers, refreshed on the device), else into
    fresh clones; returns the refreshed twin."""
    if isinstance(state, torch.Tensor):
        if (isinstance(twin, torch.Tensor) and twin.shape == state.shape
                and twin.dtype == state.dtype and twin.device == state.device):
            return twin.copy_(state)
        return state.clone()
    if isinstance(state, tuple):
        twins = twin if isinstance(twin, tuple) and len(twin) == len(state) else (
            (None,) * len(state))
        parts = [refresh_state(t, x) for t, x in zip(twins, state)]
        return type(state)(*parts) if hasattr(state, "_fields") else tuple(parts)
    return state


def poison_entry(F, i: int, j: int):
    """A copy of F (a tensor, or a tuple of row shards) with entry (i, j)
    set to NaN — the nan_inject fault. The caller may still hold F, so F
    itself is never written."""
    if isinstance(F, torch.Tensor):
        out = F.clone()
        out[i, j] = float("nan")
        return out
    shards = list(F)
    if isinstance(shards[0], tuple):        # rows of column blocks (tp > 1)
        rows, cols = shards[0][0].shape
        s, r = divmod(int(i), rows)
        c, jj = divmod(int(j), cols)
        blocks = list(shards[s])
        blocks[c] = blocks[c].clone()
        blocks[c][r, jj] = float("nan")
        shards[s] = tuple(blocks)
        return tuple(shards)
    rows = shards[0].shape[0]
    s, r = divmod(int(i), rows)
    shards[s] = shards[s].clone()
    shards[s][r, j] = float("nan")
    return tuple(shards)


def _callback_arity(callback) -> int:
    """3 when the callback takes the extras dict, else 2 (the JAX rule:
    only parameters that can take a positional argument count; *args
    accepts the extras)."""
    if callback is None:
        return 0
    try:
        params = inspect.signature(callback).parameters.values()
    except (TypeError, ValueError):
        return 2
    if any(p.kind == inspect.Parameter.VAR_POSITIONAL for p in params):
        return 3
    return sum(
        p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                   inspect.Parameter.POSITIONAL_OR_KEYWORD)
        for p in params
    )


def run_fit_loop(
    step_fn: Callable[[TrainState], TrainState],
    state: TrainState,
    cfg: BigClamConfig,
    callback: Optional[Callable[[int, float], None]] = None,
    extract_F: Optional[Callable[[TrainState], np.ndarray]] = None,
    checkpoints=None,
    state_to_arrays: Optional[Callable[[TrainState], dict]] = None,
    initial_hist: tuple = (),
    ckpt_meta: Optional[dict] = None,
    rebuild_step: Optional[Callable[[float], Callable]] = None,
    health_sig: Optional[Callable] = None,
    health_n: Optional[int] = None,
):
    """Convergence loop, shared by every trainer (port of
    bigclam_tpu/models/bigclam.py `run_fit_loop`).

    The step that takes F_t reports LLH(F_t) and eagerly produces F_{t+1};
    when |1 - LLH(F_t)/LLH(F_{t-1})| < conv_tol the loop stops and returns
    F_t — the speculative F_{t+1} is discarded. It also stops after the
    step that evaluated iteration max_iters.

    CHECKPOINTS: with a utils.checkpoint.CheckpointManager, the state is
    saved every cfg.checkpoint_every iterations (the state whose LLH the
    next step evaluates, never the final speculative one), with the LLH
    history in the sidecar meta (`llh_history`, read by both packages);
    `initial_hist` carries a restored history so the convergence test
    continues seamlessly on resume.

    CALLBACKS taking a third parameter also receive {"accept_hist": [...]}
    of the update applied this iteration; 2-parameter callbacks keep the
    (it, llh) protocol.

    With extract_F=None the loop runs STATE-RESIDENT: it returns
    (final_state, final_llh, num_iters, llh_history) and never fetches F;
    otherwise a FitResult with extract_F(final_state).

    NON-FINITE LLH: with cfg.rollback_budget > 0 the loop keeps a device
    snapshot of the last VERIFIED-finite state (a clone, refreshed in
    place by copy_ every cfg.rollback_snapshot_every iterations; never a
    host round trip). A non-finite LLH emits a `rollback` event, restores
    a copy of the snapshot (truncating the LLH history to the snapshot
    point, so the replayed iterations compare against the same
    predecessors), cuts the Armijo ladder by cfg.rollback_shrink through
    `rebuild_step(scale)` (the trainer's _ScaleRebuilder) and continues.
    After cfg.rollback_budget rollbacks, or with no rollback allowed, it
    aborts through _abort_nonfinite: diagnostics to the telemetry, then
    FloatingPointError. The fault harness is consulted once per iteration
    at site "fit.step" (kill / delay / nan_inject, the last applied to a
    clone of F).

    OBSERVABILITY (bigclam_tpu_torch.obs): each iteration beats the stall
    heartbeat of the installed RunTelemetry, and its phases run under
    emit=False spans (fit_loop/dispatch, /sync, /callback, plus
    fit_loop/checkpoint per save and fit_loop/extract_F). On CUDA the
    dispatch only enqueues the step; the host blocks in /sync, reading the
    LLH, so /sync is device time plus waits plus the read back. With
    cfg.health_every > 0 and telemetry on, a HealthMonitor turns the
    steps' health packs into `health` and `anomaly` events. Telemetry
    off costs one None check per iteration.
    """
    from bigclam_tpu_torch.obs import telemetry as _obs
    from bigclam_tpu_torch.obs import trace as _trace
    from bigclam_tpu_torch.resilience import faults as _faults

    tel = _obs.current()
    monitor = None
    if tel is not None and dx.health_on(cfg):
        from bigclam_tpu_torch.obs.health import HealthMonitor

        monitor = HealthMonitor(cfg, tel, sig_fn=health_sig, n_live=health_n)
    _span = _trace.span
    cb_arity = _callback_arity(callback)
    hist: list[float] = list(initial_hist)
    # --- rollback state (see docstring) ---
    budget = max(int(cfg.rollback_budget), 0)
    snap_every = max(int(cfg.rollback_snapshot_every), 1)
    snapshot = None          # last verified-finite state (device clone)
    snap_hist_len = len(hist)
    fallback = state if budget else None    # pre-first-snapshot target
    rollbacks = 0
    since_snap = 0
    scale = float(cfg.step_scale)
    while True:
        fault = _faults.maybe_fire("fit.step", it=int(state.it))
        if fault is not None and fault.get("kind") == "nan_inject":
            i0, j0 = fault.get("index", (0, 0))
            state = state._replace(F=poison_entry(state.F, int(i0), int(j0)))
        with _span("fit_loop/dispatch", emit=False):
            new_state = step_fn(state)
        with _span("fit_loop/sync", emit=False):
            llh_t = float(new_state.llh)       # host sync: LLH of state.F
        if not math.isfinite(llh_t):
            target = snapshot if snapshot is not None else fallback
            if rollbacks >= budget or target is None:
                _abort_nonfinite(state, new_state, llh_t, hist, rollbacks)
            rollbacks += 1
            scale *= float(cfg.rollback_shrink or 1.0)
            if tel is not None:
                tel.event(
                    "rollback", iter=int(state.it), llh=llh_t,
                    rollbacks=rollbacks, resume_iter=int(target.it),
                    step_scale=scale,
                )
            # restore a COPY: the target stays intact for later rollbacks
            state = clone_state(target)
            del hist[(snap_hist_len if snapshot is not None
                      else len(initial_hist)):]
            since_snap = 0
            if rebuild_step is not None and scale != 1.0:
                step_fn = rebuild_step(scale)
            continue
        if budget and (snapshot is None or since_snap >= snap_every):
            # state.F is VERIFIED finite (llh_t is its LLH)
            snapshot = (refresh_state(snapshot, state) if snapshot is not None
                        else clone_state(state))
            snap_hist_len = len(hist)
            since_snap = 0
            fallback = None      # the snapshot supersedes the initial state
        since_snap += 1
        if tel is not None:
            tel.step_beat(int(state.it), llh_t)
        if monitor is not None:
            monitor.maybe_observe(int(state.it), llh_t, new_state)
        if callback is not None:
            with _span("fit_loop/callback", emit=False):
                if cb_arity >= 3:
                    ah = new_state.accept_hist
                    extras = ({"accept_hist": ah.cpu().tolist()}
                              if ah is not None else None)
                    callback(int(state.it), llh_t, extras)
                else:
                    callback(int(state.it), llh_t)
        if hist and _rel_change(llh_t, hist[-1]) < cfg.conv_tol:
            hist.append(llh_t)
            break
        hist.append(llh_t)
        if int(state.it) >= cfg.max_iters:
            break
        state = new_state
        if (
            checkpoints is not None
            and cfg.checkpoint_every > 0
            and int(state.it) % cfg.checkpoint_every == 0
            and int(state.it) <= cfg.max_iters   # never persist the final
            and state_to_arrays is not None      # speculative (unevaluated) F
        ):
            # state_to_arrays may be a COLLECTIVE (fetch_global all-gathers
            # across ranks), so every rank enters it; only the file write
            # is single-writer (utils.dist)
            with _span("fit_loop/checkpoint", it=int(state.it)):
                arrays = state_to_arrays(state)
                if is_primary():
                    checkpoints.save(
                        int(state.it), arrays,
                        meta={"llh_history": hist, **(ckpt_meta or {})},
                    )
                if tel is not None:
                    tel.event("checkpoint", step=int(state.it))
    if extract_F is None:
        return state, llh_t, int(state.it), tuple(hist)
    with _span("fit_loop/extract_F"):
        F = extract_F(state)
    return FitResult(
        F=F, sumF=F.sum(axis=0), llh=llh_t, num_iters=int(state.it),
        llh_history=tuple(hist),
    )


def _state_tensors(F) -> list:
    from bigclam_tpu_torch.parallel.mesh import row_shards

    return row_shards(F)


def _abort_nonfinite(state, new_state, llh_t: float, hist, rollbacks: int = 0):
    """Non-finite-LLH sentinel: diagnose, dump, abort (port of
    bigclam_tpu/models/bigclam.py `_abort_nonfinite`). A NaN/inf LLH means
    the state is already poisoned and the convergence test can never fire
    on NaN. The diagnostics are device reductions over F (all its shards),
    emitted as a `nonfinite` telemetry event and dumped to
    <telemetry>/nonfinite_dump.npz before FloatingPointError. With
    rollback enabled this is the ESCALATION path — `rollbacks` says how
    many recovery attempts were already burned."""
    from bigclam_tpu_torch.obs import telemetry as _obs

    Fs, sums = _state_tensors(state.F), _state_tensors(state.sumF)
    diag = {
        "iter": int(state.it),
        "llh": llh_t,
        "rollbacks": rollbacks,
        "f_nonfinite": int(sum(f.numel() - int(torch.isfinite(f).sum()) for f in Fs)),
        "f_min": min(float(torch.amin(f)) for f in Fs),
        "f_max": max(float(torch.amax(f)) for f in Fs),
        "sumF_min": float(torch.amin(sums[0])),
        "sumF_max": float(torch.amax(sums[0])),
        "llh_tail": [float(v) for v in hist[-5:]],
    }
    ah = new_state.accept_hist
    diag["accept_hist"] = ah.cpu().tolist() if ah is not None else None
    tel = _obs.current()
    dump = ""
    if tel is not None:
        tel.event("nonfinite", **diag)
        dump = os.path.join(tel.directory, "nonfinite_dump.npz")
        if is_primary():
            np.savez(dump, **{k: np.asarray(v) for k, v in diag.items()
                              if v is not None})
        tel.finalize()           # the report must exist even on abort
    raise FloatingPointError(
        f"non-finite LLH {llh_t} at iteration {diag['iter']}: "
        f"{diag['f_nonfinite']} non-finite F entries, "
        f"F range [{diag['f_min']:.3g}, {diag['f_max']:.3g}], "
        f"accept_hist={diag['accept_hist']}"
        + (f"; rollback budget exhausted after {rollbacks} rollback(s)"
           if rollbacks else "")
        + (f"; diagnostics dumped to {dump}" if dump else "")
    )


class _ScaleRebuilder:
    """run_fit_loop's step-cut hook (port of the JAX `_ScaleRebuilder`):
    rebuilds the model's train step with the Armijo ladder scaled by
    cfg.step_scale. Works for every trainer exposing .cfg /
    .rebuild_step() / ._step. `restore()` puts the model back on its
    original config after the fit, so a shrunken ladder never leaks into
    the caller's next fit."""

    def __init__(self, model):
        self.model = model
        self.orig_cfg = model.cfg
        self.engaged = False

    def __call__(self, scale: float):
        self.engaged = True
        m = self.model
        m.cfg = m.cfg.replace(step_scale=scale)
        m.rebuild_step()
        return m._step

    def restore(self) -> None:
        if not self.engaged:
            return
        m = self.model
        m.cfg = self.orig_cfg
        m.rebuild_step()


class CheckpointMismatchError(ValueError):
    """A checkpoint that cannot resume this run: another graph, K, seed,
    representation or row layout. Named, never cropped into place."""


def check_ckpt_meta(meta: dict, expected: dict, directory: str,
                    soft=("n_pad", "k_pad"), run: str = "run") -> None:
    """Refuse a checkpoint whose meta disagrees with this `run` (the JAX
    rule: a key missing from an older checkpoint matches a falsy
    expectation)."""
    for key, val in expected.items():
        if key in soft:
            continue
        got = meta.get(key)
        if got is None and not val:
            continue
        if got != val:
            raise CheckpointMismatchError(
                f"checkpoint incompatible with this {run}: {key}={got} in "
                f"checkpoint vs {val} expected (dir: {directory})"
            )


def restore_checkpoint(checkpoints, expected_meta: dict, state_from_arrays):
    """Restore the newest valid checkpoint, refusing mismatches (port of
    bigclam_tpu/models/bigclam.py `restore_checkpoint`).

    The live graph, K and seed must match exactly. The PADDED shapes
    (n_pad, k_pad) are soft: padding rows and columns are inert zeros, so
    an archive of the other package (K padded to 128 there, to 32 here;
    rows padded to its CSR blocks) is cropped to the live (num_nodes, k)
    region and re-padded to this model's layout — where its rows are in
    the same order. Rows in a relabeled (balanced) order are placed by a
    permutation that depends on n_pad, so such an archive must have this
    model's n_pad, or it is refused by name.

    Returns (state, llh_history) or (None, ()) when nothing is stored."""
    restored = checkpoints.restore()
    if restored is None:
        return None, ()
    ckpt_step, arrays, meta = restored
    from bigclam_tpu_torch.obs import telemetry as _obs

    tel = _obs.current()
    if tel is not None:
        tel.event("restore", step=int(ckpt_step))
    check_ckpt_meta(meta, expected_meta, checkpoints.directory)
    n_pad, k_pad = expected_meta["n_pad"], expected_meta["k_pad"]
    n, k = expected_meta["num_nodes"], expected_meta["k"]
    F = np.asarray(arrays["F"])
    if tuple(F.shape) != (n_pad, k_pad):
        if expected_meta.get("balanced") and F.shape[0] != n_pad:
            raise CheckpointMismatchError(
                f"checkpoint F rows {F.shape[0]} vs this run's n_pad {n_pad} "
                "on a balanced layout: its rows are in the relabeled order "
                "of another padding, which cannot be mapped back (dir: "
                f"{checkpoints.directory})"
            )
        if F.shape[0] < n or F.shape[1] < k:
            raise CheckpointMismatchError(
                f"checkpoint F shape {F.shape} smaller than live region "
                f"({n}, {k}) (dir: {checkpoints.directory})"
            )
        repad = np.zeros((n_pad, k_pad), F.dtype)
        repad[:n, :k] = F[:n, :k]
        arrays = dict(arrays)
        arrays["F"] = repad
        arrays["sumF"] = repad.sum(axis=0)
    return state_from_arrays(arrays), tuple(meta.get("llh_history", ()))


def fit_with_resume(model, state, callback, extract_F, checkpoints=None,
                    resume: bool = True):
    """The trainers' fit: restore from `checkpoints` unless resume=False
    (then a cold start that still saves), run the loop with the trainer's
    checkpoint, step-cut and health hooks, and put the trainer's cfg back
    after. `model` provides _restore, _state_to_arrays, _ckpt_meta,
    health_sig, rebuild_step, _step, cfg and g."""
    hist = ()
    if checkpoints is not None and resume:
        restored, hist = model._restore(checkpoints)
        if restored is not None:
            state = restored
    rebuilder = _ScaleRebuilder(model)
    try:
        return run_fit_loop(
            model._step, state, model.cfg, callback, extract_F,
            checkpoints=checkpoints,
            state_to_arrays=model._state_to_arrays,
            initial_hist=hist,
            ckpt_meta=model._ckpt_meta(),
            rebuild_step=rebuilder,
            health_sig=model.health_sig,
            health_n=model.g.num_nodes,
        )
    finally:
        rebuilder.restore()


def state_from_jax_arrays(
    F: np.ndarray,
    n: int,
    k: int,
    k_pad: int,
    dtype: torch.dtype,
    device: torch.device,
    llh: Optional[float] = None,
    it: int = 0,
    num_s: int = 16,
) -> TrainState:
    """A TrainState of this port from the JAX package's state arrays: strip
    the JAX padding (rows past n from its CSR blocks, columns past k from
    its 128-multiple K), re-pad the columns to this port's k_pad, and
    recompute sumF as column sums in the working dtype, as both packages'
    steps do."""
    Fp = torch.zeros((n, k_pad), dtype=dtype, device=device)
    Fp[:, :k] = torch.from_numpy(np.ascontiguousarray(np.asarray(F)[:n, :k])).to(
        dtype
    ).to(device)
    return new_state(Fp, num_s, llh=llh, it=it)


def new_state(
    F: torch.Tensor, num_s: int, llh: Optional[float] = None, it: int = 0
) -> TrainState:
    """TrainState around a padded, device-resident F: sumF as column sums,
    LLH -inf until a step evaluates one, a zero accepted-step histogram."""
    return TrainState(
        F=F,
        sumF=F.sum(dim=0),
        llh=torch.tensor(
            -math.inf if llh is None else llh, dtype=F.dtype, device=F.device
        ),
        it=int(it),
        accept_hist=torch.zeros(num_s + 1, dtype=torch.int32, device=F.device),
    )


# Fields that only the HOST-side loops read (never baked into the built
# step), reset by step_cfg_key (copied from bigclam_tpu/models/bigclam.py
# `_HOST_ONLY_FIELDS`)
_HOST_ONLY_FIELDS = dict(
    conv_tol=0.0, max_iters=0, donate_state=False,
    min_com=1, max_com=1, div_com=1, ksweep_tol=0.0,
    seed=0, seed_include_self=True, isolated_phi_sentinel=0.0,
    seeding_degree_cap=None, seed_exclusion=None,
    quality_mode=False, init_noise=None, init_noise_mass=0.0,
    restart_cycles=0, restart_tol=0.0, restart_patience=0,
    quality_conv_tol=0.0, quality_max_p=None,
    checkpoint_dir=None, checkpoint_every=0, metrics_path=None,
    # rollback policy is host-loop-only; step_scale is NOT here (it
    # rescales the Armijo ladder the step is built with)
    rollback_budget=0, rollback_shrink=0.0, rollback_snapshot_every=0,
    csr_store_pad_tiles=0,
)


def step_cfg_key(cfg: BigClamConfig) -> BigClamConfig:
    """Step identity of a config (the JAX `step_cfg_key`): the config with
    the host-only fields reset, so two configs with equal keys build the
    same train step."""
    return cfg.replace(**_HOST_ONLY_FIELDS)


class MemoryAccountedModel:
    """The accounting surface every trainer shares (port of the JAX
    `MemoryAccountedModel`, bigclam_tpu/models/bigclam.py): at step build
    a trainer bakes its memory model (obs.memory) and, on a mesh, its comms
    model (obs.comms), emits them to the installed telemetry, and records
    each step config it builds (`note_step_build`). `memory_reconcile`
    holds the model's state + graph bytes against the storage bytes of the
    live tensors (exact on any device) and emits a `memory_drift` anomaly
    past the band.

    Subclasses provide `_graph_device_arrays()` (the long-lived graph
    tensors by name) and `_build_memory_model()`; mesh trainers also
    `_build_comms_model()`."""

    memory = None                # the baked obs.memory.MemoryModel
    comms = None                 # the baked obs.comms.CommsModel (meshes)

    def _step_key(self):
        """The identity of the step rebuild_step builds: its config with
        the host-only fields reset (a trainer that bakes more than the
        config into its step adds that)."""
        return step_cfg_key(self.cfg)

    def _note_step_build(self) -> None:
        """Record a step build once per step key (_step_key)."""
        from bigclam_tpu_torch.obs import telemetry as _obs

        built = self.__dict__.setdefault("_built_step_keys", set())
        key = self._step_key()
        if key not in built:
            built.add(key)
            _obs.note_step_build(self.cfg, type(self).__name__)

    def _bake_models(self) -> None:
        from bigclam_tpu_torch.obs import comms as _comms
        from bigclam_tpu_torch.obs import memory as _mem

        self.comms = self._build_comms_model()
        if self.comms is not None:
            _comms.emit_model(self.comms)
            self._emit_balance()
        self.memory = self._build_memory_model()
        _mem.emit_model(self.memory, self._host_memory_model())

    def _build_comms_model(self):
        return None

    def _emit_balance(self) -> None:
        pass

    def _graph_device_arrays(self) -> dict:
        raise NotImplementedError

    def _build_memory_model(self):
        raise NotImplementedError

    @property
    def itemsize(self) -> int:
        return torch.empty((), dtype=self.dtype).element_size()

    def _host_memory_model(self):
        from bigclam_tpu_torch.obs import memory as _mem

        g, cfg = self.g, self.cfg
        return _mem.host_rss_model(
            g.num_nodes, g.num_directed_edges, cfg.num_communities,
            self.itemsize, n_pad=self.n_pad, k_pad=self.k_pad,
            num_shards=len(getattr(self, "devices", [None])),
            representation=cfg.representation,
            sparse_m=getattr(self, "m", 0),
        )

    def _memory_state_arrays(self, state) -> list:
        """The state's long-lived tensors (the cadence-only health pack is
        priced as scratch, not here)."""
        return [state.F, state.sumF, state.llh, state.accept_hist]

    def memory_measured(self, state, extra=()) -> float:
        """Storage bytes of the live state + graph tensors on the busiest
        device (+ `extra`: retained tensors the model does not know)."""
        from bigclam_tpu_torch.obs import memory as _mem

        return _mem.measured_device_bytes(
            self._memory_state_arrays(state)
            + list(self._graph_device_arrays().values())
            + list(extra)
        )

    def memory_reconcile(self, state, extra=(), emit=True) -> dict:
        """The memory model against the live bytes
        (obs.memory.MemoryModel.reconcile); emits the `memory_drift`
        anomaly when the drift exceeds the band."""
        from bigclam_tpu_torch.obs import memory as _mem

        recon = self.memory.reconcile(self.memory_measured(state, extra))
        if emit and not recon["ok"]:
            _mem.emit_drift_anomaly(recon)
        return recon


class BigClamModel(MemoryAccountedModel):
    """Single-device BigCLAM trainer.

    Usage:
        model = BigClamModel(graph, cfg)            # on cuda
        model = BigClamModel(graph, cfg, device="cpu")
        result = model.fit(F0)                      # F0: (N, K) nonneg init
    """

    def __init__(self, g: Graph, cfg: BigClamConfig, device=None):
        self.g = g
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(cfg.dtype, self.device)
        self.n_pad = g.num_nodes
        self.k_pad = cfg.num_communities
        want, reason = csr_want_reason(cfg, self.device)
        why = kernel_supports(cfg, self.dtype) if want else ""
        if why:
            # auto mode leaves the choice to pick_candidates_impl, which
            # refuses the same configuration on cuda unless use_pallas=False
            if cfg.use_pallas_csr is True:
                raise ValueError(
                    f"use_pallas_csr=True: the CSR kernels cannot run: {why}"
                )
            want, reason = False, f"csr {why}"
        self.kc = 0
        if want:
            self.kc, self.k_pad = k_block_plan(cfg.num_communities, cfg.csr_k_block)
            check_k_block(self.kc, self.device)
            if self.kc:
                self.engaged_path = (
                    "csr_fused_kb" if csr_fused_want(cfg) else "csr_grouped_kb"
                )
            else:
                self.engaged_path = "csr_fused" if csr_fused_want(cfg) else "csr"
        else:
            self.engaged_path, vmem_reason = pick_candidates_impl(
                cfg, self.device, self.dtype
            )
            if vmem_reason not in ("", reason):
                reason = f"{reason}; {vmem_reason}"
        self.path_reason = reason
        if self.k_pad > cfg.num_communities and cfg.min_f != 0.0:
            # padding inertness relies on clip(0 + eta*grad) staying 0
            raise ValueError(
                "K padding requires min_f == 0.0; got "
                f"min_f={cfg.min_f} with K {cfg.num_communities}->{self.k_pad}"
            )
        self.csr = g.to_device(self.device)
        if self.kc:
            # the K-blocked edge dots' reverse-edge index, once per graph
            self.csr = with_rev(self.csr)
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        self.edges = EdgeChunks(
            self.csr.src, self.csr.dst,
            edge_chunk_bound(cfg, self.k_pad, itemsize),
        )
        if self.engaged_path == "pallas_vmem":
            # the edge-terms kernel's runs, once per chunk
            self.edges = with_runs(self.edges)
        self.rebuild_step()
        # the memory model (obs.memory), baked from the built layout
        self._bake_models()

    def rebuild_step(self) -> None:
        """(Re)build the train step for the CURRENT self.cfg (the
        rollback's step cut swaps in a scaled Armijo ladder) on the built
        graph layout."""
        self._step = make_train_step(
            self.csr, self.edges, self.cfg, self.engaged_path, self.kc
        )
        self._note_step_build()

    # ------------------------------------------------- memory accounting
    def _graph_device_arrays(self) -> dict:
        """The graph tensors the steps keep: the CSR (the plain sweeps'
        edge chunks are views of its src/dst), the reverse-edge index of
        the K-blocked paths, the edge chunks' runs of `pallas_vmem`."""
        return {
            "graph/csr_indptr": self.csr.indptr,
            "graph/csr_indices": self.csr.indices,
            "graph/csr_src": self.csr.src,
            "graph/csr_dst": self.csr.dst,
            "graph/csr_rev": self.csr.rev,
            "graph/edge_runs": self.edges.runs,
        }

    def _build_memory_model(self):
        from bigclam_tpu_torch.obs import memory as _mem

        cfg = self.cfg
        adt = accum_dtype(cfg, torch.empty((), dtype=self.dtype))
        return _mem.dense_memory_model(
            self.n_pad, self.k_pad, self.itemsize,
            len(cfg.step_candidates),
            _mem.bytes_by_name(self._graph_device_arrays()),
            self.engaged_path, self.csr.num_directed_edges,
            chunk=self.edges.chunk,
            health_on=int(cfg.health_every or 0) > 0,
            rollback=int(cfg.rollback_budget or 0) > 0,
            llh_itemsize=torch.empty((), dtype=adt).element_size(),
            model=type(self).__name__,
        )

    def init_state(self, F0: Optional[np.ndarray] = None) -> TrainState:
        n, k = self.g.num_nodes, self.cfg.num_communities
        if F0 is None:
            F0 = rowkeyed_init_F(self.g, self.cfg)
        if F0.shape != (n, k):
            raise ValueError(f"F0 has shape {F0.shape}, want {(n, k)}")
        F = torch.zeros((self.n_pad, self.k_pad), dtype=self.dtype, device=self.device)
        F[:n, :k] = torch.from_numpy(np.ascontiguousarray(F0)).to(self.dtype).to(self.device)
        return self.reset_state(F)

    def reset_state(self, F: torch.Tensor, llh: Optional[float] = None,
                    it: int = 0) -> TrainState:
        """TrainState around an already device-resident PADDED F: init_state
        without the upload (the device annealing loop's state a cycle).
        sumF reduced, LLH -inf, `it` 0, a zero histogram, no health pack
        until a cadence step computes one."""
        return new_state(F, len(self.cfg.step_candidates), llh=llh, it=it)

    def state_from_jax(self, F: np.ndarray, llh: Optional[float] = None,
                       it: int = 0) -> TrainState:
        """state_from_jax_arrays at this model's layout."""
        return state_from_jax_arrays(
            F, self.g.num_nodes, self.cfg.num_communities, self.k_pad,
            self.dtype, self.device, llh=llh, it=it,
            num_s=len(self.cfg.step_candidates),
        )

    def extract_F(self, state: TrainState) -> np.ndarray:
        """Fetch the live (N, K) F block to the host."""
        n, k = self.g.num_nodes, self.cfg.num_communities
        return state.F[:n, :k].cpu().numpy()

    # ------------------------------------------------ fold-in and refit
    def foldin_rows(
        self,
        state: TrainState,
        nodes,
        max_deg: Optional[int] = None,
        max_iters: Optional[int] = None,
        conv_tol: Optional[float] = None,
        init: str = "own",
    ):
        """Batched FOLD-IN: re-optimize the rows of `nodes` against this
        state's FROZEN F (ops.foldin — the per-node half of the train step
        as a batch primitive, which `cli serve`'s suggest family and the
        warm-start refit are built on), holding every other row fixed.

        init="own" (default) warm-starts each node from its CURRENT row: a
        trained node's row is a fixed point of its own fold-in objective,
        so fold-in recovers it within the convergence band and refines it
        when the frozen F has drifted. init="mean" cold-starts from the
        neighbour mean (the brand-new-node path), which may land on
        another local optimum of the row.

        Returns (rows (B, K) np.ndarray, llh (B,), iters (B,))."""
        from bigclam_tpu_torch.ops import foldin as fi
        from bigclam_tpu_torch.serve.snapshot import pad_neighbor_batch

        nodes = np.asarray(nodes, np.int64)
        nbr_ids, nbr_mask, _ = pad_neighbor_batch(
            self.g.indptr, self.g.indices, nodes, max_deg=max_deg
        )
        F = state.F
        nbr_rows = fi.gather_neighbor_rows(
            F, torch.from_numpy(nbr_ids).to(self.device))
        mask = torch.from_numpy(nbr_mask).to(device=self.device, dtype=F.dtype)
        own = F[torch.from_numpy(nodes).to(self.device)]
        sumF_others = state.sumF[None, :] - own
        rows0 = own if init == "own" else fi.neighbor_mean_rows(nbr_rows, mask)
        fit = fi.make_foldin_fit(self.cfg, max_iters=max_iters,
                                 conv_tol=conv_tol)
        rows, llh, iters = fit(rows0, nbr_rows, mask, sumF_others)
        k = self.cfg.num_communities
        return (rows[:, :k].cpu().numpy(), llh.cpu().numpy(),
                iters.cpu().numpy())

    def refit_commit(self, state: TrainState, nodes, rows: np.ndarray) -> TrainState:
        """Scatter freshly folded rows into the state (the warm-start
        refit's commit half): F rows replaced IN PLACE, sumF updated by
        the row delta; llh/it/health are the refit loop's bookkeeping."""
        from bigclam_tpu_torch.ops.foldin import apply_rows

        k = self.cfg.num_communities
        rows_p = np.zeros((len(nodes), self.k_pad), dtype=np.float64)
        rows_p[:, :k] = rows
        F, sumF = apply_rows(
            state.F, state.sumF,
            torch.from_numpy(np.asarray(nodes, np.int64)).to(self.device),
            torch.from_numpy(rows_p).to(device=self.device, dtype=self.dtype),
        )
        return state._replace(F=F, sumF=sumF)

    def warm_start_refit(self, F_prev: np.ndarray, touched, **kw):
        """Incremental warm-start refit from a previous F restricted to the
        touched rows + halo (models.refit.warm_start_refit)."""
        from bigclam_tpu_torch.models.refit import warm_start_refit

        return warm_start_refit(self, F_prev, touched, **kw)

    def health_sig(self, state: TrainState) -> torch.Tensor:
        """(N,) int32 top-community signature — the rolling membership
        snapshot obs.health churns against."""
        return dx.dense_top_community(state.F)

    # ------------------------------------------------------ checkpoints
    def _ckpt_meta(self) -> dict:
        """The sidecar meta of the JAX BigClamModel: a checkpoint of
        another graph, K or seed is refused on restore."""
        return {
            "num_nodes": self.g.num_nodes,
            "num_directed_edges": self.g.num_directed_edges,
            "k": self.cfg.num_communities,
            "n_pad": self.n_pad,
            "k_pad": self.k_pad,
            "seed": self.cfg.seed,
        }

    def _state_to_arrays(self, state: TrainState) -> dict:
        return {
            "F": state.F.cpu().numpy(),
            "sumF": state.sumF.cpu().numpy(),
            "llh": state.llh.cpu().numpy(),
            "it": np.asarray(state.it, np.int32),
        }

    def _state_from_arrays(self, arrays: dict) -> TrainState:
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.dtype).to(
                self.device)

        return TrainState(
            F=dev(arrays["F"]),
            sumF=dev(arrays["sumF"]),
            llh=dev(np.asarray(arrays["llh"])),
            it=int(arrays["it"]),
            accept_hist=torch.zeros(
                len(self.cfg.step_candidates) + 1, dtype=torch.int32,
                device=self.device,
            ),
        )

    def _restore(self, checkpoints):
        return restore_checkpoint(
            checkpoints, self._ckpt_meta(), self._state_from_arrays
        )

    # -------------------------------------------------------------- fit
    def fit(
        self,
        F0: Optional[np.ndarray] = None,
        callback: Optional[Callable[[int, float], None]] = None,
        checkpoints=None,
        resume: bool = True,
    ) -> FitResult:
        """Train to convergence from F0 (rowkeyed init when None). If
        `checkpoints` (a utils.checkpoint.CheckpointManager) holds a saved
        state, training resumes from it (resume=False: a cold start that
        still saves); F0 is only the cold-start init."""
        return fit_with_resume(self, self.init_state(F0), callback,
                               self.extract_F, checkpoints, resume)

    def fit_state(
        self,
        state: TrainState,
        callback: Optional[Callable[[int, float], None]] = None,
        checkpoints=None,
        resume: bool = True,
    ):
        """The convergence loop on a resident state (or the checkpoint's,
        when one is restored): returns (final_state, final_llh, num_iters,
        llh_history) without fetching F."""
        return fit_with_resume(self, state, callback, None, checkpoints,
                               resume)
