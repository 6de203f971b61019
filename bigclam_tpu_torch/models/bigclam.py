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
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph
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

    def fused_step(state: TrainState) -> TrainState:
        F = state.F
        F_new, _, node_llh, ok = fused_superstep(F, state.sumF, csr, cfg)
        llh = node_llh.to(accum_dtype(cfg, F)).sum()
        return TrainState(
            F=F_new, sumF=F_new.sum(dim=0), llh=llh.to(F.dtype),
            it=state.it + 1, accept_hist=accept_stats(ok),
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
        return TrainState(
            F=F_new, sumF=F_new.sum(dim=0), llh=node_llh.sum(), it=state.it + 1,
            accept_hist=accept_stats(ok),
        )

    steps = {
        "csr_fused": fused_step, "csr": split_step,
        "csr_fused_kb": kblocked_step, "csr_grouped_kb": kblocked_step,
        "pallas_vmem": xla_step, "xla": xla_step,
    }
    return steps[path]


def run_fit_loop(
    step_fn: Callable[[TrainState], TrainState],
    state: TrainState,
    cfg: BigClamConfig,
    callback: Optional[Callable[[int, float], None]] = None,
    extract_F: Optional[Callable[[TrainState], np.ndarray]] = None,
):
    """Convergence loop. The step that takes F_t reports LLH(F_t) and
    eagerly produces F_{t+1}; when |1 - LLH(F_t)/LLH(F_{t-1})| < conv_tol
    the loop stops and returns F_t — the speculative F_{t+1} is discarded.
    It also stops after the step that evaluated iteration max_iters. A
    non-finite LLH raises FloatingPointError.

    With extract_F=None returns (final_state, final_llh, num_iters,
    llh_history); otherwise a FitResult with extract_F(final_state)."""
    hist: list[float] = []
    while True:
        new_state = step_fn(state)
        llh_t = float(new_state.llh)           # host sync: LLH of state.F
        if not math.isfinite(llh_t):
            raise FloatingPointError(
                f"non-finite LLH {llh_t} at iteration {state.it}; "
                f"last finite LLHs {hist[-5:]}"
            )
        if callback is not None:
            callback(state.it, llh_t)
        if hist and _rel_change(llh_t, hist[-1]) < cfg.conv_tol:
            hist.append(llh_t)
            break
        hist.append(llh_t)
        if state.it >= cfg.max_iters:
            break
        state = new_state
    if extract_F is None:
        return state, llh_t, state.it, tuple(hist)
    F = extract_F(state)
    return FitResult(
        F=F, sumF=F.sum(axis=0), llh=llh_t, num_iters=state.it,
        llh_history=tuple(hist),
    )


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


class BigClamModel:
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
        self._step = make_train_step(
            self.csr, self.edges, cfg, self.engaged_path, self.kc
        )

    def init_state(self, F0: Optional[np.ndarray] = None) -> TrainState:
        n, k = self.g.num_nodes, self.cfg.num_communities
        if F0 is None:
            F0 = rowkeyed_init_F(self.g, self.cfg)
        if F0.shape != (n, k):
            raise ValueError(f"F0 has shape {F0.shape}, want {(n, k)}")
        F = torch.zeros((self.n_pad, self.k_pad), dtype=self.dtype, device=self.device)
        F[:n, :k] = torch.from_numpy(np.ascontiguousarray(F0)).to(self.dtype).to(self.device)
        return new_state(F, len(self.cfg.step_candidates))

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

    def fit(
        self,
        F0: Optional[np.ndarray] = None,
        callback: Optional[Callable[[int, float], None]] = None,
    ) -> FitResult:
        """Train to convergence from F0 (rowkeyed init when None)."""
        return run_fit_loop(
            self._step, self.init_state(F0), self.cfg, callback, self.extract_F
        )
