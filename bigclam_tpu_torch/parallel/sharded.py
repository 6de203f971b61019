"""Node-sharded BigCLAM training on a device mesh: the all-gather schedule.

Port of the tp = 1, single-host part of bigclam_tpu/parallel/sharded.py
(`make_sharded_train_step`, the flat and fused steps of
`make_sharded_csr_train_step`, `ShardedBigClamModel`). The mesh runs
single-controller (parallel/mesh.py): this process launches each shard's
work on that shard's device.

Layout: F is cut into dp contiguous row shards of n_pad/dp rows (padding
rows at the tail, all zero), shard i on mesh device i; `TrainState.F` and
`.sumF` hold one tensor per shard, the rest of the state lives on the first
device. Each shard owns the directed edges whose source it owns, as a CSR
over its rows with GLOBAL destination ids. One step:

    sumF   = psum of the shards' column sums
    F_full = all-gather of the shards onto each shard's device
    per shard: the edge pass of its rows against F_full, Armijo selection
    LLH, sumF and the accepted-step histogram through psum

on one of three kernel paths, named as in the JAX package:

* `csr_fused` — kernel A per shard with its destination rows from F_full
  (JAX `step_shard_fused`);
* `csr`       — kernels B and C with F_dst = F_full, selection in torch
  (JAX `step_shard_flat`);
* `xla`       — the plain torch sweeps (JAX `make_sharded_train_step`), the
  CPU path and the float64 oracle.

tp > 1 and K-blocked meshes are refused by name (MeshNotPortedError).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np
import torch

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import DeviceCSR, Graph
from bigclam_tpu_torch.models.bigclam import (
    CSR_K_MULTIPLE,
    FitResult,
    TrainState,
    _round_up,
    csr_fused_want,
    csr_want_reason,
    fit_with_resume,
    restore_checkpoint,
    rowkeyed_init_F,
)
from bigclam_tpu_torch.ops import diagnostics as dx
from bigclam_tpu_torch.ops.csr_kernels import (
    MAX_K,
    candidates_csr,
    edge_chunks,
    grad_llh_csr,
    kernel_supports,
)
from bigclam_tpu_torch.ops.fused import fused_superstep
from bigclam_tpu_torch.ops.linesearch import (
    accept_stats,
    armijo_select,
    armijo_update,
    armijo_update_kernel,
    candidates_pass,
)
from bigclam_tpu_torch.ops.objective import grad_llh
from bigclam_tpu_torch.parallel.balance import balance_graph
from bigclam_tpu_torch.parallel.mesh import K_AXIS, NODES_AXIS, Mesh
from bigclam_tpu_torch.utils.device import resolve_device, resolve_dtype


class MeshNotPortedError(NotImplementedError):
    """A mesh configuration the port does not run yet; the message names
    the ROADMAP item that brings it."""


def _shard_bounds(src: np.ndarray, n_pad: int, dp: int) -> np.ndarray:
    """Edge-array index bounds of the dp row split over src-sorted edges."""
    shard_rows = n_pad // dp
    return np.searchsorted(src, np.arange(0, n_pad + shard_rows, shard_rows))


def shard_edge_counts(src: np.ndarray, n_pad: int, dp: int) -> np.ndarray:
    """Per-shard directed-edge counts of the dp row split."""
    return np.diff(_shard_bounds(src, n_pad, dp))


def shard_edges(g: Graph, dp: int, n_pad: int) -> list:
    """Each shard's directed edges as a CSR over its n_pad/dp rows:
    [(indptr (rows+1,) int64, indices int32 GLOBAL destination ids)] per
    shard. The CSR form of JAX `shard_edges`: a shard's edges are one
    contiguous slice of the graph's CSR, and each shard keeps its own
    length (no padding to the largest shard, no mask); rows past N are
    empty."""
    rows = n_pad // dp
    bounds = _shard_bounds(g.src, n_pad, dp)
    n = g.num_nodes
    out = []
    for i in range(dp):
        lo, hi = min(i * rows, n), min((i + 1) * rows, n)
        indptr = np.full(rows + 1, bounds[i + 1], dtype=np.int64)
        indptr[: hi - lo + 1] = g.indptr[lo : hi + 1]
        out.append((indptr - bounds[i], g.indices[bounds[i] : bounds[i + 1]]))
    return out


def device_csr(indptr: np.ndarray, indices: np.ndarray, device) -> DeviceCSR:
    """A DeviceCSR on `device` from host (indptr, indices) arrays."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices)
    src = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64), np.diff(indptr))
    return DeviceCSR(
        indptr=torch.as_tensor(indptr, device=device),
        indices=torch.as_tensor(indices.astype(np.int32), device=device),
        src=torch.as_tensor(src, device=device),
        dst=torch.as_tensor(indices.astype(np.int64), device=device),
    )


def psum(parts, devices) -> list:
    """The sum of the shards' partials, taken in shard order on the first
    device and copied to every shard's device, so every shard holds the
    same bits, as after a JAX psum."""
    total = parts[0].to(devices[0])
    for p in parts[1:]:
        total = total + p.to(devices[0])
    return [total.to(d) for d in devices]


def all_gather(parts, devices) -> list:
    """The shards concatenated in shard order on each shard's device (one
    tensor per distinct device: on a mesh of one repeated device every
    shard reads the same copy)."""
    full = {}
    for d in devices:
        if d not in full:
            full[d] = torch.cat([p.to(d) for p in parts])
    return [full[d] for d in devices]


def armijo_tail_select_sharded(
    F_loc: torch.Tensor,
    grad: torch.Tensor,
    node_llh: torch.Tensor,
    cand_nbr: torch.Tensor,
    sumF: torch.Tensor,
    cfg: BigClamConfig,
    kernel: bool = False,
):
    """Armijo tails + acceptance + max-accepted-step Jacobi update of one
    shard's rows, given its NEIGHBOUR candidate terms: ONE implementation
    shared by the `xla` all-gather step and every ring step (JAX
    `armijo_tail_select_sharded`). At tp = 1 every row dot is a plain row
    dot, so this is ops.linesearch.armijo_update on the shard's rows with
    the global sumF; with kernel=True (the steps whose kernels engage:
    `csr_ring_fused`, `csr_ring`) its CUDA kernel, armijo_update_kernel.
    Returns (F_new, the shard's column sums of F_new — the caller psums
    them —, the shard's accepted-step histogram)."""
    update = armijo_update_kernel if kernel else armijo_update
    return update(F_loc, sumF, grad, node_llh, cand_nbr, cfg, with_stats=True)


def mesh_kernels_want(
    cfg: BigClamConfig, device: torch.device, dtype: torch.dtype
) -> tuple:
    """(engage the CSR kernels?, reason when not) for a mesh on `device`.

    The rule of models.bigclam.csr_want_reason (auto: on for cuda). Where
    the kernels would engage but cannot run, it raises rather than run a
    plain step on the card unasked: ValueError for a configuration the
    kernels refuse (kernel_supports), MeshNotPortedError for rows wider
    than one warp holds (the K-blocked mesh paths)."""
    want, reason = csr_want_reason(cfg, device)
    if not want:
        return False, reason
    why = kernel_supports(cfg, dtype)
    if why:
        raise ValueError(
            f"use_pallas_csr={cfg.use_pallas_csr} on {device.type}: the mesh's "
            f"CSR kernels cannot run: {why}; use_pallas_csr=False selects the "
            "plain `xla` step"
        )
    k32 = _round_up(cfg.num_communities, CSR_K_MULTIPLE)
    if k32 > MAX_K or cfg.csr_k_block:
        raise MeshNotPortedError(
            f"K={cfg.num_communities} (k_pad {k32}, csr_k_block "
            f"{cfg.csr_k_block}) needs the K-blocked kernels on a mesh "
            "(csr_ring_kb, csr_ring_fused_kb, csr_fused_kb, csr_grouped*), "
            "which are not ported yet (ROADMAP queue 1 items 14-15: K-blocked "
            f"meshes); the mesh kernels take k_pad <= {MAX_K}. "
            "use_pallas_csr=False selects the plain `xla` step"
        )
    return True, ""


def finish_step(state: TrainState, outs, devices, cfg: BigClamConfig,
                grads=None) -> TrainState:
    """The psums that end a sharded step: `outs` holds, per shard,
    (F_new, column sums of F_new, LLH of the shard's rows, accepted-step
    histogram); `grads` the shards' gradients, read only for the health
    pack on cadence iterations."""
    F_new, sums, llhs, hists = zip(*outs)
    sumF = tuple(psum(sums, devices))
    hist = psum(hists, devices)[0]
    health = None
    if dx.on_cadence(cfg, state.it):
        health = dx.health_pack(cfg, state.it, state.F, F_new, sumF[0], hist,
                                grad=grads)
    return TrainState(
        F=tuple(F_new),
        sumF=sumF,
        llh=psum(llhs, devices)[0].to(F_new[0].dtype),
        it=state.it + 1,
        accept_hist=hist,
        health=health,
    )


def make_sharded_train_step(
    devices: list, shards: List[DeviceCSR], cfg: BigClamConfig, path: str
) -> Callable[[TrainState], TrainState]:
    """One all-gather iteration on kernel path `path` (`csr_fused`, `csr`
    or `xla`); shards[i] is shard i's CSR (global destination ids) on
    devices[i]."""

    def shard_update(F_loc, sumF, csr, F_full):
        """((F_new, its column sums, LLH of the rows, histogram), grad)"""
        if path == "csr_fused":
            F_new, grad, node_llh, ok = fused_superstep(F_loc, sumF, csr, cfg, F_full)
            return (F_new, F_new.sum(dim=0), node_llh.sum(), accept_stats(ok)), grad
        if path == "csr":
            grad, node_llh = grad_llh_csr(F_loc, sumF, csr, cfg, F_full)
            cand = candidates_csr(F_loc, grad, sumF, csr, cfg, F_full)
            F_new, sum_loc, hist = armijo_select(
                F_loc, grad, node_llh, cand, cfg, with_stats=True
            )
            return (F_new, sum_loc, node_llh.sum(), hist), grad
        edges = edge_chunks(F_loc, csr, cfg)
        grad, node_llh = grad_llh(F_loc, sumF, edges, cfg, F_full)
        cand_nbr = candidates_pass(F_loc, grad, edges, cfg, F_full)
        F_new, sum_loc, hist = armijo_tail_select_sharded(
            F_loc, grad, node_llh, cand_nbr, sumF, cfg
        )
        return (F_new, sum_loc, node_llh.sum(), hist), grad

    def step(state: TrainState) -> TrainState:
        F = state.F
        sumF = psum([f.sum(dim=0) for f in F], devices)
        F_full = all_gather(F, devices)
        outs, grads = zip(*(
            shard_update(F[i], sumF[i], shards[i], F_full[i])
            for i in range(len(devices))
        ))
        return finish_step(state, outs, devices, cfg, grads)

    return step


class ShardedBigClamModel:
    """BigCLAM trainer over a (nodes, k) mesh with tp = 1, all-gather
    schedule. Mirrors models.bigclam.BigClamModel's API; the same
    trajectories (the sharding changes the schedule, not the math).

    Usage:
        mesh = make_mesh((4, 1), [torch.device("cuda:0")] * 4)
        model = ShardedBigClamModel(graph, cfg, mesh)
        result = model.fit(F0)              # F0: (N, K), original ids
    """

    def __init__(self, g: Graph, cfg: BigClamConfig, mesh: Mesh,
                 balance: bool = False):
        dp, tp = mesh.shape[NODES_AXIS], mesh.shape[K_AXIS]
        if tp > 1:
            raise MeshNotPortedError(
                f"a K-sharded mesh (tp={tp}) is not ported yet (ROADMAP queue "
                "1 item 14: the TP kernel split #4-#7 with a psum over the k "
                "axis); use a mesh of shape (dp, 1)"
            )
        self.g = g
        self.cfg = cfg
        self.mesh = mesh
        self.devices = [resolve_device(d) for d in mesh.node_devices()]
        self.device = self.devices[0]
        self.dtype = resolve_dtype(cfg.dtype, self.device)
        if cfg.min_f != 0.0:
            raise ValueError("sharded padding requires min_f == 0.0")
        self.n_pad = _round_up(max(g.num_nodes, dp), dp)
        self.kernels, self.path_reason = mesh_kernels_want(cfg, self.device, self.dtype)
        self.k_pad = (
            _round_up(cfg.num_communities, CSR_K_MULTIPLE)
            if self.kernels else cfg.num_communities
        )
        # degree-balanced relabeling (parallel/balance.py): the trainer runs
        # on the relabeled graph; F0 in and results out stay in original ids
        self._perm = None
        self.g_original = g
        if balance and dp > 1:
            self.g, self._perm = balance_graph(g, dp, self.n_pad)
        self._build_edges_and_step()

    @property
    def engaged_path(self) -> str:
        """The kernel path of this trainer's step."""
        if not self.kernels:
            return "xla"
        return "csr_fused" if csr_fused_want(self.cfg) else "csr"

    def _build_edges_and_step(self) -> None:
        dp = len(self.devices)
        self.shard_csr = [
            device_csr(indptr, indices, d)
            for (indptr, indices), d in zip(
                shard_edges(self.g, dp, self.n_pad), self.devices
            )
        ]
        self.rebuild_step()

    def rebuild_step(self) -> None:
        """(Re)build the train step for the CURRENT self.cfg on the built
        edge layout."""
        self._step = make_sharded_train_step(
            self.devices, self.shard_csr, self.cfg, self.engaged_path
        )

    # --- state ----------------------------------------------------------

    def _to_internal_rows(self, F0: np.ndarray) -> np.ndarray:
        """Original-id F rows -> the trainer's (possibly relabeled) order."""
        if self._perm is None:
            return F0
        out = np.empty_like(F0)
        out[self._perm] = F0
        return out

    def _from_internal_rows(self, F: np.ndarray) -> np.ndarray:
        """Trainer row order -> original ids (inverse of _to_internal_rows)."""
        return F if self._perm is None else F[self._perm]

    def _shard_state(self, F_host: np.ndarray, llh: Optional[float] = None,
                     it: int = 0) -> TrainState:
        """TrainState from a host (n_pad, k_pad) F in internal row order."""
        rows = self.n_pad // len(self.devices)
        Ft = torch.from_numpy(np.ascontiguousarray(F_host)).to(self.dtype)
        F = tuple(
            Ft[i * rows : (i + 1) * rows].to(d, copy=True)
            for i, d in enumerate(self.devices)
        )
        return self.reset_state(F, llh=llh, it=it)

    def health_sig(self, state: TrainState) -> torch.Tensor:
        """(n_pad,) int32 top-community signature of the shards, in the
        trainer's row order (padding rows are -1 forever)."""
        return dx.dense_top_community(state.F)

    def reset_state(self, F, llh: Optional[float] = None, it: int = 0) -> TrainState:
        """TrainState around per-shard padded F tensors: sumF through the
        psum, LLH -inf until a step evaluates one, a zero histogram."""
        return TrainState(
            F=tuple(F),
            sumF=tuple(psum([f.sum(dim=0) for f in F], self.devices)),
            llh=torch.tensor(
                -math.inf if llh is None else llh, dtype=self.dtype,
                device=self.device,
            ),
            it=int(it),
            accept_hist=torch.zeros(
                len(self.cfg.step_candidates) + 1, dtype=torch.int32,
                device=self.device,
            ),
        )

    def init_state(self, F0: Optional[np.ndarray] = None) -> TrainState:
        """Shard a host (N, K) F0 in original ids (row-keyed init when
        None)."""
        n, k = self.g.num_nodes, self.cfg.num_communities
        if F0 is None:
            F0 = rowkeyed_init_F(self.g, self.cfg)
        if F0.shape != (n, k):
            raise ValueError(f"F0 has shape {F0.shape}, want {(n, k)}")
        F_host = np.zeros((self.n_pad, self.k_pad), dtype=np.float64)
        F_host[:n, :k] = self._to_internal_rows(F0)
        return self._shard_state(F_host)

    def state_from_jax(self, F: np.ndarray, llh: Optional[float] = None,
                       it: int = 0) -> TrainState:
        """This model's state from the JAX model's padded global F (numpy,
        internal row order): its (N, K) block, re-padded to this model's
        (n_pad, k_pad) and split into the shards. The JAX CSR layouts pad
        n_pad further (to dp x block rows), so internal orders agree only
        where both models balanced at the same n_pad or not at all;
        otherwise start both from init_state(F0) in original ids."""
        n, k = self.g.num_nodes, self.cfg.num_communities
        F_host = np.zeros((self.n_pad, self.k_pad), dtype=np.float64)
        F_host[:n, :k] = np.asarray(F)[:n, :k]
        return self._shard_state(F_host, llh=llh, it=it)

    def internal_row_to_node(self) -> Optional[np.ndarray]:
        """Trainer row index -> ORIGINAL node index, or None when rows were
        never relabeled: the `row_to_node` of
        ops.extraction.extract_communities_device for callers holding the
        original graph (with the trainer's own `model.g` the raw ids
        already agree)."""
        if self._perm is None:
            return None
        inv = np.empty_like(self._perm)
        inv[self._perm] = np.arange(self._perm.size)
        return inv

    def extract_F(self, state: TrainState) -> np.ndarray:
        """Fetch the live (N, K) F block to the host in ORIGINAL node ids."""
        n, k = self.g.num_nodes, self.cfg.num_communities
        F = torch.cat([f.cpu() for f in state.F]).numpy()
        return self._from_internal_rows(F[:n])[:, :k]

    # --- checkpoints ----------------------------------------------------

    def _ckpt_meta(self) -> dict:
        """The sidecar meta of the JAX sharded trainers: F is stored in
        the trainer's internal row order, which depends on the balance
        setting and, when balanced, on the node-shard count (and n_pad,
        which restore_checkpoint then holds fixed)."""
        return {
            "num_nodes": self.g.num_nodes,
            "num_directed_edges": self.g.num_directed_edges,
            "k": self.cfg.num_communities,
            "n_pad": self.n_pad,
            "k_pad": self.k_pad,
            "balanced": self._perm is not None,
            "node_shards": len(self.devices) if self._perm is not None else 0,
            "seed": self.cfg.seed,
        }

    def _state_to_arrays(self, state: TrainState) -> dict:
        return {
            "F": torch.cat([f.cpu() for f in state.F]).numpy(),
            "sumF": state.sumF[0].cpu().numpy(),
            "llh": state.llh.cpu().numpy(),
            "it": np.asarray(state.it, np.int32),
        }

    def _state_from_arrays(self, arrays: dict) -> TrainState:
        return self._shard_state(
            np.asarray(arrays["F"]), llh=float(arrays["llh"]),
            it=int(arrays["it"]),
        )

    def _restore(self, checkpoints):
        return restore_checkpoint(
            checkpoints, self._ckpt_meta(), self._state_from_arrays
        )

    # --- training -------------------------------------------------------

    def fit(
        self,
        F0: Optional[np.ndarray] = None,
        callback: Optional[Callable[[int, float], None]] = None,
        checkpoints=None,
        resume: bool = True,
    ) -> FitResult:
        """Train to convergence from F0 (row-keyed init when None),
        resuming from `checkpoints` when it holds a state (resume=False: a
        cold start that still saves)."""
        return fit_with_resume(self, self.init_state(F0), callback,
                               self.extract_F, checkpoints, resume)

    def fit_state(
        self,
        state: TrainState,
        callback: Optional[Callable[[int, float], None]] = None,
        checkpoints=None,
        resume: bool = True,
    ):
        """The convergence loop on a resident state; returns (final_state,
        final_llh, num_iters, llh_history) without fetching F."""
        return fit_with_resume(self, state, callback, None, checkpoints, resume)
