"""Node-sharded BigCLAM training on a device mesh: the all-gather schedule.

Port of the single-host part of bigclam_tpu/parallel/sharded.py
(`make_sharded_train_step`, the flat, fused, K-blocked and tp > 1 steps of
`make_sharded_csr_train_step`, `ShardedBigClamModel`). A single-controller
mesh (parallel/mesh.py) has this process launch each shard's work on that
shard's device; on a multi-process mesh (parallel/multihost.py) a rank
builds, holds and steps its own positions, and the collectives below
cross ranks where an axis's members do.

Layout: F is cut into dp contiguous row shards of n_pad/dp rows (padding
rows at the tail, all zero). At tp = 1 shard i lives on mesh device i and
`TrainState.F` and `.sumF` hold one tensor per shard. At tp > 1 (the k
axis) each shard's K_pad columns are cut into tp blocks of K_loc columns,
block (i, j) on mesh device (i, j): `TrainState.F` holds a tuple of tp
blocks per shard and `.sumF` the column blocks of sumF, one per block;
parallel/mesh.py `row_shards` is the row view its consumers read. The rest
of the state lives on the first device. Each shard owns the directed edges
whose source it owns, as a CSR over its rows with GLOBAL destination ids.
One step:

    sumF   = psum of the shards' column sums (per column block)
    F_full = all-gather of the shards onto each shard's device
    per shard: the edge pass of its rows against F_full, Armijo selection
    LLH, sumF and the accepted-step histogram through psum

on the kernel paths named as in the JAX package:

* `csr_fused`      — tp = 1: kernel A per shard with its destination rows
  from F_full (JAX `step_shard_fused`); tp > 1: the TP split below on
  K_loc-column windows, the fold in the gradient kernel
  (`step_shard_fused_tp`);
* `csr`            — tp = 1: kernels B and C with F_dst = F_full, selection
  in torch (`step_shard_flat`); tp > 1: the TP split, fold in torch
  (`step_shard_tp`);
* `csr_fused_kb` / `csr_grouped_kb` — K_loc wider than a warp's row, or
  csr_k_block set: the K-blocked kernels (ops.kblocked) over windows of the
  shard's columns, F_dst = the gathered column block, the fold in the
  kernel or in torch (`step_shard_fused_kb`, `step_shard_grouped_kb`);
* `xla`            — the plain torch sweeps (`make_sharded_train_step`), the
  CPU path and the float64 oracle; at tp > 1 the TP split on the kernels'
  plain versions.

The TP split (every path but tp = 1 `csr_fused`/`csr`/`xla`): per shard the
edge dots of each column block (`edge_dots_kb` in its directed mode), a
psum of the per-edge partials over the k axis, the gradient columns and
the candidate dots of each block, a psum of those over k. At tp = 1 the
psums are the identity and the node pass `cand_select_from_x` ends the
step; at tp > 1 `cand_nbr_from_x` gives the neighbour candidate sums and
the node tail, the Armijo tails and the selection run in torch with their
row dots psummed over k (`armijo_tail_select_tp`; JAX
`armijo_tail_select_sharded`).

`StoreShardedBigClamModel` (JAX `StoreShardedBigClamModel`) trains the
same step from a compiled graph cache (graph/store.py) with one cache
shard per mesh position: position s builds its CSR from
`store.load_shard(s, dp)` alone, so no global CSR is assembled for the
trainer. The cache's rows_per_shard, ceil(max(N, S) / S), is the trainer's
n_pad / dp when S = dp, so a shard file is exactly one position's rows.
The JAX tile layout has no counterpart (the kernels read the CSR), so its
block-alignment rule and cross-host tile pad do not apply.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np
import torch

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import DeviceCSR, Graph, host_tensor
from bigclam_tpu_torch.models.bigclam import (
    FitResult,
    MemoryAccountedModel,
    TrainState,
    _round_up,
    check_k_block,
    csr_fused_want,
    csr_want_reason,
    fit_with_resume,
    mesh_k_plan,
    restore_checkpoint,
    rowkeyed_init_F,
    rowkeyed_init_rows,
)
from bigclam_tpu_torch.obs import comms as _comms
from bigclam_tpu_torch.obs import memory as _mem
from bigclam_tpu_torch.ops import diagnostics as dx
from bigclam_tpu_torch.ops.csr_kernels import (
    candidates_csr,
    edge_chunks,
    grad_llh_csr,
    kernel_supports,
)
from bigclam_tpu_torch.ops.fused import fused_superstep
from bigclam_tpu_torch.ops.kblocked import (
    cand_nbr_from_x,
    cand_nbr_from_x_plain,
    cand_select_from_x,
    edge_dots_windows,
    grad_cand_windows,
)
from bigclam_tpu_torch.ops.linesearch import (
    accept_stats,
    armijo_select,
    armijo_update,
    armijo_update_kernel,
    candidates_pass,
    step_etas,
)
from bigclam_tpu_torch.ops.objective import accum_dtype, edge_chunk_bound, grad_llh
from bigclam_tpu_torch.parallel import multihost as _mh
from bigclam_tpu_torch.parallel.balance import balance_graph
from bigclam_tpu_torch.parallel.mesh import (
    K_AXIS,
    NODES_AXIS,
    Axis,
    Grid,
    Mesh,
    column,
    row_shards,
    state_blocks,
)
from bigclam_tpu_torch.utils.device import resolve_device, resolve_dtype
from bigclam_tpu_torch.utils.dist import process_count as _process_count
from bigclam_tpu_torch.utils.profiling import part


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
    src = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64), np.diff(indptr))
    return DeviceCSR(
        indptr=host_tensor(indptr, np.int64, device),
        indices=host_tensor(indices, np.int32, device),
        src=host_tensor(src, np.int64, device),
        dst=host_tensor(indices, np.int64, device),
    )


def csr_to(csr: DeviceCSR, device) -> DeviceCSR:
    """A copy of a DeviceCSR on `device`."""
    return DeviceCSR(*(None if t is None else t.to(device) for t in csr))


def psum(parts, devices, site: str = "") -> list:
    """The sum of the shards' partials, taken in shard order on the first
    device and copied to every shard's device, so every shard holds the
    same bits, as after a JAX psum. `site` names it to the comms counter
    (obs.comms: each other position's partial in, the total back out).
    Where `devices` is an Axis whose members span ranks, every member's
    partial is all-gathered first (parallel/multihost.py `exchange`) and
    summed in the same order."""
    group = getattr(devices, "group", None)
    if group is not None:
        parts = _mh.exchange(parts, group)
    total = parts[0].to(devices[0])
    for p in parts[1:]:
        total = total + p.to(devices[0])
    if _comms.counting_on() and len(parts) > 1:
        _comms.count(site, sum(_nbytes(p) for p in parts[1:])
                     + (len(parts) - 1) * _nbytes(total))
    return [total.to(d) for d in devices]


def all_gather(parts, devices, site: str = "") -> list:
    """The shards concatenated in shard order on each shard's device (one
    tensor per distinct device: on a mesh of one repeated device every
    shard reads the same copy). The comms counter is told what every mesh
    position receives (the other shards), whether its device repeats or
    not. Where `devices` is an Axis whose members span ranks, the shards
    of every rank come in through one all-gather first."""
    group = getattr(devices, "group", None)
    if group is not None:
        parts = _mh.exchange(parts, group)
    full = {}
    for d in devices:
        if d not in full:
            full[d] = torch.cat([p.to(d) for p in parts])
    if _comms.counting_on() and len(parts) > 1:
        total = sum(_nbytes(p) for p in parts)
        _comms.count(site, sum(total - _nbytes(p) for p in parts))
    return [full[d] for d in devices]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


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
    the kernels would engage but cannot run, it raises ValueError (a
    configuration the kernels refuse, kernel_supports) rather than run a
    plain step on the card unasked."""
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
    return True, ""


def finish_step(state: TrainState, outs, grid: list, cfg: BigClamConfig,
                grads=None, family: str = "sharded", extras=None) -> TrainState:
    """The psums that end a sharded step: `outs` holds, per shard,
    (F_new, column sums of F_new, LLH of the shard's rows, accepted-step
    histogram), F_new and the sums in the state's layout (a tensor, or at
    tp > 1 a tuple of column blocks); grid[i][j] is block (i, j)'s device;
    `grads` the shards' gradients, read only for the health pack on
    cadence iterations; `family` names the comms sites (sharded, ring or
    twod); `extras`, where given, the exchange counters the health pack
    latches every step (ops.diagnostics.latch_extras)."""
    F_new, sums, llhs, hists = zip(*outs)
    site = family
    first = column(grid, 0)
    sumF = as_layout(column_psum(block_grid(sums), grid, f"{site}/psum_sumF"))
    hist = psum(hists, first, f"{site}/psum_scalars")[0]
    health = None
    carry = None
    if extras is not None and dx.health_on(cfg):
        extras, carry = dx.latch_extras(state.health, extras)
    if dx.on_cadence(cfg, state.it):
        health = dx.health_pack(cfg, state.it, state.F, F_new,
                                row_shards((sumF[0],))[0], hist, grad=grads,
                                extras=extras)
    elif carry is not None:
        health = carry
    return TrainState(
        F=tuple(F_new),
        sumF=sumF,
        llh=psum(llhs, first, f"{site}/psum_scalars")[0].to(
            state_blocks(F_new)[0].dtype),
        it=state.it + 1,
        accept_hist=hist,
        health=health,
    )


def block_grid(F) -> list:
    """A mesh state tensor as a grid of blocks, [i][j] the block of shard i
    and column block j: [[f] for each shard] at tp = 1."""
    return [list(row) if isinstance(row, tuple) else [row] for row in F]


def as_layout(blocks: list) -> tuple:
    """A grid of blocks [i][j] as a state tensor (block_grid's inverse): a
    tuple of shards at tp = 1, of shards' tuples of column blocks at
    tp > 1."""
    return tuple(row[0] if len(row) == 1 else tuple(row) for row in blocks)


def column_psum(blocks: list, grid: list, site: str) -> list:
    """psum over the dp shards of each column block: blocks[i][j] in,
    [i][j] out (every shard of a column holds the same bits)."""
    dp, tp = len(grid), len(grid[0])
    cols = [psum([blocks[i][j] for i in range(dp)], column(grid, j), site)
            for j in range(tp)]
    return [[cols[j][i] for j in range(tp)] for i in range(dp)]


def kpsum(parts: list, row: list, site: str) -> list:
    """The psum over the k axis of one node row: the tp blocks' partials
    summed in block order and copied to every block's device; the identity
    at tp = 1. A row whose blocks span ranks (an Axis with a group) sums
    across them."""
    if len(parts) == 1 and getattr(row, "group", None) is None:
        return list(parts)
    return psum(parts, row, site)


def one_column(devices) -> Grid:
    """The grid of a tp = 1 mesh from its column of shard devices (an
    Axis keeps its nodes-axis group)."""
    return Grid([Axis([d]) for d in devices], (getattr(devices, "group", None),))


def armijo_tail_select_tp(
    F: list,
    grad: list,
    llh_nbr: list,
    cand_nbr: list,
    sumF: list,
    cfg: BigClamConfig,
    row: list,
    site: str,
):
    """The node tail, the Armijo tails, the acceptance test and the
    largest accepted step of one node row split into tp column blocks
    (JAX `armijo_tail_select_sharded` with the node tail of the tp steps):
    every row dot is the blocks' partials psummed over k, in one psum of
    (3 + 2S, n) rows (F.sumF, F.F, g.g, and per step nf.(sumF - F + nf) and
    nf.nf), so every block takes the same decisions. llh_nbr and cand_nbr
    are the same bits on every block's device. The per-step terms are made
    in place in two (n, K_loc) temporaries (obs/memory.py prices them as
    transient/tp_tails), the same bits as the expressions above. Returns
    (per block F_new, per block column sums of F_new, node LLH (n,) and
    acceptance mask (S, n) on the first block's device)."""
    adt = accum_dtype(cfg, F[0])
    parts = []
    for f, g, s in zip(F, grad, sumF):
        rows = [f @ s, (f * f).sum(dim=1), (g * g).sum(dim=1)]
        for eta in step_etas(cfg, f):
            nf = g * eta
            nf += f
            nf.clamp_(cfg.min_f, cfg.max_f)
            t = s[None, :] - f
            t += nf
            t *= nf
            rows.append(t.sum(dim=1))
            torch.mul(nf, nf, out=t)
            rows.append(t.sum(dim=1))
            del nf, t
        parts.append(torch.stack(rows))
    F_new, sums, node_llhs, oks = [], [], [], []
    for f, g, t, ln, cn in zip(F, grad, kpsum(parts, row, site), llh_nbr, cand_nbr):
        etas = step_etas(cfg, f)
        node_llh = ln.to(adt) + (-t[0] + t[1]).to(adt)
        gg = t[2].to(adt)
        cand_llh = cn.to(adt) + (-t[3::2] + t[4::2]).to(adt)
        ok = cand_llh >= node_llh[None, :] + cfg.alpha * etas[:, None] * gg[None, :]
        best = torch.where(ok, etas[:, None], torch.zeros_like(etas)[:, None])
        best = best.max(dim=0).values
        fn = g * best[:, None]
        fn += f
        fn = torch.where(ok.any(dim=0)[:, None], fn.clamp_(cfg.min_f, cfg.max_f), f)
        F_new.append(fn)
        sums.append(fn.sum(dim=0))
        node_llhs.append(node_llh)
        oks.append(ok)
    return F_new, sums, node_llhs[0], oks[0]


def make_tp_train_step(
    grid: list, csrs: list, cfg: BigClamConfig, path: str, kc: int
) -> Callable[[TrainState], TrainState]:
    """One all-gather iteration on the TP split (the K-blocked paths at any
    tp, every path at tp > 1): grid[i][j] is the device of block (i, j),
    csrs[i][j] shard i's CSR on it, kc the window (the block's K_loc where
    one window takes it). `xla` runs the kernels' plain versions. Its parts
    are timed under utils.profiling.step_split on the current stream of
    the first block's device, grid[0][0] (parallel.ring make_ring_tp_step
    says what that reads on one card and on distinct cards)."""
    dp, tp = len(grid), len(grid[0])
    # one column block a row, none on another rank: the k psums are the
    # identity and the node pass ends the step
    whole = tp == 1 and getattr(grid[0], "group", None) is None
    plain = path == "xla"
    fold = path in ("csr_fused", "csr_fused_kb")
    nbr = cand_nbr_from_x_plain if plain else cand_nbr_from_x

    def step(state: TrainState) -> TrainState:
        F = block_grid(state.F)
        d0 = grid[0][0]
        with part("gather", d0):
            sumF = column_psum([[f.sum(dim=0) for f in r] for r in F], grid,
                               "sharded/psum_sumF")
            F_full = [[None] * tp for _ in range(dp)]
            for j in range(tp):
                cols = all_gather([F[i][j] for i in range(dp)],
                                  column(grid, j), "sharded/all_gather_F")
                for i in range(dp):
                    F_full[i][j] = cols[i]
        outs, grads = [], []
        for i in range(dp):
            row, Fi, c = grid[i], F[i], csrs[i]
            w = kc or Fi[0].shape[1]
            with part("dots", d0):
                xs = [edge_dots_windows(Fi[j], c[j], w, F_full[i][j], plain)
                      for j in range(tp)]
            with part("k_psum", d0):
                x = kpsum(xs, row, "sharded/psum_k_x")
            with part("consume", d0):
                g, ln, xc = zip(*(
                    grad_cand_windows(x[j], Fi[j], sumF[i][j], c[j], cfg, w, fold,
                                      F_full[i][j], plain)
                    for j in range(tp)
                ))
            if whole:
                with part("tails", d0):
                    F_new, node_llh, ok = cand_select_from_x(
                        xc[0], Fi[0], sumF[i][0], g[0], ln[0], c[0], cfg)
                    outs.append((F_new, F_new.sum(dim=0), node_llh.sum(),
                                 accept_stats(ok)))
                grads.append(g[0])
                continue
            with part("k_psum", d0):
                xc = kpsum(list(xc), row, "sharded/psum_k_xc")
            with part("tails", d0):
                cn = [nbr(xc[j], c[j], cfg) for j in range(tp)]
                F_new, sums, node_llh, ok = armijo_tail_select_tp(
                    list(Fi), list(g), list(ln), cn, sumF[i], cfg, row,
                    "sharded/psum_k_rows")
                outs.append((tuple(F_new), tuple(sums), node_llh.sum(),
                             accept_stats(ok)))
            grads.append(tuple(g))
        with part("finish", d0):
            return finish_step(state, outs, grid, cfg, tuple(grads))

    return step


def make_sharded_train_step(
    devices: list, shards: List[DeviceCSR], cfg: BigClamConfig, path: str
) -> Callable[[TrainState], TrainState]:
    """One all-gather iteration on kernel path `path` (`csr_fused`, `csr`
    or `xla`); shards[i] is shard i's CSR (global destination ids) on
    devices[i] (an Axis where the shards span ranks)."""

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
        sumF = psum([f.sum(dim=0) for f in F], devices, "sharded/psum_sumF")
        F_full = all_gather(F, devices, "sharded/all_gather_F")
        outs, grads = zip(*(
            shard_update(F[i], sumF[i], shards[i], F_full[i])
            for i in range(len(devices))
        ))
        return finish_step(state, outs, one_column(devices), cfg, grads)

    return step


class ShardedBigClamModel(MemoryAccountedModel):
    """BigCLAM trainer over a (nodes, k) mesh, all-gather schedule. Mirrors
    models.bigclam.BigClamModel's API; the same trajectories (the sharding
    changes the schedule, not the math).

    Usage:
        mesh = make_mesh((4, 1), [torch.device("cuda:0")] * 4)
        model = ShardedBigClamModel(graph, cfg, mesh)
        result = model.fit(F0)              # F0: (N, K), original ids
    """

    def __init__(self, g: Graph, cfg: BigClamConfig, mesh: Mesh,
                 balance: bool = False):
        dp, tp = mesh.shape[NODES_AXIS], mesh.shape[K_AXIS]
        self.g = g
        self.cfg = cfg
        self.mesh = mesh
        self.dp, self.tp = dp, tp
        # grid[i][j]: the device of this process's block (row0 + i,
        # col0 + j) — every block of a single-controller mesh; devices:
        # each local row's first, as the nodes axis of local column 0
        self.grid = mesh.grid(resolve_device)
        self.devices = column(self.grid, 0)
        self.row0, self.col0 = mesh.origin
        self.device = self.devices[0]
        self.dtype = resolve_dtype(cfg.dtype, self.device)
        if cfg.min_f != 0.0:
            raise ValueError("sharded padding requires min_f == 0.0")
        self.n_pad = _round_up(max(g.num_nodes, dp), dp)
        self.kernels, self.path_reason = mesh_kernels_want(cfg, self.device, self.dtype)
        self.kc, self.k_pad = mesh_k_plan(
            cfg.num_communities, tp, self.kernels, cfg.csr_k_block)
        if self.kernels:
            check_k_block(self.kc or self.k_pad // tp, self.device)
        # degree-balanced relabeling (parallel/balance.py): the trainer runs
        # on the relabeled graph; F0 in and results out stay in original ids
        self._perm = None
        self.g_original = g
        if balance and dp > 1:
            self.g, self._perm = balance_graph(g, dp, self.n_pad)
        self._build_edges_and_step()
        # the comms and memory models (obs.comms, obs.memory), baked from
        # the built layout
        self._bake_models()

    @property
    def engaged_path(self) -> str:
        """The kernel path of this trainer's step."""
        if not self.kernels:
            return "xla"
        if self.kc:
            return "csr_fused_kb" if csr_fused_want(self.cfg) else "csr_grouped_kb"
        return "csr_fused" if csr_fused_want(self.cfg) else "csr"

    @property
    def tp_split(self) -> bool:
        """Does the step run the TP split (make_tp_train_step): the
        K-blocked paths, and every path at tp > 1."""
        return self.tp > 1 or (self.kernels and bool(self.kc))

    def _position_shards(self):
        """(global node row, (indptr, indices)) of each node row this
        process holds: its CSR over its rows, destinations global
        (shard_edges)."""
        shards = shard_edges(self.g, self.dp, self.n_pad)
        return ((i, shards[i]) for i in self.mesh.local_rows())

    def _on_row(self, i: int, csr) -> list:
        """Shard i's CSR (or its list of ring buckets) on each block device
        of its row: the same tensors where a device repeats."""
        def to(d):
            if isinstance(csr, DeviceCSR):
                return csr_to(csr, d)
            return [csr_to(c, d) for c in csr]

        copies = {self.devices[i]: csr}
        for d in self.grid[i]:
            if d not in copies:
                copies[d] = to(d)
        return [copies[d] for d in self.grid[i]]

    def _build_edges_and_step(self) -> None:
        self.shard_csr = [
            device_csr(indptr, indices, self.devices[i - self.row0])
            for i, (indptr, indices) in self._position_shards()
        ]
        self.block_csr = [self._on_row(i, c) for i, c in enumerate(self.shard_csr)]
        self.rebuild_step()

    def rebuild_step(self) -> None:
        """(Re)build the train step for the CURRENT self.cfg on the built
        edge layout."""
        if self.tp_split:
            self._step = make_tp_train_step(
                self.grid, self.block_csr, self.cfg, self.engaged_path, self.kc)
        else:
            self._step = make_sharded_train_step(
                self.devices, self.shard_csr, self.cfg, self.engaged_path
            )
        self._note_step_build()

    # ------------------------------------------- comms and memory models
    def _llh_itemsize(self) -> int:
        """Bytes of a shard's LLH partial: the kernels' node LLH is in F's
        dtype, the plain sweeps' in the accumulation dtype."""
        if self.kernels:
            return self.itemsize
        adt = accum_dtype(self.cfg, torch.empty((), dtype=self.dtype))
        return torch.empty((), dtype=adt).element_size()

    def _build_comms_model(self):
        return _comms.sharded_step_model(
            self.n_pad, self.k_pad, self.dp, self.itemsize,
            len(self.cfg.step_candidates), llh_itemsize=self._llh_itemsize(),
            model=type(self).__name__, tp=self.tp,
            edges=self.g.num_directed_edges,
        )

    def comms_measured(self, state: TrainState):
        """The comms model re-priced from the bytes the collective helpers
        pass in one step from `state` (obs.comms.measured_step; the new
        state is dropped)."""
        return _comms.measured_step(self.comms, self._step, state)[0]

    # what evens the shards' edge counts, named by the balance telemetry
    _balance_hint = "relabel (--balance)"

    def _shard_edge_counts(self) -> np.ndarray:
        return shard_edge_counts(self.g.src, self.n_pad, self.dp)

    def _emit_balance(self) -> None:
        from bigclam_tpu_torch.obs import telemetry as _obs

        if _obs.current() is None:
            return
        dp = self.dp
        _comms.emit_shard_balance(
            "shard_edges", self._shard_edge_counts(), dp,
            process_count=_process_count(),
            hint=self._balance_hint, model=type(self).__name__, dp=dp,
        )

    def _position_graph(self, positions) -> dict:
        """The graph tensors of the given mesh positions, by name."""
        csrs = [self.shard_csr[i] for i in positions]
        return {
            "graph/shard_csr_indptr": [c.indptr for c in csrs],
            "graph/shard_csr_indices": [c.indices for c in csrs],
            "graph/shard_csr_src": [c.src for c in csrs],
            "graph/shard_csr_dst": [c.dst for c in csrs],
        }

    def _graph_device_arrays(self) -> dict:
        return self._position_graph(range(len(self.devices)))

    def _busiest_device(self) -> tuple:
        """(device, its mesh positions, its graph bytes by name) of the
        device holding the most state + graph bytes: the one the memory
        model describes (every device, on distinct cards, holds about the
        same). A position is a block (i, j) of the grid; the graph bytes
        are those of the shards whose blocks it holds."""
        n_loc = self.n_pad // self.dp
        k_loc = self.k_pad // self.tp
        best = None
        cells = [(i, j, d) for i, row in enumerate(self.grid) for j, d in enumerate(row)]
        for d in dict.fromkeys(c[2] for c in cells):
            pos = [(i, j) for i, j, x in cells if x == d]
            gb = _mem.bytes_by_name(self._position_graph(
                sorted({i for i, _ in pos})))
            state = (len(pos) * n_loc + 1) * k_loc * self.itemsize
            if d == self.devices[0]:
                state += self.itemsize + len(self.cfg.step_candidates) * 4 + 4
            total = state + sum(gb.values())
            if best is None or total > best[0]:
                best = (total, d, pos, gb)
        return best[1:]

    def _build_memory_model(self):
        cfg = self.cfg
        d, pos, gb = self._busiest_device()
        k_loc = self.k_pad // self.tp
        return _mem.sharded_memory_model(
            self.n_pad, k_loc, self.dp, self.itemsize,
            len(cfg.step_candidates), gb,
            "csr_grouped_kb" if self.tp > 1 else self.engaged_path,
            max(self.shard_csr[i].num_directed_edges for i, _ in pos),
            positions=len(pos), first_device=d == self.devices[0],
            gathers=len({j for _, j in pos}) if self.dp > 1 else 0,
            chunk=edge_chunk_bound(cfg, k_loc, self.itemsize),
            health_on=int(cfg.health_every or 0) > 0,
            rollback=int(cfg.rollback_budget or 0) > 0,
            comms=self.comms, model=type(self).__name__, tp=self.tp,
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
        """TrainState from a host (n_pad, k_pad) F in internal row order:
        one block per mesh position this process holds (whole rows of a
        shard at tp = 1), placed as multihost.put_sharded does."""
        rows = self.n_pad // self.dp
        lo = self.row0 * rows
        blocks = _mh.place_rows(F_host[lo : lo + len(self.grid) * rows],
                                self.grid, self.tp, self.col0, self.dtype)
        return self.reset_state(as_layout(blocks), llh=llh, it=it)

    def health_sig(self, state: TrainState) -> torch.Tensor:
        """(n_pad,) int32 top-community signature of the shards, in the
        trainer's row order (padding rows are -1 forever)."""
        return dx.dense_top_community(state.F)

    def reset_state(self, F, llh: Optional[float] = None, it: int = 0) -> TrainState:
        """TrainState around per-shard padded F tensors: sumF through the
        psum, LLH -inf until a step evaluates one, a zero histogram."""
        sums = column_psum([[f.sum(dim=0) for f in r] for r in block_grid(F)],
                           self.grid, "")
        return TrainState(
            F=tuple(F),
            sumF=as_layout(sums),
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
        """Fetch the live (N, K) F block to the host in ORIGINAL node ids
        (on a multi-process mesh every rank gets all of it:
        multihost.fetch_global)."""
        n, k = self.g.num_nodes, self.cfg.num_communities
        F = _mh.fetch_global(state.F, self.mesh)
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
            "node_shards": self.dp if self._perm is not None else 0,
            "seed": self.cfg.seed,
        }

    def _state_to_arrays(self, state: TrainState) -> dict:
        # a collective on a multi-process mesh: every rank enters it
        return {
            "F": _mh.fetch_global(state.F, self.mesh),
            "sumF": _mh.fetch_rows(state.sumF, self.mesh)[0],
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


# --------------------------------------------------------------------------
# store-backed trainers: one cache shard per mesh position
# --------------------------------------------------------------------------


class _StoreGraphView:
    """Graph-shaped scalar metadata for the store-backed trainers (JAX
    `_StoreGraphView`): the sizes the training loop needs. Global CSR
    arrays deliberately do not exist — touching .src/.dst/.indptr here is
    the bug this class turns into a loud error."""

    def __init__(self, store):
        self.num_nodes = store.num_nodes
        self.num_directed_edges = store.num_directed_edges
        self.num_edges = store.num_directed_edges // 2

    def __getattr__(self, name):
        raise AttributeError(
            f"store-backed trainer has no global CSR (asked for {name!r}); "
            "load the full graph with GraphStore.load_graph() if you "
            "really need it on this host"
        )


class StoreBacked:
    """The plumbing the store-backed trainers share (JAX
    `_StoreBackedMixin`): the shard-count check, one load of this
    process's shard range (`host_shard`) split into the per-position CSRs
    with their `files_read`, the manifest's edge
    counts for the balance telemetry, and the per-position row-keyed
    init. Balance is baked at ingest (`cli ingest --balance`): the cache's
    node order is the trainer's row order, and results come back in cache
    order (map to original ids through the cache's raw_ids)."""

    def _store_init(self, store, mesh: Mesh, verify: bool) -> None:
        dp = mesh.shape[NODES_AXIS]
        if store.num_shards != dp:
            raise ValueError(
                f"cache has {store.num_shards} shards but the mesh has "
                f"dp={dp} node shards; recompile with --shards {dp}"
            )
        self.store = store
        self._shard_verify = verify
        # per mesh position: the cache blobs its load opened
        self.files_read: List[tuple] = []

    def _check_rows(self) -> None:
        dp = self.dp
        if self.n_pad != dp * self.store.rows_per_shard:
            raise ValueError(
                f"cache rows_per_shard={self.store.rows_per_shard} x dp={dp} "
                f"!= the trainer's n_pad={self.n_pad}"
            )

    def _position_shards(self):
        """(global node row, (indptr, indices)) for each node row this
        process holds, from ONLY its own shard files: one load of the
        rank's shard range (multihost.load_shard_ids, kept as
        `host_shard`: shard_ids, lo, hi, files_read), recording each
        position's files_read."""
        self._check_rows()
        rows = self.n_pad // self.dp
        n = self.store.num_nodes
        local = self.mesh.local_rows()
        hs = _mh.load_shard_ids(self.store, local, self._shard_verify)
        self.host_shard = hs
        self.files_read = [
            tuple(f for f in hs.files_read if f.startswith(f"shard_{i:05d}."))
            for i in local
        ]
        for i in local:
            a, b = min(i * rows, n) - hs.lo, min((i + 1) * rows, n) - hs.lo
            e0, e1 = int(hs.indptr[a]), int(hs.indptr[b])
            # the position's rows rebased to its first edge, extended with
            # empty rows past N: the form shard_edges gives
            indptr = np.full(rows + 1, e1 - e0, dtype=np.int64)
            indptr[: b - a + 1] = hs.indptr[a : b + 1] - e0
            yield i, (indptr, hs.indices[e0:e1])

    _balance_hint = "re-ingest the cache with --balance"

    def _shard_edge_counts(self) -> np.ndarray:
        """Per-shard directed-edge counts from the store MANIFEST."""
        return np.asarray(
            [int(e["edges"]) for e in self.store.manifest["shards"]],
            dtype=np.int64,
        )

    def _host_memory_model(self):
        cfg = self.cfg
        return _mem.host_rss_model(
            self.g.num_nodes, self.g.num_directed_edges, cfg.num_communities,
            self.itemsize, n_pad=self.n_pad, k_pad=self.k_pad,
            store_native=True, num_shards=self.dp,
        )

    def init_state(self, F0: Optional[np.ndarray] = None) -> TrainState:
        """With F0=None each position seeds ONLY its own rows from the
        row-keyed counter init (models.bigclam.rowkeyed_init_rows: entry
        (r, c) is a pure function of (seed, r, c)), so no (N, K) F0 array
        exists; bit for bit the in-memory trainers' init_state(None). An
        explicit F0 (cache order) takes the host-global upload."""
        if F0 is not None:
            return super().init_state(F0)
        n, k = self.g.num_nodes, self.cfg.num_communities
        rows = self.n_pad // self.dp
        cols = self.k_pad // self.tp
        F = []
        for il, row in enumerate(self.grid):
            i = self.row0 + il
            lo, hi = i * rows, min((i + 1) * rows, n)
            local = np.zeros((rows, self.k_pad), dtype=np.float64)
            if hi > lo:
                local[: hi - lo, :k] = rowkeyed_init_rows(lo, hi, k, self.cfg.seed)
            Ft = torch.from_numpy(local).to(self.dtype)
            F.append([Ft[:, (self.col0 + jl) * cols : (self.col0 + jl + 1) * cols]
                      .to(d).contiguous() for jl, d in enumerate(row)])
        return self.reset_state(as_layout(F))


class StoreShardedBigClamModel(StoreBacked, ShardedBigClamModel):
    """The all-gather trainer fed from a compiled graph cache, one shard
    file per mesh position (JAX `StoreShardedBigClamModel`). The step is
    ShardedBigClamModel's on the same CSRs, so the trajectory is bit for
    bit ShardedBigClamModel(balance=False) on the cache's graph.

    Usage:
        store = GraphStore.open("g.cache")      # compiled with --shards 4
        model = StoreShardedBigClamModel(store, cfg, make_mesh((4, 1), devs))
    """

    def __init__(self, store, cfg: BigClamConfig, mesh: Mesh,
                 verify: bool = True):
        self._store_init(store, mesh, verify)
        super().__init__(_StoreGraphView(store), cfg, mesh, balance=False)
