"""Communication-avoiding 2D edge-block partition: the node axis factored
into R processor rows x C replica cols, so a position exchanges only its
row group's F rows and the closure of rows its edges touch, instead of
all-gathering F.

Port of bigclam_tpu/parallel/twod.py (the single-controller half:
`twod_mesh_shape`, `TwoDLayout`, the layout helpers, `twod_shard_edges`,
`twod_shard_edges_local`, `make_twod_train_step`,
`make_twod_csr_train_step`, `TwoDShardedBigClamModel`,
`StoreTwoDShardedBigClamModel`). The mesh is parallel/mesh.py's `Mesh2D`:
position (i, j) owns node block b = i * C + j (the 1D block order), and
one process launches every position's work on its device, which may
repeat (the JAX CLI refuses `--distributed` with `--partition 2d` too).

Layout. F is a tuple of p = R * C blocks of n_pad / p rows, one a
position, as the 1D all-gather trainer's row shards (parallel/mesh.py
`row_shards` reads both). Edge block (i, j) holds the directed edges whose
source lies in row group i (blocks i*C .. i*C + C - 1) and whose
destination lies in column stripe j ({b : b % C == j}); the port keeps it
as one DeviceCSR over the row group's C * n_blk rows whose indices are
CLOSURE positions i_con * cap + rank: rows of the (R * cap, K) table the
closure exchange fills (the JAX layout pads (chunks, chunk) edge arrays
or CSR tiles for the TPU; the CUDA kernels read a CSR, so there is no tile
layout and no padding economy gate). `send_idx` (R, cap) of each position
lists the rows of its block each row group's edges touch.

One step, position (i, j):

    sumF     psum over all positions of the blocks' column sums
    F_row    all-gather over cols: row group i's C * n_blk source rows
    closure  all-to-all over rows: the (R * cap, K) table of every
             destination row the edge block touches
    sweeps   the gradient/LLH sweep and the 16-candidate sweep over the
             edge block, destination rows read from the closure table
    grad     the row group's gradient over cols: the dense psum, or
             (grad_exchange "closure", C > 1) the touched-rows exchange
             (parallel.sparse_collectives.closure_grad_allreduce) with a
             per-step dense fallback on cap overflow
    scatter  psum_scatter over cols of the candidate and LLH sums: each
             position keeps its own n_blk rows
    Armijo   on the position's own rows; sumF, LLH and the histogram psum

on the kernel paths (JAX `make_twod_csr_train_step`'s dispatch):

* `csr_fused_2d`, C = 1: kernel A (ops.fused `fused_superstep`) per
  position with the closure table as its destination rows. Every psum
  spans the mesh, so the step is the 1D all-gather trainer's bit for bit.
* `csr_fused_2d_kb`, C = 1: the K-blocked windows (`edge_dots_windows`,
  `grad_cand_windows`) on the closure table, then the node pass
  `cand_select_from_x` (#7), as the 1D mesh's K-blocked step.
* `csr_fused_2d`, C > 1: kernels #8 and #9 (ops.ring_kernels) over the
  row group's rows with the closure table in the rotating shard's place,
  around the grad exchange and the psum_scatters; the tails through the
  `armijo_tail_select` epilogue on the own block.
* `csr_fused_2d_kb`, C > 1: `edge_dots_kb` (directed) and `grad_from_x_kb`
  (fold off), the grad exchange and the fold BETWEEN the scans, then
  `cand_dots_kb` and `cand_nbr_from_x`; the tails as above.
* `xla_2d`: the plain torch sweeps (ops.objective `neighbour_sums`,
  ops.linesearch `candidates_pass`) in the same schedule; the CPU path
  and the float64 oracle. At C = 1 it is the 1D `xla` step bit for bit.

Every collective goes through a counted helper (obs.comms): the
all-gather, the closure all-to-all, the grad psum or exchange, the
psum_scatters, the psums of sumF and the scalars.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph, host_tensor
from bigclam_tpu_torch.models.bigclam import (
    _round_up,
    check_k_block,
    csr_fused_want,
    csr_want_reason,
    mesh_k_plan,
)
from bigclam_tpu_torch.obs import comms as _comms
from bigclam_tpu_torch.obs import memory as _mem
from bigclam_tpu_torch.ops.csr_kernels import edge_chunks, kernel_supports
from bigclam_tpu_torch.ops.fused import fused_superstep
from bigclam_tpu_torch.ops.kblocked import (
    cand_dots_kb,
    cand_nbr_from_x,
    cand_select_from_x,
    edge_dots_windows,
    grad_cand_windows,
    grad_from_x_kb,
)
from bigclam_tpu_torch.ops.linesearch import accept_stats, candidates_pass
from bigclam_tpu_torch.ops.objective import accum_dtype, neighbour_sums, node_tail
from bigclam_tpu_torch.ops.ring_kernels import ring_cand_phase, ring_grad_phase
from bigclam_tpu_torch.parallel.balance import balance_graph
from bigclam_tpu_torch.parallel.mesh import COLS_AXIS, K_AXIS, ROWS_AXIS, Mesh2D
from bigclam_tpu_torch.parallel.sharded import (
    ShardedBigClamModel,
    StoreBacked,
    _nbytes,
    _StoreGraphView,
    all_gather,
    armijo_tail_select_sharded,
    device_csr,
    finish_step,
    psum,
)
from bigclam_tpu_torch.parallel.sparse_collectives import (
    closure_grad_allreduce,
    pmax,
)
from bigclam_tpu_torch.utils.device import resolve_device, resolve_dtype
from bigclam_tpu_torch.utils.profiling import part

# comms sites (the JAX names, obs.comms twod_step_model)
SITE_GATHER = "twod/allgather_srcF"
SITE_CLOSURE = "twod/alltoall_closure"
SITE_GRAD_CLOSURE = "twod/alltoall_grad_closure"
SITE_GRAD_COUNT = "twod/pmax_grad_count"
SITE_GRAD_COUNT_ROWS = "twod/pmax_grad_count_rows"
SITE_PSUM_GRAD = "twod/psum_grad"
SITE_SCATTER_CAND = "twod/psum_scatter_cand"
SITE_SCATTER_LLH = "twod/psum_scatter_nbr_llh"

PATHS = ("xla_2d", "csr_fused_2d", "csr_fused_2d_kb")


class TwoDKernelError(ValueError):
    """A 2D configuration the CUDA kernels cannot take on a card (the
    split-suite fallback, or what `kernel_supports` refuses); the card
    never runs `xla_2d` unasked."""


# --- host layout (copied from bigclam_tpu/parallel/twod.py) -------------------


def twod_mesh_shape(cfg: BigClamConfig, num_devices: int) -> Tuple[int, int]:
    """(R, C) for `num_devices` chips under cfg.replica_cols."""
    C = max(int(cfg.replica_cols or 1), 1)
    if num_devices % C:
        raise ValueError(
            f"replica_cols={C} does not divide the device count "
            f"{num_devices}; pick a divisor"
        )
    return (num_devices // C, C)


@dataclasses.dataclass(frozen=True)
class TwoDLayout:
    """Host-side 2D edge-block layout: each edge block's CSR over its row
    group's rows (`blocks[b]` = (indptr (C*n_blk+1,) int64, indices int32
    closure positions), in block order; the JAX layout's padded edge
    arrays), the (blocks, R, cap) contributor send lists, the telemetry
    counts, and the touched-rows grad-exchange tables (None at C = 1):
    out/in (blocks, C, grad_cap) int32, out ids group-local with sentinel
    C*n_blk, in ids block-local with sentinel n_blk, grad_counts each
    block's TRUE worst pair size."""

    blocks: List[Tuple[np.ndarray, np.ndarray]]
    send_idx: np.ndarray
    cap: int
    block_edge_counts: np.ndarray      # per edge block, row-major (i, j)
    closure_rows: int                  # real (unpadded) closure rows/step
    grad_out: Optional[np.ndarray] = None
    grad_in: Optional[np.ndarray] = None
    grad_counts: Optional[np.ndarray] = None
    grad_cap: int = 0                  # baked table width (0 = no rows)
    grad_pair_max: int = 0             # exact global worst pair size


def _grad_table_cap(cfg: BigClamConfig, pair_max: int, n_blk: int) -> int:
    """Exchange-table width: an explicit cfg.closure_grad_cap is clamped
    to the block size (wider than n_blk can never pay — the dense psum
    already moves n_blk rows); 0 means auto = the exact baked worst pair
    size, so the auto cap never overflows at runtime."""
    explicit = int(getattr(cfg, "closure_grad_cap", 0) or 0)
    if explicit > 0:
        return min(explicit, n_blk)
    return int(pair_max)


def _pack_grad_tables(
    out_sets, in_sets, C: int, n_blk: int, group_rows: int, gcap: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack per-block touched-row sets into the fixed-width int32 tables
    closure_grad_allreduce consumes. `out_sets[b][c]` are the group-local
    rows of block c this edge block touches (sentinel-filled to
    group_rows); `in_sets[b][c]` are the block-local rows of block b
    that peer column c touches (sentinel n_blk). Entries past `gcap` are
    truncated — the per-block true worst size in the returned counts is
    what flips the runtime to the dense psum when that happens."""
    nloc = len(out_sets)
    out_tab = np.full((nloc, C, max(gcap, 1)), group_rows, dtype=np.int32)
    in_tab = np.full((nloc, C, max(gcap, 1)), n_blk, dtype=np.int32)
    counts = np.zeros(nloc, dtype=np.int32)
    for r in range(nloc):
        worst = 0
        for c in range(C):
            o = np.asarray(out_sets[r][c], dtype=np.int64)
            i_ = np.asarray(in_sets[r][c], dtype=np.int64)
            worst = max(worst, int(o.size), int(i_.size))
            if gcap > 0:
                out_tab[r, c, : min(o.size, gcap)] = o[:gcap]
                in_tab[r, c, : min(i_.size, gcap)] = i_[:gcap]
        counts[r] = worst
    return out_tab, in_tab, counts


def _remap_dst(dsel: np.ndarray, unions, n_blk: int, C: int,
               cap: int) -> np.ndarray:
    """Global dst ids -> closure positions i_con*cap + rank-in-union."""
    pos = np.empty(dsel.shape[0], dtype=np.int64)
    icon = (dsel // n_blk) // C
    for i_con in np.unique(icon):
        sel = icon == i_con
        pos[sel] = i_con * cap + np.searchsorted(
            unions[int(i_con)], dsel[sel]
        )
    return pos


def _block_csr(src_local: np.ndarray, pos: np.ndarray,
               group_rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """One edge block as a CSR over its row group's rows: the group-local
    sources (CSR order, so already sorted) and their closure positions."""
    indptr = np.zeros(group_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(src_local, minlength=group_rows), out=indptr[1:])
    return indptr, np.asarray(pos, dtype=np.int32)


def _grad_sets(touched, R: int, C: int, n_blk: int, blocks) -> tuple:
    """The grad-exchange sets of twod_shard_edges: touched[(i, j)] are the
    sorted group-local src rows of edge block (i, j); returns (pair_max,
    out_sets, in_sets) over `blocks` (b = i * C + j)."""
    def seg(i: int, j: int, c: int) -> np.ndarray:
        # touched(i, j) rows falling in block (i, c)'s group-local range
        t = touched[(i, j)]
        lo = np.searchsorted(t, c * n_blk)
        hi = np.searchsorted(t, (c + 1) * n_blk)
        return t[lo:hi]

    groups = sorted({b // C for b in blocks})
    pair_max = max(
        (seg(i, j, c).size for i in groups for j in range(C) for c in range(C)),
        default=0,
    )
    out_sets = [[seg(b // C, b % C, c) for c in range(C)] for b in blocks]
    in_sets = [[seg(b // C, c, b % C) - (b % C) * n_blk for c in range(C)]
               for b in blocks]
    return int(pair_max), out_sets, in_sets


def twod_shard_edges(g: Graph, cfg: BigClamConfig, R: int, C: int,
                     n_pad: int) -> TwoDLayout:
    """Partition directed edges into R*C edge BLOCKS: block (i, j) holds
    the edges with src in processor row i's node blocks and dst in column
    stripe j ({b : b % C == j}) (JAX `twod_shard_edges`).

    CSR order means each row group's edges are one contiguous slice and
    the stable stripe selection preserves it, so at C == 1 each block's
    CSR is the 1D shard's with its destinations renamed to closure
    positions, in the same order (the rename is monotone): the
    bit-identity anchor. src is group-LOCAL ([0, C*n_blk)); dst a CLOSURE
    position i_con*cap + rank."""
    p = R * C
    n_blk = n_pad // p
    group_rows = C * n_blk
    gsrc = np.asarray(g.src)
    gdst = np.asarray(g.dst)
    gb = np.searchsorted(
        gsrc, np.arange(0, n_pad + group_rows, group_rows)
    )
    sel: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = {}
    lists: Dict[Tuple[int, int, int], np.ndarray] = {}
    counts = np.zeros((R, C), dtype=np.int64)
    for i in range(R):
        s_i = gsrc[gb[i]:gb[i + 1]].astype(np.int64)
        d_i = gdst[gb[i]:gb[i + 1]].astype(np.int64)
        dblk = d_i // n_blk
        for j in range(C):
            m = (dblk % C) == j
            dsel = d_i[m]
            sel[(i, j)] = (s_i[m] - i * group_rows, dsel)
            counts[i, j] = dsel.size
            icon = dblk[m] // C
            for i_con in range(R):
                # union over the group's shards of out(s -> block): the
                # rows of block (i_con, j) this edge block must gather
                lists[(i, j, i_con)] = np.unique(dsel[icon == i_con])
    cap = max(1, max((u.size for u in lists.values()), default=1))
    blocks = []
    send_idx = np.zeros((p, R, cap), dtype=np.int32)
    for i in range(R):
        for j in range(C):
            b = i * C + j
            s_l, d_l = sel[(i, j)]
            blocks.append(_block_csr(s_l, _remap_dst(
                d_l, {ic: lists[(i, j, ic)] for ic in range(R)},
                n_blk, C, cap,
            ), group_rows))
            # contributor side of the SAME lists: block b sends each
            # requester row group the rows that group's edges touch
            lo_b = b * n_blk
            for i_req in range(R):
                u = lists[(i_req, j, i)]
                send_idx[b, i_req, :u.size] = (u - lo_b).astype(np.int32)
    grad_out = grad_in = grad_counts = None
    grad_cap = pair_max = 0
    if C > 1:
        touched = {key: np.unique(v[0]) for key, v in sel.items()}
        pair_max, out_sets, in_sets = _grad_sets(touched, R, C, n_blk, range(p))
        grad_cap = _grad_table_cap(cfg, pair_max, n_blk)
        grad_out, grad_in, grad_counts = _pack_grad_tables(
            out_sets, in_sets, C, n_blk, group_rows, grad_cap
        )
    return TwoDLayout(
        blocks=blocks,
        send_idx=send_idx,
        cap=cap,
        block_edge_counts=counts.reshape(-1),
        closure_rows=int(sum(u.size for u in lists.values())),
        grad_out=grad_out,
        grad_in=grad_in,
        grad_counts=grad_counts,
        grad_cap=grad_cap,
        grad_pair_max=int(pair_max),
    )


def twod_shard_edges_local(shard, pair_lists: Dict[int, tuple],
                           cfg: BigClamConfig, R: int, C: int,
                           n_pad: int) -> TwoDLayout:
    """The 2D edge blocks from a graph-store slice (graph/store.HostShard of
    every shard: the single controller owns them all) and the shards'
    closure triples (JAX `twod_shard_edges_local`): no global CSR is
    assembled.

    `pair_lists` maps each shard s to its (out_ids, in_ids, edge_counts)
    closure triple — the ingest-baked v3 lists
    (GraphStore.load_closure_lists) or the v2 streaming fallback
    (store.closure_pair_lists on the shard's own CSR). The gather unions
    come from the requester group's out-lists, the send lists from the
    owned block's in-lists — identical sets by edge symmetry. A None pair
    (the bake's cap overflow) degrades to the FULL dst block on both
    sides. The JAX cross-host max exchanges of the padded geometry are the
    identity on one controller."""
    p = R * C
    n_blk = n_pad // p
    group_rows = C * n_blk
    if shard.rows_per_shard != n_blk:
        raise ValueError(
            f"cache rows_per_shard={shard.rows_per_shard} != trainer "
            f"block rows {n_blk} (n_pad={n_pad}, rows*cols={p}); "
            "recompile the cache with num_shards == rows*cols"
        )
    own = list(shard.shard_ids)
    if own and (own[0] % C or len(own) % C):
        raise ValueError(
            "store-native 2d needs every process to own whole processor "
            f"rows: first owned shard {own[0]} and owned count {len(own)} "
            f"must be multiples of replica_cols={C} — use dp_rows "
            "divisible by the process count (or fewer cols)"
        )
    n = shard.num_nodes

    def full_block(b: int) -> np.ndarray:
        return np.arange(b * n_blk, min((b + 1) * n_blk, n), dtype=np.int64)

    def union_over_group(i_req: int, b_con: int, side: int) -> np.ndarray:
        """Union over requester group i_req's shards of the pair lists
        against block b_con; side 0 = out (gather), 1 = in (send)."""
        parts = []
        for s in range(i_req * C, (i_req + 1) * C):
            lst = (
                pair_lists[s][0][b_con] if side == 0
                else pair_lists[b_con][1][s]
            )
            if lst is None:
                return full_block(b_con)
            parts.append(np.asarray(lst, dtype=np.int64))
        if not parts:
            return np.empty(0, dtype=np.int64)
        return np.unique(np.concatenate(parts))

    groups = range(own[0] // C, (own[-1] + 1) // C) if own else range(0)
    unions: Dict[Tuple[int, int, int], np.ndarray] = {}
    for i in groups:
        for j in range(C):
            for i_con in range(R):
                unions[(i, j, i_con)] = union_over_group(
                    i, i_con * C + j, side=0
                )
    sends: Dict[Tuple[int, int], np.ndarray] = {}
    for b in own:
        for i_req in range(R):
            sends[(b, i_req)] = union_over_group(i_req, b, side=1)
    cap = max(
        [u.size for u in unions.values()]
        + [u.size for u in sends.values()] + [1]
    )

    deg = np.diff(shard.indptr)
    sel: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = {}
    for i in groups:
        glo = min(i * group_rows, n)
        ghi = min((i + 1) * group_rows, n)
        e0 = int(shard.indptr[glo - shard.lo])
        e1 = int(shard.indptr[ghi - shard.lo])
        srcs = np.repeat(
            np.arange(glo, ghi, dtype=np.int64),
            deg[glo - shard.lo: ghi - shard.lo],
        )
        dsts = np.asarray(shard.indices[e0:e1], dtype=np.int64)
        stripe = (dsts // n_blk) % C
        for j in range(C):
            m = stripe == j
            sel[(i, j)] = (srcs[m] - i * group_rows, dsts[m])
            got = int(m.sum())
            want = sum(
                pair_lists[s][2][i_con * C + j]
                for s in range(i * C, (i + 1) * C)
                for i_con in range(R)
            )
            if got != want:
                raise ValueError(
                    f"edge block ({i}, {j}): closure lists say {want} "
                    f"directed edges but the loaded CSR holds "
                    f"{got} — cache inconsistent (partially "
                    "rebuilt, or loaded with verify=False?)"
                )
    blocks = []
    send_idx = np.zeros((len(own), R, cap), dtype=np.int32)
    local_counts = np.zeros(len(own), dtype=np.int64)
    for row, b in enumerate(own):
        i, j = b // C, b % C
        s_l, d_l = sel[(i, j)]
        local_counts[row] = s_l.size
        blocks.append(_block_csr(s_l, _remap_dst(
            d_l, {ic: unions[(i, j, ic)] for ic in range(R)},
            n_blk, C, cap,
        ), group_rows))
        lo_b = b * n_blk
        for i_req in range(R):
            u = sends[(b, i_req)]
            send_idx[row, i_req, :u.size] = (u - lo_b).astype(np.int32)
    grad_out = grad_in = grad_counts = None
    grad_cap = pair_max = 0
    if C > 1:
        def stripe_in(s_shard: int, j: int) -> np.ndarray:
            # global ids of shard s_shard's rows with an edge into stripe
            # j — the union of its baked in-lists against the stripe's
            # blocks; by edge symmetry this equals the src-touched set. A
            # None pair degrades to the full block: a superset only adds
            # rows whose partials are exactly 0.0
            parts = []
            for i_con in range(R):
                lst = pair_lists[s_shard][1][i_con * C + j]
                if lst is None:
                    return full_block(s_shard)
                parts.append(np.asarray(lst, dtype=np.int64))
            if not parts:
                return np.empty(0, dtype=np.int64)
            return np.unique(np.concatenate(parts))

        touched = {}
        for i in groups:
            for j in range(C):
                touched[(i, j)] = np.concatenate(
                    [stripe_in(i * C + c, j) for c in range(C)]
                ) - i * group_rows
        pair_max, out_sets, in_sets = _grad_sets(touched, R, C, n_blk, own)
        grad_cap = _grad_table_cap(cfg, pair_max, n_blk)
        grad_out, grad_in, grad_counts = _pack_grad_tables(
            out_sets, in_sets, C, n_blk, group_rows, grad_cap
        )
    return TwoDLayout(
        blocks=blocks,
        send_idx=send_idx,
        cap=cap,
        block_edge_counts=local_counts,
        closure_rows=int(sum(u.size for u in unions.values())),
        grad_out=grad_out,
        grad_in=grad_in,
        grad_counts=grad_counts,
        grad_cap=grad_cap,
        grad_pair_max=int(pair_max),
    )


# --- the step -----------------------------------------------------------------


class TwoDTrainState(NamedTuple):
    """models.bigclam.TrainState plus the touched-rows exchange counters
    of a closure-grad step (comm_ids: the largest pair size a row group
    exchanged; comm_dense: 1 when a row group fell back to the dense psum;
    None on a step without the exchange)."""

    F: tuple
    sumF: tuple
    llh: torch.Tensor
    it: int
    accept_hist: torch.Tensor
    health: Optional[torch.Tensor] = None
    comm_ids: Optional[torch.Tensor] = None
    comm_dense: Optional[torch.Tensor] = None


def closure_grad_wanted(cfg: BigClamConfig, C: int, grad_tabs) -> bool:
    """Does the step carry the touched-rows grad exchange: cols to reduce
    over, cfg says closure, and the layout baked tables (JAX
    `_closure_grad_wanted`). C == 1 is always 'dense'."""
    return (
        C > 1
        and getattr(cfg, "grad_exchange", "closure") == "closure"
        and grad_tabs is not None
    )


def row_gather(F, grid: list) -> list:
    """Each position's row-group source rows: the all-gather over cols of
    the C blocks of its processor row (its own block at C = 1)."""
    C = len(grid[0])
    if C == 1:
        return list(F)
    out = []
    for i, row in enumerate(grid):
        out += all_gather(F[i * C : (i + 1) * C], list(row), SITE_GATHER)
    return out


def closure_exchange(F, send_idx: list, grid: list) -> list:
    """The capped all-to-all over rows: position (i, j) receives from each
    (i2, j) the rows send_idx[(i2, j)][i] of its block, in i2 order — the
    (R * cap, K) closure table, gathered straight into its slices where
    the two positions share a device. Counted as what crosses between
    positions (the own slice never does)."""
    R, C = len(grid), len(grid[0])
    out = []
    moved = 0
    for b in range(R * C):
        i, j = divmod(b, C)
        dev = grid[i][j]
        cap = send_idx[b].shape[1]
        table = F[b].new_empty((R * cap, F[b].shape[1]), device=dev)
        for i2 in range(R):
            src = i2 * C + j
            rows = table[i2 * cap : (i2 + 1) * cap]
            if F[src].device == dev:
                torch.index_select(F[src], 0, send_idx[src][i], out=rows)
            else:
                rows.copy_(F[src].index_select(0, send_idx[src][i]))
            if i2 != i:
                moved += _nbytes(rows)
        out.append(table)
    if _comms.counting_on() and R > 1:
        _comms.count(SITE_CLOSURE, moved)
    return out


def psum_scatter(parts: list, devices: list, dim: int, site: str) -> list:
    """Reduce-scatter over one row group's positions: position j gets the
    sum, in position order (psum's), of every position's slice j along
    `dim`. Counted as the slices that cross between positions."""
    C = len(parts)
    if C == 1:
        return list(parts)
    n = parts[0].shape[dim] // C
    out = []
    for j, d in enumerate(devices):
        total = parts[0].narrow(dim, j * n, n).to(d)
        for c in range(1, C):
            total = total + parts[c].narrow(dim, j * n, n).to(d)
        out.append(total)
    if _comms.counting_on():
        _comms.count(site, (C - 1) * sum(_nbytes(p) for p in parts) / C)
    return out


def make_twod_train_step(grid: list, csrs: list, send_idx: list,
                         cfg: BigClamConfig, path: str, kc: int = 0,
                         grad_tabs: Optional[dict] = None):
    """One 2D iteration on `path` (PATHS): grid[i][j] is position (i, j)'s
    device, csrs[b] / send_idx[b] edge block b's CSR (closure-position
    indices) and (R, cap) send lists on it, kc the K window of
    `csr_fused_2d_kb`, grad_tabs (the touched-rows tables per position and
    the int cap) where the layout baked them. Its parts are timed under
    utils.profiling.step_split on the first position's device (gather,
    sweeps, exchange, tails, finish)."""
    if path not in PATHS:
        raise ValueError(f"unknown 2d kernel path {path!r} (one of {PATHS})")
    R, C = len(grid), len(grid[0])
    p = R * C
    devs = [d for row in grid for d in row]
    use_closure = closure_grad_wanted(cfg, C, grad_tabs)
    gcap = int(grad_tabs["cap"]) if use_closure else 0
    num_s = len(cfg.step_candidates)
    d0 = devs[0]

    def one_position_c1(F, sumF, closure, b):
        """The C = 1 kernel step of position b: (outs entry, gradient)."""
        if path == "csr_fused_2d":
            F_new, grad, node_llh, ok = fused_superstep(
                F[b], sumF[b], csrs[b], cfg, closure[b])
        else:
            x = edge_dots_windows(F[b], csrs[b], kc, closure[b])
            grad, llh_nbr, xc = grad_cand_windows(
                x, F[b], sumF[b], csrs[b], cfg, kc, True, closure[b])
            del x
            F_new, node_llh, ok = cand_select_from_x(
                xc, F[b], sumF[b], grad, llh_nbr, csrs[b], cfg)
        return (F_new, F_new.sum(dim=0), node_llh.sum(), accept_stats(ok)), grad

    def grad_sweep(F_row, sumF, closure, b):
        """Position b's neighbour gradient and LLH partials over its row
        group's rows (no fold, no node tail)."""
        if path == "xla_2d":
            return neighbour_sums(F_row[b], edge_chunks(F_row[b], csrs[b], cfg),
                                  cfg, closure[b])
        if not kc:
            gn = torch.zeros_like(F_row[b])
            ln = F_row[b].new_zeros(F_row[b].shape[0])
            return ring_grad_phase(F_row[b], closure[b], csrs[b], gn, ln, cfg)
        x = edge_dots_windows(F_row[b], csrs[b], kc, closure[b])
        gn = torch.empty_like(F_row[b])
        for col0 in range(0, gn.shape[1], kc):
            _, llh = grad_from_x_kb(x, F_row[b], sumF[b], csrs[b], col0, kc, cfg,
                                    False, gn[:, col0 : col0 + kc], closure[b])
            if col0 == 0:
                ln = llh
        return gn, ln

    def cand_sweep(F_row, grad_row, closure, b):
        """Position b's (S, C*n_blk) neighbour candidate sums."""
        if path == "xla_2d":
            return candidates_pass(F_row[b], grad_row[b],
                                   edge_chunks(F_row[b], csrs[b], cfg), cfg,
                                   closure[b])
        if not kc:
            cb = F_row[b].new_zeros((num_s, F_row[b].shape[0]))
            return ring_cand_phase(F_row[b], grad_row[b], closure[b], csrs[b], cb,
                                   cfg)
        xc = F_row[b].new_zeros((num_s, csrs[b].num_directed_edges))
        for col0 in range(0, grad_row[b].shape[1], kc):
            cand_dots_kb(F_row[b], grad_row[b][:, col0 : col0 + kc], csrs[b], col0,
                         kc, cfg, xc, closure[b])
        return cand_nbr_from_x(xc, csrs[b], cfg)

    def grad_exchange(gn: list) -> tuple:
        """The row groups' gradient over cols, in place of `gn` (each
        group's partials dropped once reduced): (per position sums,
        counters (cnt, fb) or None)."""
        if C == 1:
            return gn, None
        cnts, fbs = [], []
        for i, row in enumerate(grid):
            group = range(i * C, (i + 1) * C)
            parts = [gn[b] for b in group]
            if not use_closure:
                sums = psum(parts, list(row), SITE_PSUM_GRAD)
            elif gcap <= 0:
                # nothing touched anywhere: every partial is exactly 0
                sums = parts
                cnts.append(torch.zeros((), dtype=torch.int32, device=row[0]))
                fbs.append(torch.zeros((), dtype=torch.int32, device=row[0]))
            else:
                sums, cnt, fb = closure_grad_allreduce(
                    parts, [grad_tabs["out"][b] for b in group],
                    [grad_tabs["in"][b] for b in group],
                    [grad_tabs["count"][b] for b in group], gcap, list(row),
                    SITE_GRAD_CLOSURE, SITE_GRAD_COUNT)
                cnts.append(cnt)
                fbs.append(fb)
            for c, b in enumerate(group):
                gn[b] = sums[c]
            del parts, sums
        if not use_closure:
            return gn, None
        # the counters replicated over rows (JAX: a pmax over rows on
        # every column)
        firsts = [row[0] for row in grid]
        cnt = fb = None
        for j in range(C):
            col = [row[j] for row in grid]
            c_j = pmax([x.to(d) for x, d in zip(cnts, col)], col,
                       SITE_GRAD_COUNT_ROWS)[0]
            f_j = pmax([x.to(d) for x, d in zip(fbs, col)], col,
                       SITE_GRAD_COUNT_ROWS)[0]
            if j == 0:
                cnt, fb = c_j.to(firsts[0]), f_j.to(firsts[0])
        return gn, (cnt, fb)

    def step(state):
        F = state.F
        with part("gather", d0):
            sumF = psum([f.sum(dim=0) for f in F], devs, "twod/psum_sumF")
            F_row = row_gather(F, grid)
            closure = closure_exchange(F, send_idx, grid)
        if C == 1 and path != "xla_2d":
            outs, grads = [], []
            with part("sweeps", d0):
                for b in range(p):
                    o, g = one_position_c1(F, sumF, closure, b)
                    outs.append(o)
                    grads.append(g)
            del closure
            with part("finish", d0):
                return finish_step(state, outs, [[d] for d in devs], cfg,
                                   tuple(grads), family="twod")
        adt = accum_dtype(cfg, F[0])
        n_blk = F[0].shape[0]
        gn, ln = [], []
        with part("sweeps", d0):
            for b in range(p):
                g_, l_ = grad_sweep(F_row, sumF, closure, b)
                gn.append(g_)
                ln.append(l_)
        with part("exchange", d0):
            grad_row, counters = grad_exchange(gn)
            # the fold -sumF + F in place, once per distinct sum (a dense
            # psum gives the positions of a row group on one device one
            # tensor, whose F_row and sumF they share)
            folded = set()
            for b in range(p):
                if id(grad_row[b]) not in folded:
                    folded.add(id(grad_row[b]))
                    grad_row[b].sub_(sumF[b][None, :]).add_(F_row[b])
            del gn, folded
            ln_own = []
            for i, row in enumerate(grid):
                ln_own += psum_scatter(ln[i * C : (i + 1) * C], list(row), 0,
                                       SITE_SCATTER_LLH)
            del ln
        cands = []
        with part("sweeps", d0):
            for b in range(p):
                cands.append(cand_sweep(F_row, grad_row, closure, b))
        del closure
        with part("exchange", d0):
            cand_own = []
            for i, row in enumerate(grid):
                cand_own += psum_scatter(cands[i * C : (i + 1) * C], list(row), 1,
                                         SITE_SCATTER_CAND)
            del cands
        outs, grads = [], []
        with part("tails", d0):
            for b in range(p):
                j = b % C
                grad_own = grad_row[b][j * n_blk : (j + 1) * n_blk]
                node_llh = ln_own[b].to(adt) + node_tail(F[b], sumF[b]).to(adt)
                cn = cand_own[b] if path == "xla_2d" else cand_own[b].to(adt)
                F_new, sum_loc, hist = armijo_tail_select_sharded(
                    F[b], grad_own, node_llh, cn, sumF[b], cfg,
                    kernel=path != "xla_2d")
                outs.append((F_new, sum_loc, node_llh.sum(), hist))
                grads.append(grad_own)
        with part("finish", d0):
            extras = None
            if counters is not None:
                cnt, fb = counters
                extras = {
                    "exchanged_ids": cnt, "dense_fallback": fb,
                    "cap_occupancy": cnt.to(torch.float32) / float(max(gcap, 1)),
                }
            new = finish_step(state, outs, [[d] for d in devs], cfg, tuple(grads),
                              family="twod", extras=extras)
        if counters is None:
            return TwoDTrainState(*new)
        return TwoDTrainState(*new, comm_ids=counters[0], comm_dense=counters[1])

    return step


# --- the trainers -------------------------------------------------------------


def twod_kernels_want(cfg: BigClamConfig, device: torch.device,
                      dtype: torch.dtype) -> tuple:
    """(engage the kernel paths?, reason when not) for a 2D mesh on
    `device`: the 1D rule (csr_want_reason: auto on for cuda), with JAX's
    refusal of the split suite (`csr_fused=False`) where the kernels would
    engage, and on a card a TwoDKernelError for a configuration the
    kernels cannot take, rather than `xla_2d` unasked."""
    want, reason = csr_want_reason(cfg, device)
    if not want:
        return False, "partition=2d plain closure-gather schedule (" + reason + ")"
    if not csr_fused_want(cfg):
        msg = ("partition='2d' wires only the FUSED superstep — the "
               "split/grouped kernel suites have no closure-buffer DMA "
               "path; drop csr_fused=False, or run --partition 1d for "
               "the split suite")
        raise TwoDKernelError(f"use_pallas_csr={cfg.use_pallas_csr} but {msg}")
    why = kernel_supports(cfg, dtype)
    if why:
        raise TwoDKernelError(
            f"use_pallas_csr={cfg.use_pallas_csr} on {device.type}: the 2d "
            f"mesh's kernels cannot run: {why}; use_pallas_csr=False selects "
            "the plain `xla_2d` step"
        )
    return True, ""


class TwoDShardedBigClamModel(ShardedBigClamModel):
    """2D edge-block trainer over a (rows, cols) mesh (parallel/mesh.py
    make_mesh_2d). Same API and math as ShardedBigClamModel — checkpoints
    and resume, NaN rollback, telemetry and the health pack ride the same
    machinery on the same (n_pad, k_pad) row blocks — but the step
    exchanges closure rows instead of all-gathering F. cfg.partition must
    say "2d" and cfg.replica_cols the mesh's cols. On cuda the kernel
    paths engage (`csr_fused_2d`, `csr_fused_2d_kb` above K_loc = 1,024
    or with csr_k_block); `xla_2d` where use_pallas_csr=False (and on the
    CPU by default). The cols grad reduction is grad_exchange-baked:
    "closure" (default) routes only the touched rows, "dense" psums the
    row band.

    Usage:
        mesh = make_mesh_2d((2, 2), [torch.device("cuda:0")] * 4)
        cfg = BigClamConfig(num_communities=1000, partition="2d",
                            replica_cols=2)
        result = TwoDShardedBigClamModel(graph, cfg, mesh).fit(F0)
    """

    def __init__(self, g: Graph, cfg: BigClamConfig, mesh: Mesh2D,
                 balance: bool = False):
        shape = mesh.shape
        for ax in (ROWS_AXIS, COLS_AXIS, K_AXIS):
            if ax not in shape:
                raise ValueError(
                    "partition='2d' needs a (rows, cols, k) mesh from "
                    f"make_mesh_2d; got axes {tuple(shape)}"
                )
        R, C = shape[ROWS_AXIS], shape[COLS_AXIS]
        if shape[K_AXIS] != 1:
            raise ValueError(
                "partition='2d' does not shard the community axis: the "
                "mesh 'k' axis must be 1 (TP rides the 1d families)"
            )
        if cfg.partition != "2d":
            raise ValueError(
                f"cfg.partition={cfg.partition!r} on the 2d trainer: the "
                "step and the perf-ledger match key are partition-baked — "
                "set partition='2d'"
            )
        if cfg.replica_cols != C:
            raise ValueError(
                f"cfg.replica_cols={cfg.replica_cols} != mesh cols {C}; "
                "build the mesh from the config (twod_mesh_shape)"
            )
        if getattr(cfg, "grad_exchange", "closure") not in ("closure", "dense"):
            raise ValueError(
                f"grad_exchange={cfg.grad_exchange!r}: the 2d cols grad "
                "reduction is step-baked as 'closure' (touched-rows "
                "exchange over the baked lists) or 'dense' (partial-"
                "group psum)"
            )
        self.g = g
        self.cfg = cfg
        self.mesh = mesh
        self.R, self.C, self.p = R, C, R * C
        self.tp = 1
        # the 1D machinery's node shards (the p blocks) and origin: the 2D
        # mesh is single-controller
        self.dp, self.row0, self.col0 = self.p, 0, 0
        # rows_grid[i][j]: position (i, j)'s device; the 1D machinery reads
        # the p positions as node shards (grid[b] = [device of block b])
        self.rows_grid = [[resolve_device(d) for d in row] for row in mesh.devices]
        self.devices = [d for row in self.rows_grid for d in row]
        self.grid = [[d] for d in self.devices]
        self.device = self.devices[0]
        self.dtype = resolve_dtype(cfg.dtype, self.device)
        if cfg.min_f != 0.0:
            raise ValueError("sharded padding requires min_f == 0.0")
        self.n_pad = _round_up(max(g.num_nodes, self.p), self.p)
        self.kernels, self.path_reason = twod_kernels_want(cfg, self.device, self.dtype)
        self.kc, self.k_pad = mesh_k_plan(
            cfg.num_communities, 1, self.kernels, cfg.csr_k_block)
        if self.kernels:
            check_k_block(self.kc or self.k_pad, self.device)
        self._perm = None
        self.g_original = g
        if balance and self.p > 1:
            self.g, self._perm = balance_graph(g, self.p, self.n_pad)
        self._build_edges_and_step()
        self._bake_models()

    @property
    def engaged_path(self) -> str:
        if not self.kernels:
            return "xla_2d"
        return "csr_fused_2d_kb" if self.kc else "csr_fused_2d"

    @property
    def _closure_grad_on(self) -> bool:
        """Whether the CURRENT cfg's step carries the touched-rows grad
        exchange (and so the comm_ids/comm_dense counters)."""
        return closure_grad_wanted(self.cfg, self.C, self._grad_tabs)

    @property
    def grad_exchange(self) -> str:
        """The EFFECTIVE grad-exchange mode the perf ledger stamps; C == 1
        reports "dense" (there is no cols reduction)."""
        return "closure" if self._closure_grad_on else "dense"

    # ------------------------------------------------------ layout/step
    def _layout(self) -> TwoDLayout:
        return twod_shard_edges(self.g, self.cfg, self.R, self.C, self.n_pad)

    def _build_edges_and_step(self) -> None:
        """Device-place each position's edge-block CSR, its closure send
        lists and (C > 1) its grad-exchange tables (baked whenever C > 1,
        so rebuild_step can toggle grad_exchange without a relayout), then
        build the step."""
        layout = self._layout()
        devs = self.devices
        self.block_csr = [device_csr(ip, ix, devs[b])
                          for b, (ip, ix) in enumerate(layout.blocks)]
        self._send_idx = [host_tensor(layout.send_idx[b], np.int64, devs[b])
                          for b in range(self.p)]
        self._twod_cap = int(layout.cap)
        self._block_counts = np.asarray(layout.block_edge_counts, np.int64)
        self._grad_cap = int(layout.grad_cap)
        self._grad_pair_max = int(layout.grad_pair_max)
        self._grad_tabs = None
        if layout.grad_out is not None:
            self._grad_tabs = {
                "out": [host_tensor(layout.grad_out[b], np.int64, devs[b])
                        for b in range(self.p)],
                "in": [host_tensor(layout.grad_in[b], np.int64, devs[b])
                       for b in range(self.p)],
                "count": [torch.tensor(int(layout.grad_counts[b]),
                                       dtype=torch.int32, device=devs[b])
                          for b in range(self.p)],
                "cap": int(layout.grad_cap),
            }
        self._pad_stats = {
            "closure_cap": int(layout.cap),
            "closure_slots_padded": self.p * self.R * int(layout.cap),
            "closure_rows": int(layout.closure_rows),
        }
        if layout.grad_out is not None:
            self._pad_stats.update(grad_cap=int(layout.grad_cap),
                                   grad_pair_max=int(layout.grad_pair_max))
        self.rebuild_step()

    def rebuild_step(self) -> None:
        """(Re)build the train step for the CURRENT self.cfg on the built
        layout."""
        self._step = make_twod_train_step(
            self.rows_grid, self.block_csr, self._send_idx, self.cfg,
            self.engaged_path, self.kc, self._grad_tabs)
        self._note_step_build()

    # ----------------------------------------------------- state plumbing
    def reset_state(self, F, llh: Optional[float] = None, it: int = 0):
        """ShardedBigClamModel.reset_state, with zero exchange counters
        where the closure grad exchange is engaged."""
        st = super().reset_state(F, llh=llh, it=it)
        if not self._closure_grad_on:
            return TwoDTrainState(*st)
        zero = torch.zeros((), dtype=torch.int32, device=self.device)
        return TwoDTrainState(*st, comm_ids=zero, comm_dense=zero.clone())

    def _memory_state_arrays(self, state) -> list:
        return super()._memory_state_arrays(state) + [
            getattr(state, "comm_ids", None), getattr(state, "comm_dense", None)]

    def last_comm(self, state) -> Tuple[int, bool]:
        """(worst exchanged pair size, dense-fallback?) of the last step;
        (0, False) when the closure grad exchange is not engaged."""
        if getattr(state, "comm_ids", None) is None:
            return 0, False
        return int(state.comm_ids), bool(int(state.comm_dense))

    # ------------------------------------------------------ observability
    def _build_comms_model(self):
        return _comms.twod_step_model(
            self.n_pad, self.k_pad, self.R, self.C, self.itemsize,
            len(self.cfg.step_candidates), closure_cap=self._twod_cap,
            llh_itemsize=self._llh_itemsize(), model=type(self).__name__,
            grad_exchange=self.grad_exchange,
            grad_cap=self._grad_cap if self._closure_grad_on else 0,
            fused=self.kernels,
        )

    def comms_measured(self, state):
        """The comms model re-priced from the bytes the collective helpers
        pass in one step from `state` (the new state is dropped). A step
        whose row groups fell back to the dense psum is priced on the
        model with the exchange site swapped for that psum
        (obs.comms.twod_fallback_model, JAX `twod_measured`)."""
        with _comms.counting() as ctr:
            new = self._step(state)
        model = self.comms
        if getattr(new, "comm_dense", None) is not None and int(new.comm_dense):
            model = _comms.twod_fallback_model(model)
        return model.remeasure_totals(ctr.bytes)

    _balance_hint = "relabel (--balance)"

    def _shard_edge_counts(self) -> np.ndarray:
        return self._block_counts

    def _position_graph(self, positions) -> dict:
        """The graph tensors of the given mesh positions, by name."""
        csrs = [self.block_csr[b] for b in positions]
        out = {
            "graph/edge_block_indptr": [c.indptr for c in csrs],
            "graph/edge_block_indices": [c.indices for c in csrs],
            "graph/edge_block_src": [c.src for c in csrs],
            "graph/edge_block_dst": [c.dst for c in csrs],
            "graph/closure_send_idx": [self._send_idx[b] for b in positions],
        }
        if self._grad_tabs is not None:
            out["graph/grad_out_tab"] = [self._grad_tabs["out"][b] for b in positions]
            out["graph/grad_in_tab"] = [self._grad_tabs["in"][b] for b in positions]
            out["graph/grad_count"] = [self._grad_tabs["count"][b] for b in positions]
        return out

    def _busiest_device(self) -> tuple:
        """(device, its positions, its graph bytes by name) of the device
        holding the most positions' state and graph bytes."""
        best = None
        for d in dict.fromkeys(self.devices):
            pos = [b for b, x in enumerate(self.devices) if x == d]
            gb = _mem.bytes_by_name(self._position_graph(pos))
            total = len(pos) * (self.n_pad // self.p) * self.k_pad + sum(gb.values())
            if best is None or total > best[0]:
                best = (total, d, pos, gb)
        return best[1:]

    def _build_memory_model(self):
        cfg = self.cfg
        d, pos, gb = self._busiest_device()
        return _mem.twod_memory_model(
            self.n_pad, self.k_pad, self.R, self.C, self.itemsize,
            len(cfg.step_candidates), gb, closure_cap=self._twod_cap,
            health_on=int(cfg.health_every or 0) > 0,
            rollback=int(cfg.rollback_budget or 0) > 0, comms=self.comms,
            model=type(self).__name__, path=self.engaged_path,
            grad_exchange=self.grad_exchange,
            grad_cap=self._grad_cap if self._closure_grad_on else 0,
            positions=len(pos), first_device=d == self.devices[0],
            row_groups=len({b // self.C for b in pos}),
            edges=max(int(self.block_csr[b].num_directed_edges) for b in pos),
            chunk=_mem.edge_chunk_bound(cfg.edge_chunk, self.k_pad, self.itemsize),
            llh_itemsize=self._llh_itemsize(),
        )


class StoreTwoDShardedBigClamModel(StoreBacked, TwoDShardedBigClamModel):
    """The 2D trainer fed from a compiled graph cache of rows * cols
    shards (JAX `StoreTwoDShardedBigClamModel`, one controller): the edge
    blocks and the closure lists are built from the shard files and the
    ingest-baked closure lists (GraphStore.load_closure_lists); no global
    CSR is assembled. On a cache without baked lists (format < v3) the
    lists are streamed from each shard's own CSR (store.closure_pair_lists,
    the same derivation), and path_reason says so. Trajectories are bit
    for bit TwoDShardedBigClamModel(balance=False) on the cache's graph."""

    def __init__(self, store, cfg: BigClamConfig, mesh: Mesh2D,
                 verify: bool = True):
        self._store_init(store, mesh, verify)
        super().__init__(_StoreGraphView(store), cfg, mesh, balance=False)

    def _store_init(self, store, mesh: Mesh2D, verify: bool) -> None:
        p = mesh.shape[ROWS_AXIS] * mesh.shape[COLS_AXIS]
        if store.num_shards != p:
            raise ValueError(
                f"cache has {store.num_shards} shards but the 2d mesh "
                f"has rows*cols={p} node blocks; recompile with "
                f"--shards {p}"
            )
        self.store = store
        self._shard_verify = verify
        self.files_read: List[tuple] = []

    def _pair_lists(self, shard) -> Dict[int, tuple]:
        """The shards' closure triples: the baked v3 lists when the cache
        has them, else streamed from each shard's own CSR (recorded in
        path_reason — the same derivation, more host time)."""
        from bigclam_tpu_torch.graph.store import closure_pair_lists

        own = list(shard.shard_ids)
        entries = self.store.manifest["shards"]
        if own and all("closure" in entries[s] for s in own):
            cl = self.store.load_closure_lists(
                own[0], own[-1] + 1, verify=self._shard_verify)
            self.files_read.append(cl.files_read)
            return {s: (sc.out_ids, sc.in_ids, sc.edge_counts)
                    for s, sc in cl.shards.items()}
        self.path_reason += (
            "; closure gather lists streamed from the cached CSR (cache "
            "format < v3 — re-ingest to bake closures)"
        )
        rps = shard.rows_per_shard
        n = shard.num_nodes
        out: Dict[int, tuple] = {}
        for s in own:
            glo, ghi = min(s * rps, n), min((s + 1) * rps, n)
            a = int(shard.indptr[glo - shard.lo])
            b = int(shard.indptr[ghi - shard.lo])
            ip = shard.indptr[glo - shard.lo: ghi - shard.lo + 1] - a
            out[s] = closure_pair_lists(
                glo, ip, shard.indices[a:b], rps, self.p, cap=0)
        return out

    def _layout(self) -> TwoDLayout:
        self._check_rows()
        self.files_read = []
        shard = self.store.load_shard_range(0, self.p, verify=self._shard_verify)
        self.files_read.append(shard.files_read)
        return twod_shard_edges_local(shard, self._pair_lists(shard), self.cfg,
                                      self.R, self.C, self.n_pad)

    def _shard_edge_counts(self) -> np.ndarray:
        """Per edge-BLOCK counts from the v3 manifest's per-pair closure
        counts (block (i, j) = group i's edges into stripe j); pre-v3
        caches fall back to the per-shard totals."""
        entries = self.store.manifest["shards"]
        if all("closure" in e for e in entries):
            per_pair = np.asarray([e["closure"]["edge_counts"] for e in entries],
                                  dtype=np.int64)              # (S, S): s -> b'
            R, C = self.R, self.C
            out = np.zeros(self.p, dtype=np.int64)
            for i in range(R):
                grp = per_pair[i * C:(i + 1) * C].sum(axis=0)   # (S,)
                for j in range(C):
                    out[i * C + j] = grp[j::C].sum()
            return out
        return StoreBacked._shard_edge_counts(self)
