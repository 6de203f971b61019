"""Ring-pass sharded training: rotate F node-shards around the mesh instead
of all-gathering F.

Port of the single-host part of bigclam_tpu/parallel/ring.py
(`ring_bucket_imbalance`, `ring_shard_edges`, `rotate_scan`,
`make_ring_train_step`, the `step_shard`, `step_shard_kb` and
`step_shard_tp` of `make_ring_csr_train_step`, `RingBigClamModel`). Each
shard holds its own F_loc and one rotating shard; in phase r shard i holds
shard (i + r) % dp and sweeps the bucket of its edges whose destinations
live there. Two rotations make a step: the gradient pass, then the
16-candidate pass (it needs the finished gradient). The fold, the node tail
and the Armijo tails are added once, after each rotation, so the
trajectory is the all-gather trainer's. At tp > 1 every block (i, j) of
the mesh grid rotates along its column: block (i, j) holds block
((i + r) % dp, j) in phase r.

Buckets are per-(shard, phase) CSRs over the shard's rows with destination
rows local to the rotating shard, each of its own length: unlike the JAX
ring, nothing is padded to the largest bucket, so the "dp x padded work"
of a locality-ordered id space (the JAX `RingBigClamModel` docstring) does
not apply to the kernel path here; what stays is the per-shard edge
imbalance, which the balance relabeling evens out.

The phase sweep at tp = 1 with whole rows is kernel #8 (gradient) and #9
(candidates) on the paths `csr_ring_fused` and `csr_ring`
(ops.ring_kernels; the TPU difference between the two, an fd gather, has
no counterpart here, so both run the same kernels), or their plain versions
on `xla`. Each bucket carries kernel #8's visit order of its rows
(`visit_order`), computed once from the graph when the model builds its
buckets. Where the kernels engage, the Armijo tails and the selection of
each shard run in one more kernel, the node pass's epilogue
(ops.linesearch.armijo_update_kernel); `xla` keeps them in torch.

The K-blocked paths (`csr_ring_fused_kb`, `csr_ring_kb`) and every path at
tp > 1 sweep a phase on the TP split (`make_ring_tp_step`): the bucket's
edge dots over each column block's windows against the rotating block
(`edge_dots_kb`, directed), a psum over k, the neighbour gradient added
into the rotation's accumulators (`grad_from_x_kb`'s accumulate mode); in
the candidate rotation the candidate dots, a psum over k and the
neighbour candidate sums (`cand_nbr_from_x`). At tp = 1 the epilogue
kernel ends the step; at tp > 1 the tails run in torch with their row dots
psummed over k (parallel/sharded.py `armijo_tail_select_tp`). `xla` at
tp > 1 runs the same split on the kernels' plain versions.
"""

from __future__ import annotations

import os
import sys
import warnings
from typing import Callable, List

import numpy as np
import torch

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import DeviceCSR, Graph
from bigclam_tpu_torch.models.bigclam import TrainState, _round_up, csr_fused_want
from bigclam_tpu_torch.obs import comms as _comms
from bigclam_tpu_torch.obs import memory as _mem
from bigclam_tpu_torch.ops.kblocked import (
    cand_dots_kb,
    cand_dots_kb_plain,
    cand_nbr_from_x,
    cand_nbr_from_x_plain,
    edge_dots_windows,
    grad_from_x_kb,
    grad_from_x_kb_plain,
)
from bigclam_tpu_torch.ops.linesearch import accept_stats
from bigclam_tpu_torch.ops.objective import accum_dtype, node_tail
from bigclam_tpu_torch.ops.ring_kernels import (
    ring_cand_phase,
    ring_cand_phase_plain,
    ring_grad_phase,
    ring_grad_phase_plain,
)
from bigclam_tpu_torch.parallel import multihost as _mh
from bigclam_tpu_torch.parallel.mesh import NODES_AXIS, Mesh
from bigclam_tpu_torch.parallel.sharded import (
    ShardedBigClamModel,
    StoreBacked,
    _StoreGraphView,
    armijo_tail_select_sharded,
    armijo_tail_select_tp,
    as_layout,
    block_grid,
    column_psum,
    device_csr,
    finish_step,
    kpsum,
    one_column,
    psum,
    shard_edges,
)
from bigclam_tpu_torch.utils.profiling import part

# a bucket holding more than this multiple of the mean marks the id space
# as locality-ordered (bigclam_tpu/obs/comms.py IMBALANCE_FACTOR): the
# warning and the auto-balance rule share it
RING_IMBALANCE_FACTOR = 4.0


def ring_bucket_imbalance(g: Graph, dp: int, n_pad: int) -> tuple:
    """(max, mean) directed-edge count over the dp*dp (src shard, phase)
    buckets — the statistic behind _warn_bucket_imbalance and the
    auto-balance rule (RingBigClamModel)."""
    shard_rows = max(n_pad // dp, 1)
    src_shard = g.src // shard_rows
    phase = ((g.dst // shard_rows) - src_shard) % dp
    counts = np.zeros((dp, dp), dtype=np.int64)
    np.add.at(counts, (src_shard, phase), 1)
    return int(counts.max()) if counts.size else 1, max(
        float(g.src.size) / (dp * dp), 1.0
    )


def _warn_bucket_imbalance(num_directed_edges: int, dp: int, max_count: int,
                           hint: str) -> None:
    """Warn when one bucket holds more than RING_IMBALANCE_FACTOR x the
    mean: a locality-ordered id space (contiguous communities, BFS orders)
    puts ~all of a shard's edges in its diagonal bucket, and then the
    shards' edge counts are as uneven as their id ranges' degree sums.
    Reached only with balance=False: the default build relabels on the
    same rule."""
    mean_count = max(float(num_directed_edges) / (dp * dp), 1.0)
    if max_count > RING_IMBALANCE_FACTOR * mean_count:
        warnings.warn(
            f"ring phase buckets are imbalanced: max {max_count} vs mean "
            f"{mean_count:.0f} edges/bucket. Node ids look locality-ordered; "
            f"{hint} before the ring schedule.",
            # the caller of the model's class, the first frame outside
            # this package
            skip_file_prefixes=(os.path.dirname(__file__),),
        )


def shard_ring_buckets(indptr: np.ndarray, indices: np.ndarray, i: int,
                       dp: int, rows: int) -> list:
    """Bucket shard i's CSR (rows local, destinations GLOBAL) by
    destination shard: bucket r = (indptr (rows+1,) int64, indices int32)
    holding the edges whose destinations live in shard (i + r) % dp, with
    the destination as its row in that shard. Each bucket keeps CSR
    (src-sorted) order."""
    indptr = np.asarray(indptr, np.int64)
    dst = np.asarray(indices).astype(np.int64)
    src = np.repeat(np.arange(rows, dtype=np.int64), np.diff(indptr))
    phase = (dst // rows - i) % dp
    out = []
    for r in range(dp):
        sel = phase == r
        b_indptr = np.zeros(rows + 1, dtype=np.int64)
        np.cumsum(np.bincount(src[sel], minlength=rows), out=b_indptr[1:])
        out.append((b_indptr, (dst[sel] - ((i + r) % dp) * rows).astype(np.int32)))
    return out


def ring_shard_edges(g: Graph, dp: int, n_pad: int) -> list:
    """Bucket each src shard's edges by destination shard: buckets[i][r] =
    (indptr (rows+1,) int64, indices int32) over shard i's n_pad/dp rows,
    holding the edges whose destinations live in shard (i + r) % dp, with
    BOTH ends local (src by its CSR row, dst by its row in that shard).
    Membership is JAX `ring_shard_edges`' (phase = (dst_shard - src_shard)
    mod dp) and each bucket keeps CSR (src-sorted) order; no bucket is
    padded."""
    rows = n_pad // dp
    return [
        shard_ring_buckets(indptr, indices, i, dp, rows)
        for i, (indptr, indices) in enumerate(shard_edges(g, dp, n_pad))
    ]


# kernel #8's visit orders of a bucket's rows (visit_order) and the one the
# model takes: the fastest on an H100 at full width (PERF.md kernel table)
VISIT_ORDERS = ("identity", "pre_balance", "first_neighbour")
VISIT_ORDER = "pre_balance"


def visit_order(indptr: np.ndarray, indices: np.ndarray, how: str,
                rank=None) -> np.ndarray:
    """The rows of a bucket with an edge, as int32, in the order kernel #8's
    warps take them (which rows run together, and so which gathered rows
    the L2 cache holds; no sum depends on it):

    * "identity": ascending row;
    * "pre_balance": ascending rank[row], the node's id before the balance
      relabeling (rank None: no relabeling, so "identity");
    * "first_neighbour": ascending first neighbour (its row in the rotating
      shard), ties by row.

    Deterministic: a stable sort of the graph's own arrays."""
    indptr = np.asarray(indptr, np.int64)
    rows = np.flatnonzero(np.diff(indptr) > 0)
    if how == "identity" or (how == "pre_balance" and rank is None):
        key = rows
    elif how == "pre_balance":
        key = np.asarray(rank)[rows]
    elif how == "first_neighbour":
        key = np.asarray(indices)[indptr[rows]]
    else:
        raise ValueError(f"visit order {how!r} is not one of {VISIT_ORDERS}")
    return rows[np.argsort(key, kind="stable")].astype(np.int32)


class RingRotation:
    """The shared rotation primitive (JAX `rotate_scan`) on a
    single-controller mesh: run(shards, sweep) calls sweep(r, rot) for
    r = 0..dp-1, where rot[i] is shard (i + r) % dp resident on device i;
    between phases every device takes its ring successor's rotating shard
    (JAX perm (j, (j - 1) % dp)). The rotation after the last phase, which
    would only bring each shard home, is not made. With `stride` tp the
    positions are the blocks of a (dp, tp) grid in row-major order, and
    position p's successor is p + tp: each block rotates along its column.

    overlap=True (cfg.ring_overlap, the default): the hop for phase r + 1
    is issued before phase r's sweep, as a non_blocking copy on side
    streams of the two devices, and the next phase's stream waits for it
    (wait_stream records an event). overlap=False: the hop follows the
    sweep on the current streams. Both compute the same bits. Where a shard
    and its successor share a device (a mesh of a repeated device, any CPU
    mesh) the hop is a no-op: the rotating shard IS the other shard's
    F_loc, which is never written.

    On a multi-process mesh `devices` are this rank's positions, `phases`
    the whole ring's dp and `peers` the (predecessor, successor) ranks
    (multihost.ring_peers): a hop sends the first local row's blocks to
    the predecessor and takes the successor's in place of the last local
    row's (multihost.hop, one dist.batch_isend_irecv); hops inside the
    rank stay the copies or no-ops above."""

    def __init__(self, devices: list, overlap: bool, stride: int = 1,
                 phases: int = 0, peers=None):
        self.devices = devices
        self.overlap = overlap
        self.stride = stride
        self.phases = phases or len(devices) // stride
        self.peers = peers
        self._side = {}

    def _stream(self, device: torch.device) -> "torch.cuda.Stream":
        if device not in self._side:
            self._side[device] = torch.cuda.Stream(device=device)
        return self._side[device]

    def _hop(self, rot: list):
        """Issue one hop; returns (next rot, join) — join() makes each
        device's current stream wait for the copies it receives."""
        p, st = len(rot), self.stride
        if _comms.counting_on():
            # every mesh position receives its successor's shard, whether
            # the two positions share a device or not
            _comms.count("ring/ppermute_F_rot",
                         sum(t.numel() * t.element_size() for t in rot))
        out, joins = [], []
        remote = {}
        if self.peers is not None:
            got = _mh.hop(rot[:st], rot[p - st:], self.peers, None)
            remote = {p - st + k: t for k, t in enumerate(got)}
        for i, dst in enumerate(self.devices):
            src_dev, t = self.devices[(i + st) % p], rot[(i + st) % p]
            if i in remote:
                out.append(remote[i])
            elif src_dev == dst:
                out.append(t)
            elif not self.overlap:
                out.append(t.to(dst))
            else:
                s_src, s_dst = self._stream(src_dev), self._stream(dst)
                # the shard is ready once the source's current stream is
                s_src.wait_stream(torch.cuda.current_stream(src_dev))
                t.record_stream(s_src)
                # a cross-device copy runs on the source's current stream
                # and fences the destination's: make both the side streams
                with torch.cuda.stream(s_src), torch.cuda.stream(s_dst):
                    c = t.to(dst, non_blocking=True)
                c.record_stream(torch.cuda.current_stream(dst))
                out.append(c)
                joins.append(dst)

        def join():
            for d in joins:
                torch.cuda.current_stream(d).wait_stream(self._side[d])

        return out, join

    def run(self, shards, sweep: Callable[[int, list], None]) -> None:
        """The hops alone (their issue, and the wait for an overlapped one)
        are the step split's `rotation` part, on the first device's stream;
        the sweeps time their own parts."""
        rot = list(shards)
        dp = self.phases
        d0 = self.devices[0]
        for r in range(dp):
            if r == dp - 1:
                sweep(r, rot)
            elif self.overlap:
                with part("rotation", d0):
                    nxt, join = self._hop(rot)
                sweep(r, rot)
                with part("rotation", d0):
                    join()
                rot = nxt
            else:
                sweep(r, rot)
                with part("rotation", d0):
                    rot, _ = self._hop(rot)


def make_ring_train_step(
    devices: list, buckets: List[List[DeviceCSR]], cfg: BigClamConfig, path: str,
    phases: int = 0, peers=None,
) -> Callable[[TrainState], TrainState]:
    """One ring iteration (two rotations) on kernel path `path`:
    `csr_ring_fused` / `csr_ring` (kernels #8 and #9) or `xla` (their plain
    versions). buckets[i][r] is shard i's phase-r bucket on devices[i]
    (an Axis where the shards span ranks; `phases` and `peers` as
    RingRotation takes them)."""
    if path == "xla":
        grad_phase, cand_phase = ring_grad_phase_plain, ring_cand_phase_plain
    else:
        grad_phase, cand_phase = ring_grad_phase, ring_cand_phase
    rotation = RingRotation(devices, cfg.ring_overlap, phases=phases, peers=peers)
    dp = len(devices)
    num_s = len(cfg.step_candidates)

    def step(state: TrainState) -> TrainState:
        F = state.F
        adt = accum_dtype(cfg, F[0])
        sumF = psum([f.sum(dim=0) for f in F], devices, "ring/psum_sumF")

        # rotation 1: per phase, every shard's bucket into its accumulators
        # (fresh tensors: a rotating shard may be another shard's F_loc)
        gn = [torch.zeros_like(f) for f in F]
        ln = [f.new_zeros(f.shape[0]) for f in F]

        def grad_sweep(r, rot):
            for i in range(dp):
                grad_phase(F[i], rot[i], buckets[i][r], gn[i], ln[i], cfg)

        rotation.run(F, grad_sweep)
        grad = [g - s[None, :] + f for g, s, f in zip(gn, sumF, F)]
        node_llh = [
            l.to(adt) + node_tail(f, s).to(adt) for l, f, s in zip(ln, F, sumF)
        ]

        # rotation 2: the 16 candidates' neighbour terms (the tails and the
        # selection come after, in one kernel where the kernels engage)
        cb = [f.new_zeros((num_s, f.shape[0])) for f in F]

        def cand_sweep(r, rot):
            for i in range(dp):
                cand_phase(F[i], grad[i], rot[i], buckets[i][r], cb[i], cfg)

        rotation.run(F, cand_sweep)
        outs = []
        for i in range(dp):
            F_new, sum_loc, hist = armijo_tail_select_sharded(
                F[i], grad[i], node_llh[i], cb[i].to(adt), sumF[i], cfg,
                kernel=path != "xla",
            )
            outs.append((F_new, sum_loc, node_llh[i].sum(), hist))
        return finish_step(state, outs, one_column(devices), cfg, grad,
                           family="ring")

    return step


def make_ring_tp_step(
    grid: list, buckets: list, cfg: BigClamConfig, path: str, kc: int,
    phases: int = 0, peers=None,
) -> Callable[[TrainState], TrainState]:
    """One ring iteration on the TP split (the K-blocked paths at any tp,
    every path at tp > 1): grid[i][j] is the device of block (i, j),
    buckets[i][j][r] shard i's phase-r bucket on it, kc the window (the
    block's K_loc where one window takes it). `xla` runs the kernels'
    plain versions. Its parts are timed under utils.profiling.step_split
    on the current stream of the first block's device, grid[0][0], and do
    not overlap: on a mesh of one repeated card they add up to the step's
    busy time; on distinct cards the other devices' work shows only where
    the first device waits for it."""
    dp, tp = len(grid), len(grid[0])
    whole = tp == 1 and getattr(grid[0], "group", None) is None
    plain = path == "xla"
    grad_fn = grad_from_x_kb_plain if plain else grad_from_x_kb
    cand_fn = cand_dots_kb_plain if plain else cand_dots_kb
    nbr = cand_nbr_from_x_plain if plain else cand_nbr_from_x
    flat_dev = [d for row in grid for d in row]
    rotation = RingRotation(flat_dev, cfg.ring_overlap, stride=tp,
                            phases=phases, peers=peers)
    num_s = len(cfg.step_candidates)

    def step(state: TrainState) -> TrainState:
        F = block_grid(state.F)
        d0 = grid[0][0]
        adt = accum_dtype(cfg, F[0][0])
        w = kc or F[0][0].shape[1]
        wins = range(0, F[0][0].shape[1], w)
        with part("gather", d0):
            sumF = column_psum([[f.sum(dim=0) for f in r] for r in F], grid,
                               "ring/psum_sumF")
        flat = [f for r in F for f in r]

        # rotation 1: per phase and node row, the bucket's dots over every
        # window, their psum over k, then the neighbour gradient and LLH of
        # each block added into its accumulators (the fold comes after)
        gn = [[torch.zeros_like(f) for f in r] for r in F]
        ln = [[f.new_zeros(f.shape[0], dtype=adt if plain else f.dtype) for f in r]
              for r in F]

        def grad_sweep(r, rot):
            for i in range(dp):
                b = [buckets[i][j][r] for j in range(tp)]
                with part("dots", d0):
                    xs = [edge_dots_windows(F[i][j], b[j], w, rot[i * tp + j], plain)
                          for j in range(tp)]
                with part("k_psum", d0):
                    x = kpsum(xs, grid[i], "ring/psum_k_x")
                with part("consume", d0):
                    for j in range(tp):
                        for col0 in wins:
                            grad_fn(x[j], F[i][j], sumF[i][j], b[j], col0, w, cfg,
                                    False, gn[i][j][:, col0 : col0 + w],
                                    rot[i * tp + j], True, ln[i][j])

        rotation.run(flat, grad_sweep)
        with part("consume", d0):
            grad = [[g - s[None, :] + f for g, s, f in zip(gr, sr, fr)]
                    for gr, sr, fr in zip(gn, sumF, F)]

        # rotation 2: per phase, the candidate dots over every window, their
        # psum over k, the bucket's neighbour candidate sums
        cb = [[f.new_zeros((num_s, f.shape[0])) for f in r] for r in F]

        def cand_sweep(r, rot):
            for i in range(dp):
                b = [buckets[i][j][r] for j in range(tp)]
                xcs = []
                with part("dots", d0):
                    for j in range(tp):
                        xc = F[i][j].new_zeros((num_s, b[j].num_directed_edges))
                        for col0 in wins:
                            cand_fn(F[i][j], grad[i][j][:, col0 : col0 + w], b[j],
                                    col0, w, cfg, xc, rot[i * tp + j])
                        xcs.append(xc)
                with part("k_psum", d0):
                    xc = kpsum(xcs, grid[i], "ring/psum_k_xc")
                with part("consume", d0):
                    for j in range(tp):
                        cb[i][j] += nbr(xc[j], b[j], cfg)

        rotation.run(flat, cand_sweep)
        outs = []
        with part("tails", d0):
            for i in range(dp):
                if whole:
                    f, s = F[i][0], sumF[i][0]
                    node_llh = ln[i][0].to(adt) + node_tail(f, s).to(adt)
                    F_new, sum_loc, hist = armijo_tail_select_sharded(
                        f, grad[i][0], node_llh, cb[i][0].to(adt), s, cfg,
                        kernel=not plain,
                    )
                    outs.append((F_new, sum_loc, node_llh.sum(), hist))
                    continue
                F_new, sums, node_llh, ok = armijo_tail_select_tp(
                    F[i], grad[i], ln[i], cb[i], sumF[i], cfg, grid[i],
                    "ring/psum_k_rows")
                outs.append((tuple(F_new), tuple(sums), node_llh.sum(),
                             accept_stats(ok)))
        with part("finish", d0):
            return finish_step(state, outs, grid, cfg, as_layout(grad), family="ring")

    return step


class RingBigClamModel(ShardedBigClamModel):
    """Sharded trainer on the ring schedule (same API and trajectories as
    ShardedBigClamModel; each device holds its shard and one rotating shard
    instead of all of F).

    balance=None (the default) measures the bucket imbalance first and
    applies the degree-balanced relabeling when one bucket holds more than
    RING_IMBALANCE_FACTOR x the mean (a locality-ordered id space);
    balance=False keeps the raw layout (and warns), balance=True always
    relabels. Results come back in original ids either way."""

    def __init__(self, g: Graph, cfg: BigClamConfig, mesh: Mesh, balance=None):
        if balance is None:
            dp = mesh.shape[NODES_AXIS]
            mx, mean = ring_bucket_imbalance(g, dp, _round_up(max(g.num_nodes, dp), dp))
            balance = dp > 1 and mx > RING_IMBALANCE_FACTOR * mean
            if balance:
                print(
                    f"[bigclam] RingBigClamModel: auto-engaging balance "
                    f"relabeling (max bucket {mx} > {RING_IMBALANCE_FACTOR:g}x "
                    f"mean {mean:.0f}; pass balance=False to keep the raw "
                    "layout)",
                    file=sys.stderr,
                )
        super().__init__(g, cfg, mesh, balance=balance)

    # what evens the phase buckets, named by the imbalance warning
    _ring_balance_hint = ("relabel (balance=True or the default balance=None "
                          "auto rule) or shuffle ids")

    @property
    def engaged_path(self) -> str:
        """`csr_ring_fused` / `csr_ring` where the kernels engage (the JAX
        labels: the ring's profile is not the all-gather's), else `xla`."""
        if not self.kernels:
            return "xla"
        if self.kc:
            return "csr_ring_fused_kb" if csr_fused_want(self.cfg) else "csr_ring_kb"
        return "csr_ring_fused" if csr_fused_want(self.cfg) else "csr_ring"

    def _build_edges_and_step(self) -> None:
        """Each position's phase buckets (shard_ring_buckets) from its CSR
        (_position_shards), uploaded a position at a time."""
        dp = self.dp
        rows = self.n_pad // dp
        self.buckets = []
        max_count = 0
        for i, (indptr, indices) in self._position_shards():
            host = shard_ring_buckets(indptr, indices, i, dp, rows)
            max_count = max([max_count] + [ix.shape[0] for _, ix in host])
            self.buckets.append(
                [device_csr(ip, ix, self.devices[i - self.row0]) for ip, ix in host]
            )
        # each rank sees only its buckets: warn on the ring's largest
        max_count = _mh.global_max_int(max_count) if self.mesh.distributed \
            else max_count
        _warn_bucket_imbalance(self.g.num_directed_edges, dp, max_count,
                               self._ring_balance_hint)
        self.set_visit_order(VISIT_ORDER)
        self.block_buckets = [self._on_row(i, row) for i, row in enumerate(self.buckets)]
        self.rebuild_step()

    def _balance_perm(self):
        """The balance relabeling (original id -> trainer row), or None
        when rows were never relabeled."""
        return self._perm

    def set_visit_order(self, how: str) -> None:
        """Give every bucket kernel #8's visit order `how` (visit_order; the
        pre-balance rank of a row is its node's original id), in place, so a
        built step takes it too."""
        perm = self._balance_perm()
        rank = None
        if perm is not None:
            rank = np.arange(self.n_pad)
            rank[perm] = np.arange(perm.shape[0])
        rows = self.n_pad // self.dp
        for il, row in enumerate(self.buckets):
            i = self.row0 + il
            shard_rank = None if rank is None else rank[i * rows : (i + 1) * rows]
            for r, b in enumerate(row):
                order = visit_order(b.indptr.cpu().numpy(), b.indices.cpu().numpy(),
                                    how, shard_rank)
                row[r] = b._replace(order=torch.as_tensor(order, device=b.indptr.device))
        self.visit_order = how

    def rebuild_step(self) -> None:
        peers = _mh.ring_peers(self.mesh)
        if self.tp_split:
            self._step = make_ring_tp_step(
                self.grid, self.block_buckets, self.cfg, self.engaged_path, self.kc,
                self.dp, peers)
        else:
            self._step = make_ring_train_step(
                self.devices, self.buckets, self.cfg, self.engaged_path,
                self.dp, peers)
        self._note_step_build()

    # ------------------------------------------- comms and memory models
    def _llh_itemsize(self) -> int:
        """The ring's node LLH is in the accumulation dtype on every path."""
        adt = accum_dtype(self.cfg, torch.empty((), dtype=self.dtype))
        return torch.empty((), dtype=adt).element_size()

    def _build_comms_model(self):
        return _comms.ring_step_model(
            self.n_pad, self.k_pad, self.dp, self.itemsize,
            len(self.cfg.step_candidates), llh_itemsize=self._llh_itemsize(),
            model=type(self).__name__, tp=self.tp,
            edges=self.g.num_directed_edges,
        )

    def _position_graph(self, positions) -> dict:
        """The ring buckets of the given mesh positions, by name."""
        bs = [b for i in positions for b in self.buckets[i]]
        return {
            "graph/ring_bucket_indptr": [b.indptr for b in bs],
            "graph/ring_bucket_indices": [b.indices for b in bs],
            "graph/ring_bucket_src": [b.src for b in bs],
            "graph/ring_bucket_dst": [b.dst for b in bs],
            "graph/ring_bucket_order": [b.order for b in bs],
        }

    def _build_memory_model(self):
        cfg = self.cfg
        d, pos, gb = self._busiest_device()
        dp, nl = self.dp, len(self.grid)
        remote = (sum(self.grid[(i + 1) % nl][j] != d for i, j in pos)
                  if dp > 1 else 0)
        return _mem.ring_memory_model(
            self.n_pad, self.k_pad // self.tp, dp, self.itemsize,
            len(cfg.step_candidates), gb, positions=len(pos),
            tp=self.tp, tp_split=self.tp_split,
            bucket_edges=max(b.num_directed_edges for i, _ in pos
                             for b in self.buckets[i]),
            first_device=d == self.devices[0], remote_successors=remote,
            overlap=bool(cfg.ring_overlap),
            health_on=int(cfg.health_every or 0) > 0,
            rollback=int(cfg.rollback_budget or 0) > 0,
            comms=self.comms, model=type(self).__name__,
        )


class StoreRingBigClamModel(StoreBacked, RingBigClamModel):
    """The ring trainer fed from a compiled graph cache, one shard file
    per mesh position (JAX `StoreRingBigClamModel`): position s buckets
    its phases from its own shard's CSR, so no global CSR is assembled.
    On a balanced cache (`cli ingest --balance`) the cache's balance
    permutation (store.load_perm) gives the pre-balance ranks of kernel
    #8's visit order, which is then the in-memory balanced build's.
    Trajectories are bit for bit RingBigClamModel's on the same layout:
    balance=False on the cache's graph, or balance=True on the text graph
    for a balanced cache."""

    _ring_balance_hint = StoreBacked._balance_hint

    def __init__(self, store, cfg: BigClamConfig, mesh: Mesh,
                 verify: bool = True):
        self._store_init(store, mesh, verify)
        # balance=False skips the in-memory auto-probe (it needs g.src);
        # the build warns from its own buckets instead
        super().__init__(_StoreGraphView(store), cfg, mesh, balance=False)

    def _balance_perm(self):
        return self.store.load_perm(verify=self._shard_verify)
