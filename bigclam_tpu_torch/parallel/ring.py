"""Ring-pass sharded training: rotate F node-shards around the mesh instead
of all-gathering F.

Port of the tp = 1, single-host part of bigclam_tpu/parallel/ring.py
(`ring_bucket_imbalance`, `ring_shard_edges`, `rotate_scan`,
`make_ring_train_step`, the tp = 1 `step_shard` of
`make_ring_csr_train_step`, `RingBigClamModel`). Each shard holds its own
F_loc and one rotating shard; in phase r shard i holds shard (i + r) % dp
and sweeps the bucket of its edges whose destinations live there. Two
rotations make a step: the gradient pass, then the 16-candidate pass (it
needs the finished gradient). The fold, the node tail and the Armijo tails
are added once, after each rotation, so the trajectory is the all-gather
trainer's.

Buckets are per-(shard, phase) CSRs over the shard's rows with destination
rows local to the rotating shard, each of its own length: unlike the JAX
ring, nothing is padded to the largest bucket, so the "dp x padded work"
of a locality-ordered id space (the JAX `RingBigClamModel` docstring) does
not apply to the kernel path here; what stays is the per-shard edge
imbalance, which the balance relabeling evens out.

The phase sweep is kernel #8 (gradient) and #9 (candidates) on the paths
`csr_ring_fused` and `csr_ring` (ops.ring_kernels; the TPU difference
between the two, an fd gather, has no counterpart here, so both run the
same kernels), or their plain versions on `xla`. Each bucket carries
kernel #8's visit order of its rows (`visit_order`), computed once from
the graph when the model builds its buckets. Where the kernels engage, the
Armijo tails and the selection of each shard run in one more kernel, the
node pass's epilogue (ops.linesearch.armijo_update_kernel); `xla` keeps
them in torch.
"""

from __future__ import annotations

import sys
import warnings
from typing import Callable, List

import numpy as np
import torch

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import DeviceCSR, Graph
from bigclam_tpu_torch.models.bigclam import TrainState, _round_up, csr_fused_want
from bigclam_tpu_torch.ops.objective import accum_dtype, node_tail
from bigclam_tpu_torch.ops.ring_kernels import (
    ring_cand_phase,
    ring_cand_phase_plain,
    ring_grad_phase,
    ring_grad_phase_plain,
)
from bigclam_tpu_torch.parallel.mesh import NODES_AXIS, Mesh
from bigclam_tpu_torch.parallel.sharded import (
    ShardedBigClamModel,
    armijo_tail_select_sharded,
    device_csr,
    finish_step,
    psum,
)

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


def _warn_bucket_imbalance(g: Graph, dp: int, max_count: int) -> None:
    """Warn when one bucket holds more than RING_IMBALANCE_FACTOR x the
    mean: a locality-ordered id space (contiguous communities, BFS orders)
    puts ~all of a shard's edges in its diagonal bucket, and then the
    shards' edge counts are as uneven as their id ranges' degree sums.
    Reached only with balance=False: the default build relabels on the
    same rule."""
    mean_count = max(float(g.src.size) / (dp * dp), 1.0)
    if max_count > RING_IMBALANCE_FACTOR * mean_count:
        warnings.warn(
            f"ring phase buckets are imbalanced: max {max_count} vs mean "
            f"{mean_count:.0f} edges/bucket. Node ids look locality-ordered; "
            "relabel (balance=True or the default balance=None auto rule) "
            "or shuffle ids before the ring schedule.",
            stacklevel=5,                 # the caller of RingBigClamModel()
        )


def ring_shard_edges(g: Graph, dp: int, n_pad: int) -> list:
    """Bucket each src shard's edges by destination shard: buckets[i][r] =
    (indptr (rows+1,) int64, indices int32) over shard i's n_pad/dp rows,
    holding the edges whose destinations live in shard (i + r) % dp, with
    BOTH ends local (src by its CSR row, dst by its row in that shard).
    Membership is JAX `ring_shard_edges`' (phase = (dst_shard - src_shard)
    mod dp) and each bucket keeps CSR (src-sorted) order; no bucket is
    padded."""
    rows = n_pad // dp
    src_shard = g.src.astype(np.int64) // rows
    dst_shard = g.dst.astype(np.int64) // rows
    key = src_shard * dp + (dst_shard - src_shard) % dp
    order = np.argsort(key, kind="stable")         # CSR order within a bucket
    bounds = np.searchsorted(key[order], np.arange(dp * dp + 1))
    buckets = []
    for i in range(dp):
        row = []
        for r in range(dp):
            sel = order[bounds[i * dp + r] : bounds[i * dp + r + 1]]
            src = g.src[sel].astype(np.int64) - i * rows
            indptr = np.zeros(rows + 1, dtype=np.int64)
            np.cumsum(np.bincount(src, minlength=rows), out=indptr[1:])
            dst = g.dst[sel].astype(np.int64) - ((i + r) % dp) * rows
            row.append((indptr, dst.astype(np.int32)))
        buckets.append(row)
    return buckets


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
    would only bring each shard home, is not made.

    overlap=True (cfg.ring_overlap, the default): the hop for phase r + 1
    is issued before phase r's sweep, as a non_blocking copy on side
    streams of the two devices, and the next phase's stream waits for it
    (wait_stream records an event). overlap=False: the hop follows the
    sweep on the current streams. Both compute the same bits. Where a shard
    and its successor share a device (a mesh of a repeated device, any CPU
    mesh) the hop is a no-op: the rotating shard IS the other shard's
    F_loc, which is never written."""

    def __init__(self, devices: list, overlap: bool):
        self.devices = devices
        self.overlap = overlap
        self._side = {}

    def _stream(self, device: torch.device) -> "torch.cuda.Stream":
        if device not in self._side:
            self._side[device] = torch.cuda.Stream(device=device)
        return self._side[device]

    def _hop(self, rot: list):
        """Issue one hop; returns (next rot, join) — join() makes each
        device's current stream wait for the copies it receives."""
        dp = len(rot)
        out, joins = [], []
        for i, dst in enumerate(self.devices):
            src_dev, t = self.devices[(i + 1) % dp], rot[(i + 1) % dp]
            if src_dev == dst:
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
        rot = list(shards)
        dp = len(rot)
        for r in range(dp):
            if r == dp - 1:
                sweep(r, rot)
            elif self.overlap:
                nxt, join = self._hop(rot)
                sweep(r, rot)
                join()
                rot = nxt
            else:
                sweep(r, rot)
                rot, _ = self._hop(rot)


def make_ring_train_step(
    devices: list, buckets: List[List[DeviceCSR]], cfg: BigClamConfig, path: str
) -> Callable[[TrainState], TrainState]:
    """One ring iteration (two rotations) on kernel path `path`:
    `csr_ring_fused` / `csr_ring` (kernels #8 and #9) or `xla` (their plain
    versions). buckets[i][r] is shard i's phase-r bucket on devices[i]."""
    if path == "xla":
        grad_phase, cand_phase = ring_grad_phase_plain, ring_cand_phase_plain
    else:
        grad_phase, cand_phase = ring_grad_phase, ring_cand_phase
    rotation = RingRotation(devices, cfg.ring_overlap)
    dp = len(devices)
    num_s = len(cfg.step_candidates)

    def step(state: TrainState) -> TrainState:
        F = state.F
        adt = accum_dtype(cfg, F[0])
        sumF = psum([f.sum(dim=0) for f in F], devices)

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
        return finish_step(state, outs, devices, cfg, grad)

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

    @property
    def engaged_path(self) -> str:
        """`csr_ring_fused` / `csr_ring` where the kernels engage (the JAX
        labels: the ring's profile is not the all-gather's), else `xla`."""
        if not self.kernels:
            return "xla"
        return "csr_ring_fused" if csr_fused_want(self.cfg) else "csr_ring"

    def _build_edges_and_step(self) -> None:
        dp = len(self.devices)
        _warn_bucket_imbalance(
            self.g, dp, ring_bucket_imbalance(self.g, dp, self.n_pad)[0]
        )
        host = ring_shard_edges(self.g, dp, self.n_pad)
        self.buckets = [
            [device_csr(indptr, indices, d) for indptr, indices in host[i]]
            for i, d in enumerate(self.devices)
        ]
        self.set_visit_order(VISIT_ORDER)
        self.rebuild_step()

    def set_visit_order(self, how: str) -> None:
        """Give every bucket kernel #8's visit order `how` (visit_order; the
        pre-balance rank of a row is its node's original id), in place, so a
        built step takes it too."""
        rank = None
        if self._perm is not None:
            rank = np.arange(self.n_pad)
            rank[self._perm] = np.arange(self._perm.shape[0])
        rows = self.n_pad // len(self.devices)
        for i, row in enumerate(self.buckets):
            shard_rank = None if rank is None else rank[i * rows : (i + 1) * rows]
            for r, b in enumerate(row):
                order = visit_order(b.indptr.cpu().numpy(), b.indices.cpu().numpy(),
                                    how, shard_rank)
                row[r] = b._replace(order=torch.as_tensor(order, device=b.indptr.device))
        self.visit_order = how

    def rebuild_step(self) -> None:
        self._step = make_ring_train_step(
            self.devices, self.buckets, self.cfg, self.engaged_path
        )
