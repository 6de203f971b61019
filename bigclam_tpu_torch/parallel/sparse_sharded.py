"""Sharded sparse-representation BigCLAM trainer: top-M member lists over
the node axis of a (dp, 1) mesh, with the sparse allreduce of sumF.

Port of bigclam_tpu/parallel/sparse_sharded.py (`shard_touched_counts`,
`make_sparse_sharded_step`, `SparseShardedBigClamModel`). The mesh runs
single-controller (parallel/mesh.py): this process launches each shard's
work on that shard's device, and a device may repeat; on a multi-process
mesh (parallel/multihost.py) a rank holds and steps its own shards, and
the gathers, psums and the capped exchange cross ranks.

The dense mesh steps move O(K) a node: an all-gather of the (n_loc, K) F
shards and a (K,) psum of sumF. On the sparse representation both scale
with M instead:

  state     ids/w: one (n_loc, M) row shard a mesh position; K appears
            only in the (K,) sumF, one copy a shard's device
  exchange  an all-gather of the (n_loc, M) id/weight shards (the edge
            sweeps read neighbour rows from the gathered copy), and
            parallel.sparse_collectives.sparse_allreduce_sum for sumF:
            only the TOUCHED community ids travel, in fixed (cap,)
            buffers sized from the initial per-shard touched counts
            (cfg.sparse_comm_cap / sparse_cap_slack)

Above the density threshold (cfg.sparse_dense_fallback) the capped
exchange would move more bytes than the (K,) psum, so the step is built
with the dense psum instead (a STATIC choice, named in engaged_path); an
admission burst past the cap falls back to the dense psum for that step
only. Exchange-volume counters ride the state (comm_ids = the most
touched ids a shard exchanged, comm_dense = 1 when a step summed sumF by
the psum).

One step, per shard on its device:

    support update every cfg.support_every steps, against the gathered
      PRE-update rows of every shard
    ONE gather of the post-support ids and weights
    presence, then the sumF allreduce
    the gradient sweep, the candidate sweep and Armijo
      (ops.sparse_members; the member lookups read the gathered copy,
      with the shard's source rows offset by its first row, so the CUDA
      member-lookup kernel runs as on one device)
    the sumF allreduce of the new weights

The K axis is not sharded: member rows are M-wide whatever K is, so a
mesh with tp > 1 is refused, as is balance=True. The math is that of
models.sparse.SparseBigClamModel per iteration, with the per-shard sums
added in shard order; trajectories match the single-device sparse
trainer to float summation order.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.models.bigclam import _round_up, step_cfg_key
from bigclam_tpu_torch.models.sparse import SparseBigClamModel
from bigclam_tpu_torch.obs import comms as _comms
from bigclam_tpu_torch.obs import memory as _mem
from bigclam_tpu_torch.ops import diagnostics as dx
from bigclam_tpu_torch.ops import sparse_members as sm
from bigclam_tpu_torch.ops.objective import EdgeChunks, accum_dtype, edge_chunk_bound
from bigclam_tpu_torch.ops.sparse_members import SparseTrainState, SupportBlocks
from bigclam_tpu_torch.parallel import multihost as _mh
from bigclam_tpu_torch.parallel.mesh import K_AXIS, NODES_AXIS, Mesh, column
from bigclam_tpu_torch.parallel.sharded import (
    all_gather,
    device_csr,
    psum,
    shard_edge_counts,
    shard_edges,
)
from bigclam_tpu_torch.parallel.sparse_collectives import (
    auto_cap,
    psum_allreduce_sum,
    sparse_allreduce_sum,
    static_mode,
)
from bigclam_tpu_torch.utils.device import resolve_device
from bigclam_tpu_torch.utils.dist import process_count
from bigclam_tpu_torch.utils.profiling import part

SITE_MEMBERS = "sparse/all_gather_members"
SITE_SCALARS = "sparse/psum_scalars"


def shard_touched_counts(ids: np.ndarray, dp: int, k_pad: int) -> np.ndarray:
    """(dp,) number of distinct communities present in each shard's rows
    of a host (n_pad, M) id array — the figure the sparse-allreduce cap
    is sized from (auto_cap over the max). Copied from the JAX module."""
    n_pad = ids.shape[0]
    rows = n_pad // dp
    return np.array(
        [
            np.unique(
                ids[i * rows : (i + 1) * rows][
                    ids[i * rows : (i + 1) * rows] < k_pad
                ]
            ).size
            for i in range(dp)
        ],
        dtype=np.int64,
    )


def make_sparse_sharded_step(
    devices: list,
    edges: List[EdgeChunks],
    blocks: List[SupportBlocks],
    cfg: BigClamConfig,
    k_pad: int,
    m: int,
    cap: int,
    mode: str,
    n_live: Optional[int] = None,
    row0: int = 0,
) -> Callable[[SparseTrainState], SparseTrainState]:
    """One sharded sparse iteration. edges[i] / blocks[i] are shard i's
    edge chunks and support blocks on devices[i] (sources local, dst
    GLOBAL — they index the gathered rows); `mode` is the static
    collective choice (sparse_collectives.static_mode); `n_live` the live
    node count of the support-churn denominator (None: the padded rows).
    On a multi-process mesh `devices` is an Axis of this rank's shards,
    the first of them node shard `row0`, and the churn counts this rank's
    rows. Its parts are timed under utils.profiling.step_split on the
    first device's current stream."""
    sup_every = max(int(cfg.support_every), 1)
    use_sparse = mode == "sparse"
    dp = len(devices)
    d0 = devices[0]

    def allreduce(vals, pres):
        if use_sparse:
            return sparse_allreduce_sum(vals, pres, cap, k_pad, devices)
        return psum_allreduce_sum(vals, pres, devices)

    def step(state: SparseTrainState) -> SparseTrainState:
        ids0, w = list(state.ids), list(state.F)
        n_loc = ids0[0].shape[0]
        ids = list(ids0)
        if state.it % sup_every == 0:
            # the admission pass scores against the PRE-update neighbour
            # rows, as on one device — gathered, since neighbours live on
            # other shards
            with part("gathers", d0):
                i_full = all_gather(ids0, devices, SITE_MEMBERS)
                w_full = all_gather(w, devices, SITE_MEMBERS)
            with part("support", d0):
                for i in range(dp):
                    ids[i], w[i] = sm.support_update(
                        ids0[i], w[i], blocks[i], m, k_pad,
                        ids_nbr=i_full[i], w_nbr=w_full[i])
            del i_full, w_full
        # ONE post-support gather pair feeds the gradient AND candidate
        # sweeps (the dense steps' single gather of F, at M columns)
        with part("gathers", d0):
            ids_full = all_gather(ids, devices, SITE_MEMBERS)
            w_full = all_gather(w, devices, SITE_MEMBERS)
        with part("allreduces", d0):
            pres = [sm.presence(x, k_pad) for x in ids]
            sumF, cnt, fb = allreduce(
                [sm.sparse_sumF(ids[i], w[i], k_pad) for i in range(dp)], pres)
        w_new, grads, llhs, hists = [], [], [], []
        for i in range(dp):
            with part("grad_sweep", d0):
                grad, node_llh = sm.sparse_grad_llh(
                    ids[i], w[i], sumF[i], edges[i], cfg, k_pad,
                    ids_dst=ids_full[i], w_dst=w_full[i], row0=(row0 + i) * n_loc)
            with part("cand_sweep", d0):
                cand_nbr = sm.sparse_candidates(
                    ids[i], w[i], grad, edges[i], cfg, k_pad,
                    ids_dst=ids_full[i], w_dst=w_full[i], row0=(row0 + i) * n_loc)
            with part("armijo", d0):
                wn, hist = sm.sparse_armijo_update(
                    ids[i], w[i], sumF[i], grad, node_llh, cand_nbr, cfg, k_pad)
            w_new.append(wn)
            grads.append(grad)
            llhs.append(node_llh.sum())
            hists.append(hist)
        del ids_full, w_full
        with part("allreduces", d0):
            llh = psum(llhs, devices, SITE_SCALARS)[0]
            hist = psum(hists, devices, SITE_SCALARS)[0]
            # sumF of the UPDATED weights (ids unchanged since the support
            # pass: the touched set and the cap pressure are the same)
            sumF_new, cnt2, fb2 = allreduce(
                [sm.sparse_sumF(ids[i], w_new[i], k_pad) for i in range(dp)],
                pres)
        comm_ids, comm_dense = torch.maximum(cnt, cnt2), torch.maximum(fb, fb2)
        health = None
        if dx.health_on(cfg):
            # the fraction of LIVE member-id slots the admission rewrote,
            # over every shard (summed in shard order on the first device)
            # — every step, so the latch carries off-cadence bursts to the
            # next sample
            slots = float(max(n_live or n_loc * dp, 1) * m)
            changed = [(a != b).to(torch.float32).sum().to(d0)
                       for a, b in zip(ids, ids0)]
            churn = changed[0]
            for c in changed[1:]:
                churn = churn + c
            extras = {"support_churn": churn / slots}
            if use_sparse:
                # the cap pressure (touched ids vs the build-time cap) and
                # the runtime fallback flag; NA in static-psum mode
                extras["cap_occupancy"] = (
                    comm_ids.to(torch.float32) / float(max(cap, 1)))
                extras["dense_fallback"] = comm_dense.to(torch.float32)
                extras["exchanged_ids"] = comm_ids.to(torch.float32)
            extras, carry = dx.latch_extras(state.health, extras)
            health = dx.health_pack(
                cfg, state.it, tuple(state.F), tuple(w_new), sumF_new[0],
                hist, grad=tuple(grads), extras=extras, skip_carry=carry)
        return SparseTrainState(
            F=tuple(w_new),
            ids=tuple(ids),
            sumF=tuple(sumF_new),
            llh=llh.to(w[0].dtype),
            it=state.it + 1,
            accept_hist=hist,
            comm_ids=comm_ids,
            comm_dense=comm_dense,
            health=health,
        )

    return step


class SparseShardedBigClamModel(SparseBigClamModel):
    """Sparse-representation trainer over the node axis of a (dp, 1) mesh.
    The state's F (the weights) and ids are tuples of row shards, one a
    mesh position, and sumF one copy a shard; the rest lives on the first
    device.

    Usage:
        mesh = make_mesh((4, 1), [torch.device("cuda:0")] * 4)
        model = SparseShardedBigClamModel(graph, cfg, mesh)
        result = model.fit(F0)       # F0: dense (N, K) init, sparsified
    """

    def __init__(self, g: Graph, cfg: BigClamConfig, mesh: Mesh,
                 balance: bool = False):
        if mesh.shape[K_AXIS] != 1:
            raise ValueError(
                "the sparse representation does not shard the K axis "
                f"(mesh has tp={mesh.shape[K_AXIS]}): member rows are "
                "M-wide regardless of K — use a (dp, 1) mesh"
            )
        if balance:
            raise ValueError(
                "balance=True is not supported on the sparse sharded "
                "trainer yet; pre-balance at ingest (cli ingest "
                "--balance) instead"
            )
        self.mesh = mesh
        self.dp = mesh.shape[NODES_AXIS]
        # this process's node shards (every shard single-controller), the
        # first of them shard row0: an Axis with the nodes-axis group
        self.devices = column(mesh.grid(resolve_device), 0)
        self.row0 = mesh.origin[0]
        super().__init__(g, cfg, device=self.devices[0])

    def _path_reason(self) -> str:
        return (
            f"representation=sparse M={self.m} comm={self.comm_mode} "
            f"cap={self.comm_cap}"
        )

    # ------------------------------------------------------------ build
    def _setup(self) -> None:
        g, cfg, dp = self.g, self.cfg, self.dp
        # support blocks cannot straddle shards: the block size is sized
        # against a shard's rows, and every shard owns whole blocks
        self.block_b = sm.pick_block_b(
            cfg.sparse_score_block, -(-g.num_nodes // dp), self.m,
            g.num_directed_edges / max(g.num_nodes, 1),
        )
        self.n_pad = _round_up(max(g.num_nodes, dp), dp * self.block_b)
        self.n_loc = self.n_pad // dp
        chunk = edge_chunk_bound(cfg, self.m, self.itemsize)
        shards = shard_edges(g, dp, self.n_pad)
        self.shard_csr = [
            device_csr(*shards[self.row0 + i], d)
            for i, d in enumerate(self.devices)
        ]
        self.edges = [EdgeChunks(c.src, c.dst, chunk) for c in self.shard_csr]
        sl, dd, mm = sm.support_blocks_host(g, self.n_pad, self.block_b)
        bps = (self.n_pad // self.block_b) // dp
        self.blocks = [
            SupportBlocks(
                src_local=torch.as_tensor(sl[i * bps:(i + 1) * bps]).to(d),
                dst=torch.as_tensor(dd[i * bps:(i + 1) * bps]).to(d),
                mask=torch.as_tensor(mm[i * bps:(i + 1) * bps]).to(self.dtype).to(d),
                block_b=self.block_b,
            )
            for i, d in enumerate(self.devices, start=self.row0)
        ]
        # a build-time guess of one M row a shard, with slack;
        # _on_init_sparsified refines it from the REAL initial touched
        # counts and rebuilds the step when the layout moves
        self._set_comm(max(self.m, 8))
        self.rebuild_step()

    def _set_comm(self, touched_per_shard: int) -> None:
        cfg = self.cfg
        if cfg.sparse_comm_cap > 0:
            self.comm_cap = min(_round_up(cfg.sparse_comm_cap, 8), self.k_pad)
        else:
            self.comm_cap = auto_cap(
                touched_per_shard, self.k_pad, cfg.sparse_cap_slack, self.m
            )
        self.comm_mode = static_mode(
            self.comm_cap, self.k_pad, cfg.sparse_dense_fallback
        )
        self._emit_comm_event(touched_per_shard)
        # the comms and memory models follow the collective layout: re-baked
        # and re-emitted (replacing the old ones) when the refinement moves
        # it, so the run report prices the step that runs; the first bake
        # is the constructor's
        if self.memory is not None:
            self.comms = self._build_comms_model()
            _comms.emit_model(self.comms)
            self.memory = self._build_memory_model()
            _mem.emit_model(self.memory, self._host_memory_model())

    def _emit_comm_event(self, touched_per_shard: int) -> None:
        """The collective layout (cap, static mode, the touched count it
        was sized from) as a `sparse_comm` telemetry event, at build and
        again when _on_init_sparsified refines the auto cap; the per-step
        occupancy and fallback counters ride the `health` events."""
        from bigclam_tpu_torch.obs import telemetry as _obs

        tel = _obs.current()
        if tel is not None:
            tel.event(
                "sparse_comm",
                comm_cap=int(self.comm_cap),
                comm_mode=str(self.comm_mode),
                touched_per_shard=int(touched_per_shard),
                k=int(self.k_pad),
                m=int(self.m),
                dp=int(self.dp),
            )

    def _make_step(self):
        merge = ("merge_pallas" if sm.merge_kernel_want(self.cfg, self.device)
                 else "xla")
        step = make_sparse_sharded_step(
            self.devices, self.edges, self.blocks, self.cfg, self.k_pad,
            self.m, self.comm_cap, self.comm_mode, n_live=self.g.num_nodes,
            row0=self.row0,
        )
        comm = "spall" if self.comm_mode == "sparse" else "psum"
        return step, f"sparse_{merge}_{comm}"

    def _step_key(self):
        # the collective layout is baked into the step but not into the
        # config (auto cap): a step build per (cfg, cap, mode)
        return (step_cfg_key(self.cfg), self.comm_cap, self.comm_mode)

    def _on_init_sparsified(self, ids: np.ndarray) -> None:
        """Size the exchange cap from the initial per-shard touched counts
        (sparse_cap_slack headroom for support growth), then rebuild the
        step if the collective layout moved."""
        counts = shard_touched_counts(ids, self.dp, self.k_pad)
        worst = int(counts.max()) if counts.size else 1
        old = (self.comm_cap, self.comm_mode)
        self._set_comm(worst)
        if (self.comm_cap, self.comm_mode) != old:
            self.rebuild_step()
            self.path_reason = (
                f"representation=sparse M={self.m} comm={self.comm_mode} "
                f"cap={self.comm_cap} (auto from {worst} touched/shard)"
            )

    # ------------------------------------------- comms and memory models
    def _build_comms_model(self):
        adt = accum_dtype(self.cfg, torch.empty((), dtype=self.dtype))
        llh_isz = torch.empty((), dtype=adt).element_size()
        return _comms.sparse_step_model(
            self.n_pad, self.m, self.k_pad, self.dp, self.itemsize,
            len(self.cfg.step_candidates), self.comm_cap, self.comm_mode,
            support_every=self.cfg.support_every, llh_itemsize=llh_isz,
            model=type(self).__name__,
        )

    def comms_measured(self, state: SparseTrainState) -> dict:
        """The static model against the RUNTIME exchange counters riding
        `state` (obs.comms.sparse_measured, JAX's keys), plus the model
        re-priced from the bytes the collective helpers pass in one step
        from `state` (`counted_sites`, `counted_bytes_per_step`; the new
        state is dropped)."""
        out = _comms.sparse_measured(self.comms, state)
        counted = _comms.measured_step(self.comms, self._step, state)[0]
        out["counted_sites"] = counted.site_bytes()
        out["counted_bytes_per_step"] = round(counted.bytes_per_step(), 1)
        return out

    def _emit_balance(self) -> None:
        from bigclam_tpu_torch.obs import telemetry as _obs

        if _obs.current() is None:
            return
        _comms.emit_shard_balance(
            "shard_edges", shard_edge_counts(self.g.src, self.n_pad, self.dp),
            self.dp, process_count=process_count(),
            hint="pre-balance at ingest (cli ingest --balance)",
            model=type(self).__name__, dp=self.dp,
        )

    def _position_graph(self, positions) -> dict:
        """The graph tensors of the given mesh positions, by name."""
        csrs = [self.shard_csr[i] for i in positions]
        blocks = [self.blocks[i] for i in positions]
        return {
            "graph/shard_csr_indptr": [c.indptr for c in csrs],
            "graph/shard_csr_indices": [c.indices for c in csrs],
            "graph/shard_csr_src": [c.src for c in csrs],
            "graph/shard_csr_dst": [c.dst for c in csrs],
            "graph/support_blocks": [(b.src_local, b.dst, b.mask) for b in blocks],
        }

    def _graph_device_arrays(self) -> dict:
        return self._position_graph(range(len(self.devices)))

    def _memory_state_arrays(self, state) -> list:
        return [state.F, state.ids, state.sumF, state.llh, state.accept_hist,
                state.comm_ids, state.comm_dense]

    def _busiest_device(self) -> tuple:
        """(device, its mesh positions, its graph bytes by name) of the
        device holding the most state + graph bytes: the one the memory
        model describes."""
        best = None
        row = self.n_loc * self.m * (self.itemsize + 4)
        for d in dict.fromkeys(self.devices):
            pos = [i for i, x in enumerate(self.devices) if x == d]
            gb = _mem.bytes_by_name(self._position_graph(pos))
            total = len(pos) * row + self.k_pad * self.itemsize + sum(gb.values())
            if best is None or total > best[0]:
                best = (total, d, pos, gb)
        return best[1:]

    def _build_memory_model(self):
        cfg = self.cfg
        d, pos, gb = self._busiest_device()
        return _mem.sparse_memory_model(
            self.n_pad, self.m, self.k_pad, self.itemsize,
            len(cfg.step_candidates), gb,
            max(self.shard_csr[i].num_directed_edges for i in pos),
            chunk=self.edges[0].chunk,
            health_on=int(cfg.health_every or 0) > 0,
            rollback=int(cfg.rollback_budget or 0) > 0,
            model=type(self).__name__, dp=self.dp, positions=len(pos),
            first_device=d == self.devices[0],
            gathers=1 if self.dp > 1 else 0, comms=self.comms,
        )

    # ------------------------------------------------------------ state
    def _place(self, ids: np.ndarray, w: np.ndarray):
        """Host (n_pad, M) ids and weights -> one row shard a position."""
        ids_t = torch.from_numpy(np.asarray(ids, np.int32))
        w_t = torch.from_numpy(np.asarray(w)).to(self.dtype)
        r = self.n_loc
        # this process's shards only on a multi-process mesh
        return (
            tuple(ids_t[i * r:(i + 1) * r].to(d, copy=True)
                  for i, d in enumerate(self.devices, start=self.row0)),
            tuple(w_t[i * r:(i + 1) * r].to(d, copy=True)
                  for i, d in enumerate(self.devices, start=self.row0)),
        )

    def reset_state(self, ids, w, llh: Optional[float] = None,
                    it: int = 0) -> SparseTrainState:
        """A SparseTrainState around placed row shards: sumF through the
        psum (every shard's device the same bits), LLH -inf until a step
        evaluates one, zero histogram and counters on the first device."""
        sums = psum([sm.sparse_sumF(i, x, self.k_pad) for i, x in zip(ids, w)],
                    self.devices)
        d0 = self.devices[0]
        zero = torch.zeros((), dtype=torch.int32, device=d0)
        return SparseTrainState(
            F=tuple(w),
            ids=tuple(ids),
            sumF=tuple(sums),
            llh=torch.tensor(-float("inf") if llh is None else llh,
                             dtype=self.dtype, device=d0),
            it=int(it),
            accept_hist=torch.zeros(len(self.cfg.step_candidates) + 1,
                                    dtype=torch.int32, device=d0),
            comm_ids=zero,
            comm_dense=zero.clone(),
        )

    def _joined(self, state: SparseTrainState) -> SparseTrainState:
        """The state with its row shards joined on the first device (the
        single-device layout the fold-in reads; every rank's shards on a
        multi-process mesh)."""
        d0 = self.devices[0]
        return state._replace(
            F=torch.from_numpy(_mh.fetch_global(state.F, self.mesh)).to(d0),
            ids=torch.from_numpy(_mh.fetch_global(state.ids, self.mesh)).to(d0),
            sumF=state.sumF[0],
        )

    def extract_F(self, state: SparseTrainState) -> np.ndarray:
        """Densify the live (N, K) block on the host (a collective on a
        multi-process mesh: multihost.fetch_global)."""
        return sm.to_dense(
            _mh.fetch_global(state.ids, self.mesh),
            _mh.fetch_global(state.F, self.mesh),
            self.g.num_nodes, self.cfg.num_communities,
        )

    def last_comm(self, state: SparseTrainState):
        """(max touched ids exchanged, dense-fallback flag) of the last
        step — the exchange-volume counters the gates assert."""
        return int(state.comm_ids), bool(int(state.comm_dense))

    def health_sig(self, state: SparseTrainState) -> torch.Tensor:
        """(n_pad,) int32 top-community signature of the shards on the
        first device (-1 on empty rows)."""
        d0 = self.devices[0]
        return torch.cat([dx.sparse_top_community(i, w).to(d0)
                          for i, w in zip(state.ids, state.F)])

    def state_nbytes(self, state: Optional[SparseTrainState] = None) -> int:
        """Affiliation-state bytes (ids + weights + one sumF) over every
        shard."""
        if state is None:
            return super().state_nbytes()
        return int(sum(t.numel() * t.element_size()
                       for t in (*state.F, *state.ids, state.sumF[0])))

    def foldin_rows(self, state: SparseTrainState, nodes, **kw):
        """SparseBigClamModel.foldin_rows on the joined shards."""
        return super().foldin_rows(self._joined(state), nodes, **kw)

    def refit_commit(self, state: SparseTrainState, nodes,
                     rows: np.ndarray) -> SparseTrainState:
        """SparseBigClamModel.refit_commit on the joined shards, placed
        back one row shard a position."""
        out = super().refit_commit(self._joined(state), nodes, rows)
        return self.reset_state(
            *self._place(out.ids.cpu().numpy(), out.F.cpu().numpy()),
            llh=float(state.llh), it=state.it)

    # ------------------------------------------------------ checkpoints
    def _ckpt_meta(self) -> dict:
        meta = super()._ckpt_meta()
        # another shard count pads rows differently; slot arrays are
        # cropped nowhere, so refuse rather than re-pad
        meta["node_shards"] = self.dp
        return meta

    def _state_to_arrays(self, state: SparseTrainState) -> dict:
        # a collective on a multi-process mesh: every rank enters it
        return {
            "F": _mh.fetch_global(state.F, self.mesh),
            "ids": _mh.fetch_global(state.ids, self.mesh),
            "sumF": state.sumF[0].cpu().numpy(),
            "llh": state.llh.cpu().numpy(),
            "it": np.asarray(state.it, np.int32),
        }
