"""Single-device BigCLAM trainer on the sparse top-M membership
representation (ops.sparse_members).

Port of the single-device parts of bigclam_tpu/models/sparse.py. One
outer iteration is

    [support update every cfg.support_every iterations: admit candidate
     communities from neighbour member lists, keep the top M]
    -> sparse grad/LLH pass -> 16-candidate Armijo pass (one member
       lookup per edge chunk in each pass) -> masked Jacobi update ->
       sparse sumF

on one of two paths, named as in the JAX package: `sparse_merge_pallas`,
where every member lookup runs in the CUDA kernel csrc/member_lookup.cu
(auto on `cuda`; cfg.sparse_pallas_merge=True on the CPU runs the
kernel's plain version), and `sparse_xla`, the plain torch lookup. The
iteration counter is a host int, so the support-update decision is a
plain `if`.

Rows are padded to a whole number of support-update blocks (n_pad =
round_up(N, block_b), as the JAX model pads); padding rows and empty
slots hold the sentinel id K with weight 0, which stays 0 only with
min_f == 0 (checked). Edge chunks are bounded by the (chunk, M) width,
not K.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.models.bigclam import (
    CheckpointMismatchError,
    FitResult,
    MemoryAccountedModel,
    _round_up,
    check_ckpt_meta,
    count_rows,
    fit_with_resume,
    rowkeyed_init_F,
)
from bigclam_tpu_torch.ops import diagnostics as dx
from bigclam_tpu_torch.ops import sparse_members as sm
from bigclam_tpu_torch.ops.objective import EdgeChunks, edge_chunk_bound
from bigclam_tpu_torch.ops.sparse_members import SparseTrainState
from bigclam_tpu_torch.utils.device import resolve_device, resolve_dtype
from bigclam_tpu_torch.utils.profiling import part


def effective_m(cfg: BigClamConfig) -> int:
    """The slot count actually allocated: cfg.sparse_m clamped to K (more
    slots than communities hold nothing; M >= K is the dense-parity
    regime)."""
    return max(1, min(int(cfg.sparse_m), int(cfg.num_communities)))


def make_sparse_train_step(
    edges: EdgeChunks,
    blocks: sm.SupportBlocks,
    cfg: BigClamConfig,
    k_pad: int,
    m: int,
    n_live: Optional[int] = None,
) -> Callable[[SparseTrainState], SparseTrainState]:
    """One sparse iteration; the same step contract as
    models.bigclam.make_train_step (the state's LLH is that of its input).
    `n_live` is the live node count of the support-churn denominator
    (padding rows never admit; None falls back to the padded count).

    Its parts are spans timed on the state's device (utils.profiling.part,
    the mesh step's names): `support` (the support update), `sums` (each
    of the two column sums), `grad_sweep`, `cand_sweep` and `armijo`; the
    histogram feeds the step counters (count_rows)."""
    sup_every = max(int(cfg.support_every), 1)

    def step(state: SparseTrainState) -> SparseTrainState:
        ids0, w = state.ids, state.F
        ids, d = ids0, w.device
        if state.it % sup_every == 0:
            with part("support", d):
                ids, w = sm.support_update(ids0, w, blocks, m, k_pad)
        # recomputed, not carried: a support update may drop members
        with part("sums", d):
            sumF = sm.sparse_sumF(ids, w, k_pad)
        with part("grad_sweep", d):
            grad, node_llh = sm.sparse_grad_llh(ids, w, sumF, edges, cfg, k_pad)
        with part("cand_sweep", d):
            cand_nbr = sm.sparse_candidates(ids, w, grad, edges, cfg, k_pad)
        with part("armijo", d):
            w_new, hist = sm.sparse_armijo_update(
                ids, w, sumF, grad, node_llh, cand_nbr, cfg, k_pad
            )
        with part("sums", d):
            sumF_new = sm.sparse_sumF(ids, w_new, k_pad)
        count_rows(hist, ids.shape[0] - n_live if n_live else 0)
        health = None
        if dx.health_on(cfg):
            # support churn: the fraction of live member-id slots the
            # admission pass rewrote, computed every step and LATCHED
            # (max since the last sample) so an off-cadence admission
            # burst still shows in the next sample; the pack itself only
            # on cadence iterations
            slots = float(max(n_live or ids.shape[0], 1) * m)
            churn = (ids != ids0).to(torch.float32).sum() / slots
            extras, carry = dx.latch_extras(state.health, {"support_churn": churn})
            health = dx.health_pack(cfg, state.it, w, w_new, sumF_new, hist,
                                    grad=grad, extras=extras, skip_carry=carry)
        return SparseTrainState(
            F=w_new,
            ids=ids,
            sumF=sumF_new,
            llh=node_llh.sum().to(w.dtype),
            it=state.it + 1,
            accept_hist=hist,
            comm_ids=state.comm_ids,
            comm_dense=state.comm_dense,
            health=health,
        )

    return step


def new_sparse_state(
    ids: torch.Tensor, w: torch.Tensor, k_pad: int, num_s: int,
    llh: Optional[float] = None, it: int = 0,
) -> SparseTrainState:
    """SparseTrainState around device-resident (ids, w): sumF by the
    sparse scatter, LLH -inf until a step evaluates one, a zero
    accepted-step histogram and zero exchange counters."""
    zero = torch.zeros((), dtype=torch.int32, device=w.device)
    return SparseTrainState(
        F=w,
        ids=ids,
        sumF=sm.sparse_sumF(ids, w, k_pad),
        llh=torch.tensor(
            -float("inf") if llh is None else llh, dtype=w.dtype, device=w.device
        ),
        it=int(it),
        accept_hist=torch.zeros(num_s + 1, dtype=torch.int32, device=w.device),
        comm_ids=zero,
        comm_dense=zero.clone(),
    )


def state_from_jax_sparse_arrays(
    ids: np.ndarray,
    w: np.ndarray,
    n: int,
    m: int,
    k: int,
    dtype: torch.dtype,
    device: torch.device,
    llh: Optional[float] = None,
    it: int = 0,
    n_pad: Optional[int] = None,
    num_s: int = 16,
) -> SparseTrainState:
    """A SparseTrainState of this port from the JAX package's sparse state
    arrays (`ids`, and the weights it names `F`): the rows past n stripped
    and re-padded to n_pad (default n) with sentinel rows. The sentinel
    is K in both packages (both pad K to itself on the sparse path)."""
    ids, w = np.asarray(ids)[:n], np.asarray(w)[:n]
    if ids.shape != (n, m) or w.shape != (n, m):
        raise ValueError(f"ids {ids.shape} / weights {w.shape}, want ({n}, {m})")
    n_pad = n if n_pad is None else n_pad
    ids_p = torch.full((n_pad, m), k, dtype=torch.int32)
    w_p = torch.zeros((n_pad, m), dtype=dtype)
    ids_p[:n] = torch.as_tensor(np.array(ids, np.int32))
    w_p[:n] = torch.as_tensor(np.array(w)).to(dtype)
    return new_sparse_state(
        ids_p.to(device), w_p.to(device), k, num_s, llh=llh, it=it
    )


class SparseBigClamModel(MemoryAccountedModel):
    """Single-device sparse-representation trainer.

    Usage:
        model = SparseBigClamModel(graph, cfg)     # cfg.representation="sparse"
        model = SparseBigClamModel(graph, cfg, device="cpu")
        result = model.fit(F0)                     # F0: dense (N, K) init,
                                                   # sparsified to top-M rows
    """

    def __init__(self, g: Graph, cfg: BigClamConfig, device=None):
        if cfg.representation != "sparse":
            raise ValueError(
                "SparseBigClamModel requires cfg.representation='sparse' "
                f"(got {cfg.representation!r})"
            )
        if cfg.min_f != 0.0:
            # sentinel slots rely on clip(0 + eta*0) staying 0, as dense
            # padding does
            raise ValueError(
                f"sparse representation requires min_f == 0.0 (got {cfg.min_f})"
            )
        self.g = g
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(cfg.dtype, self.device)
        self.m = effective_m(cfg)
        self.k_pad = cfg.num_communities
        if sm.merge_kernel_want(cfg, self.device) and self.device.type == "cuda":
            sm.check_member_limit(self.m)
        self._setup()
        self.path_reason = self._path_reason()
        # the memory model (obs.memory), baked from the built layout
        self._bake_models()

    def _setup(self) -> None:
        """Padding, the device edge and block layout, and the train step
        (the hook the sharded trainer replaces with its schedule)."""
        g, cfg = self.g, self.cfg
        self.block_b = sm.pick_block_b(
            cfg.sparse_score_block, g.num_nodes, self.m,
            g.num_directed_edges / max(g.num_nodes, 1),
        )
        self.n_pad = _round_up(max(g.num_nodes, 1), self.block_b)
        self.csr = g.to_device(self.device)
        # edge chunks bounded by the (chunk, M) gather width: M, not K
        self.edges = EdgeChunks(
            self.csr.src, self.csr.dst,
            edge_chunk_bound(cfg, self.m, self.itemsize),
        )
        self.blocks = sm.build_support_blocks(
            g, self.n_pad, self.block_b, dtype=self.dtype, device=self.device
        )
        self.rebuild_step()

    def _path_reason(self) -> str:
        return f"representation=sparse M={self.m}"

    def _make_step(self):
        """(the train step for the CURRENT self.cfg, its path name)."""
        step = make_sparse_train_step(
            self.edges, self.blocks, self.cfg, self.k_pad, self.m,
            n_live=self.g.num_nodes,
        )
        merge = "merge_pallas" if sm.merge_kernel_want(self.cfg, self.device) else "xla"
        return step, f"sparse_{merge}"

    def rebuild_step(self) -> None:
        """(Re)build the train step for the CURRENT self.cfg."""
        self._step, self.engaged_path = self._make_step()
        self._note_step_build()

    # ------------------------------------------------- memory accounting
    def _graph_device_arrays(self) -> dict:
        """The CSR (the edge chunks are views of its src/dst) and the
        support update's block layout."""
        return {
            "graph/csr_indptr": self.csr.indptr,
            "graph/csr_indices": self.csr.indices,
            "graph/csr_src": self.csr.src,
            "graph/csr_dst": self.csr.dst,
            "graph/support_blocks": (self.blocks.src_local, self.blocks.dst,
                                     self.blocks.mask),
        }

    def _memory_state_arrays(self, state) -> list:
        return [state.F, state.ids, state.sumF, state.llh, state.accept_hist]

    def _build_memory_model(self):
        from bigclam_tpu_torch.obs import memory as _mem

        cfg = self.cfg
        return _mem.sparse_memory_model(
            self.n_pad, self.m, self.k_pad, self.itemsize,
            len(cfg.step_candidates),
            _mem.bytes_by_name(self._graph_device_arrays()),
            self.csr.num_directed_edges, chunk=self.edges.chunk,
            health_on=int(cfg.health_every or 0) > 0,
            rollback=int(cfg.rollback_budget or 0) > 0,
            model=type(self).__name__,
        )

    # ------------------------------------------------------------ state
    def init_state(self, F0: Optional[np.ndarray] = None) -> SparseTrainState:
        """Sparsify a dense (N, K) init (rowkeyed when None) to top-M rows,
        through the hooks _on_init_sparsified, _place and reset_state."""
        n, k = self.g.num_nodes, self.cfg.num_communities
        if F0 is None:
            F0 = rowkeyed_init_F(self.g, self.cfg)
        if F0.shape != (n, k):
            raise ValueError(f"F0 has shape {F0.shape}, want {(n, k)}")
        ids, w, _ = sm.from_dense(np.asarray(F0), self.m, self.k_pad, self.n_pad)
        self._on_init_sparsified(ids)
        return self.reset_state(*self._place(ids, w))

    def _place(self, ids: np.ndarray, w: np.ndarray):
        """Host (n_pad, M) ids and weights -> the device (the sharded
        trainer's hook places one row shard a mesh position)."""
        return (torch.from_numpy(np.asarray(ids, np.int32)).to(self.device),
                torch.from_numpy(np.asarray(w)).to(self.dtype).to(self.device))

    def _on_init_sparsified(self, ids: np.ndarray) -> None:
        """Hook: the sharded trainer sizes its sparse-allreduce buffers
        from the initial per-shard touched counts here."""

    def reset_state(self, ids, w, llh: Optional[float] = None,
                    it: int = 0) -> SparseTrainState:
        """A SparseTrainState around placed (ids, w)."""
        return new_sparse_state(ids, w, self.k_pad,
                                len(self.cfg.step_candidates), llh=llh, it=it)

    def state_from_jax(
        self, ids: np.ndarray, w: np.ndarray, llh: Optional[float] = None,
        it: int = 0,
    ) -> SparseTrainState:
        """state_from_jax_sparse_arrays at this model's layout."""
        return state_from_jax_sparse_arrays(
            ids, w, self.g.num_nodes, self.m, self.cfg.num_communities,
            self.dtype, self.device, llh=llh, it=it, n_pad=self.n_pad,
            num_s=len(self.cfg.step_candidates),
        )

    def extract_F(self, state: SparseTrainState) -> np.ndarray:
        """Densify the live (N, K) block on the host."""
        return sm.to_dense(
            state.ids.cpu().numpy(), state.F.cpu().numpy(),
            self.g.num_nodes, self.cfg.num_communities,
        )

    def state_nbytes(self, state: Optional[SparseTrainState] = None) -> int:
        """Affiliation-state bytes (ids + weights + sumF), from the model's
        shapes without a state."""
        if state is None:
            isz = torch.empty((), dtype=self.dtype).element_size()
            return int(self.n_pad * self.m * (isz + 4) + self.k_pad * isz)
        return int(sum(
            t.numel() * t.element_size() for t in (state.F, state.ids, state.sumF)
        ))

    # ------------------------------------------------ fold-in and refit
    def foldin_rows(
        self,
        state: SparseTrainState,
        nodes,
        max_deg: Optional[int] = None,
        max_iters: Optional[int] = None,
        conv_tol: Optional[float] = None,
        init: str = "own",
    ):
        """Batched fold-in against the frozen sparse state (the twin of
        BigClamModel.foldin_rows): the neighbour member lists are
        densified per query batch (ops.foldin.densify_member_rows — only
        the B*D window pays K columns), then the same row ascent runs.
        Returns dense (rows (B, K), llh (B,), iters (B,))."""
        from bigclam_tpu_torch.ops import foldin as fi
        from bigclam_tpu_torch.serve.snapshot import pad_neighbor_batch

        nodes = np.asarray(nodes, np.int64)
        nbr_ids, nbr_mask, _ = pad_neighbor_batch(
            self.g.indptr, self.g.indices, nodes, max_deg=max_deg
        )
        dt = state.F.dtype
        nbr_rows = fi.densify_member_rows(
            state.ids, state.F, torch.from_numpy(nbr_ids).to(self.device),
            self.k_pad,
        )
        mask = torch.from_numpy(nbr_mask).to(device=self.device, dtype=dt)
        own = fi.densify_rows(state.ids, state.F,
                              torch.from_numpy(nodes).to(self.device),
                              self.k_pad)
        sumF_others = state.sumF[None, :] - own
        rows0 = own if init == "own" else fi.neighbor_mean_rows(nbr_rows, mask)
        fit = fi.make_foldin_fit(self.cfg, max_iters=max_iters,
                                 conv_tol=conv_tol)
        rows, llh, iters = fit(rows0, nbr_rows, mask, sumF_others)
        k = self.cfg.num_communities
        return (rows[:, :k].cpu().numpy(), llh.cpu().numpy(),
                iters.cpu().numpy())

    def refit_commit(
        self, state: SparseTrainState, nodes, rows: np.ndarray
    ) -> SparseTrainState:
        """The sparse twin of BigClamModel.refit_commit: freshly folded
        DENSE rows are re-sparsified to top-M member lists (ops.
        sparse_members.from_dense, the init-time truncation rule) and
        scattered into the slot arrays; sumF re-reduces from the member
        lists so it never drifts from the truncation."""
        nodes_t = torch.from_numpy(np.asarray(nodes, np.int64)).to(self.device)
        ids_b, w_b, _ = sm.from_dense(
            np.asarray(rows, np.float64), self.m, self.k_pad, len(nodes)
        )
        ids = state.ids.index_copy(
            0, nodes_t, torch.from_numpy(ids_b).to(self.device))
        w = state.F.index_copy(
            0, nodes_t,
            torch.from_numpy(w_b).to(device=self.device, dtype=self.dtype))
        return state._replace(
            ids=ids, F=w, sumF=sm.sparse_sumF(ids, w, self.k_pad)
        )

    def warm_start_refit(self, F_prev: np.ndarray, touched, **kw):
        """Incremental warm-start refit restricted to touched rows + halo
        (models.refit.warm_start_refit): the state stays M-sized, only
        each fold-in query window densifies."""
        from bigclam_tpu_torch.models.refit import warm_start_refit

        return warm_start_refit(self, F_prev, touched, **kw)

    def health_sig(self, state: SparseTrainState) -> torch.Tensor:
        """(N_pad,) int32 top-community signature from the member lists
        (-1 on empty rows)."""
        return dx.sparse_top_community(state.ids, state.F)

    # ------------------------------------------------------ checkpoints
    def _ckpt_meta(self) -> dict:
        """The sidecar meta of the JAX SparseBigClamModel: a dense
        checkpoint, another M, graph, K, padding or seed is refused."""
        return {
            "num_nodes": self.g.num_nodes,
            "num_directed_edges": self.g.num_directed_edges,
            "k": self.cfg.num_communities,
            "n_pad": self.n_pad,
            "k_pad": self.k_pad,
            "seed": self.cfg.seed,
            "representation": "sparse",
            "sparse_m": self.m,
        }

    def _state_to_arrays(self, state: SparseTrainState) -> dict:
        return {
            "F": state.F.cpu().numpy(),
            "ids": state.ids.cpu().numpy(),
            "sumF": state.sumF.cpu().numpy(),
            "llh": state.llh.cpu().numpy(),
            "it": np.asarray(state.it, np.int32),
        }

    def _state_from_arrays(self, arrays: dict) -> SparseTrainState:
        if "ids" not in arrays:
            raise CheckpointMismatchError(
                "checkpoint holds no member-id array: dense-representation "
                "checkpoints cannot resume a sparse fit"
            )
        return self.reset_state(*self._place(arrays["ids"], arrays["F"]),
                                llh=float(arrays["llh"]), it=int(arrays["it"]))

    def _restore(self, checkpoints):
        """Sparse restore: strict meta equality (representation, M, K,
        graph, padding, seed) — the dense path's re-pad does not apply to
        slot arrays. Emits the same `restore` event as the dense one."""
        restored = checkpoints.restore()
        if restored is None:
            return None, ()
        ckpt_step, arrays, meta = restored
        from bigclam_tpu_torch.obs import telemetry as _obs

        tel = _obs.current()
        if tel is not None:
            tel.event("restore", step=int(ckpt_step))
        check_ckpt_meta(meta, self._ckpt_meta(), checkpoints.directory,
                        soft=(), run="sparse run")
        return self._state_from_arrays(arrays), tuple(meta.get("llh_history", ()))

    # -------------------------------------------------------------- fit
    def fit(
        self,
        F0: Optional[np.ndarray] = None,
        callback: Optional[Callable[[int, float], None]] = None,
        checkpoints=None,
        resume: bool = True,
    ) -> FitResult:
        """Train to convergence from F0 (rowkeyed init when None),
        resuming from `checkpoints` when it holds a state (resume=False:
        a cold start that still saves)."""
        return fit_with_resume(self, self.init_state(F0), callback,
                               self.extract_F, checkpoints, resume)

    def fit_state(
        self,
        state: SparseTrainState,
        callback: Optional[Callable[[int, float], None]] = None,
        checkpoints=None,
        resume: bool = True,
    ):
        """The convergence loop from a state, with no dense F anywhere:
        returns (final_state, final_llh, num_iters, llh_history)."""
        return fit_with_resume(self, state, callback, None, checkpoints, resume)
