"""Sparse top-M membership representation on a torch device.

Port of the single-device parts of bigclam_tpu/ops/sparse_members.py.
Dense F is O(N*K); each node keeps only its top-M communities instead:

  ids  (N_pad, M) int32 — member community ids, sorted ascending per row;
                          empty slots hold the sentinel K_pad (sorts last)
  w    (N_pad, M) float — member weights, 0.0 in sentinel slots

State bytes and bytes per edge scale with M, not K. The edge sweeps mirror
ops.objective / ops.linesearch restricted to the support:

  * edge dot F_u.F_v = sum over u's slots of w_u times the neighbour's
    weight in that community (`member_lookup`: a batched searchsorted of
    u's ids in v's sorted ids; on the card the CUDA kernel
    csrc/member_lookup.cu, which reads both rows straight from the state);
  * gradient = the looked-up neighbour weights over omp, summed per source
    slot, in slot space (N, M);
  * ||grad||^2 = slot terms + the closed-form off-support correction
    sum_{c not in S_u} sumF[c]^2, so the Armijo rule is the dense one;
  * support update every cfg.support_every iterations: admit candidate
    communities from neighbour member lists, keep the top-M by weight +
    neighbour mass.

With M >= K and support_every = 1 the dynamics equal the dense ones (the
JAX module's PARITY note). The sharded trainer's `presence` and the
sparse collectives are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.ops import build
from bigclam_tpu_torch.ops.linesearch import accept_stats, step_etas
from bigclam_tpu_torch.ops.objective import EdgeChunks, accum_dtype, edge_terms

# member slots the CUDA kernel takes (one warp per edge, the neighbour's
# ids and weights staged in 8 bytes of shared memory per slot)
MAX_M = 1024

# candidate entries one support-update batch holds (whole node blocks)
SUPPORT_BATCH_ENTRIES = 1 << 26


class MemberLimitError(ValueError):
    """More member slots than the CUDA member-lookup kernel takes."""


class SparseTrainState(NamedTuple):
    """TrainState twin of the sparse path. `F` holds the (N_pad, M) member
    WEIGHTS (named F as in the dense state); `ids` the member ids."""

    F: torch.Tensor            # (N_pad, M) member weights
    ids: torch.Tensor          # (N_pad, M) int32 sorted member ids
    sumF: torch.Tensor         # (K_pad,) dense column sums
    llh: torch.Tensor          # scalar: LLH of the PREVIOUS state
    it: int                    # iteration counter
    accept_hist: torch.Tensor  # (S+1,) int32 accepted-step histogram
    health: Optional[torch.Tensor] = None  # health pack (ops.diagnostics)


class SupportBlocks(NamedTuple):
    """Per-node-block edge layout of the support update: block b owns src
    rows [b*block_b, (b+1)*block_b), src stored block-local. Shapes
    (n_blocks, eb) padded to the largest block's edge count (mask 0 on
    padding, dst 0, src_local block_b - 1)."""

    src_local: torch.Tensor    # int32
    dst: torch.Tensor          # int32 (global)
    mask: torch.Tensor         # float
    block_b: int


# --- host functions (copied bit-identically from the JAX package,
# bigclam_tpu/ops/sparse_members.py) ---------------------------------------


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pick_block_b(budget_elems: int, n: int, m: int, avg_deg: float) -> int:
    """Support-update block size: the sort works on
    ~(block_b * (1 + avg_deg)) * M candidate entries per block, so size
    block_b to keep that near the element budget — K plays no part.
    Clamped to [8, 1024] and rounded to 8."""
    per_row = max(int(m) * (1.0 + max(avg_deg, 0.0)), 1.0)
    b = max(int(budget_elems / per_row), 8)
    b = min(b, 1024, _round_up(max(n, 8), 8))
    return _round_up(b, 8) if b % 8 else b


def from_dense(
    F: np.ndarray, m: int, k_pad: int, n_pad: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Sparsify a dense (N, K) init: per-row top-m entries by weight
    (ties to the LOWEST community id via the stable sort), ids sorted
    ascending with sentinel k_pad padding. Returns (ids, w, truncated) —
    `truncated` counts positive entries dropped because a row held more
    than m (0 whenever m >= max row support; the M >= K parity regime)."""
    F = np.asarray(F)
    n, k = F.shape
    assert k <= k_pad, (k, k_pad)
    order = np.argsort(-F, axis=1, kind="stable")[:, :m]
    vals = np.take_along_axis(F, order, axis=1)
    keep = vals > 0
    truncated = int((F > 0).sum() - keep.sum())
    sel_ids = np.where(keep, order, k_pad)
    srt = np.argsort(sel_ids, axis=1, kind="stable")
    ids = np.full((n_pad, m), k_pad, dtype=np.int32)
    w = np.zeros((n_pad, m), dtype=F.dtype)
    ids[:n] = np.take_along_axis(sel_ids, srt, axis=1)
    w[:n] = np.take_along_axis(np.where(keep, vals, 0.0), srt, axis=1)
    return ids, w, truncated


def to_dense(
    ids: np.ndarray, w: np.ndarray, n: int, k: int
) -> np.ndarray:
    """Densify the live (n, k) block of a sparse state (host side; the
    extraction/eval pipelines consume dense F)."""
    ids = np.asarray(ids)[:n]
    w = np.asarray(w)[:n]
    out = np.zeros((n, k), dtype=w.dtype)
    valid = ids < k
    rows = np.broadcast_to(np.arange(n)[:, None], ids.shape)
    np.add.at(out, (rows[valid], ids[valid]), w[valid])
    return out


def support_blocks_host(
    g, n_pad: int, block_b: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host arrays of the per-block edge layout: (src_local, dst, mask),
    each (n_blocks, eb) with eb the graph-wide max per-block edge count
    (uniform so the sharded trainer can reshape to (dp, blocks/dp, eb)).
    CSR order means each block's edges are one contiguous src slice."""
    assert n_pad % block_b == 0, (n_pad, block_b)
    n_blocks = n_pad // block_b
    src, dst = g.src, g.dst
    bounds = np.searchsorted(src, np.arange(0, n_pad + block_b, block_b))
    counts = np.diff(bounds)
    eb = _round_up(max(int(counts.max()) if counts.size else 1, 1), 8)
    sl = np.full((n_blocks, eb), block_b - 1, dtype=np.int32)
    dd = np.zeros((n_blocks, eb), dtype=np.int32)
    mm = np.zeros((n_blocks, eb), dtype=np.float32)
    for b in range(n_blocks):
        e0, e1 = int(bounds[b]), int(bounds[b + 1])
        cnt = e1 - e0
        sl[b, :cnt] = src[e0:e1] - b * block_b
        dd[b, :cnt] = dst[e0:e1]
        mm[b, :cnt] = 1.0
    return sl, dd, mm


# --- device functions --------------------------------------------------------


def build_support_blocks(
    g, n_pad: int, block_b: int, dtype=torch.float32, device=None
) -> SupportBlocks:
    """Device-resident SupportBlocks over the whole graph."""
    sl, dd, mm = support_blocks_host(g, n_pad, block_b)
    return SupportBlocks(
        src_local=torch.as_tensor(sl, device=device),
        dst=torch.as_tensor(dd, device=device),
        mask=torch.as_tensor(mm, device=device).to(dtype),
        block_b=block_b,
    )


def member_lookup(
    iv: torch.Tensor, wv: torch.Tensor, iu: torch.Tensor, k_pad: int
) -> torch.Tensor:
    """For each (edge, slot): the neighbour's weight in community iu, or
    0.0 when the neighbour is not a member. iv/wv/iu are (E, M) with iv
    sorted ascending per row (sentinels sort last and never match)."""
    m = iv.shape[-1]
    pos = torch.searchsorted(iv, iu).clamp_max_(m - 1)
    hit = (iv.gather(1, pos) == iu) & (iu < k_pad)
    return torch.where(hit, wv.gather(1, pos), torch.zeros((), dtype=wv.dtype))


def member_lookup_rows_plain(
    ids: torch.Tensor, w: torch.Tensor, s: torch.Tensor, d: torch.Tensor,
    k_pad: int,
) -> torch.Tensor:
    """Plain PyTorch member_lookup_rows: the rows gathered, then
    member_lookup(ids[d], w[d], ids[s], k_pad)."""
    return member_lookup(
        ids.index_select(0, d), w.index_select(0, d), ids.index_select(0, s),
        k_pad,
    )


def check_member_limit(m: int) -> None:
    """The CUDA kernel takes 1 <= M <= MAX_M member slots."""
    if not 1 <= m <= MAX_M:
        raise MemberLimitError(
            f"M={m} member slots is outside the member-lookup CUDA kernel's "
            f"range 1..{MAX_M} (--sparse-m / cfg.sparse_m)"
        )


def _check_cuda(ids, w, s, d) -> None:
    if ids.dim() != 2 or ids.dtype != torch.int32 or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous (N_pad, M) int32 matrix")
    check_member_limit(ids.shape[1])
    if w.dtype != torch.float32:
        raise TypeError(f"w must be float32, got {w.dtype}")
    if tuple(w.shape) != tuple(ids.shape) or not w.is_contiguous():
        raise ValueError(f"w must be contiguous of shape {tuple(ids.shape)}")
    for name, t in (("src", s), ("dst", d)):
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int64 vector")
    if s.shape != d.shape:
        raise ValueError(f"src {tuple(s.shape)} and dst {tuple(d.shape)} differ")
    for name, t in (("w", w), ("src", s), ("dst", d)):
        if t.device != ids.device:
            raise ValueError(f"{name} is on {t.device}, ids on {ids.device}")


def member_lookup_rows(
    ids: torch.Tensor, w: torch.Tensor, s: torch.Tensor, d: torch.Tensor,
    k_pad: int,
) -> torch.Tensor:
    """member_lookup for edges s -> d read straight from the state
    (counterpart of the TPU `member_lookup_pallas`): for edge e and own
    slot j, the weight of ids[s[e], j] in row d[e], or 0. Returns (E, M).

    CPU tensors run the plain version; CUDA tensors launch
    csrc/member_lookup.cu and count the launch in
    `member_lookup_rows.launches`, or raise. The function is exact, so the
    kernel equals the plain version bit for bit."""
    if ids.device.type == "cpu":
        return member_lookup_rows_plain(ids, w, s, d, k_pad)
    _check_cuda(ids, w, s, d)
    e, m = int(s.shape[0]), int(ids.shape[1])
    out = torch.empty((e, m), dtype=w.dtype, device=w.device)
    build.launch(
        ids.device, "bigclam_member_lookup",
        ids.data_ptr(), w.data_ptr(), s.data_ptr(), d.data_ptr(), e, m,
        int(k_pad), out.data_ptr(),
    )
    member_lookup_rows.launches += 1
    return out


member_lookup_rows.launches = 0


def reset_launch_counts() -> None:
    """Set the member-lookup kernel's launch counter to 0."""
    member_lookup_rows.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {"member_lookup": member_lookup_rows.launches}


def merge_kernel_want(cfg: BigClamConfig, device: torch.device) -> bool:
    """Should the member-lookup kernel engage? Auto
    (cfg.sparse_pallas_merge=None) = on for cuda devices; True on the CPU
    runs the kernel's plain version; False = the plain path `sparse_xla`."""
    want = cfg.sparse_pallas_merge
    if want is None:
        want = device.type == "cuda"
    return bool(want)


def member_lookup_impl(
    ids: torch.Tensor, w: torch.Tensor, s: torch.Tensor, d: torch.Tensor,
    k_pad: int, cfg: BigClamConfig,
) -> torch.Tensor:
    """The one member-lookup dispatch every sparse edge sweep goes through:
    the kernel wrapper when merge_kernel_want, else the plain version."""
    if merge_kernel_want(cfg, ids.device):
        return member_lookup_rows(ids, w, s, d, k_pad)
    return member_lookup_rows_plain(ids, w, s, d, k_pad)


def sparse_sumF(ids: torch.Tensor, w: torch.Tensor, k_pad: int) -> torch.Tensor:
    """Dense (K_pad,) column sums from the sparse state — a scatter-add of
    the member slots' weights in row-major order. Sentinel slots are left
    out, as the JAX scatter drops them: on the card, adding them into one
    extra sentinel bucket would aim every empty slot's atomic add at a
    single address."""
    valid = ids < k_pad
    acc = torch.zeros(k_pad, dtype=w.dtype, device=w.device)
    return acc.index_add_(0, ids[valid].long(), w[valid])


def masked_sumF_at(
    ids: torch.Tensor, sumF: torch.Tensor, k_pad: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(valid, sumF gathered at each member slot — 0 in sentinel slots)."""
    valid = ids < k_pad
    at = sumF[ids.clamp_max(k_pad - 1).long()]
    return valid, torch.where(valid, at, torch.zeros((), dtype=sumF.dtype))


def sparse_node_tail(w: torch.Tensor, sumF_at: torch.Tensor) -> torch.Tensor:
    """-F_u.sumF + F_u.F_u restricted to the support (exact: off-support
    entries of F_u are zero)."""
    return -(w * sumF_at).sum(dim=1) + (w * w).sum(dim=1)


def sparse_grad_llh(
    ids: torch.Tensor,
    w: torch.Tensor,
    sumF: torch.Tensor,
    edges: EdgeChunks,
    cfg: BigClamConfig,
    k_pad: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-node slot-space gradient + per-node LLH in one edge sweep, the
    sparse twin of ops.objective.grad_llh. Returns (grad (N, M) — 0 in
    sentinel slots, node_llh (N,))."""
    n = ids.shape[0]
    adt = accum_dtype(cfg, w)
    nbr_llh = torch.zeros(n, dtype=adt, device=w.device)
    nbr_grad = torch.zeros_like(w)
    for s, d in edges.slices():
        vals = member_lookup_impl(ids, w, s, d, k_pad, cfg)       # (chunk, M)
        x = (w.index_select(0, s) * vals).sum(dim=1)
        omp, ell = edge_terms(x, cfg)
        nbr_llh.index_add_(0, s, ell.to(adt))
        nbr_grad.index_add_(0, s, vals * (1.0 / omp)[:, None])
    valid, sumF_at = masked_sumF_at(ids, sumF, k_pad)
    grad = torch.where(valid, nbr_grad - sumF_at + w, torch.zeros((), dtype=w.dtype))
    node_llh = nbr_llh + sparse_node_tail(w, sumF_at).to(adt)
    return grad, node_llh


def sparse_candidates(
    ids: torch.Tensor,
    w: torch.Tensor,
    grad: torch.Tensor,
    edges: EdgeChunks,
    cfg: BigClamConfig,
    k_pad: int,
) -> torch.Tensor:
    """Neighbour-sum candidate terms for every Armijo step, (S, N) — the
    sparse twin of ops.linesearch.candidates_pass. The member lookup runs
    once per chunk and serves all candidates (the support does not move
    within a step)."""
    n = ids.shape[0]
    adt = accum_dtype(cfg, w)
    etas = step_etas(cfg, w)
    out = torch.zeros((etas.shape[0], n), dtype=adt, device=w.device)
    for s, d in edges.slices():
        vals = member_lookup_impl(ids, w, s, d, k_pad, cfg)
        wu, gu = w.index_select(0, s), grad.index_select(0, s)
        for i in range(etas.shape[0]):
            nw = torch.clamp(wu + etas[i] * gu, cfg.min_f, cfg.max_f)
            _, ell = edge_terms((nw * vals).sum(dim=1), cfg)
            out[i].index_add_(0, s, ell.to(adt))
    return out


def sparse_armijo_update(
    ids: torch.Tensor,
    w: torch.Tensor,
    sumF: torch.Tensor,
    grad: torch.Tensor,
    node_llh: torch.Tensor,
    cand_nbr: torch.Tensor,
    cfg: BigClamConfig,
    k_pad: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Armijo acceptance + max-accepted-step Jacobi update on the slot
    arrays — the sparse twin of ops.linesearch.armijo_update. ||grad||^2
    carries the exact off-support correction, so the acceptance rule is the
    dense path's. Returns (w_new, accept_hist)."""
    adt = accum_dtype(cfg, w)
    etas = step_etas(cfg, w)
    _, sumF_at = masked_sumF_at(ids, sumF, k_pad)
    gg_slots = (grad * grad).sum(dim=1)
    off_support = (sumF @ sumF) - (sumF_at * sumF_at).sum(dim=1)
    gg = (gg_slots + off_support).to(adt)
    tails = []
    for eta in etas:
        nf = torch.clamp(w + eta * grad, cfg.min_f, cfg.max_f)
        sf_adj = sumF_at - w + nf
        tails.append((-(nf * sf_adj).sum(dim=1) + (nf * nf).sum(dim=1)).to(adt))
    cand_llh = cand_nbr + torch.stack(tails)
    ok = cand_llh >= node_llh[None, :] + cfg.alpha * etas[:, None] * gg[None, :]
    best_eta = torch.where(ok, etas[:, None], torch.zeros((), dtype=etas.dtype))
    best_eta = best_eta.max(dim=0).values
    w_new = torch.where(
        ok.any(dim=0)[:, None],
        torch.clamp(w + best_eta[:, None] * grad, cfg.min_f, cfg.max_f),
        w,
    )
    return w_new, accept_stats(ok)


def _support_rows(
    ids: torch.Tensor,
    w: torch.Tensor,
    r0: int,
    r1: int,
    src: torch.Tensor,
    dst: torch.Tensor,
    m: int,
    k_pad: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """New (ids, w) of rows [r0, r1) from their own slots and the member
    lists of their neighbours over edges src -> dst (src in [r0, r1))."""
    rows, dev = r1 - r0, ids.device
    own_node = torch.arange(r0, r1, device=dev).repeat_interleave(m)
    own_cid, own_w = ids[r0:r1].reshape(-1), w[r0:r1].reshape(-1)
    nb_node = src.repeat_interleave(m)
    nb_cid = ids.index_select(0, dst).reshape(-1)
    nb_w = w.index_select(0, dst).reshape(-1)
    # sentinel entries are never kept, and a neighbour entry of weight 0
    # adds nothing to its run's rank: both are left out
    own = own_cid < k_pad
    nb = (nb_cid < k_pad) & (nb_w != 0)
    own_node, own_cid, own_w = own_node[own], own_cid[own], own_w[own]
    n_own = own_node.shape[0]
    node = torch.cat([own_node, nb_node[nb]])
    cid = torch.cat([own_cid, nb_cid[nb]]).long()
    rc = torch.cat([own_w, nb_w[nb]])
    # one run per (node, community); the key orders runs by node, then id
    key = node * (k_pad + 1) + cid
    run_key, inv = torch.unique(key, sorted=True, return_inverse=True)
    rank = torch.zeros(run_key.shape[0], dtype=w.dtype, device=dev)
    rank.index_add_(0, inv, rc)
    wsum = torch.zeros_like(rank).index_add_(0, inv[:n_own], own_w)
    # a non-finite rank keeps its slot (+inf), so a NaN weight is not
    # dropped here but reaches the LLH, as on the dense path
    rank = torch.where(torch.isfinite(rank), rank, torch.full_like(rank, float("inf")))
    kept = rank > 0
    run_key, rank, wsum = run_key[kept], rank[kept], wsum[kept]
    node, cid = run_key // (k_pad + 1), run_key % (k_pad + 1)
    # per node by rank descending, ties to the lower id (stable sorts)
    order = torch.argsort(-rank, stable=True)
    order = order[torch.argsort(node[order], stable=True)]
    node, cid, wsum = node[order], cid[order], wsum[order]
    pos = torch.arange(node.shape[0], device=dev) - torch.searchsorted(node, node)
    take = pos < m
    r, c = node[take] - r0, pos[take]
    new_ids = torch.full((rows, m), k_pad, dtype=torch.int32, device=dev)
    new_w = torch.zeros((rows, m), dtype=w.dtype, device=dev)
    new_ids[r, c] = cid[take].to(torch.int32)
    new_w[r, c] = wsum[take]
    new_ids, srt = torch.sort(new_ids, dim=1, stable=True)
    return new_ids, new_w.gather(1, srt)


def support_update(
    ids: torch.Tensor,
    w: torch.Tensor,
    blocks: SupportBlocks,
    m: int,
    k_pad: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One support-update pass: per node, admit candidate communities from
    neighbour member lists and keep the top-M by weight + neighbour mass.
    rank(c) = w_u[c] + sum_{v in N(u)} w_v[c]; only rank > 0 entries keep a
    slot, surviving members keep their weight EXACTLY, admissions start at
    weight 0.

    Sort-based, with no K-sized axis: the candidate entries (own slots and
    one per (edge, neighbour slot)) are grouped into (node, community) runs
    by one sort of the key node*(K_pad+1) + id, summed into ranks, ordered
    by descending rank (ties to the lower id) and cut to M per node. A
    node's result depends only on its own entries, so whole node blocks are
    batched together, up to SUPPORT_BATCH_ENTRIES entries a batch (the JAX
    pass loops over one block at a time)."""
    block_b = blocks.block_b
    n_rows = ids.shape[0]
    n_blocks = n_rows // block_b
    assert n_blocks * block_b == n_rows, (n_rows, block_b)
    eb = blocks.dst.shape[1]
    step = max(1, SUPPORT_BATCH_ENTRIES // ((block_b + eb) * m))
    new_ids, new_w = torch.empty_like(ids), torch.empty_like(w)
    for b0 in range(0, n_blocks, step):
        b1 = min(b0 + step, n_blocks)
        base = torch.arange(b0, b1, device=ids.device)[:, None] * block_b
        live = blocks.mask[b0:b1].reshape(-1) > 0
        src = (blocks.src_local[b0:b1].long() + base).reshape(-1)[live]
        dst = blocks.dst[b0:b1].reshape(-1)[live].long()
        r0, r1 = b0 * block_b, b1 * block_b
        new_ids[r0:r1], new_w[r0:r1] = _support_rows(ids, w, r0, r1, src, dst, m, k_pad)
    return new_ids, new_w
