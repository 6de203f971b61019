"""LLH + gradient over chunked edges, in plain PyTorch.

Port of bigclam_tpu/ops/objective.py. One fused edge-parallel sweep:
gather F rows at both endpoints of every directed edge, dot along K,
clipped log-prob terms, and `index_add_` back to the source nodes. Edges
are processed in chunks so the (chunk, K) gathers stay bounded in memory.

Math:
  ell(u)  = sum_{v in N(u)} [ log(1 - clip(exp(-F_u.F_v), min_p, max_p)) + F_u.F_v ]
            - F_u . sumF + F_u . F_u
  grad_u  = sum_{v in N(u)} F_v / (1 - clip(exp(-F_u.F_v))) - sumF + F_u

All-zero F rows and K columns are inert (their terms are 0, and Armijo
never moves them while min_f == 0), so padding never changes the result.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional, Tuple

import torch

from bigclam_tpu_torch.config import BigClamConfig


class EdgeChunks(NamedTuple):
    """Directed edges in CSR order, swept `chunk` edges at a time. `runs`,
    where set, holds each chunk's run offsets (ops.edge_kernels.edge_runs),
    which the candidate edge-terms kernel takes."""

    src: torch.Tensor   # (E,) int64
    dst: torch.Tensor   # (E,) int64
    chunk: int
    runs: Optional[Tuple[torch.Tensor, ...]] = None

    def slices(self) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        e = int(self.src.shape[0])
        for lo in range(0, e, self.chunk):
            yield self.src[lo : lo + self.chunk], self.dst[lo : lo + self.chunk]


def edge_chunk_bound(
    cfg: BigClamConfig, k_cols: Optional[int] = None, itemsize: int = 4
) -> int:
    """cfg.edge_chunk capped so one gathered (chunk, k_cols) array stays
    under ~1 GB (bigclam_tpu/models/bigclam.py `edge_chunk_bound`)."""
    cols = k_cols if k_cols else cfg.num_communities
    per_edge_bytes = max(cols, 1) * itemsize
    return min(max(cfg.edge_chunk, 1), max((1 << 30) // per_edge_bytes, 1024))


def accum_dtype(cfg: BigClamConfig, F: torch.Tensor) -> torch.dtype:
    """LLH accumulation dtype: cfg.accum_dtype, else F's dtype."""
    return getattr(torch, cfg.accum_dtype) if cfg.accum_dtype else F.dtype


def edge_terms(
    x: torch.Tensor, cfg: BigClamConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-edge clipped survival 1-p (p = exp(-x)) and LLH term log(1-p)+x.

    1-p is formed directly as -expm1(-x), then clipped to
    [1-max_p, 1-min_p] (bounds computed on the host in float64), which
    keeps full relative precision for tiny x.
    """
    omp = torch.clamp(-torch.expm1(-x), 1.0 - cfg.max_p, 1.0 - cfg.min_p)
    return omp, torch.log(omp) + x


def node_tail(F: torch.Tensor, sumF: torch.Tensor) -> torch.Tensor:
    """The folded non-edge terms per node: -F_u.sumF + F_u.F_u."""
    return -(F @ sumF) + (F * F).sum(dim=1)


def neighbour_sums(
    F: torch.Tensor,
    edges: EdgeChunks,
    cfg: BigClamConfig,
    F_dst: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The edge sweep of grad_llh: (sum_v F_v / omp(F_u.F_v) (N,K),
    sum_v ell (N,) in the accumulation dtype), with the source rows from F
    and the destination rows F_v from F_dst (default F) — on a mesh, the
    gathered F or a ring phase's rotating shard."""
    fdst = F if F_dst is None else F_dst
    adt = accum_dtype(cfg, F)
    nbr_llh = torch.zeros(F.shape[0], dtype=adt, device=F.device)
    nbr_grad = torch.zeros_like(F)
    for s, d in edges.slices():
        fd = fdst.index_select(0, d)
        x = (F.index_select(0, s) * fd).sum(dim=1)
        omp, ell = edge_terms(x, cfg)
        nbr_llh.index_add_(0, s, ell.to(adt))
        nbr_grad.index_add_(0, s, fd * (1.0 / omp)[:, None])
    return nbr_grad, nbr_llh


def grad_llh(
    F: torch.Tensor,
    sumF: torch.Tensor,
    edges: EdgeChunks,
    cfg: BigClamConfig,
    F_dst: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-node gradient + per-node LLH in one edge sweep (neighbour rows
    from F_dst, default F; see neighbour_sums).

    Returns (grad (N,K), node_llh (N,)); global LLH = node_llh.sum().
    """
    nbr_grad, nbr_llh = neighbour_sums(F, edges, cfg, F_dst)
    grad = nbr_grad - sumF[None, :] + F
    node_llh = nbr_llh + node_tail(F, sumF).to(nbr_llh.dtype)
    return grad, node_llh


def loglikelihood(
    F: torch.Tensor, sumF: torch.Tensor, edges: EdgeChunks, cfg: BigClamConfig
) -> torch.Tensor:
    """Global LLH only, one edge sweep."""
    adt = accum_dtype(cfg, F)
    acc = torch.zeros((), dtype=adt, device=F.device)
    for s, d in edges.slices():
        x = (F.index_select(0, s) * F.index_select(0, d)).sum(dim=1)
        _, ell = edge_terms(x, cfg)
        acc = acc + ell.to(adt).sum()
    return acc + node_tail(F, sumF).to(adt).sum()
