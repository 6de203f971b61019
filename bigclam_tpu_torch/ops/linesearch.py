"""Armijo backtracking line search, all candidates in one edge sweep.

Port of bigclam_tpu/ops/linesearch.py. Each edge chunk is gathered once
(F_src, grad_src, F_dst) and every candidate step is scored against the
gathered rows. Candidate semantics: F_u' = clip(F_u + eta*grad_u, min_f,
max_f) scored against everyone else's OLD rows with the node-local
sumF' = sumF - F_u + F_u', accepted iff

    ell_eta(u) >= ell(u) + alpha * eta * ||grad_u||^2

and the chosen step is the LARGEST accepted eta; nodes with no accepted
candidate keep their row (the Jacobi simultaneous update).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.ops.objective import EdgeChunks, accum_dtype, edge_terms


def step_etas(cfg: BigClamConfig, like: torch.Tensor) -> torch.Tensor:
    """(S,) candidate steps in `like`'s dtype and device."""
    return torch.tensor(cfg.step_candidates, dtype=like.dtype, device=like.device)


def candidates_scan(
    F: torch.Tensor,
    edges: EdgeChunks,
    cfg: BigClamConfig,
    terms_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """Shared chunk loop of the candidate pass (bigclam_tpu/ops/linesearch.py
    `candidates_scan`): terms_fn(src, dst) gives a chunk's (S, chunk) LLH
    edge terms, and one `index_add_` along dim 1 sums them into (S, N) in
    the accumulation dtype. terms_fn is the plain body of candidates_pass
    or the CUDA kernel (ops.edge_kernels.candidates_pass_kernel)."""
    n = F.shape[0]
    adt = accum_dtype(cfg, F)
    out = torch.zeros((len(cfg.step_candidates), n), dtype=adt, device=F.device)
    for s, d in edges.slices():
        out.index_add_(1, s, terms_fn(s, d).to(adt))
    return out


def candidate_edge_terms_body(
    fs: torch.Tensor, gs: torch.Tensor, fd: torch.Tensor, cfg: BigClamConfig
) -> torch.Tensor:
    """(S, chunk) unmasked LLH edge terms from gathered (chunk, K) rows:
    for each eta_s, ell(clip(fs + eta_s*gs, min_f, max_f) . fd)."""
    etas = step_etas(cfg, fs)
    rows = []
    for i in range(etas.shape[0]):
        nf = torch.clamp(fs + etas[i] * gs, cfg.min_f, cfg.max_f)
        _, ell = edge_terms((nf * fd).sum(dim=1), cfg)
        rows.append(ell)
    return torch.stack(rows)


def candidates_pass(
    F: torch.Tensor,
    grad: torch.Tensor,
    edges: EdgeChunks,
    cfg: BigClamConfig,
    F_dst: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Neighbor-sum part of ell_eta(u) for every candidate step.

    Returns (S, N): for each eta_i and node u,
    sum_{v in N(u)} [log(1 - clip(exp(-F_u'.F_v))) + F_u'.F_v], with the
    neighbour rows F_v from F_dst (default F; on a mesh, the gathered F or
    a ring phase's rotating shard).
    """
    fdst = F if F_dst is None else F_dst

    def terms(s, d):
        return candidate_edge_terms_body(
            F.index_select(0, s), grad.index_select(0, s), fdst.index_select(0, d),
            cfg,
        )

    return candidates_scan(F, edges, cfg, terms)


def accept_stats(ok: torch.Tensor) -> torch.Tensor:
    """(S+1,) int32 accepted-step histogram from the (S, N) acceptance mask:
    slot s = #nodes whose chosen (max-accepted) step is step_candidates[s],
    slot S = #rows with no accepted candidate. step_candidates is
    descending, so the chosen step is the first accepted row."""
    num_s = ok.shape[0]
    ok = ok.to(torch.bool)
    accepted = ok.any(dim=0)
    chosen = torch.argmax(ok.to(torch.uint8), dim=0)     # first True
    counts = torch.bincount(chosen[accepted], minlength=num_s)
    rejected = (~accepted).sum()
    return torch.cat([counts, rejected[None]]).to(torch.int32)


def armijo_select(
    F: torch.Tensor,
    grad: torch.Tensor,
    node_llh: torch.Tensor,
    cand_llh: torch.Tensor,
    cfg: BigClamConfig,
    with_stats: bool = False,
):
    """Acceptance test + max-accepted-step selection + Jacobi update, given
    the FULL per-candidate LLH (neighbor terms + Armijo tails), (S, N).

    Returns (F_new, sumF_new) with sumF as fresh column sums; with
    with_stats=True additionally the accept_stats histogram.
    """
    adt = accum_dtype(cfg, F)
    etas = step_etas(cfg, F)
    gg = (grad * grad).sum(dim=1).to(adt)
    ok = cand_llh >= node_llh[None, :] + cfg.alpha * etas[:, None] * gg[None, :]
    best_eta = torch.where(ok, etas[:, None], torch.zeros_like(etas)[:, None])
    best_eta = best_eta.max(dim=0).values
    accepted = ok.any(dim=0)
    F_new = torch.where(
        accepted[:, None],
        torch.clamp(F + best_eta[:, None] * grad, cfg.min_f, cfg.max_f),
        F,
    )
    if with_stats:
        return F_new, F_new.sum(dim=0), accept_stats(ok)
    return F_new, F_new.sum(dim=0)


def armijo_tails(
    F: torch.Tensor, sumF: torch.Tensor, grad: torch.Tensor, cfg: BigClamConfig
) -> torch.Tensor:
    """(S, N) Armijo tail terms -F'.(sumF - F_u + F') + F'.F' per candidate."""
    adt = accum_dtype(cfg, F)
    tails = []
    for eta in step_etas(cfg, F):
        nf = torch.clamp(F + eta * grad, cfg.min_f, cfg.max_f)
        sf_adj = sumF[None, :] - F + nf
        tails.append((-(nf * sf_adj).sum(dim=1) + (nf * nf).sum(dim=1)).to(adt))
    return torch.stack(tails)


def armijo_update(
    F: torch.Tensor,
    sumF: torch.Tensor,
    grad: torch.Tensor,
    node_llh: torch.Tensor,
    cand_nbr: torch.Tensor,
    cfg: BigClamConfig,
    with_stats: bool = False,
):
    """armijo_select for callers holding only the NEIGHBOR candidate terms
    (candidates_pass output): adds the Armijo tails, then selects."""
    return armijo_select(
        F, grad, node_llh, cand_nbr + armijo_tails(F, sumF, grad, cfg), cfg,
        with_stats=with_stats,
    )
