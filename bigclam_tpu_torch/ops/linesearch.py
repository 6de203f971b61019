"""Armijo backtracking line search, all candidates in one edge sweep.

Port of bigclam_tpu/ops/linesearch.py. Each edge chunk is gathered once
(F_src, grad_src, F_dst) and every candidate step is scored against the
gathered rows. Candidate semantics: F_u' = clip(F_u + eta*grad_u, min_f,
max_f) scored against everyone else's OLD rows with the node-local
sumF' = sumF - F_u + F_u', accepted iff

    ell_eta(u) >= ell(u) + alpha * eta * ||grad_u||^2

and the chosen step is the LARGEST accepted eta; nodes with no accepted
candidate keep their row (the Jacobi simultaneous update).

`armijo_update_kernel` computes armijo_update with the tails, the test and
the selection in one CUDA kernel (`armijo_tail_select`, the epilogue of the
node pass in csrc/cand_from_x.cu); the `pallas_vmem` and ring steps take
it where the kernels engage.
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


def armijo_accept(
    F: torch.Tensor,
    grad: torch.Tensor,
    node_llh: torch.Tensor,
    cand_llh: torch.Tensor,
    cfg: BigClamConfig,
):
    """Acceptance test + max-accepted-step selection + Jacobi update, given
    the FULL per-candidate LLH (neighbor terms + Armijo tails), (S, N).

    Returns (F_new, ok): ok is the (S, N) acceptance mask (feed
    accept_stats)."""
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
    return F_new, ok


def armijo_select(
    F: torch.Tensor,
    grad: torch.Tensor,
    node_llh: torch.Tensor,
    cand_llh: torch.Tensor,
    cfg: BigClamConfig,
    with_stats: bool = False,
):
    """armijo_accept, returning (F_new, sumF_new) with sumF as fresh column
    sums; with with_stats=True additionally the accept_stats histogram."""
    F_new, ok = armijo_accept(F, grad, node_llh, cand_llh, cfg)
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


# --- the tails and the selection in one CUDA kernel -------------------------


def armijo_tail_select_plain(
    F: torch.Tensor,
    sumF: torch.Tensor,
    grad: torch.Tensor,
    node_llh: torch.Tensor,
    cand_nbr: torch.Tensor,
    cfg: BigClamConfig,
):
    """Plain PyTorch armijo_tail_select: armijo_update's tails and
    armijo_accept."""
    return armijo_accept(
        F, grad, node_llh, cand_nbr + armijo_tails(F, sumF, grad, cfg), cfg
    )


def armijo_tail_select(
    F: torch.Tensor,
    sumF: torch.Tensor,
    grad: torch.Tensor,
    node_llh: torch.Tensor,
    cand_nbr: torch.Tensor,
    cfg: BigClamConfig,
):
    """From the NEIGHBOUR candidate terms (S, N): the Armijo tails, the
    acceptance test and the selection of every row in one launch
    (csrc/cand_from_x.cu `bigclam_armijo_select`, the node pass's epilogue;
    the threshold rounded as kernel A rounds it). Returns (F_new, ok (S, N)
    bool). On CPU tensors the plain version runs; on CUDA tensors F, grad,
    sumF, node_llh and cand_nbr must be float32 and contiguous and the
    ladder at most 16 steps, or it raises. Counts its launches in
    `armijo_tail_select.launches`."""
    if F.device.type == "cpu":
        return armijo_tail_select_plain(F, sumF, grad, node_llh, cand_nbr, cfg)
    # csr_kernels imports this module: its helpers come in at the call
    from bigclam_tpu_torch.ops import build
    from bigclam_tpu_torch.ops.csr_kernels import check_float32, kernel_constants

    if F.dim() != 2:
        raise ValueError(f"F must be (n, K), got {tuple(F.shape)}")
    c = kernel_constants(cfg)
    n, k = F.shape
    check_float32(F.device, [
        ("F", F, (n, k)), ("grad", grad, (n, k)), ("sumF", sumF, (k,)),
        ("node_llh", node_llh, (n,)), ("cand_nbr", cand_nbr, (c["num_s"], n)),
    ])
    F_new = torch.empty_like(F)
    ok = torch.empty((c["num_s"], n), dtype=torch.bool, device=F.device)
    build.launch(
        F.device, "bigclam_armijo_select",
        F.data_ptr(), sumF.data_ptr(), grad.data_ptr(), node_llh.data_ptr(),
        cand_nbr.data_ptr(), n, k, c["etas"].ctypes.data, c["coefs"].ctypes.data,
        c["num_s"], c["min_f"], c["max_f"], F_new.data_ptr(), ok.data_ptr(),
    )
    armijo_tail_select.launches += 1
    return F_new, ok


armijo_tail_select.launches = 0


def armijo_update_kernel(
    F: torch.Tensor,
    sumF: torch.Tensor,
    grad: torch.Tensor,
    node_llh: torch.Tensor,
    cand_nbr: torch.Tensor,
    cfg: BigClamConfig,
    with_stats: bool = False,
):
    """armijo_update with the tails, the test and the selection in one CUDA
    kernel (armijo_tail_select); the column sums and the histogram stay in
    torch. On CPU tensors armijo_tail_select runs its plain version, and
    this is armijo_update bit for bit."""
    F_new, ok = armijo_tail_select(F, sumF, grad, node_llh, cand_nbr, cfg)
    if with_stats:
        return F_new, F_new.sum(dim=0), accept_stats(ok)
    return F_new, F_new.sum(dim=0)


def reset_launch_counts() -> None:
    """Set the launch counter of the epilogue kernel's wrapper to 0."""
    armijo_tail_select.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {"armijo_tail_select": armijo_tail_select.launches}
