"""Fold-in inference: optimize node rows against a FROZEN F.

Port of bigclam_tpu/ops/foldin.py. Holding everyone else's rows fixed,
the terms of the global LLH that involve node u are

    ell(u) = sum_{v in N(u)} [ log(1 - clip(exp(-r.F_v))) + r.F_v ]
             - r . sumF_others

where r is u's candidate row and sumF_others = sum_w F_w over the FROZEN
rows (for an existing node that is sumF - F_u; for a brand-new node it is
the global sumF as-is). This is the trainer's per-node objective, so
optimizing r with the same Armijo candidate ladder (accept iff
ell_eta >= ell + alpha*eta*||g||^2, take the LARGEST accepted eta)
converges to the row the full fit would have produced for u against that
F.

Everything here is BATCHED over B query nodes with padded neighbour lists
(B, D): each node's trajectory depends only on its own row and the frozen
F, so batched fold-in equals sequential fold-in node for node, and a
request batcher can coalesce arbitrary suggest queries into one call. The
products are torch einsums on whatever device the tensors live on: no
hand kernel (the JAX function is plain jnp and reaches no Pallas kernel).

The JAX optimizer is one lax.while_loop with per-node convergence and no
host round trip. Here the loop runs on the host and tests `any(active)`
before every step, as the while_loop's cond does: it stops as soon as
every node has converged.

Padding conventions: neighbour slots beyond a node's degree carry mask 0
(coeff = mask/omp = 0); padding QUERY rows carry all-zero rows and masks
and stay at zero (grad = -sumF_others <= 0 clips back to the zero row).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.ops.objective import edge_terms


def foldin_pass(
    rows: torch.Tensor,
    nbr_rows: torch.Tensor,
    nbr_mask: torch.Tensor,
    sumF_others: torch.Tensor,
    cfg: BigClamConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused gradient + per-node LLH of a row batch vs frozen neighbours.

    rows (B, K), nbr_rows (B, D, K), nbr_mask (B, D), sumF_others (B, K)
    -> (grad (B, K), llh (B,)): coeff = mask/omp folds the +F_v term, and
    the node tail is -r.sumF_others."""
    x = torch.einsum("bk,bdk->bd", rows, nbr_rows)
    omp, ell = edge_terms(x, cfg)
    nbr_llh = (ell * nbr_mask).sum(dim=-1)
    coeff = nbr_mask / omp
    grad = torch.einsum("bd,bdk->bk", coeff, nbr_rows) - sumF_others
    llh = nbr_llh - torch.einsum("bk,bk->b", rows, sumF_others)
    return grad, llh


def foldin_candidates(
    rows: torch.Tensor,
    grad: torch.Tensor,
    nbr_rows: torch.Tensor,
    nbr_mask: torch.Tensor,
    sumF_others: torch.Tensor,
    cfg: BigClamConfig,
) -> torch.Tensor:
    """(S, B) candidate LLHs: ell_eta per node for every Armijo step, the
    S steps as one (S, B, D) product (the JAX function maps over them)."""
    etas = torch.tensor(cfg.step_candidates, dtype=rows.dtype,
                        device=rows.device)
    nf = torch.clamp(rows[None] + etas[:, None, None] * grad[None],
                     cfg.min_f, cfg.max_f)
    x = torch.einsum("sbk,bdk->sbd", nf, nbr_rows)
    _, ell = edge_terms(x, cfg)
    return (ell * nbr_mask[None]).sum(dim=-1) - torch.einsum(
        "sbk,bk->sb", nf, sumF_others
    )


def _rel_change_elem(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Elementwise |1 - new/old| with the old == 0 corner handled (the
    trainer's convergence predicate, per node)."""
    safe = torch.where(old == 0.0, torch.ones_like(old), old)
    rc = torch.abs(1.0 - new / safe)
    corner = torch.where(new == 0.0, torch.zeros_like(new),
                         torch.full_like(new, float("inf")))
    return torch.where(old == 0.0, corner, rc)


def neighbor_mean_rows(
    nbr_rows: torch.Tensor, nbr_mask: torch.Tensor
) -> torch.Tensor:
    """Warm-start rows: the masked mean of the frozen neighbour rows (a
    zero init is a fixed point the ascent never leaves)."""
    deg = torch.clamp(nbr_mask.sum(dim=-1, keepdim=True), min=1.0)
    return torch.einsum("bd,bdk->bk", nbr_mask, nbr_rows) / deg


def make_foldin_fit(
    cfg: BigClamConfig,
    max_iters: Optional[int] = None,
    conv_tol: Optional[float] = None,
):
    """The batched fold-in optimizer.

    Returns fit(rows0, nbr_rows, nbr_mask, sumF_others) ->
    (rows (B, K), llh (B,), iters (B,) int32): Armijo row ascent to
    per-node convergence, on the device of its inputs. rows0 is copied,
    never written (the JAX function donates it). `llh` is each node's
    ell at the step it was last active (its final row's, once it
    converged)."""
    mi = int(cfg.max_iters if max_iters is None else max_iters)
    tol = float(cfg.conv_tol if conv_tol is None else conv_tol)

    def fit(rows, nbr_rows, nbr_mask, sumF_others):
        rows = rows.clone()
        dt, dev = rows.dtype, rows.device
        etas = torch.tensor(cfg.step_candidates, dtype=dt, device=dev)
        b = rows.shape[0]
        llh_prev = torch.full((b,), float("-inf"), dtype=dt, device=dev)
        active = torch.ones(b, dtype=torch.bool, device=dev)
        iters = torch.zeros(b, dtype=torch.int32, device=dev)
        for it in range(mi):
            if it and not bool(active.any()):
                break
            grad, llh = foldin_pass(rows, nbr_rows, nbr_mask, sumF_others,
                                    cfg)
            # per-node convergence BEFORE this iteration's update: a
            # converged node keeps the row whose llh fired the test
            if it > 0:
                act = active & ~(_rel_change_elem(llh, llh_prev) < tol)
            else:
                act = active
            cand = foldin_candidates(rows, grad, nbr_rows, nbr_mask,
                                     sumF_others, cfg)
            gg = torch.einsum("bk,bk->b", grad, grad)
            ok = cand >= llh[None, :] + cfg.alpha * etas[:, None] * gg[None, :]
            best_eta = torch.where(ok, etas[:, None],
                                   torch.zeros((), dtype=dt, device=dev)
                                   ).max(dim=0).values
            accepted = ok.any(dim=0)
            rows = torch.where(
                (act & accepted)[:, None],
                torch.clamp(rows + best_eta[:, None] * grad, cfg.min_f,
                            cfg.max_f),
                rows,
            )
            llh_prev = torch.where(active, llh, llh_prev)
            active = act
            iters = iters + act.to(torch.int32)
        return rows, llh_prev, iters

    return fit


def apply_rows(
    F: torch.Tensor,
    sumF: torch.Tensor,
    nodes: torch.Tensor,
    rows: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Commit a folded row batch into a frozen state: F[nodes] <- rows IN
    PLACE, and the new sumF by the exact row delta (no O(N*K)
    re-reduction per batch). Padded columns are zero in `rows`, so sumF's
    padding stays inert."""
    old = F.index_select(0, nodes)
    F.index_copy_(0, nodes, rows)
    return F, sumF + (rows - old).sum(dim=0)


# ------------------------------------------------- frozen-state gathers
def gather_neighbor_rows(F: torch.Tensor, nbr_ids: torch.Tensor) -> torch.Tensor:
    """Dense frozen rows for a padded neighbour batch: (B, D, K). Padding
    slots may point at any valid row — their mask is 0."""
    return F[nbr_ids.long()]


def _densify(mi: torch.Tensor, mw: torch.Tensor, k_pad: int) -> torch.Tensor:
    """Scatter member slots (..., M) dense to (..., k_pad). Every id at or
    above k_pad (the sentinel of either package's snapshots, which may sit
    past k_pad + 1) lands in one discarded overflow column: JAX drops an
    out-of-range scatter silently, torch would raise."""
    cols = torch.clamp(mi.long(), max=k_pad)
    out = torch.zeros((*mi.shape[:-1], k_pad + 1), dtype=mw.dtype,
                      device=mw.device)
    return out.scatter_add_(-1, cols, mw)[..., :k_pad]


def densify_member_rows(
    ids: torch.Tensor, w: torch.Tensor, nbr_ids: torch.Tensor, k_pad: int
) -> torch.Tensor:
    """Sparse-representation frozen rows: the (B, D, M) member lists of the
    neighbour batch scattered dense to (B, D, k_pad). Only the query
    window pays K columns; the state stays M-sized."""
    nbr = nbr_ids.long()
    return _densify(ids[nbr], w[nbr], k_pad)


def densify_rows(
    ids: torch.Tensor, w: torch.Tensor, node_ids: torch.Tensor, k_pad: int
) -> torch.Tensor:
    """(B, k_pad) dense rows of the given nodes from sparse member lists
    (the sumF_others subtraction for existing sparse nodes)."""
    nodes = node_ids.long()
    return _densify(ids[nodes], w[nodes], k_pad)
