"""Plain PyTorch BigCLAM iteration on top-M member lists (the sparse F of
the reference's v3: each node keeps at most M communities).

A row is (ids, w): M community ids in ascending order, empty slots holding
the id K with weight 0. F_u is w_u at ids_u and 0 elsewhere. One iteration:

1. Support update: rank_u(c) = F_u[c] + sum_{v in N(u)} F_v[c] over the
   communities of u's own list and its neighbours' lists (neighbour slots
   of weight 0 left out); the M of largest rank, rank > 0, ties to the
   lower id, make u's new list. A member keeps its weight, an admitted
   community starts at 0.
2. The dense iteration of reference/dense.py restricted to the support:
   the gradient in the listed communities only (elsewhere it is -sumF,
   which the clip at 0 undoes), ||grad_u||^2 with the off-support part
   sum_{c not listed} sumF[c]^2, the same ladder and Armijo test.

Edge dots F_u . F_v match the two lists slot by slot (an (M, M) equality
table per edge). Dense rank rows of a block of nodes make the support
update. Imports nothing of the program.
"""

from __future__ import annotations

import torch

from clambench.compare import sparse_delta_norm
from clambench.reference.dense import Params, ego_pairs, ell, histogram, params
from clambench.reference.graph import RefGraph


def seeded(g: RefGraph, seeds: torch.Tensor, k: int, m: int, dtype):
    """(ids, w): each node's ego-net memberships at weight 1, the lowest m
    ids where there are more."""
    rows, cols = ego_pairs(g, seeds[:k])
    order = torch.argsort(cols, stable=True)
    order = order[torch.argsort(rows[order], stable=True)]
    rows, cols = rows[order], cols[order]
    counts = torch.bincount(rows, minlength=g.n)
    slot = torch.arange(rows.shape[0], device=rows.device) - torch.repeat_interleave(
        torch.cumsum(counts, 0) - counts, counts)
    take = slot < m
    ids = torch.full((g.n, m), k, dtype=torch.int64, device=rows.device)
    ids[rows[take], slot[take]] = cols[take]
    return ids, (ids < k).to(dtype)


def column_sums(ids: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    valid = ids < k
    out = torch.zeros(k + 1, dtype=w.dtype, device=w.device)
    out.index_add_(0, torch.where(valid, ids, k).reshape(-1),
                   torch.where(valid, w, 0.0).reshape(-1))
    return out[:k]


def support(ids: torch.Tensor, w: torch.Tensor, g: RefGraph, k: int,
            rows_per_block: int = 1 << 14):
    """Step 1 over all rows: the new (ids, w)."""
    n, m = ids.shape
    dev = ids.device
    new_ids = torch.full_like(ids, k)
    new_w = torch.zeros_like(w)
    for r0 in range(0, n, rows_per_block):
        r1 = min(r0 + rows_per_block, n)
        b = r1 - r0
        own = torch.zeros((b, k + 1), dtype=w.dtype, device=dev)
        own.scatter_(1, ids[r0:r1], w[r0:r1])
        listed = torch.zeros((b, k + 1), dtype=torch.bool, device=dev)
        listed.scatter_(1, ids[r0:r1], True)
        rank = own.clone()
        e0, e1 = int(g.indptr[r0]), int(g.indptr[r1])
        s, d = g.src[e0:e1] - r0, g.dst[e0:e1]
        nid, nw = ids[d], w[d]
        keep = (nid < k) & (nw != 0)
        flat = (s[:, None] * (k + 1) + nid)[keep]
        rank.view(-1).index_add_(0, flat, nw[keep])
        cand = torch.zeros((b, k + 1), dtype=torch.bool, device=dev)
        cand.view(-1)[flat] = True
        cand |= listed
        cand[:, k] = False
        rank = torch.where(cand & (rank > 0), rank, torch.zeros_like(rank))
        rank = rank[:, :k]
        top_v, top_i = torch.topk(rank, min(m + 1, k), dim=1)
        # a tie across the M-th place: order those rows by (rank desc, id)
        if m < k:
            tie = (top_v[:, m - 1] == top_v[:, m]) & (top_v[:, m] > 0)
            if bool(tie.any()):
                rows = torch.nonzero(tie).squeeze(1)
                srt = torch.sort(rank[rows], dim=1, descending=True, stable=True)
                top_v[rows] = srt.values[:, :m + 1]
                top_i[rows] = srt.indices[:, :m + 1]
        top_v, top_i = top_v[:, :m], top_i[:, :m]
        sel = torch.where(top_v > 0, top_i, torch.full_like(top_i, k))
        sel = torch.sort(sel, dim=1).values
        new_ids[r0:r1, :sel.shape[1]] = sel
        new_w[r0:r1, :sel.shape[1]] = own.gather(1, sel)
    return new_ids, new_w


def lookups(ids: torch.Tensor, w: torch.Tensor, g: RefGraph, k: int,
            edges_per_block: int = 1 << 15) -> torch.Tensor:
    """(2E, M): for edge (u, v) and u's slot j, F_v at ids_u[j]."""
    e, m = g.num_directed_edges, ids.shape[1]
    out = torch.empty((e, m), dtype=w.dtype, device=w.device)
    for lo in range(0, e, edges_per_block):
        s, d = g.src[lo:lo + edges_per_block], g.dst[lo:lo + edges_per_block]
        iu, iv = ids[s], ids[d]
        eq = (iu[:, :, None] == iv[:, None, :]) & (iu < k)[:, :, None]
        out[lo:lo + s.shape[0]] = torch.bmm(eq.to(w.dtype), w[d][:, :, None])[:, :, 0]
    return out


def step(ids: torch.Tensor, w: torch.Tensor, g: RefGraph, k: int, p: Params):
    """One iteration from (ids, w). Returns (ids, w_new, llh, histogram):
    ids after the support update, w_new the stepped weights on them, llh
    that of the support-updated input."""
    ids, w = support(ids, w, g, k)
    n = ids.shape[0]
    valid = ids < k
    sumF = column_sums(ids, w, k)
    sumF_at = torch.where(valid, sumF[ids.clamp_max(k - 1)], 0.0)
    vals = lookups(ids, w, g, k)
    omp, e_ll = ell((w[g.src] * vals).sum(1), p)
    node_llh = torch.zeros(n, dtype=w.dtype, device=w.device)
    node_llh.index_add_(0, g.src, e_ll)
    node_llh += -(w * sumF_at).sum(1) + (w * w).sum(1)
    nbr = torch.zeros_like(w)
    nbr.index_add_(0, g.src, vals / omp[:, None])
    grad = torch.where(valid, nbr - sumF_at + w, 0.0)
    gg = (grad * grad).sum(1) + (sumF @ sumF) - (sumF_at * sumF_at).sum(1)
    ok = torch.zeros((len(p.etas), n), dtype=torch.bool, device=w.device)
    ws, gs = w[g.src], grad[g.src]
    for i, eta in enumerate(p.etas):
        nf = torch.clamp(w + eta * grad, p.min_f, p.max_f)
        cand = -(nf * (sumF_at - w + nf)).sum(1) + (nf * nf).sum(1)
        nfs = torch.clamp(ws + eta * gs, p.min_f, p.max_f)
        cand.index_add_(0, g.src, ell((nfs * vals).sum(1), p)[1])
        ok[i] = cand >= node_llh + p.alpha * eta * gg
        del nfs
    etas = torch.tensor(p.etas, dtype=w.dtype, device=w.device)
    best = torch.where(ok, etas[:, None], torch.zeros_like(etas)[:, None]).amax(0)
    w_new = torch.where(ok.any(0)[:, None],
                        torch.clamp(w + best[:, None] * grad, p.min_f, p.max_f), w)
    return ids, w_new, node_llh.sum(), histogram(ok)


def follow(g: RefGraph, seeds: torch.Tensor, bigclam: dict, rows: torch.Tensor,
           steps: int, dtype) -> dict:
    """As reference/dense.py `follow`, on member lists."""
    k, p = int(bigclam["num_communities"]), params(bigclam)
    ids, w = seeded(g, seeds, k, min(int(bigclam["sparse_m"]), k), dtype)
    ids0, w0 = ids.clone(), w.clone()
    out = {"rows0": {"ids": ids0[rows].cpu().numpy(), "w": w0[rows].double().cpu().numpy()},
           "llh": [], "hists": []}
    for t in range(steps + 1):
        if t == steps:
            out["state"] = {"ids": ids[rows].cpu().numpy(),
                            "w": w[rows].double().cpu().numpy(),
                            "sumF": column_sums(ids, w, k).double().cpu().numpy(),
                            "delta_norm": sparse_delta_norm(ids, w, ids0, w0, k)}
        ids, w, llh, hist = step(ids, w, g, k, p)
        out["llh"].append(float(llh))
        out["hists"].append(hist.cpu().numpy())
    return out
