"""Plain PyTorch BigCLAM iteration on a dense F (Yang & Leskovec, WSDM'13,
with the reference implementation's Armijo line search).

For p_uv = exp(-F_u . F_v), clipped to [min_p, max_p], and
ell(x) = log(1 - p) + x:

    LLH(u)  = sum_{v in N(u)} ell(F_u . F_v) - F_u . sumF + F_u . F_u
    grad_u  = sum_{v in N(u)} F_v / (1 - p_uv) - sumF + F_u

Each node tries the steps eta in {1, beta, ..., beta^15}: F_u' = clip(F_u
+ eta grad_u, min_f, max_f), scored against everyone else's old rows with
the node's own change in sumF, and accepted where LLH'(u) >= LLH(u) +
alpha eta ||grad_u||^2. Every node takes its largest accepted step at once
(Jacobi); a node with none keeps its row. The LLH an iteration reports is
that of its input. Edges are swept in blocks so that the gathered rows fit.
Imports nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from clambench.compare import dense_delta_norm
from clambench.reference.graph import RefGraph


class Params(NamedTuple):
    alpha: float
    etas: tuple
    min_p: float
    max_p: float
    min_f: float
    max_f: float


def params(bigclam: dict) -> Params:
    beta = float(bigclam["beta"])
    etas = tuple(beta ** i for i in range(int(bigclam["max_backtracks"]) + 1))
    return Params(float(bigclam["alpha"]), etas, float(bigclam["min_p"]),
                  float(bigclam["max_p"]), float(bigclam["min_f"]),
                  float(bigclam["max_f"]))


def ell(x: torch.Tensor, p: Params) -> tuple:
    """(1 - p, log(1 - p) + x) of edge dots x, clipped."""
    omp = torch.clamp(-torch.expm1(-x), 1.0 - p.max_p, 1.0 - p.min_p)
    return omp, torch.log(omp) + x


def edge_blocks(g: RefGraph, width: int, budget: int = 1 << 27):
    """(src, dst) blocks of at most ~budget gathered elements each."""
    e = g.num_directed_edges
    step = max(1024, budget // max(width, 1))
    for lo in range(0, e, step):
        yield g.src[lo:lo + step], g.dst[lo:lo + step]


def ego_pairs(g: RefGraph, seeds: torch.Tensor):
    """(rows, cols): (member, c) for each member of seed c's ego-net, the
    seed and its neighbours."""
    counts = g.indptr[seeds + 1] - g.indptr[seeds]
    cols = torch.repeat_interleave(torch.arange(seeds.shape[0], device=seeds.device),
                                   counts)
    first = torch.repeat_interleave(g.indptr[seeds], counts)
    offset = torch.arange(cols.shape[0], device=seeds.device) - torch.repeat_interleave(
        torch.cumsum(counts, 0) - counts, counts)
    return (torch.cat([g.dst[first + offset], seeds]),
            torch.cat([cols, torch.arange(seeds.shape[0], device=seeds.device)]))


def seeded(g: RefGraph, seeds: torch.Tensor, k: int, dtype) -> torch.Tensor:
    """F0: column c the ego-net indicator of seed c."""
    rows, cols = ego_pairs(g, seeds[:k])
    F = torch.zeros((g.n, k), dtype=dtype, device=seeds.device)
    F[rows, cols] = 1.0
    return F


def histogram(ok: torch.Tensor) -> torch.Tensor:
    """(S+1,) counts: rows whose largest accepted step is eta_s, then rows
    with none."""
    s = ok.shape[0]
    first = torch.where(ok.any(0), torch.argmax(ok.to(torch.int8), 0),
                        torch.full_like(ok[0], s, dtype=torch.int64))
    return torch.bincount(first, minlength=s + 1)


def step(F: torch.Tensor, g: RefGraph, p: Params):
    """One iteration from F (n, k). Returns (F_new, llh of F, histogram)."""
    n, k = F.shape
    sumF = F.sum(0)
    nbr_grad = torch.zeros_like(F)
    node_llh = torch.zeros(n, dtype=F.dtype, device=F.device)
    for s, d in edge_blocks(g, k):
        fd = F[d]
        omp, e_ll = ell((F[s] * fd).sum(1), p)
        node_llh.index_add_(0, s, e_ll)
        nbr_grad.index_add_(0, s, fd / omp[:, None])
    grad = nbr_grad.sub_(sumF).add_(F)
    node_llh += -(F @ sumF) + (F * F).sum(1)
    gg = (grad * grad).sum(1)
    ok = torch.zeros((len(p.etas), n), dtype=torch.bool, device=F.device)
    for i, eta in enumerate(p.etas):
        nf = torch.clamp(F + eta * grad, p.min_f, p.max_f)
        # -nf.(sumF - F_u + nf) + nf.nf
        cand = -(nf @ sumF) + (nf * F).sum(1)
        for s, d in edge_blocks(g, k):
            cand.index_add_(0, s, ell((nf[s] * F[d]).sum(1), p)[1])
        ok[i] = cand >= node_llh + p.alpha * eta * gg
        del nf, cand
    etas = torch.tensor(p.etas, dtype=F.dtype, device=F.device)
    best = torch.where(ok, etas[:, None], torch.zeros_like(etas)[:, None]).amax(0)
    F_new = torch.where(ok.any(0)[:, None],
                        torch.clamp(F + best[:, None] * grad, p.min_f, p.max_f), F)
    return F_new, node_llh.sum(), histogram(ok)


def follow(g: RefGraph, seeds: torch.Tensor, bigclam: dict, rows: torch.Tensor,
           steps: int, dtype) -> dict:
    """`steps` + 1 iterations from the seeded F: each LLH and histogram,
    F's sampled rows at the start (`rows0`) and, after `steps`
    iterations, the sampled rows, sumF and the norm of the change."""
    k, p = int(bigclam["num_communities"]), params(bigclam)
    F = seeded(g, seeds, k, dtype)
    F0 = seeded(g, seeds, k, torch.bool)
    out = {"rows0": F0[rows].double().cpu().numpy(), "llh": [], "hists": []}
    for t in range(steps + 1):
        if t == steps:
            out["state"] = {"rows": F[rows].double().cpu().numpy(),
                            "sumF": F.sum(0).double().cpu().numpy(),
                            "delta_norm": dense_delta_norm(F, F0)}
        F, llh, hist = step(F, g, p)
        out["llh"].append(float(llh))
        out["hists"].append(hist.cpu().numpy())
    return out
