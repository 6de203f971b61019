"""Plain PyTorch conductance seeding (BigCLAM's conductanceLocalMin).

For every node u with ego-net S(u) = {u} + N(u): tri(u) = edges among
N(u), S1(u) = sum of the neighbours' degrees,

    cut   = S1 - deg - 2 tri,   vol_S = 2 deg + 2 tri,
    vol_T = 2E - vol_S - 2 cut,
    phi   = 0 if vol_S == 0, 1 if vol_T <= 0, else cut / min(vol_S, vol_T).

Each node with neighbours nominates its neighbour of least (phi, id); a
node without neighbours nominates itself at phi 10. The seeds are the
nominees, each once, by ascending (phi, id). Triangles are counted from
the wedges at each node: pairs of its neighbours (both lists sorted), each
looked up among the edges, in chunks. Every quantity before the division
is an exact integer, so phi is the correctly rounded quotient.
"""

from __future__ import annotations

import torch

from clambench.reference.graph import RefGraph

ISOLATED_PHI = 10.0
WEDGE_CHUNK = 1 << 25


def triangles(g: RefGraph) -> torch.Tensor:
    """(n,) int64 edges among each node's neighbours."""
    dev = g.src.device
    deg = g.degrees()
    e = g.num_directed_edges
    pos = torch.arange(e, device=dev) - g.indptr[g.src]
    later = deg[g.src] - 1 - pos            # partners after this position
    keys = g.src * g.n + g.dst              # sorted: the CSR's order
    tri = torch.zeros(g.n, dtype=torch.int64, device=dev)
    csum = torch.cumsum(later, 0)
    start = 0
    while start < e:
        # edges [start, stop) whose wedges fit one chunk
        limit = (csum[start - 1] if start else 0) + WEDGE_CHUNK
        stop = int(torch.searchsorted(csum, limit, right=True))
        stop = min(max(stop, start + 1), e)
        first = torch.arange(start, stop, device=dev)
        count = later[start:stop]
        e1 = torch.repeat_interleave(first, count)
        if e1.numel():
            base = torch.cumsum(count, 0) - count
            step = torch.arange(e1.shape[0], device=dev) - torch.repeat_interleave(
                base, count)
            e2 = e1 + 1 + step
            want = g.dst[e1] * g.n + g.dst[e2]
            at = torch.searchsorted(keys, want).clamp_max_(e - 1)
            closed = (keys[at] == want).to(torch.int64)
            tri.index_add_(0, g.src[e1], closed)
        start = stop
    return tri


def conductance(g: RefGraph) -> torch.Tensor:
    deg = g.degrees().to(torch.float64)
    s1 = torch.zeros(g.n, dtype=torch.float64, device=deg.device)
    s1.index_add_(0, g.src, deg[g.dst])
    tri = triangles(g).to(torch.float64)
    cut = s1 - deg - 2.0 * tri
    vol_s = 2.0 * deg + 2.0 * tri
    vol_t = float(g.num_directed_edges) - vol_s - 2.0 * cut
    ratio = cut / torch.minimum(vol_s, vol_t).clamp_min(1e-300)
    return torch.where(vol_s == 0, torch.zeros_like(ratio),
                       torch.where(vol_t <= 0, torch.ones_like(ratio), ratio))


def seeds(g: RefGraph) -> torch.Tensor:
    """All seeds, by ascending (phi, id)."""
    phi = conductance(g)
    dev = phi.device
    deg = g.degrees()
    # each node's neighbour of least (phi, id): sort edges by (src, phi, dst)
    order = torch.argsort(g.dst, stable=True)
    order = order[torch.argsort(phi[g.dst][order], stable=True)]
    order = order[torch.argsort(g.src[order], stable=True)]
    nominee = torch.arange(g.n, device=dev)
    has = deg > 0
    nominee[has] = g.dst[order][g.indptr[:-1][has]]
    cand = torch.unique(nominee)
    cand_phi = torch.where(deg[cand] > 0, phi[cand],
                           torch.full_like(phi[cand], ISOLATED_PHI))
    return cand[torch.argsort(cand_phi, stable=True)]
