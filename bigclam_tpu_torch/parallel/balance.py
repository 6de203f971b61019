"""Degree-balanced node relabeling: even out per-shard edge counts before
sharding.

Copied from bigclam_tpu/parallel/balance.py (`balance_permutation`,
`balance_graph`; pinned bit-identical by tests/test_torch_host.py). A
host-side snake (boustrophedon) assignment — sort nodes by degree, deal
them across the dp shards alternating direction each round — relabels
nodes once at model build; the trainers run on the relabeled graph and
results are mapped back, so the transform is invisible to callers (exact
up to float summation order — neighbor lists re-sort under the new ids).

Shard row ranges are fixed by the trainers (rows = n_pad/dp, padding rows at
the tail), so per-shard node counts are forced; the snake balances the
*degree* sums within that constraint, fully vectorized.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from bigclam_tpu_torch.graph.csr import Graph


def balance_permutation(degrees: np.ndarray, dp: int, n_pad: int) -> np.ndarray:
    """Snake node->shard assignment; returns perm (old id -> new id).

    New ids are compact [0, N): shard i owns ids [i*rows, min((i+1)*rows, N))
    — the same contiguous ranges the trainers shard on — and receives exactly
    that many nodes, dealt heaviest-first in direction-alternating rounds.
    Shards whose capacity is exhausted (tail shards of the padded range) drop
    out; active shards are always an id-prefix because capacities are
    non-increasing in shard id.
    """
    n = int(degrees.shape[0])
    if n_pad % dp != 0 or n_pad < n:
        raise ValueError(f"n_pad {n_pad} must be a multiple of dp {dp} and >= N {n}")
    rows = n_pad // dp
    caps = np.minimum(np.arange(1, dp + 1) * rows, n) - np.minimum(
        np.arange(dp) * rows, n
    )
    order = np.argsort(degrees, kind="stable")[::-1]      # heaviest first
    perm = np.empty(n, dtype=np.int64)
    remaining = caps.copy()
    start = 0                                             # nodes dealt so far
    round_no = 0                                          # global snake parity
    while start < n:
        active = np.flatnonzero(remaining > 0)
        m = active.size
        full_rounds = min(int(remaining[active].min()), (n - start) // m)
        if full_rounds > 0:
            blk = order[start : start + full_rounds * m].reshape(
                full_rounds, m
            ).copy()
            odd = (round_no + np.arange(full_rounds)) % 2 == 1
            blk[odd] = blk[odd, ::-1]                     # snake direction
            filled = (caps[active] - remaining[active])[None, :]
            slots = active[None, :] * rows + filled + np.arange(
                full_rounds
            )[:, None]
            perm[blk] = slots
            remaining[active] -= full_rounds
            start += full_rounds * m
            round_no += full_rounds
        else:                                             # final partial round
            rem = n - start
            act = active[::-1] if round_no % 2 else active
            sel = act[:rem]
            perm[order[start:]] = sel * rows + (caps[sel] - remaining[sel])
            remaining[sel] -= 1
            start = n
    return perm


def balance_graph(g: Graph, dp: int, n_pad: int) -> Tuple[Graph, np.ndarray]:
    """(relabeled graph, perm). F rows map as F_new[perm[u]] = F_old[u];
    map device results back with F_old = F_new[perm]."""
    perm = balance_permutation(g.degrees, dp, n_pad)
    return g.permute(perm), perm
