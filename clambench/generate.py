"""The one graph generator every traffic mix reads.

A mix file (`traffic/<mix>.json`) names a generator `kind` and its
parameters; the configuration gives the scale: `graph.nodes`,
`graph.edges` (the undirected edge target) and `graph.communities` (the
planted ground-truth communities). `make_pairs` returns raw (u, v) id
pairs, self loops and repeats included, as a user's edge list would hold
them; the program and the reference each build their own graph from them.

Kinds:

* `agm_powerlaw` — each node joins m communities, drawn uniformly without
  repeats, with P(m) proportional to m^-exponent on [1, max_memberships];
  one p_in for all communities, solved so that the expected number of
  distinct edges (pairs shared by two communities counted once per
  community) is the target. A community's members are drawn over all
  ids, so a node's neighbours lie anywhere in the id range. With
  `connected`, a spanning tree (`spanning_tree`) comes first and the
  communities draw the rest of the target: one component, no isolated
  node, as SNAP's com- graphs (each its network's largest component). A
  small `max_memberships` (the `seeded` mix: 4) keeps degrees near the
  mean; a large one gives heavy-tailed degrees with hubs.

Everything is drawn from numpy's default_rng(seed), in bulk, so the same
seed gives the same pairs.
"""

from __future__ import annotations

import numpy as np


def _expected_distinct(sizes: np.ndarray, p: float) -> float:
    """Expected distinct edges when each community of size s draws
    Binomial(C(s,2), p) ordered pairs uniformly and drops self pairs: a
    non-self draw lands on one of the C(s,2) pairs uniformly, so with
    q = p (s-1)/s the count is P (1 - (1 - q/P)^P), P = C(s,2)."""
    s = sizes.astype(np.float64)
    pairs = s * (s - 1.0) / 2.0
    live = pairs > 0
    s, pairs = s[live], pairs[live]
    q = p * (s - 1.0) / s
    return float(np.sum(pairs * -np.expm1(pairs * np.log1p(-q / pairs))))


def solve_p_in(sizes: np.ndarray, target_edges: float) -> float:
    """The p_in whose expected distinct edges over communities of `sizes`
    is target_edges (bisection; refuses a target no p reaches)."""
    if _expected_distinct(sizes, 1.0) < target_edges:
        raise ValueError(
            f"{target_edges} edges exceed what these communities can hold"
        )
    lo, hi = 0.0, 1.0
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if _expected_distinct(sizes, mid) < target_edges:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _draw_pairs(rng, members: np.ndarray, offsets: np.ndarray,
                p: float) -> np.ndarray:
    """For each community c (members[offsets[c]:offsets[c+1]]), draw
    Binomial(C(s,2), p) ordered pairs uniformly, drop self pairs, map to
    node ids. Returns (E, 2) int64."""
    sizes = np.diff(offsets)
    pairs = sizes * (sizes - 1) // 2
    counts = rng.binomial(pairs, p)
    owner = np.repeat(np.arange(sizes.shape[0]), counts)
    span = sizes[owner]
    a = (rng.random(owner.shape[0]) * span).astype(np.int64)
    b = (rng.random(owner.shape[0]) * span).astype(np.int64)
    keep = a != b
    base = offsets[:-1][owner]
    return np.stack([members[base + a][keep], members[base + b][keep]], axis=1)


def _memberships(rng, nodes: int, communities: int, exponent: float,
                 max_m: int) -> tuple[np.ndarray, np.ndarray]:
    """(node, community) memberships: m per node from the truncated power
    law, then m distinct communities each, drawn uniformly (repeats
    redrawn until none is left)."""
    max_m = min(max_m, communities)
    m_values = np.arange(1, max_m + 1, dtype=np.float64)
    prob = m_values ** -exponent
    prob /= prob.sum()
    m = rng.choice(max_m, size=nodes, p=prob) + 1
    node = np.repeat(np.arange(nodes, dtype=np.int64), m)
    comm = rng.integers(0, communities, node.shape[0])
    while True:
        key = node * communities + comm
        order = np.argsort(key, kind="stable")
        dup = np.zeros(key.shape[0], dtype=bool)
        dup[order[1:]] = key[order[1:]] == key[order[:-1]]
        n_dup = int(dup.sum())
        if n_dup == 0:
            return node, comm
        comm[dup] = rng.integers(0, communities, n_dup)


def spanning_tree(rng, nodes: int) -> np.ndarray:
    """A random recursive tree over the nodes in a random order: each node
    after the first links to one drawn uniformly among those before it.
    (nodes - 1, 2) int64: the graph becomes one component."""
    order = rng.permutation(nodes).astype(np.int64)
    parent = (rng.random(nodes - 1) * np.arange(1, nodes)).astype(np.int64)
    return np.stack([order[1:], order[parent]], axis=1)


def agm_powerlaw(rng, nodes: int, communities: int, edges: int,
                 exponent: float, max_memberships: int,
                 connected: bool = False) -> np.ndarray:
    tree = spanning_tree(rng, nodes) if connected else np.zeros((0, 2), np.int64)
    node, comm = _memberships(rng, nodes, communities, exponent,
                              max_memberships)
    order = np.lexsort((node, comm))
    members = node[order]
    sizes = np.bincount(comm, minlength=communities)
    offsets = np.zeros(communities + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    p = solve_p_in(sizes, edges - tree.shape[0])
    return np.concatenate([tree, _draw_pairs(rng, members, offsets, p)])


KINDS = {"agm_powerlaw": agm_powerlaw}


def make_pairs(config: dict, mix: dict, seed: int) -> np.ndarray:
    """Raw (u, v) int64 pairs of the mix's graph at the configuration's
    scale, from `seed`."""
    graph = mix["graph"]
    kind = graph["kind"]
    if kind not in KINDS:
        raise ValueError(f"unknown graph kind {kind!r} (one of {sorted(KINDS)})")
    params = {k: v for k, v in graph.items() if k != "kind"}
    scale = config["graph"]
    rng = np.random.default_rng(int(seed))
    return KINDS[kind](rng, int(scale["nodes"]), int(scale["communities"]),
                       int(scale["edges"]), **params)
