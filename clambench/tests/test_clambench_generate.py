"""The generator: deterministic by seed, and on its edge targets."""

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse.csgraph import connected_components

from clambench import generate, registry

SCALE = {"graph": {"nodes": 20000, "edges": 60000, "communities": 150}}
MIXES = {
    "seeded": registry.mix("seeded"),
    "heavy_tail": {"graph": {"kind": "agm_powerlaw", "exponent": 2.0,
                             "max_memberships": 64}},
}


def distinct_edges(pairs):
    a = np.sort(pairs, axis=1)
    a = a[a[:, 0] != a[:, 1]]
    return np.unique(a[:, 0] * 10**7 + a[:, 1]).shape[0]


@pytest.mark.parametrize("kind", sorted(MIXES))
def test_same_seed_same_pairs(kind):
    a = generate.make_pairs(SCALE, MIXES[kind], 2**31 + 5)
    b = generate.make_pairs(SCALE, MIXES[kind], 2**31 + 5)
    c = generate.make_pairs(SCALE, MIXES[kind], 2**31 + 6)
    assert np.array_equal(a, b)
    assert not np.array_equal(a[:100], c[:100])


@pytest.mark.parametrize("kind,tol", [("seeded", 0.02), ("heavy_tail", 0.03)])
def test_edge_target(kind, tol):
    got = [distinct_edges(generate.make_pairs(SCALE, MIXES[kind], s)) for s in (1, 2)]
    for e in got:
        assert abs(e - 60000) <= tol * 60000, got


def test_seeded_mix_is_one_component_over_spread_ids():
    """Overlaps join the communities: the largest component holds nearly
    every node with an edge, and neighbours lie anywhere in the id range."""
    pairs = generate.make_pairs(SCALE, MIXES["seeded"], 3)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    n = SCALE["graph"]["nodes"]
    adj = sp.coo_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])), shape=(n, n))
    _, label = connected_components(adj, directed=False)
    linked = np.unique(pairs)
    assert np.bincount(label[linked]).max() >= 0.99 * linked.shape[0]
    assert np.median(np.abs(pairs[:, 0] - pairs[:, 1])) > n / 5


def test_powerlaw_memberships_have_no_repeats():
    rng = np.random.default_rng(0)
    node, comm = generate._memberships(rng, 5000, 300, 2.0, 64)
    key = node * 300 + comm
    assert np.unique(key).shape[0] == key.shape[0]
    m = np.bincount(node, minlength=5000)
    assert m.min() >= 1 and m.max() <= 64
    assert (m == 1).mean() > 0.5                        # P(1) = 1/zeta-ish


def test_unknown_kind_is_refused():
    with pytest.raises(ValueError):
        generate.make_pairs(SCALE, {"graph": {"kind": "nope"}}, 0)
