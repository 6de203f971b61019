"""The port's component pass (bigclam_tpu_torch/ops/components.py) held
against the JAX package's `_labels_and_stats` and the scipy oracle
(models.quality._graph_components): labels, component sizes and internal
edge counts equal bit for bit on random memberships under several seeds,
a disconnected graph with singletons, and across batches of a small
patched edge budget; the discrete moves (atomize_reassign,
repair_communities) agree across both backends and with the JAX package;
and the backend rule follows its env hook and the tensors' device."""

import numpy as np
import pytest
import torch

from bigclam_tpu.models import quality as jq
from bigclam_tpu.ops import components as jc

from bigclam_tpu_torch.graph.ingest import graph_from_edges
from bigclam_tpu_torch.models import quality as tq
from bigclam_tpu_torch.models.agm import sample_planted_graph
from bigclam_tpu_torch.ops import components as tc
from bigclam_tpu_torch.ops.extraction import delta_threshold

torch.set_num_threads(2)


def _partition(comps):
    return {frozenset(int(x) for x in c) for c in comps}


def _stats(member, g, **kw):
    return tc.column_component_stats(member, *tc.device_edges(g, "cpu"),
                                     g.num_nodes, **kw)


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == np.int32
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_labels_match_jax_and_scipy_random_membership(seed):
    rng = np.random.default_rng(seed)
    g, _ = sample_planted_graph(500, 20, p_in=0.3, rng=rng)
    n = g.num_nodes
    c_total = 12
    member = rng.random((c_total, n)) < rng.uniform(0.0, 0.4, (c_total, 1))
    member[0] = False                           # empty membership
    member[1] = False
    member[1, int(rng.integers(n))] = True      # single-node component
    member[2] = True                            # the whole graph
    ours = _stats(member, g)
    _assert_same(ours, jc.column_component_stats(member, *jc.device_edges(g), n))
    labels, sizes, counts = ours
    for c in range(c_total):
        mem = np.flatnonzero(member[c])
        host = _partition(tq._graph_components(mem, g.indptr, g.indices))
        assert _partition(tc.components_from_labels(labels[c], n)) == host, c
        for comp in tc.components_from_labels(labels[c], n):
            assert labels[c][comp].min() == comp.min()       # the root id
            assert np.all(sizes[c][comp] == comp.size)
            inside = np.isin(tq._gather_neighbors(comp, g.indptr, g.indices),
                             comp).sum()
            assert np.all(counts[c][comp] == inside)
        out = np.setdiff1d(np.arange(n), mem)
        assert np.all(labels[c][out] == n) and np.all(sizes[c][out] == 0)
    # a tensor mask (the device quality path's input) gives the same arrays
    _assert_same(_stats(torch.from_numpy(member), g), ours)
    dev = _stats(member, g, as_numpy=False)
    assert all(isinstance(x, torch.Tensor) for x in dev)
    _assert_same([x.numpy() for x in dev], ours)


def _cliques_graph():
    edges = [(b * 5 + i, b * 5 + j) for b in range(6)
             for i in range(5) for j in range(i + 1, 5)]
    return graph_from_edges(edges, num_nodes=32)    # nodes 30, 31 isolated


def test_disconnected_graph_singletons_and_batches(monkeypatch):
    g = _cliques_graph()
    n = g.num_nodes
    member = np.ones((5, n), bool)
    member[1, :10] = False                       # first two cliques out
    member[2] = False                            # empty column
    member[3] = False
    member[3, [30, 31]] = True                   # isolated singletons only
    member[4, ::2] = True                        # broken cliques
    member[4, 1::2] = False
    labels, sizes, counts = ours = _stats(member, g)
    want = {frozenset(range(b * 5, b * 5 + 5)) for b in range(6)}
    assert _partition(tc.components_from_labels(labels[0], n)) == want | {
        frozenset({30}), frozenset({31})}
    assert _partition(tc.components_from_labels(labels[2], n)) == set()
    assert labels[3][30] == 30 and labels[3][31] == 31
    assert sizes[3][30] == 1 and counts[3][31] == 0
    _assert_same(ours, jc.column_component_stats(member, *jc.device_edges(g), n))
    # batches: an explicit col_batch and the auto batch under a patched
    # budget (E = 120 directed edges: 2 columns a batch) equal one batch
    _assert_same(_stats(member, g, col_batch=3), ours)
    monkeypatch.setattr(tc, "EDGE_ELEM_BUDGET", 2 * g.num_directed_edges)
    _assert_same(_stats(member, g), ours)
    mem = np.flatnonzero(member[1])
    assert _partition(tc.graph_components_device(mem, g, device="cpu")) == \
        _partition(tq._graph_components(mem, g.indptr, g.indices))
    assert tc.graph_components_device(np.zeros(0, np.int64), g) == []
    z = _stats(np.zeros((0, n), bool), g)
    assert all(x.shape == (0, n) for x in z)


def _shifted_F(g, truth, k):
    F = np.zeros((g.num_nodes, k))
    for c in range(k):                  # shifted: block c + half of c+1
        nxt = truth[(c + 1) % k]
        F[truth[c], c] = 1.0
        F[nxt[: len(nxt) // 2], c] = 1.0
    return F


def test_atomize_backends_agree_with_jax():
    g, truth = sample_planted_graph(600, 25, p_in=0.4,
                                    rng=np.random.default_rng(5))
    k = len(truth)
    delta = delta_threshold(g.num_nodes, g.num_edges)
    F = _shifted_F(g, truth, k)
    F_h, n_h = tq.atomize_reassign(F, g, delta, k, components="host")
    F_d, n_d = tq.atomize_reassign(F, g, delta, k, components="device",
                                   device="cpu")
    F_j, n_j = jq.atomize_reassign(F, g, delta, k, components="host")
    assert n_h == n_d == n_j > 0
    np.testing.assert_array_equal(F_h, F_d)
    np.testing.assert_array_equal(F_h, F_j)


def test_repair_backends_agree_with_jax():
    g, truth = sample_planted_graph(240, 10, p_in=0.5,
                                    rng=np.random.default_rng(3))
    k = 10
    F = np.zeros((g.num_nodes, k))
    for c in range(3, 10):
        F[truth[c], c] = 1.0
    F[truth[0] + truth[1], 0] = 1.0      # merged blocks 0+1 on column 0
    half = len(truth[2]) // 2
    F[truth[2][:half], 1] = 1.0          # block 2 fragmented over 1 and 2
    F[truth[2][half:], 2] = 1.0
    delta = delta_threshold(g.num_nodes, g.num_edges)
    F_h, n_h = tq.repair_communities(F, g, delta, k, components="host")
    F_d, n_d = tq.repair_communities(F, g, delta, k, components="device",
                                     device="cpu")
    F_j, n_j = jq.repair_communities(F, g, delta, k, components="host")
    assert n_h == n_d == n_j == 1
    np.testing.assert_array_equal(F_h, F_d)
    np.testing.assert_array_equal(F_h, F_j)
    edits, nrep = tq.repair_plan(F, g, delta, k)
    jedits, jnrep = jq.repair_plan(F, g, delta, k)
    assert nrep == jnrep and len(edits) == len(jedits)
    for a, b in zip(edits, jedits):
        assert a[0] == b[0] and len(a) == len(b)
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(x, y)


def test_backend_rule_env_hook_and_device(monkeypatch):
    monkeypatch.delenv("BIGCLAM_COMPONENTS", raising=False)
    big, small = tc.DEVICE_MIN_CELLS, tc.DEVICE_MIN_CELLS - 1
    assert tc.components_backend(big, 1) == "host"           # no device
    assert tc.components_backend(big, 1, device="cpu") == "host"
    cuda = torch.device("cuda", 0)
    assert tc.components_backend(big, 1, device=cuda) == "device"
    assert tc.components_backend(small, 1, device=cuda) == "host"
    assert tc.components_backend(1, 1, "device") == "device"  # override
    assert tc.components_backend(big, 1, "host", cuda) == "host"
    monkeypatch.setenv("BIGCLAM_COMPONENTS", "device")
    assert tc.components_backend(1, 1, device="cpu") == "device"
    monkeypatch.setenv("BIGCLAM_COMPONENTS", "host")
    assert tc.components_backend(big, 1, device=cuda) == "host"
    assert tc.components_backend(big, 1, "device", cuda) == "device"
    monkeypatch.setenv("BIGCLAM_COMPONENTS", "bogus")
    assert tc.components_backend(big, 1, device=cuda) == "device"
    # the JAX package's floor and budget
    assert (tc.DEVICE_MIN_CELLS, tc.EDGE_ELEM_BUDGET) == (
        jc.DEVICE_MIN_CELLS, jc.EDGE_ELEM_BUDGET)


def test_env_hook_routes_atomize_to_the_device_pass(monkeypatch):
    """BIGCLAM_COMPONENTS=device sends the auto backend of atomize_reassign
    through the label-propagation pass (a CPU trainer would take scipy)."""
    g, truth = sample_planted_graph(240, 10, p_in=0.8,
                                    rng=np.random.default_rng(5))
    k = 10
    F = _shifted_F(g, truth, k)
    delta = delta_threshold(g.num_nodes, g.num_edges)
    calls = []
    orig = tc.column_component_stats
    monkeypatch.setattr(tc, "column_component_stats",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    monkeypatch.setenv("BIGCLAM_COMPONENTS", "device")
    F_d, n_d = tq.atomize_reassign(F, g, delta, k, device="cpu")
    assert calls
    monkeypatch.setenv("BIGCLAM_COMPONENTS", "host")
    calls.clear()
    F_h, n_h = tq.atomize_reassign(F, g, delta, k, device="cpu")
    assert not calls and n_h == n_d == k
    np.testing.assert_array_equal(F_h, F_d)
