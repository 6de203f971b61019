"""The plain reference against a float64 CPU run of the port on tiny
graphs: the graph, the seeds, and the iterations of both representations."""

import numpy as np
import pytest
import torch

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.ingest import graph_from_edges
from bigclam_tpu_torch.models.bigclam import BigClamModel
from bigclam_tpu_torch.models.sparse import SparseBigClamModel
from bigclam_tpu_torch.ops.seeding import conductance_seeds, init_F
from bigclam_tpu_torch.ops import sparse_members as sm
from clambench import compare, generate
from clambench.reference import dense as rdense
from clambench.reference import graph as rgraph
from clambench.reference import seeding as rseeding
from clambench.reference import sparse as rsparse

CPU = torch.device("cpu")
SETTINGS = dict(alpha=0.05, beta=0.1, max_backtracks=15, min_p=1e-4, max_p=0.9999,
                min_f=0.0, max_f=1000.0)
GRAPHS = {
    "seeded": ({"graph": {"nodes": 1500, "edges": 9000, "communities": 30}},
               {"graph": {"kind": "agm_powerlaw", "exponent": 2.0,
                          "max_memberships": 4}}),
    "powerlaw": ({"graph": {"nodes": 1500, "edges": 9000, "communities": 30}},
                 {"graph": {"kind": "agm_powerlaw", "exponent": 2.0,
                            "max_memberships": 16}}),
}


def graphs(name, seed=11):
    scale, mix = GRAPHS[name]
    pairs = generate.make_pairs(scale, mix, seed)
    n = scale["graph"]["nodes"]
    return pairs, graph_from_edges(pairs, num_nodes=n), rgraph.build(pairs, n, CPU)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_and_seeds_match_the_program(name):
    pairs, g, rg = graphs(name)
    assert rg.num_directed_edges == g.num_directed_edges
    assert np.array_equal(rg.indptr.numpy(), g.indptr)
    assert np.array_equal(rg.dst.numpy(), g.indices)
    prog = conductance_seeds(g, BigClamConfig(), backend="numpy")
    assert np.array_equal(rseeding.seeds(rg).numpy(), prog)


def test_triangles_in_chunks(monkeypatch):
    _, _, rg = graphs("powerlaw")
    whole = rseeding.triangles(rg)
    monkeypatch.setattr(rseeding, "WEDGE_CHUNK", 7)
    assert torch.equal(rseeding.triangles(rg), whole)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_dense_step_matches_the_port_in_float64(name):
    pairs, g, rg = graphs(name)
    k = 12
    cfg = BigClamConfig(num_communities=k, dtype="float64", **SETTINGS)
    seeds = conductance_seeds(g, cfg, backend="numpy")
    F0 = init_F(g, seeds, cfg)
    model = BigClamModel(g, cfg, device="cpu")
    state = model.init_state(F0)
    F = rdense.seeded(rg, rseeding.seeds(rg), k, torch.float64)
    assert np.array_equal(F.numpy(), F0)
    p = rdense.params(SETTINGS)
    for _ in range(3):
        new = model._step(state)
        F, llh, hist = rdense.step(F, rg, p)
        assert float(new.llh) == pytest.approx(float(llh), rel=1e-12)
        np.testing.assert_allclose(new.F[:, :k].numpy(), F.numpy(), rtol=1e-9, atol=1e-12)
        assert np.array_equal(compare.pooled(new.accept_hist.numpy()),
                              compare.pooled(hist.numpy()))
        state = new


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_sparse_step_matches_the_port_in_float64(name):
    """Each step from the program's own input state: the support update's
    ranks are sums in another order, so a near tie at the M-th place may
    go the other way in a row or two; everything else agrees."""
    pairs, g, rg = graphs(name)
    k, m = 30, 4
    cfg = BigClamConfig(num_communities=k, dtype="float64", representation="sparse",
                        sparse_m=m, **SETTINGS)
    seeds = conductance_seeds(g, cfg, backend="numpy")
    model = SparseBigClamModel(g, cfg, device="cpu")
    state = model.init_state(init_F(g, seeds, cfg))
    n = g.num_nodes
    ids, w = rsparse.seeded(rg, rseeding.seeds(rg), k, m, torch.float64)
    assert np.array_equal(state.ids[:n].numpy(), ids.numpy())
    assert np.array_equal(state.F[:n].numpy(), w.numpy())
    p = rdense.params(SETTINGS)
    pad = model.n_pad - n
    for _ in range(4):
        new = model._step(state)
        ids, w, llh, hist = rsparse.step(state.ids[:n].long(), state.F[:n], rg, k, p)
        assert float(new.llh) == pytest.approx(float(llh), rel=1e-12)
        same = (new.ids[:n].numpy() == ids.numpy()).all(1)
        assert same.mean() >= 0.998
        np.testing.assert_allclose(new.F[:n].numpy()[same], w.numpy()[same],
                                   rtol=1e-9, atol=1e-12)
        h = new.accept_hist.numpy().copy()
        h[-1] -= pad
        assert np.abs(compare.pooled(h) - compare.pooled(hist.numpy())).sum() <= 2 * (~same).sum()
        state = new


def test_sparse_delta_norm_is_the_dense_one():
    rng = np.random.default_rng(0)
    k, m, n = 9, 4, 50
    ids = np.sort(np.stack([rng.choice(k + 1, m, replace=False) for _ in range(n)]), 1)
    ids0 = np.sort(np.stack([rng.choice(k + 1, m, replace=False) for _ in range(n)]), 1)
    w = np.where(ids < k, rng.random((n, m)), 0.0)
    w0 = np.where(ids0 < k, rng.random((n, m)), 0.0)
    dense = np.linalg.norm(compare.densify(ids, w, k) - compare.densify(ids0, w0, k))
    got = compare.sparse_delta_norm(torch.as_tensor(ids), torch.as_tensor(w),
                                    torch.as_tensor(ids0), torch.as_tensor(w0), k)
    assert got == pytest.approx(dense, rel=1e-12)


def test_support_update_breaks_ties_to_the_lower_id():
    # node 0 with neighbours 1..3, each in one community at weight 1: three
    # tied candidates for M = 2 slots; both sides keep the two lower ids
    pairs = np.array([[0, 1], [0, 2], [0, 3]])
    k = 5
    ids = torch.tensor([[k, k], [3, k], [1, k], [2, k]])
    w = torch.tensor([[0.0, 0.0], [1.0, 0.0], [1.0, 0.0], [1.0, 0.0]], dtype=torch.float64)
    new_ids, new_w = rsparse.support(ids, w, rgraph.build(pairs, 4, CPU), k)
    assert new_ids[0].tolist() == [1, 2] and new_w[0].tolist() == [0.0, 0.0]
    g = graph_from_edges(pairs, num_nodes=4)
    pad_ids = torch.cat([ids, torch.full((4, 2), k)]).to(torch.int32)
    pad_w = torch.cat([w, torch.zeros((4, 2), dtype=torch.float64)])
    p_ids, p_w = sm.support_update(pad_ids, pad_w,
                                   sm.build_support_blocks(g, 8, 8, dtype=torch.float64),
                                   2, k)
    assert p_ids[0].tolist() == [1, 2] and p_w[0].tolist() == [0.0, 0.0]
