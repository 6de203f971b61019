"""The edge orderings behind two CUDA kernels of the port, on the CPU:
the runs of an edge chunk that the candidate edge-terms kernel (#14,
ops.edge_kernels.edge_runs) walks one warp each, and the visit orders of a
ring bucket's rows that kernel #8 takes (parallel/ring.py `visit_order`).
Runs are held against a numpy reference on CSR-ordered, boundary-split,
shuffled and hub chunks; a visit order must be a deterministic permutation
of exactly the bucket's rows with an edge. Neither changes a result: the
plain versions, which the CPU runs, ignore both, and the trajectories with
and without them are equal bit for bit. On a card only: #8 under every
visit order equals #8 without one, bit for bit."""

import numpy as np
import pytest
import torch

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.ingest import graph_from_edges
from bigclam_tpu_torch.models.agm import sample_planted_graph
from bigclam_tpu_torch.models.bigclam import BigClamModel
from bigclam_tpu_torch.ops import csr_kernels as ck
from bigclam_tpu_torch.ops import edge_kernels as ek
from bigclam_tpu_torch.ops import ring_kernels as rk
from bigclam_tpu_torch.ops.objective import EdgeChunks, grad_llh
from bigclam_tpu_torch.parallel import RingBigClamModel, make_mesh
from bigclam_tpu_torch.parallel.ring import VISIT_ORDER, VISIT_ORDERS, visit_order

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _runs_reference(src: np.ndarray) -> np.ndarray:
    """Run offsets by a plain loop: a run ends where the next entry differs."""
    out = [0]
    for e in range(1, len(src)):
        if src[e] != src[e - 1]:
            out.append(e)
    if len(src):
        out.append(len(src))
    return np.asarray(out, np.int64)


def _hub_graph(seed=5, n=300, degrees=(120, 700 - 1)):
    """Planted blocks plus two hubs of the given degrees (a hub spans many
    32-edge tiles and, in short chunks, several chunks)."""
    rng = np.random.default_rng(seed)
    g0, _ = sample_planted_graph(n, 15, p_in=0.3, rng=rng)
    pairs = [np.stack([g0.src, g0.dst], axis=1)]
    extra = max(degrees) + 1 - n
    total = n + max(extra, 0)
    for hub, deg in enumerate(degrees):
        nbrs = rng.choice(np.setdiff1d(np.arange(total), [hub]), deg, replace=False)
        pairs.append(np.stack([np.full(deg, hub), nbrs], axis=1))
    return graph_from_edges(np.concatenate(pairs), num_nodes=total)


def _chunks(g, how, chunk):
    """(src, dst) chunks of g's directed edges in CSR order or shuffled."""
    src = g.src.astype(np.int64)
    dst = g.dst.astype(np.int64)
    if how == "shuffled":
        perm = np.random.default_rng(0).permutation(src.shape[0])
        src, dst = src[perm], dst[perm]
    return EdgeChunks(torch.as_tensor(src), torch.as_tensor(dst), chunk)


@pytest.mark.parametrize("how,chunk", [
    ("csr", 10**9),       # one chunk: each run is a whole neighbourhood
    ("csr", 500),         # chunk boundaries split nodes, the hub over two
    ("shuffled", 777),    # runs of mostly one edge
])
def test_edge_runs_match_a_plain_loop(how, chunk):
    g = _hub_graph()
    edges = ek.with_runs(_chunks(g, how, chunk))
    slices = list(edges.slices())
    assert len(edges.runs) == len(slices)
    for (s, _), runs in zip(slices, edges.runs):
        want = _runs_reference(s.numpy())
        assert runs.dtype == torch.int64
        np.testing.assert_array_equal(runs.numpy(), want)
        np.testing.assert_array_equal(ek.edge_runs(s).numpy(), want)
        # each run holds one source, and consecutive runs differ
        r = runs.numpy()
        sv = s.numpy()
        for a, b in zip(r[:-1], r[1:]):
            assert b > a and (sv[a:b] == sv[a]).all()
        assert (sv[r[1:-1]] != sv[r[1:-1] - 1]).all()
    if how == "csr" and chunk == 500:
        hub_runs = sum(int((s[r[:-1]] == 1).sum())
                       for (s, _), r in zip(slices, edges.runs))
        assert hub_runs == 2      # the degree-699 hub is split across two chunks


def test_edge_runs_of_edge_cases():
    for src, want in (([], [0]), ([4], [0, 1]), ([3, 3, 3], [0, 3]),
                      ([1, 2, 1, 1], [0, 1, 2, 4])):
        got = ek.edge_runs(torch.as_tensor(src, dtype=torch.int64))
        assert got.tolist() == want


def test_candidate_edge_terms_ignore_runs_on_the_cpu():
    """Given runs or not, the wrapper's result is the same (the plain
    version on the CPU), and the model caches runs only on pallas_vmem."""
    g = _hub_graph(n=200, degrees=(90, 40))
    k = 7
    cfg = BigClamConfig(num_communities=k, dtype="float64", use_pallas=True,
                        edge_chunk=300)
    m = BigClamModel(g, cfg, device="cpu")
    assert m.engaged_path == "pallas_vmem"
    assert len(m.edges.runs) == len(list(m.edges.slices()))
    xla = BigClamModel(g, cfg.replace(use_pallas=False), device="cpu")
    assert xla.engaged_path == "xla" and xla.edges.runs is None
    F = torch.as_tensor(np.random.default_rng(1).uniform(0, 1, (g.num_nodes, k)))
    grad, _ = grad_llh(F, F.sum(dim=0), m.edges, cfg)
    for (s, d), runs in zip(m.edges.slices(), m.edges.runs):
        a = ek.candidate_edge_terms(F, grad, s, d, cfg, runs)
        b = ek.candidate_edge_terms(F, grad, s, d, cfg)
        assert torch.equal(a, b)
    assert torch.equal(ek.candidates_pass_kernel(F, grad, m.edges, cfg),
                       ek.candidates_pass_kernel(F, grad, xla.edges, cfg))


def test_ladder_plan_of_the_edge_terms_kernel_takes_any_k():
    """#14 reads F_u and grad_u per column chunk: any K, #9's shared memory."""
    ring = ck.ladder_launch_plan("ring_cand_phase", 37)["smem_bytes"]
    for k in (1, 37, 1000, 1100, 3000):
        plan = ck.ladder_launch_plan("candidate_edge_terms", k)
        assert plan["kpl"] is None and plan["smem_bytes"] == ring
        assert not plan["opt_in"]
    with pytest.raises(ck.KernelKLimitError):
        ck.ladder_launch_plan("candidate_edge_terms", 0)
    with pytest.raises(ValueError):
        ck.ladder_launch_plan("grad_llh_csr", 37)


# --- visit orders ---------------------------------------------------------


def _bucket(seed=0, rows=60, cols=80, p=0.05):
    """A bucket-like CSR (sorted neighbour rows) with empty rows."""
    rng = np.random.default_rng(seed)
    a = rng.random((rows, cols)) < p
    a[::7] = False                                   # some rows without an edge
    indptr = np.zeros(rows + 1, np.int64)
    np.cumsum(a.sum(axis=1), out=indptr[1:])
    indices = np.nonzero(a)[1].astype(np.int32)
    return indptr, indices


@pytest.mark.parametrize("how", VISIT_ORDERS)
def test_visit_order_is_a_deterministic_permutation_of_the_rows_with_an_edge(how):
    indptr, indices = _bucket()
    rank = np.random.default_rng(3).permutation(60)
    order = visit_order(indptr, indices, how, rank)
    assert order.dtype == np.int32
    live = np.flatnonzero(np.diff(indptr) > 0)
    assert sorted(order.tolist()) == live.tolist()
    np.testing.assert_array_equal(order, visit_order(indptr, indices, how, rank))
    key = {"identity": order, "pre_balance": rank[order],
           "first_neighbour": indices[indptr[order]]}[how]
    assert (np.diff(key) >= 0).all()
    # ties broken by row
    tied = np.diff(key) == 0
    assert (np.diff(order)[tied] > 0).all()
    # an empty bucket has an empty order
    empty = np.zeros(5, np.int64)
    assert visit_order(empty, np.zeros(0, np.int32), how, rank[:4]).shape == (0,)


def test_pre_balance_order_without_a_relabeling_is_the_identity():
    indptr, indices = _bucket(1)
    np.testing.assert_array_equal(
        visit_order(indptr, indices, "pre_balance"),
        visit_order(indptr, indices, "identity"))
    with pytest.raises(ValueError):
        visit_order(indptr, indices, "random")


@pytest.mark.parametrize("balance", [False, True])
def test_ring_model_buckets_carry_their_visit_orders(balance):
    g = _hub_graph(n=240, degrees=(100, 60))
    dp = 3
    cfg = BigClamConfig(num_communities=5, dtype="float64")
    m = RingBigClamModel(g, cfg, make_mesh((dp, 1), [CPU] * dp), balance=balance)
    assert m.visit_order == VISIT_ORDER
    rows = m.n_pad // dp
    rank = None
    if balance:
        rank = np.arange(m.n_pad)
        rank[m._perm] = np.arange(g.num_nodes)
    for how in VISIT_ORDERS:
        m.set_visit_order(how)
        for i in range(dp):
            for r in range(dp):
                b = m.buckets[i][r]
                want = visit_order(
                    b.indptr.numpy(), b.indices.numpy(), how,
                    None if rank is None else rank[i * rows : (i + 1) * rows])
                assert b.order.dtype == torch.int32
                np.testing.assert_array_equal(b.order.numpy(), want)


def test_ring_trajectory_does_not_depend_on_the_visit_order():
    g = _hub_graph(n=240, degrees=(100, 60))
    cfg = BigClamConfig(num_communities=6, max_iters=3, conv_tol=0.0,
                        use_pallas_csr=True)
    F0 = np.random.default_rng(2).uniform(0.0, 1.0, (g.num_nodes, 6))
    m = RingBigClamModel(g, cfg, make_mesh((3, 1), [CPU] * 3), balance=True)
    assert m.engaged_path == "csr_ring_fused"
    fits = []
    for how in VISIT_ORDERS:
        m.set_visit_order(how)
        fits.append(m.fit(F0))
    for f in fits[1:]:
        assert f.llh_history == fits[0].llh_history
        np.testing.assert_array_equal(f.F, fits[0].F)


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [37, 1000])
def test_cuda_ring_grad_phase_is_the_same_under_every_visit_order(k, cuda_device):
    g = _hub_graph()
    cfg = BigClamConfig(num_communities=k)
    dp = 3
    m = RingBigClamModel(g, cfg, make_mesh((dp, 1), [cuda_device] * dp), balance=True)
    rows = m.n_pad // dp
    rng = np.random.default_rng(k)
    F = torch.as_tensor(rng.uniform(0.0, 1.0, (m.n_pad, k)), dtype=torch.float32)
    shards = [F[i * rows : (i + 1) * rows].contiguous().to(cuda_device) for i in range(dp)]

    def sweep(plain=False, order=True):
        gn = [torch.zeros_like(f) for f in shards]
        ln = [f.new_zeros(rows) for f in shards]
        for r in range(dp):
            for i in range(dp):
                b = m.buckets[i][r] if order else m.buckets[i][r]._replace(order=None)
                fn = rk.ring_grad_phase_plain if plain else rk.ring_grad_phase
                fn(shards[i], shards[(i + r) % dp], b, gn[i], ln[i], cfg)
        torch.cuda.synchronize()
        return gn + ln

    base = sweep(order=False)
    want = sweep(plain=True)
    for got, w in zip(base, want):
        np.testing.assert_allclose(got.cpu().numpy(), w.cpu().numpy(), rtol=3e-5, atol=3e-5)
    for how in VISIT_ORDERS:
        m.set_visit_order(how)
        assert all(torch.equal(a, b) for a, b in zip(sweep(), base)), how
