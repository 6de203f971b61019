"""The port's sparse top-M representation against the JAX package's.

* Host code (`pick_block_b`, `from_dense`, `to_dense`,
  `support_blocks_host`) is bit-identical.
* The plain member lookup equals the JAX `member_lookup` and the
  interpret-mode Pallas `member_lookup_pallas` exactly (the function is
  exact: a hit copies the stored weight, a miss gives 0).
* The sparse sweeps, the Armijo update and the support update match the
  JAX ones in float64 (rtol 1e-12; support ids and weights equal).
* Six-step trajectories of `SparseBigClamModel` match the JAX model in
  float64 (LLH rtol 1e-10, ids equal) on both merge paths, and in float32
  at LLH rtol 1e-5; at M >= K the sparse trajectory equals the port's
  dense `xla` one (rtol 1e-11, as tests/test_sparse.py holds the JAX pair).
* `cli fit --representation sparse --device cpu` and its refusals.
* `sparse_candidates` runs its plain body on CPU tensors and on the
  `sparse_xla` path; the candidate-sweep wrapper's launch arguments, its
  launch counter and its span-table counter (checked on the CPU with the
  launch stubbed).
* On a card only: the CUDA member-lookup kernel equals its plain version
  bit for bit; the candidate-sweep kernel equals the plain sweep in the
  float32 band.
"""

import contextlib
import ctypes
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigclam_tpu.config import BigClamConfig as JaxConfig
from bigclam_tpu.graph.ingest import graph_from_edges as jax_graph_from_edges
from bigclam_tpu.models.agm import sample_planted_graph
from bigclam_tpu.models.sparse import SparseBigClamModel as JaxSparseModel
from bigclam_tpu.ops import sparse_members as jsm

from bigclam_tpu_torch import cli
from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.models.bigclam import BigClamModel
from bigclam_tpu_torch.obs import trace
from bigclam_tpu_torch.ops import build
from bigclam_tpu_torch.models.sparse import (
    SparseBigClamModel,
    effective_m,
    state_from_jax_sparse_arrays,
)
from bigclam_tpu_torch.ops import sparse_members as sm
from bigclam_tpu_torch.ops.objective import EdgeChunks
from bigclam_tpu_torch.utils.device import DeviceUnavailableError

torch.set_num_threads(2)


def _random_graph(seed, n=57, p=0.12, isolated=()):
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < p
    edges = [(i, j) for i in range(n) for j in range(i + 1, n) if a[i, j]]
    edges.append((0, n - 1))
    edges = [e for e in edges if e[0] not in isolated and e[1] not in isolated]
    return jax_graph_from_edges(edges, num_nodes=n)


def _port_graph(g):
    return Graph(indptr=g.indptr, indices=g.indices, raw_ids=g.raw_ids)


def _jcfg(k, m, **kw):
    base = dict(
        num_communities=k, representation="sparse", sparse_m=m,
        dtype="float64", max_iters=6, conv_tol=0.0, edge_chunk=64,
        use_pallas=False, use_pallas_csr=False, sparse_pallas_merge=False,
    )
    base.update(kw)
    return JaxConfig(**base)


def _models(g, jcfg):
    jm = JaxSparseModel(g, jcfg)
    pm = SparseBigClamModel(
        _port_graph(g), BigClamConfig(**dataclasses.asdict(jcfg)), device="cpu"
    )
    return jm, pm


def _member_rows(rng, e, m, k, fill=0.6):
    """Sorted unique member-id rows with sentinel (k) padding and weights
    (tests/test_fused.py's generator)."""
    ids = np.full((e, m), k, np.int32)
    w = np.zeros((e, m), np.float32)
    for r in range(e):
        cnt = int(rng.integers(0, m + 1) * fill) if fill < 1 else m
        pick = np.sort(rng.choice(k, size=min(cnt, k), replace=False))
        ids[r, : pick.size] = pick
        w[r, : pick.size] = rng.random(pick.size).astype(np.float32)
    return ids, w


@pytest.fixture(scope="module")
def planted():
    """tests/test_sparse.py's planted AGM blocks (N=1,024, K=256) with a
    community-localized init."""
    g, truth = sample_planted_graph(
        1024, 256, p_in=0.6, rng=np.random.default_rng(11)
    )
    F0 = np.zeros((g.num_nodes, 256))
    for c, nodes in enumerate(truth):
        F0[nodes, c] = 1.0
    return g, F0


# --- host code -------------------------------------------------------------


@pytest.mark.parametrize(
    "args",
    [(1 << 22, 300_000, 64, 28.4), (1 << 22, 57, 6, 3.1), (1000, 13, 9, 0.0),
     (1 << 10, 5000, 300, 2.5), (1 << 22, 3, 1, 0.0)],
)
def test_pick_block_b_is_bit_identical(args):
    assert sm.pick_block_b(*args) == jsm.pick_block_b(*args)


@pytest.mark.parametrize("m,k,n_pad", [(9, 9, 16), (3, 9, 13), (1, 5, 13), (9, 9, 13)])
def test_from_dense_and_to_dense_are_bit_identical(m, k, n_pad):
    rng = np.random.default_rng(m + k)
    F = rng.uniform(0.0, 1.0, size=(13, k))
    F[F < 0.4] = 0.0
    F[4] = 0.0                                  # an all-sentinel row
    F[6, :3] = 0.5                              # ties go to the lower id
    got, want = sm.from_dense(F, m, k, n_pad), jsm.from_dense(F, m, k, n_pad)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert got[2] == want[2]
    ids, w, _ = got
    np.testing.assert_array_equal(sm.to_dense(ids, w, 13, k), jsm.to_dense(ids, w, 13, k))


@pytest.mark.parametrize("block_b", [8, 16, 64])
def test_support_blocks_host_is_bit_identical(block_b):
    g = _random_graph(3, isolated=(5,))
    n_pad = -(-g.num_nodes // block_b) * block_b
    for a, b in zip(sm.support_blocks_host(_port_graph(g), n_pad, block_b),
                    jsm.support_blocks_host(g, n_pad, block_b)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


# --- member lookup ---------------------------------------------------------


@pytest.mark.parametrize(
    "e,m,k,fill", [(53, 8, 20, 0.6), (300, 5, 37, 0.6), (257, 1, 7, 1.0),
                   (40, 64, 100, 0.6), (9, 4, 7, 0.0)],
)
def test_plain_member_lookup_equals_jax_and_pallas_interpret(e, m, k, fill):
    """E not a multiple of the Pallas kernel's 256-row block, M = 1, and
    (fill 0) all-sentinel rows on both sides: the sentinel == sentinel
    collision must not count as a hit."""
    rng = np.random.default_rng(e + m)
    iv, wv = _member_rows(rng, e, m, k, fill)
    iu, _ = _member_rows(rng, e, m, k, fill)
    iv[0], wv[0] = k, 0.0                       # an all-sentinel neighbour row
    got = sm.member_lookup(torch.as_tensor(iv), torch.as_tensor(wv),
                           torch.as_tensor(iu), k).numpy()
    ref = jsm.member_lookup(jnp.asarray(iv), jnp.asarray(wv), jnp.asarray(iu), k)
    pal = jsm.member_lookup_pallas(jnp.asarray(iv), jnp.asarray(wv),
                                   jnp.asarray(iu), k, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(got, np.asarray(pal))
    assert (got[iu >= k] == 0).all()


def test_rows_form_equals_the_gathered_jax_lookup():
    """member_lookup_rows reads (ids, w) at src/dst: exactly
    member_lookup(ids[dst], w[dst], ids[src]) of the JAX package."""
    rng = np.random.default_rng(7)
    n, m, k, e = 40, 6, 15, 333
    ids, w = _member_rows(rng, n, m, k)
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    sm.reset_launch_counts()
    got = sm.member_lookup_rows(torch.as_tensor(ids), torch.as_tensor(w),
                                torch.as_tensor(src), torch.as_tensor(dst), k)
    ref = jsm.member_lookup(jnp.asarray(ids[dst]), jnp.asarray(w[dst]),
                            jnp.asarray(ids[src]), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert sm.member_lookup_rows.launches == 0          # the CPU runs plain


def test_merge_dispatch_and_member_limit():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    cfg = BigClamConfig(representation="sparse")
    assert not sm.merge_kernel_want(cfg, cpu) and sm.merge_kernel_want(cfg, cuda)
    assert sm.merge_kernel_want(cfg.replace(sparse_pallas_merge=True), cpu)
    assert not sm.merge_kernel_want(cfg.replace(sparse_pallas_merge=False), cuda)
    sm.check_member_limit(1)
    sm.check_member_limit(sm.MAX_M)
    for m in (0, sm.MAX_M + 1):
        with pytest.raises(sm.MemberLimitError, match="--sparse-m"):
            sm.check_member_limit(m)


def _sweep_inputs(rng, n, m, k, device="cpu", offset=0):
    """Member rows of k ids on `device` (off 16 bytes with offset > 0), a
    gradient of both signs (some steps clip to 0), 0 in sentinel slots."""
    ids, w, k = _member_state(rng, n, m, device, k, offset)
    grad = torch.as_tensor(rng.normal(0.0, 0.5, (n, m)), dtype=torch.float32)
    grad = torch.where(ids.cpu() < k, grad, torch.zeros(()))
    return ids, w, grad.to(device), k


@pytest.mark.parametrize("merge", [None, True, False])
def test_candidates_run_the_plain_body_on_cpu(merge, monkeypatch):
    """On CPU tensors sparse_candidates never reaches the kernel wrapper,
    whichever the merge switch: the same bits on every setting, equal to
    the JAX sweep, and no candidate-sweep launch counted."""
    def refuse(*a, **k):
        raise AssertionError("the kernel wrapper ran on CPU tensors")

    g = _random_graph(0)
    F0 = np.random.default_rng(1).uniform(0.0, 1.0, (g.num_nodes, 6))
    jm, pm, sj, sp = _state_pair(g, _jcfg(6, 4), F0)
    cfg = pm.cfg.replace(sparse_pallas_merge=merge)
    sumF = sm.sparse_sumF(sp.ids, sp.F, 6)
    grad, _ = sm.sparse_grad_llh(sp.ids, sp.F, sumF, pm.edges, cfg, 6)
    monkeypatch.setattr(sm, "sparse_candidates_kernel", refuse)
    sm.reset_launch_counts()
    got = sm.sparse_candidates(sp.ids, sp.F, grad, pm.edges, cfg, 6)
    assert sm.launch_counts()["cand_sweep"] == 0
    plain = sm.sparse_candidates(sp.ids, sp.F, grad, pm.edges,
                                 pm.cfg.replace(sparse_pallas_merge=False), 6)
    assert torch.equal(got, plain)
    sumF_j = jsm.sparse_sumF(sj.ids, sj.F, 6)
    grad_j, _ = jsm.sparse_grad_llh(sj.ids, sj.F, sumF_j, jm._edges, jm.cfg, 6)
    want = jsm.sparse_candidates(sj.ids, sj.F, grad_j, jm._edges, jm.cfg, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


def _stub_launches(monkeypatch):
    """Record each launch as (entry, arguments, the step sizes read from
    the host array the call points at)."""
    calls = []

    def launch(dev, entry, *a):
        etas = (ctypes.c_float * a[12]).from_address(a[11])
        calls.append((entry, a, np.array(etas, np.float32)))

    monkeypatch.setattr(build, "launch", launch)
    return calls


@pytest.mark.parametrize("steps,sharded", [(15, False), (20, False), (15, True)])
def test_cand_sweep_launch_arguments(steps, sharded, monkeypatch):
    """The wrapper's launches, with the launch stubbed on the CPU: one per
    16 step candidates (21 candidates: 16, then 5 into the rows after),
    each with the C entry's argument count, the source rows and the
    destination rows (the gathered ones on the sharded form), every edge,
    the float32 clip bounds and step sizes, and the (S, N) zeros."""
    rng = np.random.default_rng(steps)
    ids, w, grad, k = _sweep_inputs(rng, 40, 6, 20)
    ids_d, w_d = (ids.clone(), w.clone()) if sharded else (None, None)
    src, dst = (torch.as_tensor(x) for x in _csr_order_edges(rng, 40, 30, 8))
    cfg = BigClamConfig(num_communities=k, representation="sparse", sparse_m=6,
                        max_backtracks=steps, max_p=0.999, min_p=0.01)
    calls = _stub_launches(monkeypatch)
    sm.reset_launch_counts()
    out = sm.sparse_candidates_kernel(ids, w, grad, EdgeChunks(src, dst, 50), cfg,
                                      k, ids_d, w_d)
    s = len(cfg.step_candidates)
    assert out.shape == (s, 40) and out.dtype == torch.float32
    assert not out.any()
    groups = [(0, 16), (16, s - 16)] if s > 16 else [(0, s)]
    assert sm.launch_counts() == {"member_lookup": 0, "cand_sweep": len(groups)}
    assert len(calls) == len(groups)
    etas = np.asarray(cfg.step_candidates, np.float32)
    rows = (ids_d, w_d) if sharded else (ids, w)
    for (entry, a, got), (s0, ns) in zip(calls, groups):
        assert entry == "bigclam_cand_sweep"
        assert len(a) + 1 == len(build.ENTRIES[entry])     # + the stream
        assert a[:7] == (ids.data_ptr(), w.data_ptr(), grad.data_ptr(),
                         rows[0].data_ptr(), rows[1].data_ptr(),
                         src.data_ptr(), dst.data_ptr())
        assert a[7:11] == (src.numel(), 40, 6, k)
        np.testing.assert_array_equal(got, etas[s0 : s0 + ns])
        assert a[13:17] == (float(np.float32(1 - 0.999)), float(np.float32(1 - 0.01)),
                            0.0, 1000.0)
        assert a[17:] == (0, out[s0].data_ptr())


def test_cand_sweep_counts_edges_only_while_spans_record(monkeypatch):
    """`cand_sweep/edges` adds each launch's edges to the span table inside
    a recording scope, and nothing outside one."""
    rng = np.random.default_rng(3)
    ids, w, grad, k = _sweep_inputs(rng, 30, 4, 12)
    src, dst = (torch.as_tensor(x) for x in _csr_order_edges(rng, 30, 20, 6))
    edges = EdgeChunks(src, dst, 16)
    cfg = BigClamConfig(num_communities=k, representation="sparse", sparse_m=4)
    _stub_launches(monkeypatch)
    trace.reset()
    try:
        sm.sparse_candidates_kernel(ids, w, grad, edges, cfg, k)
        assert "cand_sweep/edges" not in trace.totals()["counters"]
        with trace.recording():
            sm.sparse_candidates_kernel(ids, w, grad, edges, cfg, k)
            sm.sparse_candidates_kernel(ids, w, grad, edges, cfg, k)
        sm.sparse_candidates_kernel(ids, w, grad, edges, cfg, k)
        assert trace.totals()["counters"]["cand_sweep/edges"] == 2 * src.numel()
    finally:
        trace.reset()


def test_cand_sweep_wrapper_refusals(monkeypatch):
    """What the kernel does not take raises before a launch: more than
    MAX_M slots, float64 state or gradient, a float16 accumulation,
    destination rows of another width."""
    calls = _stub_launches(monkeypatch)
    e = torch.zeros(3, dtype=torch.int64)
    edges = EdgeChunks(e, e, 4)
    cfg = BigClamConfig(num_communities=3, representation="sparse", sparse_m=4)
    ids = torch.full((4, 4), 3, dtype=torch.int32)
    w = torch.zeros((4, 4))
    wide = torch.full((4, sm.MAX_M + 1), 3, dtype=torch.int32)
    with pytest.raises(sm.MemberLimitError):
        sm.sparse_candidates_kernel(wide, wide.float(), wide.float(), edges, cfg, 3)
    with pytest.raises(TypeError, match="float32"):
        sm.sparse_candidates_kernel(ids, w.double(), w, edges, cfg, 3)
    with pytest.raises(TypeError, match="grad"):
        sm.sparse_candidates_kernel(ids, w, w.double(), edges, cfg, 3)
    with pytest.raises(TypeError, match="accumulates"):
        sm.sparse_candidates_kernel(ids, w, w, edges, cfg.replace(accum_dtype="float16"), 3)
    with pytest.raises(ValueError, match="slots"):
        sm.sparse_candidates_kernel(ids, w, w, edges, cfg, 3, ids[:, :2].contiguous(),
                                    w[:, :2].contiguous())
    assert calls == []


# --- sweeps, Armijo and support update -------------------------------------


def _state_pair(g, jcfg, F0):
    jm, pm = _models(g, jcfg)
    sj, sp = jm.init_state(F0), pm.init_state(F0)
    np.testing.assert_array_equal(sp.ids.numpy(), np.asarray(sj.ids))
    np.testing.assert_array_equal(sp.F.numpy(), np.asarray(sj.F))
    return jm, pm, sj, sp


@pytest.mark.parametrize("k,m", [(6, 6), (8, 3)])
def test_sweeps_and_armijo_match_jax_in_float64(k, m):
    g = _random_graph(0)
    F0 = np.random.default_rng(1).uniform(0.0, 1.0, (g.num_nodes, k))
    jm, pm, sj, sp = _state_pair(g, _jcfg(k, m), F0)
    jcfg, cfg = jm.cfg, pm.cfg
    ids_j, w_j, ids_p, w_p = sj.ids, sj.F, sp.ids, sp.F
    close = lambda a, b: np.testing.assert_allclose(  # noqa: E731
        a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
    sumF_p, sumF_j = sm.sparse_sumF(ids_p, w_p, k), jsm.sparse_sumF(ids_j, w_j, k)
    close(sumF_p, sumF_j)
    grad_p, llh_p = sm.sparse_grad_llh(ids_p, w_p, sumF_p, pm.edges, cfg, k)
    grad_j, llh_j = jsm.sparse_grad_llh(ids_j, w_j, sumF_j, jm._edges, jcfg, k)
    close(grad_p, grad_j)
    close(llh_p, llh_j)
    cand_p = sm.sparse_candidates(ids_p, w_p, grad_p, pm.edges, cfg, k)
    cand_j = jsm.sparse_candidates(ids_j, w_j, grad_j, jm._edges, jcfg, k)
    close(cand_p, cand_j)
    wn_p, hist_p = sm.sparse_armijo_update(ids_p, w_p, sumF_p, grad_p, llh_p, cand_p, cfg, k)
    wn_j, hist_j = jsm.sparse_armijo_update(ids_j, w_j, sumF_j, grad_j, llh_j, cand_j, jcfg, k)
    close(wn_p, wn_j)
    np.testing.assert_array_equal(hist_p.numpy(), np.asarray(hist_j))


def _support_pair(g, F, m, k, n_pad, block_b):
    ids, w, _ = sm.from_dense(F, m, k, n_pad)
    got = sm.support_update(
        torch.as_tensor(ids), torch.as_tensor(w),
        sm.build_support_blocks(_port_graph(g), n_pad, block_b, torch.float64),
        m, k,
    )
    want = jsm.support_update(
        jnp.asarray(ids), jnp.asarray(w),
        jsm.build_support_blocks(g, n_pad, block_b, np.float64), m, k,
    )
    return [t.numpy() for t in got], [np.asarray(t) for t in want]


def test_support_update_star_matches_jax(toy_graphs):
    """tests/test_sparse.py's star: the hub admits its neighbour's
    community at weight 0, the neighbour keeps its weight exactly."""
    g = toy_graphs["star"]
    F = np.zeros((g.num_nodes, 6))
    F[1, 2] = 0.7
    (ids, w), (ids_j, w_j) = _support_pair(g, F, 4, 6, 8, 8)
    np.testing.assert_array_equal(ids, ids_j)
    np.testing.assert_array_equal(w, w_j)
    assert 2 in ids[0] and w[0][ids[0] == 2] == 0.0
    assert w[1][ids[1] == 2] == 0.7 and 2 not in ids[3]


@pytest.mark.parametrize(
    "m,block_b,batch",
    [(3, 8, sm.SUPPORT_BATCH_ENTRIES), (3, 16, 1), (8, 64, sm.SUPPORT_BATCH_ENTRIES),
     (2, 8, 500)],
)
def test_support_update_matches_jax_truncating_and_batched(m, block_b, batch, monkeypatch):
    """M < K truncation (ties to the lower id; integer ranks make many),
    and the node blocks batched together or one at a time."""
    g = _random_graph(5, isolated=(9,))
    k = 8
    rng = np.random.default_rng(m)
    F = np.where(rng.random((g.num_nodes, k)) < 0.5, 1.0, 0.0)
    F[3] = rng.uniform(0.0, 1.0, k)
    n_pad = -(-g.num_nodes // block_b) * block_b
    ids, w, _ = sm.from_dense(F, m, k, n_pad)
    blocks = sm.build_support_blocks(_port_graph(g), n_pad, block_b, torch.float64)
    monkeypatch.setattr(sm, "SUPPORT_BATCH_ENTRIES", batch)
    got = sm.support_update(torch.as_tensor(ids), torch.as_tensor(w), blocks, m, k)
    want = jsm.support_update(jnp.asarray(ids), jnp.asarray(w),
                              jsm.build_support_blocks(g, n_pad, block_b, np.float64), m, k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_support_update_keeps_a_nan_weight_as_jax_does():
    """A NaN weight ranks +inf and keeps its slot (it must reach the LLH,
    not be dropped by the top-M cut)."""
    g = _random_graph(6)
    k, m = 7, 2
    F = np.random.default_rng(2).uniform(0.0, 1.0, (g.num_nodes, k))
    ids, w, _ = sm.from_dense(F, m, k, 64)
    w[5, 1] = np.nan
    blocks_p = sm.build_support_blocks(_port_graph(g), 64, 8, torch.float64)
    got = sm.support_update(torch.as_tensor(ids), torch.as_tensor(w), blocks_p, m, k)
    want = jsm.support_update(jnp.asarray(ids), jnp.asarray(w),
                              jsm.build_support_blocks(g, 64, 8, np.float64), m, k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert int(ids[5, 1]) in got[0][5].tolist() and torch.isnan(got[1][5]).any()


# --- trajectories ----------------------------------------------------------


def _trajectory(jm, pm, F0, steps=6, rtol=1e-10, ids_equal=True):
    sj, sp = jm.init_state(F0), pm.init_state(F0)
    for _ in range(steps):
        sj, sp = jm._step(sj), pm._step(sp)
        np.testing.assert_allclose(float(sp.llh), float(sj.llh), rtol=rtol)
        if ids_equal:
            np.testing.assert_array_equal(sp.ids.numpy(), np.asarray(sj.ids))
    assert sp.it == int(sj.it) == steps
    return sj, sp


@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("k,m", [(6, 6), (6, 9), (8, 3)])
def test_six_f64_steps_match_jax(k, m, merge):
    """Both merge paths: sparse_xla, and the kernel's plain version against
    the interpret-mode Pallas merge (sparse_merge_pallas)."""
    g = _random_graph(0)
    F0 = np.random.default_rng(1).uniform(0.0, 1.0, (g.num_nodes, k))
    jm, pm = _models(g, _jcfg(k, m, sparse_pallas_merge=merge, pallas_interpret=merge))
    path = "sparse_merge_pallas" if merge else "sparse_xla"
    assert jm.engaged_path == pm.engaged_path == path
    assert pm.m == jm.m == min(m, k) and pm.n_pad == jm.n_pad
    sj, sp = _trajectory(jm, pm, F0)
    np.testing.assert_allclose(sp.F.numpy(), np.asarray(sj.F), rtol=1e-10, atol=1e-12)


def test_six_f64_steps_match_jax_on_planted_truncating(planted):
    g, F0 = planted
    jm, pm = _models(g, _jcfg(256, 8, edge_chunk=1 << 20))
    _trajectory(jm, pm, F0)


def test_six_f32_steps_match_jax(planted):
    g, F0 = planted
    jm, pm = _models(g, _jcfg(256, 8, dtype="float32", edge_chunk=1 << 20))
    _trajectory(jm, pm, F0, rtol=1e-5, ids_equal=False)


def test_m_ge_k_trajectory_matches_the_port_dense_path(toy_graphs):
    """The twin of tests/test_sparse.py::test_m_ge_k_trajectory_matches_dense
    on the port: at M >= K with a support update every step the sparse
    trajectory is the dense `xla` one."""
    g = _port_graph(toy_graphs["two_cliques"])
    F0 = np.random.default_rng(5).uniform(0.1, 1.0, size=(g.num_nodes, 4))
    base = dict(num_communities=4, dtype="float64", max_iters=8, conv_tol=0.0)
    dm = BigClamModel(g, BigClamConfig(**base), device="cpu")
    sp = SparseBigClamModel(
        g, BigClamConfig(representation="sparse", sparse_m=4, **base), device="cpu"
    )
    assert dm.engaged_path == "xla"
    ds, ss = dm.init_state(F0), sp.init_state(F0)
    for _ in range(8):
        ds, ss = dm._step(ds), sp._step(ss)
        np.testing.assert_allclose(float(ss.llh), float(ds.llh), rtol=1e-11)
    np.testing.assert_allclose(sp.extract_F(ss), dm.extract_F(ds), rtol=1e-10, atol=1e-12)
    rd = dm.fit(F0)
    rs = sp.fit(F0)
    assert rs.num_iters == rd.num_iters
    np.testing.assert_allclose(rs.llh_history, rd.llh_history, rtol=1e-11)


def test_fit_state_and_state_bytes():
    g = _random_graph(1)
    jm, pm = _models(g, _jcfg(10, 4))
    F0 = np.random.default_rng(2).uniform(0.0, 1.0, (g.num_nodes, 10))
    st, llh, iters, hist = pm.fit_state(pm.init_state(F0))
    assert iters == 6 and len(hist) == 7 and llh == hist[-1]
    assert pm.state_nbytes(st) == pm.state_nbytes() == jm.state_nbytes()
    assert pm.state_nbytes() == pm.n_pad * 4 * (8 + 4) + 10 * 8


def test_state_from_jax_round_trip():
    """Two JAX steps, the state carried across (rows past N stripped and
    re-padded), then one more step in each package."""
    g = _random_graph(4)
    k, m = 8, 3
    F0 = np.random.default_rng(7).uniform(0.0, 1.0, (g.num_nodes, k))
    jm, pm = _models(g, _jcfg(k, m))
    sj = jm._step(jm._step(jm.init_state(F0)))
    sp = pm.state_from_jax(np.asarray(sj.ids), np.asarray(sj.F),
                           llh=float(sj.llh), it=int(sj.it))
    assert tuple(sp.F.shape) == (pm.n_pad, m) and sp.it == 2
    assert (sp.ids[g.num_nodes:] == k).all() and (sp.F[g.num_nodes:] == 0).all()
    np.testing.assert_array_equal(sp.ids.numpy(), np.asarray(sj.ids))
    np.testing.assert_allclose(sp.sumF.numpy(), np.asarray(sj.sumF), rtol=1e-12)
    sj2, sp2 = jm._step(sj), pm._step(sp)
    np.testing.assert_allclose(float(sp2.llh), float(sj2.llh), rtol=1e-10)
    np.testing.assert_array_equal(sp2.ids.numpy(), np.asarray(sj2.ids))
    n = g.num_nodes
    bare = state_from_jax_sparse_arrays(
        np.asarray(sj.ids), np.asarray(sj.F), n, m, k, torch.float64,
        torch.device("cpu"),
    )
    assert tuple(bare.ids.shape) == (n, m)
    assert torch.equal(bare.F, sp.F[:n]) and torch.equal(bare.ids, sp.ids[:n])


def test_model_checks(toy_graphs):
    g = _port_graph(toy_graphs["two_cliques"])
    cfg = BigClamConfig(num_communities=4, representation="sparse", sparse_m=64)
    assert effective_m(cfg) == 4
    assert effective_m(cfg.replace(num_communities=100)) == 64
    m = SparseBigClamModel(g, cfg, device="cpu")
    assert m.engaged_path == "sparse_xla" and m.path_reason == "representation=sparse M=4"
    m = SparseBigClamModel(g, cfg.replace(sparse_pallas_merge=True), device="cpu")
    assert m.engaged_path == "sparse_merge_pallas"
    with pytest.raises(ValueError, match="min_f"):
        SparseBigClamModel(g, cfg.replace(min_f=0.1), device="cpu")
    with pytest.raises(ValueError, match="representation"):
        SparseBigClamModel(g, cfg.replace(representation="dense"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailableError):
            SparseBigClamModel(g, cfg)


# --- cli -------------------------------------------------------------------


def _edge_file(tmp_path):
    rng = np.random.default_rng(0)
    edges = set()
    while len(edges) < 200:
        u, v = rng.integers(0, 64, 2)
        if u != v:
            edges.add((min(int(u), int(v)), max(int(u), int(v))))
    path = tmp_path / "g.txt"
    path.write_text("".join(f"{u}\t{v}\n" for u, v in sorted(edges)))
    return str(path)


def test_cli_sparse_fit_on_cpu_matches_jax_cli(tmp_path):
    from bigclam_tpu.cli import main as jax_main

    path = _edge_file(tmp_path)
    argv = ["fit", "--graph", path, "--k", "8", "--representation", "sparse",
            "--sparse-m", "4", "--max-iters", "4", "--init", "random",
            "--dtype", "float64"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv + ["--device", "cpu", "--out", str(tmp_path / "c.txt")]) == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["representation"] == "sparse" and out["sparse_m"] == 4
    assert out["kernel_path"] == "sparse_xla" and out["device_kind"] == "cpu"
    assert out["kernel_path_reason"] == "representation=sparse M=4"
    assert out["communities"] >= 1
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_main(argv + ["--quiet"]) == 0
    ref = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert ref["kernel_path"] == out["kernel_path"] and ref["sparse_m"] == 4
    assert out["iters"] == ref["iters"]
    np.testing.assert_allclose(out["llh"], ref["llh"], rtol=1e-10)


def test_cli_sparse_refuses_csr_kernels_on_and_needs_a_card(tmp_path):
    path = _edge_file(tmp_path)
    argv = ["fit", "--graph", path, "--k", "4", "--representation", "sparse",
            "--max-iters", "2", "--init", "random"]
    with pytest.raises(SystemExit, match="member-lookup kernel"):
        cli.main(argv + ["--csr-kernels", "on", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailableError):
            cli.main(argv)


# --- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 3, 5, 16, 17, 37, 64, 100, 1024])
def test_cuda_member_lookup_equals_plain(m, cuda_device):
    rng = np.random.default_rng(m)
    n, k, e = 300, max(2 * m, 8), 5_003
    ids, w = _member_rows(rng, n, m, k)
    ids, w = torch.as_tensor(ids, device=cuda_device), torch.as_tensor(w, device=cuda_device)
    src = torch.as_tensor(rng.integers(0, n, e), device=cuda_device)
    dst = torch.as_tensor(rng.integers(0, n, e), device=cuda_device)
    sm.reset_launch_counts()
    got = sm.member_lookup_rows(ids, w, src, dst, k)
    torch.cuda.synchronize()
    assert sm.launch_counts() == {"member_lookup": 1, "cand_sweep": 0}
    assert torch.equal(got, sm.member_lookup_rows_plain(ids, w, src, dst, k))


def _csr_order_edges(rng, n, hub_degree=200, max_degree=60):
    """Directed edges in CSR order (each source's edges in a row, its
    destinations sorted): node 0 a hub of `hub_degree` edges (a run across
    several 32-edge spans), the others up to max_degree - 1 edges, some
    none."""
    deg = rng.integers(0, max_degree, n)
    deg[0] = hub_degree
    dst = [np.sort(rng.choice(n, d, replace=False)) for d in deg]
    return np.repeat(np.arange(n), deg), np.concatenate(dst)


def _member_state(rng, n, m, device, k=None, offset=0):
    """Member rows of k ids (default 2m: about half of a row's slots hit
    in another) on `device`; with `offset` > 0 the rows start `offset`
    elements into their storage, so not on 16 bytes."""
    k = max(2 * m, 8) if k is None else k
    ids_np, w_np = _member_rows(rng, n, m, k)
    ids = torch.empty(n * m + offset, dtype=torch.int32, device=device)[offset:]
    w = torch.empty(n * m + offset, dtype=torch.float32, device=device)[offset:]
    ids, w = ids.view(n, m), w.view(n, m)
    ids.copy_(torch.as_tensor(ids_np))
    w.copy_(torch.as_tensor(w_np))
    return ids, w, k


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,offset", [
    (4, 8, 0), (37, 74, 0), (64, 128, 0), (128, 256, 0), (64, 1024, 0),
    (64, 1025, 0), (200, 400, 0), (37, 2000, 0), (64, 2000, 0), (64, 2000, 1),
    (1024, 2048, 0),
])
def test_cuda_member_lookup_on_csr_runs(m, k, offset, cuda_device):
    """The kernel on edges in CSR order, swept in chunks of 150 edges
    (runs of one source cut at chunk borders, the hub's among them, and
    spans cut short), equal to its plain version bit for bit: lane groups
    at M=4; the table up to k_pad 1,024 and M=128; above either the staged
    search, with 4-byte copies at M=37 and at M=64 on rows off 16 bytes,
    16-byte copies at M=64 and 200, and the shared-memory opt-in at
    M=1,024."""
    rng = np.random.default_rng(m + k + offset)
    n = 300
    ids, w, k = _member_state(rng, n, m, cuda_device, k, offset)
    assert (ids.data_ptr() % 16 == 0) == (offset == 0)
    src, dst = _csr_order_edges(rng, n)
    edges = EdgeChunks(torch.as_tensor(src, device=cuda_device),
                       torch.as_tensor(dst, device=cuda_device), 150)
    assert src.size % 150 and src[149] == src[150]   # the hub's run cut
    sm.reset_launch_counts()
    for s, d in edges.slices():
        got = sm.member_lookup_rows(ids, w, s, d, k)
        torch.cuda.synchronize()
        assert torch.equal(got, sm.member_lookup_rows_plain(ids, w, s, d, k))
    assert sm.launch_counts() == {"member_lookup": -(-src.size // 150),
                                  "cand_sweep": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(5, 10), (64, 128), (64, 2000)])
@pytest.mark.parametrize("e", [1, 31, 33, 129, 1000])
def test_cuda_member_lookup_edge_counts(e, m, k, cuda_device):
    """Edge batches of 1, 31, 33, 129 and 1,000 edges (a warp's 32-edge
    span and one either side, one past four spans, and a non-multiple of
    the span), starting inside a run of the CSR order, equal to the plain
    version bit for bit on each layout: lane groups, the table and the
    staged search."""
    rng = np.random.default_rng(e)
    n = 300
    ids, w, k = _member_state(rng, n, m, cuda_device, k)
    src, dst = _csr_order_edges(rng, n)
    s = torch.as_tensor(src, device=cuda_device)[5 : 5 + e]
    d = torch.as_tensor(dst, device=cuda_device)[5 : 5 + e]
    got = sm.member_lookup_rows(ids, w, s, d, k)
    torch.cuda.synchronize()
    assert got.shape == (e, m)
    assert torch.equal(got, sm.member_lookup_rows_plain(ids, w, s, d, k))


@pytest.mark.cuda
def test_cuda_sparse_passes_match_the_plain_merge(cuda_device):
    """The grad/LLH and candidate passes on the kernel path against the
    plain merge path on the card: equal lookups, sums in another atomic
    order, so held to the float32 band (rtol = atol = 3e-5)."""
    g = _port_graph(_random_graph(0))
    cfg = BigClamConfig(num_communities=8, representation="sparse", sparse_m=3)
    F0 = np.random.default_rng(1).uniform(0.0, 1.0, (g.num_nodes, 8))
    mk = SparseBigClamModel(g, cfg, device=cuda_device)
    plain = cfg.replace(sparse_pallas_merge=False)
    assert mk.engaged_path == "sparse_merge_pallas"
    st = mk.init_state(F0)
    sm.reset_launch_counts()
    out = {}
    for name, c in (("kernel", cfg), ("plain", plain)):
        grad, llh = sm.sparse_grad_llh(st.ids, st.F, st.sumF, mk.edges, c, 8)
        cand = sm.sparse_candidates(st.ids, st.F, grad, mk.edges, c, 8)
        out[name] = [t.cpu().numpy() for t in (grad, llh, cand)]
    torch.cuda.synchronize()
    chunks = -(-g.num_directed_edges // mk.edges.chunk)
    # the kernel path's grad pass looks up each chunk; its candidate pass
    # is one candidate-sweep launch
    assert sm.launch_counts() == {"member_lookup": chunks, "cand_sweep": 1}
    for a, b in zip(out["kernel"], out["plain"]):
        np.testing.assert_allclose(a, b, rtol=3e-5, atol=3e-5)


def _sweep_pair(ids, w, grad, edges, cfg, k, **dst):
    """The candidate sweep on the kernel path (one launch, counted) and on
    the plain path, synchronized."""
    sm.reset_launch_counts()
    got = sm.sparse_candidates(ids, w, grad, edges, cfg, k, **dst)
    torch.cuda.synchronize()
    launches = sm.launch_counts()["cand_sweep"]
    want = sm.sparse_candidates(ids, w, grad, edges,
                                cfg.replace(sparse_pallas_merge=False), k, **dst)
    assert sm.launch_counts()["cand_sweep"] == launches
    return got, want, launches


def _sweep_cfg(k, m, **kw):
    return BigClamConfig(num_communities=k, representation="sparse", sparse_m=m, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,offset", [
    (1, 8, 0), (5, 10, 0), (37, 74, 0), (37, 2000, 0), (64, 128, 0),
    (64, 1024, 0), (64, 1025, 0), (64, 8385, 0), (64, 2000, 1), (100, 2000, 0),
    (1024, 2048, 0),
])
def test_cuda_cand_sweep_equals_plain(m, k, offset, cuda_device):
    """The candidate-sweep kernel against the plain sweep on edges in CSR
    order (a hub of 200 edges that the plain path's 150-edge chunks cut,
    nodes without edges), in the float32 band of the plain merge test
    (rtol = atol = 3e-5: the same terms, the dots and the per-node sums in
    another order): one lane a slot (M <= 32), two (M = 64), four and 32,
    k_pad on both sides of 1,024, rows on and off 16 bytes; one launch."""
    rng = np.random.default_rng(m + k + offset)
    n = 300
    ids, w, grad, k = _sweep_inputs(rng, n, m, k, cuda_device, offset)
    src, dst = _csr_order_edges(rng, n)
    assert (np.bincount(src, minlength=n) == 0).any()
    edges = EdgeChunks(torch.as_tensor(src, device=cuda_device),
                       torch.as_tensor(dst, device=cuda_device), 150)
    assert src[149] == src[150]
    got, want, launches = _sweep_pair(ids, w, grad, edges, _sweep_cfg(k, m), k)
    assert launches == 1 and got.shape == (16, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=3e-5, atol=3e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(5, 10), (64, 2000)])
@pytest.mark.parametrize("e", [1, 31, 33, 129])
def test_cuda_cand_sweep_edge_counts(e, m, k, cuda_device):
    """1, 31, 33 and 129 edges (a warp's span and one either side, one past
    four spans), starting inside a run of the CSR order."""
    rng = np.random.default_rng(e + m)
    n = 300
    ids, w, grad, k = _sweep_inputs(rng, n, m, k, cuda_device)
    src, dst = _csr_order_edges(rng, n)
    edges = EdgeChunks(torch.as_tensor(src[5 : 5 + e], device=cuda_device),
                       torch.as_tensor(dst[5 : 5 + e], device=cuda_device), 64)
    got, want, launches = _sweep_pair(ids, w, grad, edges, _sweep_cfg(k, m), k)
    assert launches == 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=3e-5, atol=3e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [5, 64])
def test_cuda_cand_sweep_sharded_form(m, cuda_device):
    """The sharded trainer's form: a shard's own rows [r0, r1) as sources
    (local ids), the rows of every shard as destinations (ids_dst, w_dst,
    row0); against the plain sweep of the same form and against the
    one-device sweep's columns of those rows."""
    rng = np.random.default_rng(m)
    n, r0, r1 = 300, 100, 220
    ids, w, grad, k = _sweep_inputs(rng, n, m, None, cuda_device)
    src, dst = _csr_order_edges(rng, n)
    keep = (src >= r0) & (src < r1)
    dev = lambda x: torch.as_tensor(x, device=cuda_device)  # noqa: E731
    loc = EdgeChunks(dev(src[keep] - r0), dev(dst[keep]), 150)
    cfg = _sweep_cfg(k, m)
    shard = [t[r0:r1].contiguous() for t in (ids, w, grad)]
    got, want, launches = _sweep_pair(*shard, loc, cfg, k, ids_dst=ids, w_dst=w, row0=r0)
    assert launches == 1 and got.shape == (16, r1 - r0)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=3e-5, atol=3e-5)
    whole = sm.sparse_candidates(ids, w, grad, EdgeChunks(dev(src), dev(dst), 150), cfg, k)
    np.testing.assert_allclose(got.cpu().numpy(), whole[:, r0:r1].cpu().numpy(),
                               rtol=3e-5, atol=3e-5)


@pytest.mark.cuda
def test_cuda_cand_sweep_float64_sums_and_21_steps(cuda_device):
    """A float64 accumulation (float64 atomics) and 21 step candidates (two
    launches: 16 steps, then 5 into the rows after), against the plain
    sweep; while spans record, `cand_sweep/edges` counts every edge of
    each launch."""
    rng = np.random.default_rng(21)
    n = 300
    ids, w, grad, k = _sweep_inputs(rng, n, 64, 1100, cuda_device)
    src, dst = _csr_order_edges(rng, n)
    edges = EdgeChunks(torch.as_tensor(src, device=cuda_device),
                       torch.as_tensor(dst, device=cuda_device), 150)
    cfg = _sweep_cfg(k, 64, accum_dtype="float64", max_backtracks=20)
    trace.reset()
    try:
        with trace.recording():
            got, want, launches = _sweep_pair(ids, w, grad, edges, cfg, k)
        counted = trace.totals()["counters"]["cand_sweep/edges"]
    finally:
        trace.reset()
    assert launches == 2 and counted == 2 * src.size
    assert got.shape == (21, n) and got.dtype == torch.float64
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=3e-5, atol=3e-5)


@pytest.mark.cuda
def test_cuda_wrapper_raises_above_the_member_bound(cuda_device):
    ids = torch.full((4, sm.MAX_M + 1), 3, dtype=torch.int32, device=cuda_device)
    e = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    with pytest.raises(sm.MemberLimitError):
        sm.member_lookup_rows(ids, ids.float(), e, e, 3)
