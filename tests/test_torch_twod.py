"""The port's 2D edge-block partition (bigclam_tpu_torch/parallel/twod.py)
against the JAX package on the 8-device CPU fake.

The kernel paths `csr_fused_2d` and `csr_fused_2d_kb` on the kernels'
plain versions are held against JAX `TwoDShardedBigClamModel` under the
fused interpret-mode config of tests/test_fused2d.py, at (4, 1) and (2, 2),
closure and dense (F at rtol = atol = 3e-5, LLH at 1e-5: the tolerance of
tests/test_torch_kbmesh.py::test_kernel_paths_match_jax_interpret). At
C = 1 the 2D trainer is the port's 1D ShardedBigClamModel bit for bit, in
float32 and float64; the closure exchange gives the dense psum's bits, and
a cap of 1 falls back on every step with the same counters; the
store-native trainer is the in-memory one bit for bit, and a cache without
baked closure lists streams them and says so. The JAX `xla_2d` step fails
on this jax (a shard_map scan-carry TypeError at
bigclam_tpu/parallel/twod.py:641), so the port's `xla_2d` in float64 is
held against the spec interpreter and against the kernel path's plain
versions at rtol 1e-10. The copied layout helpers are pinned to their JAX
sources by AST, and the layouts to the JAX layouts by value.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax

from bigclam_tpu.config import BigClamConfig as JaxConfig
from bigclam_tpu.models.agm import sample_planted_graph as jax_planted
from bigclam_tpu.parallel import TwoDShardedBigClamModel as JaxTwoD
from bigclam_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from bigclam_tpu.parallel import twod as jtwod
from bigclam_tpu.spec import interpreter as spec

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.graph.store import compile_graph_cache
from bigclam_tpu_torch.parallel import (
    ShardedBigClamModel,
    StoreTwoDShardedBigClamModel,
    TwoDShardedBigClamModel,
    make_mesh,
    make_mesh_2d,
)
from bigclam_tpu_torch.parallel import twod as ptwod
from bigclam_tpu_torch.parallel.mesh import row_shards, state_blocks
from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL = ATOL = 3e-5
K = 8
CPU = torch.device("cpu")
# the JAX fused interpret config of tests/test_fused2d.py: n_pad 240 at
# p = 4 gives n_blk 60, which block_b 30 divides on both grids
JAX_FUSED = dict(use_pallas_csr=True, pallas_interpret=True,
                 csr_block_b=30, csr_tile_t=64)


@pytest.fixture(scope="module")
def planted():
    g, _ = jax_planted(240, 4, p_in=0.3, rng=np.random.default_rng(0))
    return g


def _port_graph(g):
    return Graph(g.indptr, g.indices, g.raw_ids)


def _F0(g, seed=1):
    # small weights: the planted cliques collapse no row in a few steps
    return np.random.default_rng(seed).uniform(0.0, 0.3, (g.num_nodes, K))


def _mesh(shape):
    return make_mesh_2d(shape, [CPU] * (shape[0] * shape[1]))


def _cfg(shape, **kw):
    return BigClamConfig(num_communities=K, partition="2d",
                         replica_cols=shape[1], **kw)


def _run(model, F0, steps):
    st = model.init_state(F0)
    llhs = []
    for _ in range(steps):
        st = model._step(st)
        llhs.append(float(st.llh))
    return llhs, model.extract_F(st), st


def _write_edges(g, path):
    src, dst = np.asarray(g.src), np.asarray(g.dst)
    with open(path, "w") as f:
        for s, d in zip(src.tolist(), dst.tolist()):
            if s < d:
                f.write(f"{s}\t{d}\n")


@pytest.fixture(scope="module")
def caches(planted, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("twod_caches")
    txt = str(tmp / "g.txt")
    _write_edges(planted, txt)
    return {
        "v3": compile_graph_cache(txt, str(tmp / "v3"), num_shards=4),
        "v2": compile_graph_cache(txt, str(tmp / "v2"), num_shards=4,
                                  closure_bake=False),
    }


# --------------------------------------------------- against JAX interpret
KERNEL_CASES = [
    # (mesh, csr_k_block, grad_exchange, engaged path)
    ((4, 1), 0, "closure", "csr_fused_2d"),
    ((4, 1), 4, "closure", "csr_fused_2d_kb"),
    ((2, 2), 0, "closure", "csr_fused_2d"),
    ((2, 2), 0, "dense", "csr_fused_2d"),
    ((2, 2), 4, "closure", "csr_fused_2d_kb"),
    ((2, 2), 4, "dense", "csr_fused_2d_kb"),
]


@pytest.mark.parametrize("shape,kb,gx,path", KERNEL_CASES)
def test_kernel_paths_match_jax_interpret(planted, shape, kb, gx, path):
    """The kernel paths on the kernels' plain versions (kernel A, #7-#12
    on the closure table) against the JAX fused 2D trainer in interpret
    mode, the same engaged path and grad exchange on both."""
    jm = JaxTwoD(planted, JaxConfig(
        num_communities=K, partition="2d", replica_cols=shape[1],
        grad_exchange=gx, csr_k_block=kb, **JAX_FUSED),
        jax_make_mesh_2d(shape, jax.devices()[:4]))
    pm = TwoDShardedBigClamModel(
        _port_graph(planted),
        _cfg(shape, grad_exchange=gx, use_pallas_csr=True, csr_k_block=kb),
        _mesh(shape))
    assert jm.engaged_path == pm.engaged_path == path
    assert jm.grad_exchange == pm.grad_exchange
    F0 = _F0(planted)
    jl, jF, _ = _run(jm, F0, 3)
    pl, pF, _ = _run(pm, F0, 3)
    np.testing.assert_allclose(pF, jF, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)


# ----------------------------------------------------- C = 1 against 1D
@pytest.mark.parametrize("dtype,kernels,kb,path", [
    ("float32", False, 0, "xla_2d"),
    ("float64", False, 0, "xla_2d"),
    ("float32", True, 0, "csr_fused_2d"),
    ("float32", True, 4, "csr_fused_2d_kb"),
])
def test_c1_bit_identical_to_1d(planted, dtype, kernels, kb, path):
    """At C = 1 each edge block is the 1D shard's CSR with its
    destinations renamed to closure positions in the same order: the fit
    is the 1D all-gather trainer's bit for bit."""
    g = _port_graph(planted)
    kw = dict(dtype=dtype, use_pallas_csr=kernels, csr_k_block=kb,
              max_iters=4, conv_tol=0.0)
    m1 = ShardedBigClamModel(g, BigClamConfig(num_communities=K, **kw),
                             make_mesh((4, 1), [CPU] * 4))
    m2 = TwoDShardedBigClamModel(g, _cfg((4, 1), **kw), _mesh((4, 1)))
    assert m2.engaged_path == path and m2.grad_exchange == "dense"
    r1, r2 = m1.fit(_F0(planted)), m2.fit(_F0(planted))
    assert r1.llh_history == r2.llh_history and r1.llh == r2.llh
    assert np.array_equal(r1.F, r2.F)


# ---------------------------------------------- the grad exchange, overflow
@pytest.mark.parametrize("kernels", [False, True], ids=["xla_2d", "csr_fused_2d"])
def test_closure_equals_dense_and_cap_falls_back(planted, kernels):
    """The touched-rows exchange gives the dense psum's bits; with
    closure_grad_cap = 1 below every pair size each step takes the dense
    psum (the counters say so) and the fit is the dense one bit for bit."""
    g = _port_graph(planted)
    kw = dict(use_pallas_csr=kernels, max_iters=4, conv_tol=0.0)
    fits = {}
    for name, extra in (("closure", {}), ("dense", {"grad_exchange": "dense"}),
                        ("cap1", {"closure_grad_cap": 1})):
        m = TwoDShardedBigClamModel(g, _cfg((2, 2), **kw, **extra), _mesh((2, 2)))
        st = m._step(m._step(m.init_state(_F0(planted))))
        ids, fell_back = m.last_comm(st)
        if name == "closure":
            assert m.grad_exchange == "closure"
            assert 0 < ids <= m._grad_cap and not fell_back
        elif name == "dense":
            assert (ids, fell_back) == (0, False) and st.comm_ids is None
        else:
            assert m._grad_cap == 1 < m._grad_pair_max
            assert fell_back and ids > m._grad_cap
        fits[name] = m.fit(_F0(planted))
    for name in ("closure", "cap1"):
        assert fits[name].llh_history == fits["dense"].llh_history
        assert np.array_equal(fits[name].F, fits["dense"].F)


def test_closure_grad_allreduce_is_the_psum(planted):
    """closure_grad_allreduce on random partials restricted to the baked
    touched rows: every row a position touched or owns carries the psum's
    bits; the sizes the counter reads are the baked ones."""
    from bigclam_tpu_torch.parallel.sharded import psum
    from bigclam_tpu_torch.parallel.sparse_collectives import (
        closure_grad_allreduce,
    )

    g = _port_graph(planted)
    m = TwoDShardedBigClamModel(g, _cfg((2, 2)), _mesh((2, 2)))
    n_row = m.C * (m.n_pad // m.p)
    rng = np.random.default_rng(5)
    tabs = m._grad_tabs
    for i in range(m.R):
        group = range(i * m.C, (i + 1) * m.C)
        parts = []
        for b in group:
            part = torch.zeros((n_row, m.k_pad), dtype=torch.float32)
            rows = torch.as_tensor(np.unique(m.block_csr[b].src.numpy()))
            part[rows] = torch.as_tensor(rng.standard_normal(
                (rows.shape[0], m.k_pad)), dtype=torch.float32)
            parts.append(part)
        out, cnt, fb = closure_grad_allreduce(
            parts, [tabs["out"][b] for b in group], [tabs["in"][b] for b in group],
            [tabs["count"][b] for b in group], tabs["cap"], [CPU] * m.C,
            "s", "c")
        want = psum(parts, [CPU] * m.C)[0]
        assert int(fb) == 0 and int(cnt) == m._grad_pair_max
        for j, b in enumerate(group):
            rows = torch.as_tensor(np.unique(m.block_csr[b].src.numpy()))
            assert torch.equal(out[j][rows], want[rows])
            own = slice(j * (n_row // m.C), (j + 1) * (n_row // m.C))
            assert torch.equal(out[j][own], want[own])


# -------------------------------------------------------------- the store
@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_store_native_matches_in_memory(planted, caches, shape):
    g = _port_graph(planted)
    cfg = _cfg(shape, use_pallas_csr=True, max_iters=3, conv_tol=0.0)
    m_mem = TwoDShardedBigClamModel(g, cfg, _mesh(shape))
    m_st = StoreTwoDShardedBigClamModel(caches["v3"], cfg, _mesh(shape))
    assert m_st.engaged_path == m_mem.engaged_path == "csr_fused_2d"
    assert "streamed" not in m_st.path_reason
    assert m_st._twod_cap == m_mem._twod_cap
    assert m_st._grad_pair_max == m_mem._grad_pair_max
    assert np.array_equal(m_st._shard_edge_counts(), m_mem._shard_edge_counts())
    r_mem, r_st = m_mem.fit(_F0(planted)), m_st.fit(_F0(planted))
    assert r_st.llh_history == r_mem.llh_history
    assert np.array_equal(r_st.F, r_mem.F)


def test_v2_cache_streams_closure_lists(planted, caches):
    g = _port_graph(planted)
    cfg = _cfg((2, 2), max_iters=3, conv_tol=0.0)
    assert not caches["v2"].manifest["closure"]["baked"]
    m = StoreTwoDShardedBigClamModel(caches["v2"], cfg, _mesh((2, 2)))
    assert "streamed from the cached CSR" in m.path_reason
    r = m.fit(_F0(planted))
    r_mem = TwoDShardedBigClamModel(g, cfg, _mesh((2, 2))).fit(_F0(planted))
    assert np.array_equal(r.F, r_mem.F)


def test_store_refuses_a_shard_grid_off_the_mesh(caches):
    with pytest.raises(ValueError, match="recompile with --shards 8"):
        StoreTwoDShardedBigClamModel(caches["v3"], _cfg((4, 2)),
                                     make_mesh_2d((4, 2), [CPU] * 8))


# ------------------------------------------------------- xla_2d in float64
@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_xla_2d_float64_matches_spec_and_kernel_plain(planted, shape):
    """The JAX xla_2d cannot serve (its scan carry fails on this jax): the
    port's float64 xla_2d against the spec interpreter's steps and against
    the kernel path's step (plain versions) on the same layout."""
    g = _port_graph(planted)
    m = TwoDShardedBigClamModel(g, _cfg(shape, dtype="float64"), _mesh(shape))
    assert m.engaged_path == "xla_2d"
    kernel_step = ptwod.make_twod_train_step(
        m.rows_grid, m.block_csr, m._send_idx, m.cfg, "csr_fused_2d", 0,
        m._grad_tabs)
    F0 = _F0(planted)
    jcfg = JaxConfig(num_communities=K, dtype="float64")
    F, st, st_k = F0.copy(), m.init_state(F0), m.init_state(F0)
    for _ in range(4):
        llh_spec = spec.loglikelihood(F, F.sum(0), planted, jcfg)
        F = spec.line_search_step(F, F.sum(0), planted, jcfg)[0]
        st, st_k = m._step(st), kernel_step(st_k)
        np.testing.assert_allclose(float(st.llh), llh_spec, rtol=1e-10)
        np.testing.assert_allclose(float(st_k.llh), llh_spec, rtol=1e-10)
        np.testing.assert_allclose(m.extract_F(st), F, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(m.extract_F(st_k), F, rtol=1e-10, atol=1e-10)


# ---------------------------------------- the trainer's shared machinery
def test_resume_rollback_and_state_views(planted, tmp_path):
    """Checkpoints and resume bit for bit, a NaN rollback recovers (one
    rollback, the dense exchange's history within 1e-10 in float64), and
    the 2D state reads through row_shards/state_blocks as p row blocks."""
    from bigclam_tpu_torch.resilience.faults import FaultPlan, install_plan

    g = _port_graph(planted)
    cfg = _cfg((2, 2), max_iters=6, conv_tol=0.0, checkpoint_every=1)
    m = TwoDShardedBigClamModel(g, cfg, _mesh((2, 2)))
    st = m.init_state(_F0(planted))
    assert len(row_shards(st.F)) == len(state_blocks(st.F)) == 4
    assert torch.equal(torch.cat(row_shards(st.F))[: g.num_nodes, :K],
                       torch.as_tensor(_F0(planted), dtype=torch.float32))
    full = m.fit(_F0(planted))
    cm = CheckpointManager(str(tmp_path / "ck"))
    TwoDShardedBigClamModel(g, cfg.replace(max_iters=3), _mesh((2, 2))).fit(
        _F0(planted), checkpoints=cm)
    assert cm.latest_step() == 3
    res = TwoDShardedBigClamModel(g, cfg, _mesh((2, 2))).fit(
        _F0(planted), checkpoints=cm)
    np.testing.assert_array_equal(res.F, full.F)
    assert list(res.llh_history[-3:]) == list(full.llh_history[-3:])
    cfg64 = _cfg((2, 2), dtype="float64", max_iters=6, conv_tol=0.0,
                 rollback_budget=3)
    clean = TwoDShardedBigClamModel(g, cfg64, _mesh((2, 2))).fit(_F0(planted))
    install_plan(FaultPlan.from_spec({"faults": [
        {"kind": "nan_inject", "site": "fit.step", "at": 3, "index": [70, 3]}]}))
    try:
        healed = TwoDShardedBigClamModel(g, cfg64, _mesh((2, 2))).fit(_F0(planted))
    finally:
        install_plan(None)
    assert np.isfinite(healed.F).all() and np.isfinite(healed.llh)
    np.testing.assert_allclose(healed.llh_history[:3], clean.llh_history[:3],
                               rtol=1e-10)


def test_health_pack_carries_the_exchange_counters(planted):
    """With health on, a closure-grad step latches its exchange counters
    into the pack's exchanged_ids / dense_fallback / cap_occupancy slots
    (the sparse allreduce's slots, JAX `_twod_health`): the auto cap never
    falls back, a cap of 1 always does; the dense exchange leaves them NA."""
    from bigclam_tpu_torch.ops.diagnostics import HEALTH_INDEX, NA

    g = _port_graph(planted)
    for extra, want_fb in (({}, 0.0), ({"closure_grad_cap": 1}, 1.0),
                           ({"grad_exchange": "dense"}, NA)):
        m = TwoDShardedBigClamModel(g, _cfg((2, 2), health_every=1, **extra),
                                    _mesh((2, 2)))
        st = m._step(m.init_state(_F0(planted)))
        h = st.health
        assert float(h[HEALTH_INDEX["dense_fallback"]]) == want_fb, extra
        if want_fb == NA:
            assert float(h[HEALTH_INDEX["exchanged_ids"]]) == NA
            continue
        assert float(h[HEALTH_INDEX["exchanged_ids"]]) == m._grad_pair_max
        assert float(h[HEALTH_INDEX["cap_occupancy"]]) == pytest.approx(
            m._grad_pair_max / m._grad_cap)


def test_comms_counted_equal_the_model(planted):
    """One step's counted bytes equal twod_step_model site for site, on
    both exchanges, and a fallback step the model with the exchange priced
    as the psum it became."""
    g = _port_graph(planted)
    for shape, extra in (((4, 1), {}), ((2, 2), {}),
                         ((2, 2), {"grad_exchange": "dense"}),
                         ((2, 2), {"use_pallas_csr": True}),
                         ((2, 2), {"closure_grad_cap": 1})):
        m = TwoDShardedBigClamModel(g, _cfg(shape, **extra), _mesh(shape))
        st = m.init_state(_F0(planted))
        measured = m.comms_measured(st)
        model = m.comms
        if extra.get("closure_grad_cap"):
            from bigclam_tpu_torch.obs.comms import twod_fallback_model

            model = twod_fallback_model(m.comms)
            assert measured.bytes_per_step() > m.comms.bytes_per_step()
        assert measured.site_bytes() == model.site_bytes(), (shape, extra)
        assert m.comms.bytes_per_step() > 0


# ------------------------------------------------------------- refusals
def test_build_refusals(planted):
    g = _port_graph(planted)
    with pytest.raises(ValueError, match="rows, cols"):
        TwoDShardedBigClamModel(g, _cfg((4, 1)), make_mesh((4, 1), [CPU] * 4))
    with pytest.raises(ValueError, match="partition-baked"):
        TwoDShardedBigClamModel(g, BigClamConfig(num_communities=K), _mesh((4, 1)))
    with pytest.raises(ValueError, match="replica_cols"):
        TwoDShardedBigClamModel(g, _cfg((4, 1)).replace(replica_cols=2),
                                _mesh((4, 1)))
    with pytest.raises(ptwod.TwoDKernelError, match="partition 1d"):
        TwoDShardedBigClamModel(g, _cfg((4, 1), use_pallas_csr=True,
                                        csr_fused=False), _mesh((4, 1)))


# ------------------------------------------------------------ copy pins
def _docless_function_ast(path, package, name):
    tree = ast.parse(path.read_text().replace(package + ".", "PKG."))
    node = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    for sub in ast.walk(node):
        body = getattr(sub, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            sub.body = body[1:] or [ast.Pass()]
    return ast.dump(node)


@pytest.mark.parametrize("name", ["twod_mesh_shape", "_grad_table_cap",
                                  "_pack_grad_tables", "_remap_dst"])
def test_layout_helpers_are_their_jax_sources(name):
    rel = "parallel/twod.py"
    assert (_docless_function_ast(REPO / "bigclam_tpu_torch" / rel,
                                  "bigclam_tpu_torch", name)
            == _docless_function_ast(REPO / "bigclam_tpu" / rel, "bigclam_tpu",
                                     name))


def _jax_blocks(layout):
    """The JAX layout's edge blocks as (src, dst) of their real slots."""
    counts = np.asarray(layout.block_edge_counts).reshape(-1)
    src = np.asarray(layout.edges.src).reshape(counts.shape[0], -1)
    dst = np.asarray(layout.edges.dst).reshape(counts.shape[0], -1)
    return [(src[b, :c], dst[b, :c]) for b, c in enumerate(counts)]


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4), (2, 3)])
def test_layouts_are_the_jax_layouts(planted, caches, shape):
    """twod_shard_edges (and at p = 4 the store's twod_shard_edges_local)
    give the JAX layout's send lists, cap, counts and grad tables, and each
    block's CSR holds the JAX block's edges, sources and closure positions,
    in order."""
    R, C = shape
    p = R * C
    n_pad = -(-max(planted.num_nodes, p) // p) * p
    jcfg = JaxConfig(num_communities=K, partition="2d", replica_cols=C)
    ref = jtwod.twod_shard_edges(planted, jcfg, R, C, n_pad, np.float32)
    layouts = [ptwod.twod_shard_edges(_port_graph(planted), _cfg(shape), R, C,
                                      n_pad)]
    if p == 4:
        store = caches["v3"]
        shard = store.load_shard_range(0, p)
        cl = store.load_closure_lists(0, p)
        pairs = {s: (sc.out_ids, sc.in_ids, sc.edge_counts)
                 for s, sc in cl.shards.items()}
        layouts.append(ptwod.twod_shard_edges_local(shard, pairs, _cfg(shape), R,
                                                    C, n_pad))
    ref_blocks = _jax_blocks(ref)
    for lay in layouts:
        assert lay.cap == ref.cap and lay.closure_rows == ref.closure_rows
        assert np.array_equal(lay.send_idx, ref.send_idx)
        assert np.array_equal(lay.block_edge_counts,
                              np.asarray(ref.block_edge_counts).reshape(-1))
        for name in ("grad_out", "grad_in", "grad_counts"):
            a, b = getattr(lay, name), getattr(ref, name)
            assert (a is None and b is None) or np.array_equal(a, b), name
        assert (lay.grad_cap, lay.grad_pair_max) == (ref.grad_cap, ref.grad_pair_max)
        for (indptr, indices), (s_ref, d_ref) in zip(lay.blocks, ref_blocks):
            src = np.repeat(np.arange(indptr.shape[0] - 1), np.diff(indptr))
            assert np.array_equal(src, s_ref) and np.array_equal(indices, d_ref)
