"""The port's K-blocked and K-sharded meshes (parallel/sharded.py
`make_tp_train_step`, parallel/ring.py `make_ring_tp_step`) against the
JAX package: float64 `xla` at (2, 2) and (4, 2) on both schedules against
the JAX `xla` meshes at 1e-10; the K-blocked paths and the tp > 1 kernel
paths on the kernels' plain versions against the JAX CSR mesh steps in
interpret mode (F at rtol = atol = 3e-5, LLH at 1e-5, tests/test_ring.py:
176-177), with the same `engaged_path`; the plain dots' directed mode
against their pair mode; the store-native trainers on the K-blocked paths
bit for bit the in-memory ones; and at tp > 1 checkpoints and resume,
NaN rollback, health, extraction and the comms model's sites, each held
to the uninterrupted or tp = 1 run. On a card only: the three window
kernels with a destination tensor F_dst and the dots' directed mode
against their plain versions.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from bigclam_tpu.config import BigClamConfig as JaxConfig
from bigclam_tpu.models.agm import sample_planted_graph as jax_planted
from bigclam_tpu.parallel import RingBigClamModel as JaxRing
from bigclam_tpu.parallel import ShardedBigClamModel as JaxSharded
from bigclam_tpu.parallel import make_mesh as jax_make_mesh

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.graph.store import GraphStore, compile_graph_cache
from bigclam_tpu_torch.obs import comms as pcomms
from bigclam_tpu_torch.ops import kblocked as kb
from bigclam_tpu_torch.ops.extraction import (
    extract_community_arrays,
    extract_community_arrays_device,
)
from bigclam_tpu_torch.parallel import (
    RingBigClamModel,
    ShardedBigClamModel,
    StoreRingBigClamModel,
    StoreShardedBigClamModel,
    make_mesh,
)
from bigclam_tpu_torch.parallel.mesh import row_shards
from bigclam_tpu_torch.parallel.ring import shard_ring_buckets
from bigclam_tpu_torch.parallel.sharded import device_csr, shard_edges
from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(2)

RTOL = ATOL = 3e-5
K = 40
CPU = torch.device("cpu")
CLASSES = {"allgather": (ShardedBigClamModel, JaxSharded),
           "ring": (RingBigClamModel, JaxRing)}


@pytest.fixture(scope="module")
def planted():
    g, _ = jax_planted(120, 6, p_in=0.3, rng=np.random.default_rng(0))
    return g


def _port_graph(g):
    return Graph(g.indptr, g.indices, g.raw_ids)


def _F0(g, seed=1):
    # small enough that no row collapses to zero in a few steps at K = 40
    return np.random.default_rng(seed).uniform(0.0, 0.3, (g.num_nodes, K))


def _mesh(shape):
    return make_mesh(shape, [CPU] * (shape[0] * shape[1]))


def _jax_mesh(shape):
    return jax_make_mesh(shape, jax.devices()[: shape[0] * shape[1]])


def _run(model, F0, steps):
    st = model.init_state(F0)
    llhs = []
    for _ in range(steps):
        st = model._step(st)
        llhs.append(float(st.llh))
    return llhs, model.extract_F(st)


@pytest.mark.parametrize("shape", [(2, 2), (4, 2)])
@pytest.mark.parametrize("schedule", ["allgather", "ring"])
def test_xla_float64_tp_matches_jax(planted, schedule, shape):
    """`xla` at tp > 1 (the TP split on the plain versions, k psums
    between the dots and their consumers) against the JAX `xla` mesh
    (make_sharded_train_step / make_ring_train_step at tp > 1)."""
    ours, theirs = CLASSES[schedule]
    jcfg = JaxConfig(num_communities=K, dtype="float64", max_iters=4, conv_tol=0.0)
    kw = {"balance": False} if schedule == "ring" else {}
    jm = theirs(planted, jcfg, _jax_mesh(shape), **kw)
    pm = ours(_port_graph(planted), BigClamConfig(**dataclasses.asdict(jcfg)),
              _mesh(shape), **kw)
    assert jm.engaged_path == pm.engaged_path == "xla" and pm.tp_split
    F0 = _F0(planted)
    jl, jF = _run(jm, F0, 4)
    pl, pF = _run(pm, F0, 4)
    np.testing.assert_allclose(pl, jl, rtol=1e-10)
    np.testing.assert_allclose(pF, jF, rtol=1e-10, atol=1e-10)


KERNEL_CASES = [
    # (schedule, mesh, csr_fused, csr_k_block, engaged path)
    ("allgather", (2, 1), None, 32, "csr_fused_kb"),
    ("allgather", (2, 1), False, 32, "csr_grouped_kb"),
    ("allgather", (2, 2), None, 32, "csr_fused_kb"),
    ("allgather", (2, 2), None, 0, "csr_fused"),
    ("allgather", (2, 2), False, 0, "csr"),
    ("ring", (2, 1), None, 32, "csr_ring_fused_kb"),
    ("ring", (2, 1), False, 32, "csr_ring_kb"),
    ("ring", (2, 2), False, 32, "csr_ring_kb"),
    ("ring", (2, 2), None, 0, "csr_ring_fused"),
    ("ring", (2, 2), False, 0, "csr_ring"),
]


@pytest.mark.parametrize("schedule,shape,fused_on,kb_cols,path", KERNEL_CASES)
def test_kernel_paths_match_jax_interpret(planted, schedule, shape, fused_on,
                                          kb_cols, path):
    """The K-blocked and tp > 1 mesh steps on the kernels' plain versions
    (F_dst the gathered F or the rotating shard) against the JAX CSR mesh
    steps in interpret mode, the same engaged path on both."""
    ours, theirs = CLASSES[schedule]
    kw = {"balance": False} if schedule == "ring" else {}
    jcfg = JaxConfig(num_communities=K, use_pallas_csr=True, pallas_interpret=True,
                     csr_block_b=8, csr_tile_t=8, csr_fused=fused_on,
                     csr_k_block=kb_cols)
    jm = theirs(planted, jcfg, _jax_mesh(shape), **kw)
    pm = ours(_port_graph(planted),
              BigClamConfig(num_communities=K, use_pallas_csr=True,
                            csr_fused=fused_on, csr_k_block=kb_cols),
              _mesh(shape), **kw)
    assert jm.engaged_path == pm.engaged_path == path
    assert pm.k_pad % (32 * shape[1]) == 0
    F0 = _F0(planted)
    jl, jF = _run(jm, F0, 3)
    pl, pF = _run(pm, F0, 3)
    np.testing.assert_allclose(pF, jF, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)


def test_mesh_k_plan_pads_to_32_tp():
    """K pads to a multiple of 32 tp and K_loc takes its own K blocks: at
    K = 3,000, 3 of 1,024 at tp = 1 and 2 of 768 at tp = 2 (the JAX
    package pads to 128 tp for the TPU's lanes). The preflight's torch-free
    copy (obs/memory.py) plans the same blocks."""
    from bigclam_tpu_torch.models.bigclam import mesh_k_plan
    from bigclam_tpu_torch.obs import memory as pmem

    assert mesh_k_plan(3000, 1, True) == (1024, 3072)
    assert mesh_k_plan(3000, 2, True) == (768, 3072)
    assert mesh_k_plan(100, 2, True, 32) == (32, 128)
    assert mesh_k_plan(1000, 2, True) == (0, 1024)
    assert mesh_k_plan(5, 2, False) == (0, 6)
    for k in (5, 37, 100, 1000, 1100, 3000, 8385):
        for tp in (1, 2, 3, 4, 8):
            for kb in (0, 32):
                assert pmem.mesh_k_plan(k, tp, kb) == mesh_k_plan(k, tp, True, kb)


@pytest.mark.parametrize("kc", [3, 16, 37])
def test_plain_directed_dots_equal_the_pair_mode(planted, kc):
    """The plain dots walked per directed edge equal the pair mode (each
    pair once through the reverse-edge index) bit for bit on a whole
    symmetric graph; with F_dst or on a shard's CSR the mode is directed."""
    g = _port_graph(planted)
    csr = kb.with_rev(g.to_device(CPU))
    F = torch.as_tensor(np.random.default_rng(kc).uniform(0, 1, (g.num_nodes, 2 * kc)),
                        dtype=torch.float32)
    x_pair = torch.zeros(csr.num_directed_edges)
    x_dir = torch.zeros_like(x_pair)
    for col0 in (0, kc):
        kb.edge_dots_kb(F, csr, col0, kc, x_pair, directed=False)
        kb.edge_dots_kb(F, csr, col0, kc, x_dir, directed=True)
    assert torch.equal(x_dir, x_pair)
    assert kb.edge_mode(csr) is csr.rev
    assert kb.edge_mode(csr, F_dst=F) is None
    indptr, indices = shard_edges(g, 2, 120)[1]
    shard = device_csr(indptr, indices, CPU)
    assert kb.edge_mode(shard) is None
    with pytest.raises(kb.AsymmetricCSRError):
        kb.edge_mode(shard, directed=False)


def test_plain_accumulate_mode_is_a_scratch_and_an_add(planted):
    """grad_from_x_kb's accumulate mode over a ring's phases equals the sum
    of the phases' fresh windows added in phase order, bit for bit."""
    g = _port_graph(planted)
    dp, rows = 3, 40
    cfg = BigClamConfig(num_communities=K)
    rng = np.random.default_rng(5)
    F = torch.as_tensor(rng.uniform(0, 0.3, (120, 64)), dtype=torch.float32)
    sumF = F.sum(dim=0)
    indptr, indices = shard_edges(g, dp, 120)[0]
    acc, ln = torch.zeros((rows, 64)), torch.zeros(rows)
    want, want_ln = torch.zeros((rows, 64)), torch.zeros(rows)
    for r, (b_ip, b_ix) in enumerate(shard_ring_buckets(indptr, indices, 0, dp, rows)):
        b = device_csr(b_ip, b_ix, CPU)
        rot = F[r * rows : (r + 1) * rows]
        x = kb.edge_dots_windows(F[:rows], b, 32, rot)
        for col0 in (0, 32):
            kb.grad_from_x_kb(x, F[:rows], sumF, b, col0, 32, cfg, False,
                              acc[:, col0 : col0 + 32], rot, True, ln)
            g_w, l_w = kb.grad_from_x_kb(x, F[:rows], sumF, b, col0, 32, cfg,
                                         False, F_dst=rot)
            want[:, col0 : col0 + 32] += g_w
            if col0 == 0:
                want_ln += l_w
    assert torch.equal(acc, want) and torch.equal(ln, want_ln)
    with pytest.raises(ValueError, match="not both"):
        kb.grad_from_x_kb(x, F[:rows], sumF, b, 0, 32, cfg, True, acc[:, :32],
                          rot, True, ln)


@pytest.fixture(scope="module")
def cache(planted, tmp_path_factory):
    root = tmp_path_factory.mktemp("kbmesh")
    path = root / "g.txt"
    keep = planted.src < planted.dst
    np.savetxt(path, np.stack([planted.src[keep], planted.dst[keep]], axis=1),
               fmt="%d")
    return compile_graph_cache(str(path), str(root / "cache"), num_shards=2)


@pytest.mark.parametrize("shape,kb_cols", [((2, 1), 32), ((2, 2), 32), ((2, 2), 0)])
@pytest.mark.parametrize("schedule", ["allgather", "ring"])
def test_store_native_k_blocked_bit_identical_to_in_memory(cache, schedule,
                                                           shape, kb_cols):
    """The store-native trainers take the K-blocked and tp > 1 paths too,
    bit for bit the in-memory trainers on the cache's graph (the JAX
    package pins the same, tests/test_fused.py:227-250)."""
    store = GraphStore.open(cache.directory)
    cfg = BigClamConfig(num_communities=K, use_pallas_csr=True, csr_k_block=kb_cols,
                        max_iters=3, conv_tol=0.0)
    mem_cls, store_cls = ((RingBigClamModel, StoreRingBigClamModel)
                          if schedule == "ring"
                          else (ShardedBigClamModel, StoreShardedBigClamModel))
    mem = mem_cls(store.load_graph(), cfg, _mesh(shape), balance=False)
    model = store_cls(store, cfg, _mesh(shape))
    assert model.engaged_path == mem.engaged_path and model.tp_split
    F0 = _F0(store.load_graph(), seed=3)
    a, b = mem.fit(F0), model.fit(F0)
    assert a.llh_history == b.llh_history and len(a.llh_history) == 4
    np.testing.assert_array_equal(a.F, b.F)
    # the per-position row-keyed init, split into column blocks
    for x, y in zip(model.init_state(None).F, mem.init_state(None).F):
        for u, v in zip(x if isinstance(x, tuple) else (x,),
                        y if isinstance(y, tuple) else (y,)):
            assert torch.equal(u, v)


@pytest.mark.parametrize("schedule", ["allgather", "ring"])
def test_tp_checkpoint_and_resume_bit_for_bit(planted, tmp_path, schedule):
    """A (2, 2) fit stopped after 3 steps and resumed from its checkpoint
    ends bit for bit where the uninterrupted fit ends; the archive holds
    the whole (n_pad, k_pad) F, as at tp = 1."""
    cls = CLASSES[schedule][0]
    g = _port_graph(planted)
    cfg = BigClamConfig(num_communities=K, use_pallas_csr=True, max_iters=6,
                        conv_tol=0.0, checkpoint_every=1)
    F0 = _F0(planted)
    full = cls(g, cfg, _mesh((2, 2))).fit(F0)
    cm = CheckpointManager(str(tmp_path / schedule))
    cls(g, cfg.replace(max_iters=3), _mesh((2, 2))).fit(F0, checkpoints=cm)
    assert cm.latest_step() == 3
    res = cls(g, cfg, _mesh((2, 2))).fit(F0, checkpoints=cm)
    np.testing.assert_array_equal(res.F, full.F)
    assert list(res.llh_history[-3:]) == list(full.llh_history[-3:])
    m = cls(g, cfg, _mesh((2, 2)))
    arrays = m._state_to_arrays(m.init_state(F0))
    assert arrays["F"].shape == (m.n_pad, m.k_pad) and arrays["sumF"].shape == (m.k_pad,)


@pytest.mark.parametrize("schedule", ["allgather", "ring"])
def test_tp_nan_rollback_matches_jax(planted, tmp_path, schedule):
    """A NaN injected into F at step 3 of a (2, 2) float64 fit: one
    rollback and the JAX mesh's LLH history (1e-10), F finite."""
    from bigclam_tpu.resilience import faults as jres

    from bigclam_tpu_torch.resilience.faults import FaultPlan, install_plan

    ours, theirs = CLASSES[schedule]
    kw = {"balance": False} if schedule == "ring" else {}
    jcfg = JaxConfig(num_communities=K, dtype="float64", max_iters=6, conv_tol=0.0,
                     rollback_budget=3, rollback_shrink=0.1)
    plan = {"faults": [{"kind": "nan_inject", "site": "fit.step", "at": 3,
                        "index": [70, 33]}]}
    F0 = _F0(planted)
    jres.install_plan(jres.FaultPlan.from_spec(plan))
    try:
        rj = theirs(planted, jcfg, _jax_mesh((2, 2)), **kw).fit(F0)
    finally:
        jres.install_plan(None)
    install_plan(FaultPlan.from_spec(plan))
    try:
        rp = ours(_port_graph(planted), BigClamConfig(**dataclasses.asdict(jcfg)),
                  _mesh((2, 2)), **kw).fit(F0)
    finally:
        install_plan(None)
    assert len(rp.llh_history) == len(rj.llh_history)
    np.testing.assert_allclose(rp.llh_history, rj.llh_history, rtol=1e-10)
    assert np.isfinite(rp.F).all()


def test_tp_health_extraction_and_comms(planted):
    """At (2, 2): the health pack equals the (2, 1) mesh's (1e-10: the
    same rows, joined from their column blocks); the device extraction of
    the block state equals the host extraction; the comms counter sees the
    model's sites, k psums included, byte for byte on both schedules."""
    g = _port_graph(planted)
    cfg = BigClamConfig(num_communities=K, dtype="float64", health_every=1)
    F0 = _F0(planted)
    packs = []
    for shape in ((2, 1), (2, 2)):
        m = ShardedBigClamModel(g, cfg, _mesh(shape))
        st = m._step(m.init_state(F0))
        packs.append(st.health.numpy())
    np.testing.assert_allclose(packs[1], packs[0], rtol=1e-10, atol=1e-12)
    F_host = torch.cat(row_shards(st.F)).numpy()[: g.num_nodes, :K]
    dev = extract_community_arrays_device(st.F, g, num_communities=K)
    host = extract_community_arrays(F_host, g)
    for name in ("ids", "offsets", "nodes"):
        np.testing.assert_array_equal(getattr(dev, name), getattr(host, name))
    for cls in (ShardedBigClamModel, RingBigClamModel):
        m = cls(g, BigClamConfig(num_communities=K, use_pallas_csr=True),
                _mesh((2, 2)))
        measured = m.comms_measured(m.init_state(F0))
        assert measured.site_bytes() == m.comms.site_bytes()
        assert any(s.site.endswith("psum_k_x") for s in m.comms.sites)
        assert m.comms.params["tp"] == 2
    cm = pcomms.sharded_step_model(120, 64, 2, 4, 16)
    assert cm.params["tp"] == 1 and len(cm.sites) == 3


def test_tp_host_quality_schedule_matches_jax(planted):
    """The host quality schedule (fit_quality: host kicks, repair) on a
    (2, 2) float64 mesh against the JAX fit_quality on the same mesh; the
    device-resident schedule (no longer refused there) against the JAX
    fit_quality_device on the same mesh, fed the JAX draws."""
    from bigclam_tpu.models.quality import fit_quality as jax_fit_quality
    from bigclam_tpu.models.quality import fit_quality_device as jax_fit_quality_device

    from bigclam_tpu_torch.models.quality import fit_quality, fit_quality_device
    from test_torch_quality_device import jax_noise

    jcfg = JaxConfig(num_communities=8, dtype="float64", max_iters=30,
                     quality_mode=True, restart_cycles=2)
    F0 = np.random.default_rng(2).uniform(0.0, 0.3, (planted.num_nodes, 8))
    jm = JaxSharded(planted, jcfg, _jax_mesh((2, 2)))
    jr = jax_fit_quality(jm, F0)
    pm = ShardedBigClamModel(_port_graph(planted),
                             BigClamConfig(**dataclasses.asdict(jcfg)), _mesh((2, 2)))
    pr = fit_quality(pm, F0)
    np.testing.assert_allclose(pr.fit.llh, jr.fit.llh, rtol=1e-10)
    np.testing.assert_allclose(pr.fit.F, jr.fit.F, rtol=1e-9, atol=1e-10)
    jd = jax_fit_quality_device(jm, F0)
    pd = fit_quality_device(pm, F0, noise=jax_noise(jm, F0, jcfg.seed))
    assert (pd.num_cycles, pd.total_iters, pd.num_repairs) == (
        jd.num_cycles, jd.total_iters, jd.num_repairs)
    np.testing.assert_allclose(pd.cycles_llh, jd.cycles_llh, rtol=1e-10)
    np.testing.assert_allclose(pd.fit.llh, jd.fit.llh, rtol=1e-10)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tp_tails_in_place_equal_the_expressions(dtype):
    """armijo_tail_select_tp builds its per-step terms in place (two block
    temporaries, as obs/memory.py prices them): bit for bit the
    out-of-place expressions clamp(F + eta g), nf.(sumF - F + nf), nf.nf
    and where(ok, clamp(F + best g), F)."""
    from bigclam_tpu_torch.ops.linesearch import step_etas
    from bigclam_tpu_torch.parallel.sharded import armijo_tail_select_tp

    cfg = BigClamConfig(num_communities=64)
    rng = np.random.default_rng(5)
    F = [torch.as_tensor(rng.uniform(0, 1, (30, 32)), dtype=dtype) for _ in range(2)]
    G = [torch.as_tensor(rng.normal(0, 2, (30, 32)), dtype=dtype) for _ in range(2)]
    S = [f.sum(dim=0) + 3 for f in F]
    ln = [torch.as_tensor(rng.normal(0, 5, 30), dtype=dtype)] * 2
    cn = [torch.as_tensor(rng.normal(0, 5, (len(cfg.step_candidates), 30)),
                          dtype=dtype)] * 2
    F_new, sums, node_llh, ok = armijo_tail_select_tp(F, G, ln, cn, S, cfg,
                                                      [CPU, CPU], "t")
    parts = []
    for f, g, s in zip(F, G, S):
        rows = [f @ s, (f * f).sum(dim=1), (g * g).sum(dim=1)]
        for eta in step_etas(cfg, f):
            nf = torch.clamp(f + eta * g, cfg.min_f, cfg.max_f)
            rows += [(nf * (s[None, :] - f + nf)).sum(dim=1), (nf * nf).sum(dim=1)]
        parts.append(torch.stack(rows))
    t = parts[0] + parts[1]
    etas = step_etas(cfg, F[0])
    want_llh = ln[0] + (-t[0] + t[1])
    want_ok = (cn[0] + (-t[3::2] + t[4::2])
               >= want_llh[None, :] + cfg.alpha * etas[:, None] * t[2][None, :])
    best = torch.where(want_ok, etas[:, None], torch.zeros_like(etas)[:, None])
    best = best.max(dim=0).values
    assert torch.equal(node_llh, want_llh) and torch.equal(ok, want_ok)
    assert 0 < int(want_ok.any(dim=0).sum()) < 30
    for f, g, fn, sm in zip(F, G, F_new, sums):
        want = torch.where(want_ok.any(dim=0)[:, None],
                           torch.clamp(f + best[:, None] * g, cfg.min_f, cfg.max_f), f)
        assert torch.equal(fn, want) and torch.equal(sm, want.sum(dim=0))


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
@pytest.mark.parametrize("schedule", ["allgather", "ring"])
def test_tp_memory_model_prices_the_tails_and_the_split_parts_do_not_nest(
        planted, schedule, shape):
    """At tp > 1 the trainer's memory model holds the torch tails' two
    (n_loc, K_loc) temporaries (none at tp = 1), and the step split's
    parts (utils.profiling.step_split) are disjoint intervals: the ring's
    `rotation` times its hops alone, not the sweeps whose parts it holds."""
    from bigclam_tpu_torch.utils import profiling

    ours, _ = CLASSES[schedule]
    kw = {"balance": False} if schedule == "ring" else {}
    m = ours(_port_graph(planted), BigClamConfig(num_communities=K, use_pallas_csr=True,
                                                 csr_k_block=32), _mesh(shape), **kw)
    assert m.tp_split
    n_loc, k_loc = m.n_pad // shape[0], m.k_pad // shape[1]
    tails = {b.name: b.total_bytes for b in m.memory.buffers}.get("transient/tp_tails", 0)
    assert tails == (2 * n_loc * k_loc * 4 if shape[1] > 1 else 0)
    st = m.init_state(_F0(planted))
    with profiling.step_split() as split:
        rec = profiling._SPLIT["on"]
        m._step(st)
    spans = sorted((t0, t1, name) for name, t0, t1 in rec)
    for (_, end, a), (start, _, b) in zip(spans, spans[1:]):
        assert end <= start, (a, b)
    assert {"dots", "k_psum", "consume", "tails", "finish"} <= set(split)
    assert ("rotation" in split) == (schedule == "ring")


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k,kc", [(37, 37), (1100, 576)])
def test_cuda_window_kernels_with_f_dst_match_plain(planted, cuda_device, k, kc):
    """edge_dots_kb (directed), grad_from_x_kb (fold, no fold, accumulate)
    and cand_dots_kb on shard 1 of a dp = 2 split, F_dst the whole F,
    against their plain versions."""
    g = _port_graph(planted)
    k_pad = -(-k // kc) * kc
    F = torch.as_tensor(np.random.default_rng(k).uniform(0, 1, (120, k_pad)),
                        dtype=torch.float32, device=cuda_device)
    indptr, indices = shard_edges(g, 2, 120)[1]
    csr = device_csr(indptr, indices, cuda_device)
    F_loc = F[60:].contiguous()
    cfg = BigClamConfig(num_communities=k)
    sumF = F.sum(dim=0)
    x_k, x_p = torch.zeros(csr.num_directed_edges, device=cuda_device), None
    x_p = torch.zeros_like(x_k)
    for col0 in range(0, k_pad, kc):
        kb.edge_dots_kb(F_loc, csr, col0, kc, x_k, F)
        kb.edge_dots_kb_plain(F_loc, csr, col0, kc, x_p, F)
    torch.testing.assert_close(x_k, x_p, rtol=RTOL, atol=ATOL)
    acc_k = torch.ones((60, k_pad), device=cuda_device)
    acc_p, l_k, l_p = acc_k.clone(), torch.ones(60, device=cuda_device), None
    l_p = l_k.clone()
    for col0 in range(0, k_pad, kc):
        for fold in (True, False):
            g_k, _ = kb.grad_from_x_kb(x_p, F_loc, sumF, csr, col0, kc, cfg, fold, F_dst=F)
            g_p, _ = kb.grad_from_x_kb_plain(x_p, F_loc, sumF, csr, col0, kc, cfg,
                                             fold, F_dst=F)
            torch.testing.assert_close(g_k, g_p, rtol=RTOL, atol=ATOL)
        kb.grad_from_x_kb(x_p, F_loc, sumF, csr, col0, kc, cfg, False,
                          acc_k[:, col0 : col0 + kc], F, True, l_k)
        kb.grad_from_x_kb_plain(x_p, F_loc, sumF, csr, col0, kc, cfg, False,
                                acc_p[:, col0 : col0 + kc], F, True, l_p)
        xc_k = torch.zeros((len(cfg.step_candidates), csr.num_directed_edges),
                           device=cuda_device)
        xc_p = torch.zeros_like(xc_k)
        kb.cand_dots_kb(F_loc, g_p.contiguous(), csr, col0, kc, cfg, xc_k, F)
        kb.cand_dots_kb_plain(F_loc, g_p, csr, col0, kc, cfg, xc_p, F)
        torch.testing.assert_close(xc_k, xc_p, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(acc_k, acc_p, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(l_k, l_p, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kc", [37, 576])
def test_cuda_directed_mode_equals_the_pair_mode(planted, cuda_device, kc):
    g = _port_graph(planted)
    csr = kb.with_rev(g.to_device(cuda_device))
    F = torch.as_tensor(np.random.default_rng(kc).uniform(0, 1, (120, 2 * kc)),
                        dtype=torch.float32, device=cuda_device)
    x_pair = torch.zeros(csr.num_directed_edges, device=cuda_device)
    x_dir = torch.zeros_like(x_pair)
    for col0 in (0, kc):
        kb.edge_dots_kb(F, csr, col0, kc, x_pair, directed=False)
        kb.edge_dots_kb(F, csr, col0, kc, x_dir, directed=True)
    torch.cuda.synchronize()
    assert torch.equal(x_dir, x_pair)
