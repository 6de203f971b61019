"""The port's all-gather schedule (bigclam_tpu_torch.parallel.sharded)
against the JAX package: the per-shard CSR against JAX `shard_edges`; the
port's `ShardedBigClamModel` on CPU meshes (repeated CPU devices) against
the JAX `ShardedBigClamModel` on `jax.devices()[:dp]` — float64 `xla`, and
`csr_fused` / `csr` on the plain versions of kernels A/B/C with their
destination rows from the gathered F against the JAX CSR sharded steps in
interpret mode; shard invariance against the port's single-device model;
the mesh and its refusals. On a card only: kernels A/B/C with a separate
destination-row tensor against their plain versions.

Tolerances: float64 at 1e-10; float32 kernel paths at rtol = atol = 3e-5,
LLH at 1e-5 (tests/test_ring.py:176-177).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from bigclam_tpu.config import BigClamConfig as JaxConfig
from bigclam_tpu.graph.ingest import graph_from_edges as jax_graph_from_edges
from bigclam_tpu.parallel import ShardedBigClamModel as JaxSharded
from bigclam_tpu.parallel import make_mesh as jax_make_mesh
from bigclam_tpu.parallel.sharded import shard_edges as jax_shard_edges

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.models.bigclam import BigClamModel
from bigclam_tpu_torch.ops import csr_kernels as ck
from bigclam_tpu_torch.ops import fused
from bigclam_tpu_torch.parallel import (
    ShardedBigClamModel,
    make_mesh,
)
from bigclam_tpu_torch.parallel.sharded import (
    all_gather,
    device_csr,
    psum,
    shard_edge_counts,
    shard_edges,
)

torch.set_num_threads(2)

RTOL = ATOL = 3e-5
CPU = torch.device("cpu")


def _random_graph(seed, n=71, p=0.12):
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < p
    edges = [(i, j) for i in range(n) for j in range(i + 1, n) if a[i, j]]
    edges.append((0, n - 1))
    return jax_graph_from_edges(edges, num_nodes=n + 2)     # two isolated


def _port_graph(g):
    return Graph(g.indptr, g.indices, g.raw_ids)


def _cpu_mesh(dp):
    return make_mesh((dp, 1), [CPU] * dp)


def _run(model, F0, steps):
    st = model.init_state(F0)
    llhs = []
    for _ in range(steps):
        st = model._step(st)
        llhs.append(float(st.llh))
    return llhs, model.extract_F(st)


@pytest.mark.parametrize("dp", [1, 2, 3, 4])
def test_shard_csr_holds_the_jax_shard_edges(dp):
    g = _random_graph(0)
    n_pad = -(-g.num_nodes // dp) * dp
    ref = jax_shard_edges(g, JaxConfig(), dp, n_pad, np.float32)
    ours = shard_edges(_port_graph(g), dp, n_pad)
    np.testing.assert_array_equal(
        [len(ind) for _, ind in ours], shard_edge_counts(g.src, n_pad, dp)
    )
    for i, (indptr, indices) in enumerate(ours):
        assert indptr.shape == (n_pad // dp + 1,)
        m = ref.mask[i].reshape(-1) > 0
        src = np.repeat(np.arange(n_pad // dp), np.diff(indptr))
        np.testing.assert_array_equal(src, ref.src[i].reshape(-1)[m])
        np.testing.assert_array_equal(indices, ref.dst[i].reshape(-1)[m])


def test_psum_and_all_gather_give_every_shard_the_same_bits():
    rng = np.random.default_rng(0)
    parts = [torch.as_tensor(rng.normal(size=5)) for _ in range(3)]
    sums = psum(parts, [CPU] * 3)
    assert all(torch.equal(s, (parts[0] + parts[1]) + parts[2]) for s in sums)
    full = all_gather(parts, [CPU] * 3)
    assert all(torch.equal(f, torch.cat(parts)) for f in full)


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_allgather_xla_float64_matches_jax(dp):
    g = _random_graph(1)
    k = 6
    jcfg = JaxConfig(num_communities=k, dtype="float64", max_iters=4, conv_tol=0.0)
    F0 = np.random.default_rng(0).uniform(0.1, 1.0, (g.num_nodes, k))
    jm = JaxSharded(g, jcfg, jax_make_mesh((dp, 1), jax.devices()[:dp]))
    pm = ShardedBigClamModel(
        _port_graph(g), BigClamConfig(**dataclasses.asdict(jcfg)), _cpu_mesh(dp)
    )
    assert jm.engaged_path == pm.engaged_path == "xla"
    jl, jF = _run(jm, F0, 4)
    pl, pF = _run(pm, F0, 4)
    np.testing.assert_allclose(pl, jl, rtol=1e-10)
    np.testing.assert_allclose(pF, jF, rtol=1e-10, atol=1e-10)
    # the JAX state carried across: the same first step
    js = jm.init_state(F0)
    ps = pm.state_from_jax(np.asarray(js.F))
    np.testing.assert_allclose(float(pm._step(ps).llh), float(jm._step(js).llh),
                               rtol=1e-10)


@pytest.mark.parametrize("path", ["csr_fused", "csr"])
@pytest.mark.parametrize("dp", [2, 4])
def test_allgather_csr_paths_match_jax_interpret(path, dp):
    """The all-gather CSR steps on the plain versions of A/B/C (F_dst = the
    gathered F) against the JAX sharded CSR step in interpret mode."""
    g = _random_graph(0)
    k = 6
    fused_on = path == "csr_fused"
    jcfg = JaxConfig(
        num_communities=k, use_pallas_csr=True, pallas_interpret=True,
        csr_block_b=8, csr_tile_t=8, csr_fused=None if fused_on else False,
    )
    jm = JaxSharded(g, jcfg, jax_make_mesh((dp, 1), jax.devices()[:dp]))
    assert jm.engaged_path == path
    pm = ShardedBigClamModel(
        _port_graph(g),
        BigClamConfig(num_communities=k, use_pallas_csr=True,
                      csr_fused=None if fused_on else False),
        _cpu_mesh(dp),
    )
    assert pm.engaged_path == path and pm.k_pad == 32
    F0 = np.random.default_rng(1).uniform(0.0, 1.0, (g.num_nodes, k))
    jl, jF = _run(jm, F0, 3)
    pl, pF = _run(pm, F0, 3)
    np.testing.assert_allclose(pF, jF, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)


def test_allgather_shard_invariance():
    """dp = 4 all-gather (xla, float64, balanced and not) against the
    port's single-device model at 1e-10."""
    g = _port_graph(_random_graph(2))
    k = 5
    cfg = BigClamConfig(num_communities=k, dtype="float64", max_iters=4, conv_tol=0.0)
    F0 = np.random.default_rng(2).uniform(0.1, 1.0, (g.num_nodes, k))
    ref = BigClamModel(g, cfg, device="cpu").fit(F0)
    for balance in (False, True):
        m = ShardedBigClamModel(g, cfg, _cpu_mesh(4), balance=balance)
        assert (m._perm is not None) == balance
        res = m.fit(F0)
        np.testing.assert_allclose(res.llh_history, ref.llh_history, rtol=1e-10)
        np.testing.assert_allclose(res.F, ref.F, rtol=1e-10, atol=1e-10)


def test_mesh_shapes_and_refusals():
    g = _port_graph(_random_graph(3))
    with pytest.raises(ValueError, match=r"mesh shape \(2, 1\) needs 2 devices, got 3"):
        make_mesh((2, 1), [CPU] * 3)
    mesh = make_mesh((2, 2), [CPU] * 4)
    assert mesh.shape == {"nodes": 2, "k": 2} and mesh.size == 4
    assert mesh.label() == "2x2"
    # a K-sharded mesh and a K-blocked mesh build and engage
    m = ShardedBigClamModel(g, BigClamConfig(num_communities=5), mesh)
    assert (m.engaged_path, m.tp, m.k_pad, m.kc, m.tp_split) == ("xla", 2, 6, 0, True)
    st = m.init_state()
    assert [tuple(b.shape) for b in st.F[1]] == [(37, 3), (37, 3)]
    m = ShardedBigClamModel(
        g, BigClamConfig(num_communities=4, use_pallas_csr=True, csr_k_block=32),
        _cpu_mesh(2),
    )
    assert (m.engaged_path, m.kc, m.k_pad) == ("csr_fused_kb", 32, 32)
    with pytest.raises(ValueError, match="use_pallas_csr=False selects"):
        ShardedBigClamModel(
            g, BigClamConfig(num_communities=4, use_pallas_csr=True, dtype="float64"),
            _cpu_mesh(2),
        )
    with pytest.raises(ValueError, match="min_f"):
        ShardedBigClamModel(g, BigClamConfig(num_communities=4, min_f=0.1), _cpu_mesh(2))
    m = ShardedBigClamModel(g, BigClamConfig(num_communities=4), _cpu_mesh(3))
    assert (m.n_pad, m.k_pad, m.engaged_path) == (75, 4, "xla")
    assert m.path_reason == "auto: device 'cpu' is not cuda"


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [37, 1000])
def test_cuda_kernels_with_f_dst_match_plain(k, cuda_device):
    """Kernels A/B/C over shard 1 of a dp = 2 split, their destination rows
    from the whole F, against the plain versions."""
    g = _port_graph(_random_graph(4, n=300, p=0.05))
    n_pad = -(-g.num_nodes // 2) * 2
    indptr, indices = shard_edges(g, 2, n_pad)[1]
    cfg = BigClamConfig(num_communities=k)
    rng = np.random.default_rng(k)
    F_full = torch.zeros((n_pad, k))
    F_full[: g.num_nodes] = torch.as_tensor(rng.uniform(0.0, 1.0, (g.num_nodes, k)))
    F = F_full[n_pad // 2 :].contiguous()
    sumF = F_full.sum(dim=0)
    csr = device_csr(indptr, indices, CPU)
    want = fused.fused_superstep(F, sumF, csr, cfg, F_full)
    cand_p = ck.candidates_csr(F, want[1], sumF, csr, cfg, F_full)
    dev = [t.to(cuda_device) for t in (F, sumF, F_full, want[1])]
    csr_d = device_csr(indptr, indices, cuda_device)
    got = fused.fused_superstep(dev[0], dev[1], csr_d, cfg, dev[2])
    g_k, l_k = ck.grad_llh_csr(dev[0], dev[1], csr_d, cfg, dev[2])
    c_k = ck.candidates_csr(dev[0], dev[3], dev[1], csr_d, cfg, dev[2])
    torch.cuda.synchronize()
    for a, b in ((got[1], want[1]), (got[2], want[2]), (g_k, want[1]),
                 (l_k, want[2]), (c_k, cand_p)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=RTOL, atol=ATOL)
