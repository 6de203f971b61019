"""The port's ring schedule (bigclam_tpu_torch.parallel.ring) against the
JAX package: the (shard, phase) buckets against JAX `ring_shard_edges` and
`ring_block_tiles`; the plain versions of kernels #8 and #9 against the
interpret-mode Pallas kernels `_grad_blocks_fused` / `_cand_blocks_fused`
per bucket (block 8, tile 8, as tests/test_ring.py runs them); the port's
`RingBigClamModel` on CPU meshes (repeated CPU devices) against the JAX
`RingBigClamModel` on `jax.devices()[:dp]`; shard invariance against the
port's single-device model; the overlapped rotation against the serial
one; the balance relabeling; `cli fit --mesh` and its refusals. On a card
only: each ring kernel against its plain version, and a ring over two
cards.

Tolerances: float64 `xla` trajectories at 1e-10 (F and LLH; the sums run
in another order); float32 kernels and `csr_ring_fused` at rtol = atol =
3e-5, LLH at 1e-5 (tests/test_ring.py:176-177). The JAX serial ring
(ring_overlap=False) raises under the installed jax (ROADMAP queue 3), so
the port is held against JAX's overlapped schedule and its own serial
schedule against its overlapped one, bit for bit.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigclam_tpu.cli import main as jax_main
from bigclam_tpu.config import BigClamConfig as JaxConfig
from bigclam_tpu.graph.ingest import graph_from_edges as jax_graph_from_edges
from bigclam_tpu.ops.csr_tiles import ring_block_tiles
from bigclam_tpu.ops.pallas_csr import TilesDev
from bigclam_tpu.ops.pallas_fused import _cand_blocks_fused, _grad_blocks_fused
from bigclam_tpu.parallel import make_mesh as jax_make_mesh
from bigclam_tpu.parallel.ring import RingBigClamModel as JaxRing
from bigclam_tpu.parallel.ring import ring_shard_edges as jax_ring_shard_edges

from bigclam_tpu_torch import cli
from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.models.bigclam import BigClamModel
from bigclam_tpu_torch.ops import ring_kernels as rk
from bigclam_tpu_torch.parallel import (
    RingBigClamModel,
    make_mesh,
)
from bigclam_tpu_torch.parallel.ring import (
    VISIT_ORDERS,
    ring_bucket_imbalance,
    ring_shard_edges,
    visit_order,
)
from bigclam_tpu_torch.parallel.sharded import device_csr

torch.set_num_threads(2)

RTOL = ATOL = 3e-5
BLOCK = TILE = 8
CPU = torch.device("cpu")


def _random_graph(seed, n=71, p=0.12, isolated=()):
    """tests/test_ring.py's random graph, optionally with isolated nodes."""
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < p
    edges = [(i, j) for i in range(n) for j in range(i + 1, n) if a[i, j]]
    edges.append((0, n - 1))
    edges = [e for e in edges if e[0] not in isolated and e[1] not in isolated]
    return jax_graph_from_edges(edges, num_nodes=n)


def _path_graph(n=10, extra_isolated=1):
    """A path 0-1-...-(n-1) plus isolated nodes: with dp = 3 its shards
    meet only their neighbours, so bucket (0, 2) is empty, and N = 11 leaves
    a padding row."""
    return jax_graph_from_edges(
        [(i, i + 1) for i in range(n - 1)], num_nodes=n + extra_isolated
    )


def _port_graph(g):
    return Graph(g.indptr, g.indices, g.raw_ids)


def _cpu_mesh(dp):
    return make_mesh((dp, 1), [CPU] * dp)


def _jax_mesh(dp):
    return jax_make_mesh((dp, 1), jax.devices()[:dp])


def _bucket_pairs(indptr, indices):
    """(local src, local dst) rows of one bucket, in its order."""
    src = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
    return np.stack([src, indices.astype(np.int64)], axis=1)


# --- buckets ---------------------------------------------------------------


@pytest.mark.parametrize("dp", [1, 2, 3, 4])
@pytest.mark.parametrize("graph", ["random", "path"])
def test_buckets_hold_the_jax_bucket_edges(dp, graph):
    """Every (shard, phase) bucket holds exactly the edges of JAX
    `ring_shard_edges` (in its order, same local ids) and of JAX
    `ring_block_tiles` at the JAX CSR n_pad (as a set)."""
    g = _random_graph(0) if graph == "random" else _path_graph()
    n_pad = -(-g.num_nodes // dp) * dp
    ours = ring_shard_edges(_port_graph(g), dp, n_pad)
    ref = jax_ring_shard_edges(g, JaxConfig(), dp, n_pad, np.float32)
    sizes = []
    for i in range(dp):
        for r in range(dp):
            indptr, indices = ours[i][r]
            assert indptr.shape == (n_pad // dp + 1,) and indices.dtype == np.int32
            m = ref.mask[i, r].reshape(-1) > 0
            want = np.stack(
                [ref.src[i, r].reshape(-1)[m], ref.dst[i, r].reshape(-1)[m]], axis=1
            )
            np.testing.assert_array_equal(_bucket_pairs(indptr, indices), want)
            sizes.append(len(indices))
    assert sum(sizes) == g.num_directed_edges
    if graph == "path" and dp == 3:
        assert n_pad > g.num_nodes and min(sizes) == 0   # padding row, empty bucket

    n_pad_t = -(-g.num_nodes // (dp * BLOCK)) * dp * BLOCK
    rbt = ring_block_tiles(g, dp, n_pad_t, BLOCK, TILE)
    ours = ring_shard_edges(_port_graph(g), dp, n_pad_t)
    for i in range(dp):
        for r in range(dp):
            m = rbt.mask[i, r] > 0
            src = rbt.block_id[i, r][:, None] * BLOCK + rbt.src_local[i, r]
            want = np.stack([src[m], rbt.dst_local[i, r][m]], axis=1)
            got = _bucket_pairs(*ours[i][r])
            np.testing.assert_array_equal(
                got[np.lexsort(got.T[::-1])], want[np.lexsort(want.T[::-1])]
            )


def test_bucket_imbalance_statistic_matches_jax():
    from bigclam_tpu.parallel.ring import ring_bucket_imbalance as jax_imb

    g = _random_graph(3)
    for dp in (1, 3, 4):
        n_pad = -(-g.num_nodes // dp) * dp
        assert ring_bucket_imbalance(_port_graph(g), dp, n_pad) == jax_imb(g, dp, n_pad)


# --- kernels #8 and #9: plain versions against the Pallas kernels ----------


@pytest.mark.parametrize("dp", [2, 3])
def test_phase_kernels_plain_match_pallas(dp):
    """Per (shard, phase) bucket at the JAX CSR n_pad: the plain #8 partials
    (accumulated onto zeros) against `_grad_blocks_fused`, and the plain #9
    partials against `_cand_blocks_fused`, in interpret mode."""
    _check_phase_kernels(_random_graph(1, isolated=(5, 40)), dp, 12)


@pytest.mark.parametrize("k", [37, 100])
def test_phase_kernels_plain_match_pallas_on_a_hub(k):
    """As above at dp = 3 on a graph with nodes of degree 100 and 700, whose
    buckets hold many 32-neighbour tiles of one node, at K = 37 and 100
    (not multiples of 32; 2 and 4 column chunks)."""
    from test_torch_kernels import _hub_graph

    g = _hub_graph((5, 40))
    assert g.degrees[0] >= 100 and g.degrees[1] >= 700
    _check_phase_kernels(g, 3, k)


def _check_phase_kernels(g, dp, k):
    rows = -(-g.num_nodes // (dp * BLOCK)) * BLOCK
    n_pad = rows * dp
    rng = np.random.default_rng(dp)
    F = np.zeros((n_pad, k), np.float32)
    F[: g.num_nodes] = rng.uniform(0.0, 1.0, (g.num_nodes, k))
    F[11] = 0.0
    G = np.zeros_like(F)
    G[: g.num_nodes] = rng.uniform(-1.5, 1.5, (g.num_nodes, k))
    jcfg = JaxConfig(num_communities=k)
    cfg = BigClamConfig(**dataclasses.asdict(jcfg))
    num_s = len(cfg.step_candidates)
    rbt = ring_block_tiles(g, dp, n_pad, BLOCK, TILE)
    ours = ring_shard_edges(_port_graph(g), dp, n_pad)
    nt = rbt.src_local.shape[2]
    for i in range(dp):
        F_loc, G_loc = F[i * rows : (i + 1) * rows], G[i * rows : (i + 1) * rows]
        for r in range(dp):
            j = (i + r) % dp
            F_rot = F[j * rows : (j + 1) * rows]
            td = TilesDev(
                src_local=jnp.asarray(rbt.src_local[i, r].reshape(nt, 1, TILE)),
                dst=jnp.asarray(rbt.dst_local[i, r]),
                mask=jnp.asarray(rbt.mask[i, r].reshape(nt, 1, TILE)),
                block_id=jnp.asarray(rbt.block_id[i, r]),
                block_b=BLOCK, tile_t=TILE, n_blocks=rbt.n_blocks,
            )
            gn_j, ln_j = _grad_blocks_fused(
                jnp.asarray(F_loc), td, jcfg, jnp.asarray(F_rot), interpret=True
            )
            cb_j = _cand_blocks_fused(
                jnp.asarray(F_loc), jnp.asarray(G_loc), td, jcfg,
                jnp.asarray(F_rot), interpret=True,
            )
            bucket = device_csr(*ours[i][r], CPU)
            Ft, Rt = torch.as_tensor(F_loc), torch.as_tensor(F_rot)
            gn, ln = torch.zeros(rows, k), torch.zeros(rows)
            assert rk.ring_grad_phase(Ft, Rt, bucket, gn, ln, cfg) == (gn, ln)
            cb = torch.zeros(num_s, rows)
            assert rk.ring_cand_phase(Ft, torch.as_tensor(G_loc), Rt, bucket, cb, cfg) is cb
            np.testing.assert_allclose(
                gn.numpy(), np.asarray(gn_j).reshape(rows, k), rtol=RTOL, atol=ATOL
            )
            np.testing.assert_allclose(
                ln.numpy(), np.asarray(ln_j).reshape(rows), rtol=RTOL, atol=ATOL
            )
            np.testing.assert_allclose(
                cb.numpy(),
                np.asarray(cb_j).transpose(1, 0, 2).reshape(num_s, rows),
                rtol=RTOL, atol=ATOL,
            )


def test_plain_phase_adds_to_the_accumulators():
    """A phase adds its partials to what the accumulators hold (the ring's
    `gn_acc + gn`), and an empty bucket adds zeros."""
    g = _port_graph(_path_graph())
    dp, n_pad, k = 3, 12, 5
    host = ring_shard_edges(g, dp, n_pad)
    cfg = BigClamConfig(num_communities=k)
    rng = np.random.default_rng(0)
    F = torch.as_tensor(rng.uniform(0.1, 1.0, (4, k)), dtype=torch.float32)
    R = torch.as_tensor(rng.uniform(0.1, 1.0, (4, k)), dtype=torch.float32)
    G = torch.as_tensor(rng.uniform(-1, 1, (4, k)), dtype=torch.float32)
    for indptr, indices in (host[0][1], host[0][2]):
        b = device_csr(indptr, indices, CPU)
        gn0, ln0, cb0 = torch.rand(4, k), torch.rand(4), torch.rand(16, 4)
        pg, pl = rk.ring_grad_phase_plain(F, R, b, torch.zeros(4, k), torch.zeros(4), cfg)
        pc = rk.ring_cand_phase_plain(F, G, R, b, torch.zeros(16, 4), cfg)
        gn, ln = rk.ring_grad_phase_plain(F, R, b, gn0.clone(), ln0.clone(), cfg)
        cb = rk.ring_cand_phase_plain(F, G, R, b, cb0.clone(), cfg)
        assert torch.equal(gn, gn0 + pg) and torch.equal(ln, ln0 + pl)
        assert torch.equal(cb, cb0 + pc)
        if len(indices) == 0:
            assert not pg.any() and not pl.any() and not pc.any()


# --- trajectories ------------------------------------------------------------


def _jax_llhs_and_F(model, F0, steps):
    st = model.init_state(F0)
    llhs = []
    for _ in range(steps):
        st = model._step(st)
        llhs.append(float(st.llh))
    return llhs, model.extract_F(st)


def _port_llhs_and_F(model, F0, steps):
    st = model.init_state(F0)
    llhs = []
    for _ in range(steps):
        st = model._step(st)
        llhs.append(float(st.llh))
    return llhs, model.extract_F(st), st


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_ring_xla_float64_matches_jax(dp):
    g = _random_graph(2)
    k = 6
    jcfg = JaxConfig(num_communities=k, dtype="float64", max_iters=4, conv_tol=0.0)
    F0 = np.random.default_rng(0).uniform(0.1, 1.0, (g.num_nodes, k))
    jm = JaxRing(g, jcfg, _jax_mesh(dp), balance=False)
    pm = RingBigClamModel(
        _port_graph(g), BigClamConfig(**dataclasses.asdict(jcfg)), _cpu_mesh(dp),
        balance=False,
    )
    assert jm.engaged_path == pm.engaged_path == "xla"
    assert pm.n_pad == jm.n_pad
    jl, jF = _jax_llhs_and_F(jm, F0, 4)
    pl, pF, _ = _port_llhs_and_F(pm, F0, 4)
    np.testing.assert_allclose(pl, jl, rtol=1e-10)
    np.testing.assert_allclose(pF, jF, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dp", [2, 4])
def test_ring_csr_fused_matches_jax_interpret(dp):
    """`csr_ring_fused` on the plain versions of #8/#9 against the JAX
    `csr_ring_fused` in interpret mode, from the same (N, K) F0 (the two
    packages pad n differently, so rows are compared in original ids)."""
    g = _random_graph(0)
    k = 6
    jcfg = JaxConfig(
        num_communities=k, edge_chunk=64, use_pallas_csr=True,
        pallas_interpret=True, csr_block_b=BLOCK, csr_tile_t=TILE,
    )
    jm = JaxRing(g, jcfg, _jax_mesh(dp))
    assert jm.engaged_path == "csr_ring_fused"
    pm = RingBigClamModel(
        _port_graph(g), BigClamConfig(num_communities=k, use_pallas_csr=True),
        _cpu_mesh(dp),
    )
    assert pm.engaged_path == "csr_ring_fused" and pm.path_reason == ""
    assert (pm._perm is None) == (jm._perm is None)
    F0 = np.random.default_rng(1).uniform(0.0, 1.0, (g.num_nodes, k))
    jl, jF = _jax_llhs_and_F(jm, F0, 3)
    pl, pF, _ = _port_llhs_and_F(pm, F0, 3)
    np.testing.assert_allclose(pF, jF, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)


def test_ring_shard_invariance_and_serial_schedule():
    """dp = 4 ring (xla, float64) against the port's single-device model
    at 1e-10; the serial rotation equals the overlapped one bit for bit, on
    the plain `xla` phases and on the `csr_ring` ones."""
    g = _port_graph(_random_graph(4))
    k = 5
    cfg = BigClamConfig(num_communities=k, dtype="float64", max_iters=4, conv_tol=0.0)
    F0 = np.random.default_rng(2).uniform(0.1, 1.0, (g.num_nodes, k))
    ref = BigClamModel(g, cfg, device="cpu").fit(F0)
    ring = RingBigClamModel(g, cfg, _cpu_mesh(4), balance=False).fit(F0)
    np.testing.assert_allclose(ring.llh_history, ref.llh_history, rtol=1e-10)
    np.testing.assert_allclose(ring.F, ref.F, rtol=1e-10, atol=1e-10)
    for extra in ({}, {"use_pallas_csr": True, "csr_fused": False, "dtype": "float32"}):
        on = RingBigClamModel(g, cfg.replace(**extra), _cpu_mesh(4), balance=False)
        off = RingBigClamModel(
            g, cfg.replace(ring_overlap=False, **extra), _cpu_mesh(4), balance=False
        )
        assert on.engaged_path == off.engaged_path
        _, _, s_on = _port_llhs_and_F(on, F0, 3)
        _, _, s_off = _port_llhs_and_F(off, F0, 3)
        assert torch.equal(s_on.llh, s_off.llh)
        assert all(torch.equal(a, b) for a, b in zip(s_on.F, s_off.F))


def test_balanced_ring_returns_original_ids():
    """A balanced ring fit returns F in original ids, equal to the
    unbalanced fit's (float64); balance=None relabels a locality-ordered
    graph by itself, as the JAX ring does."""
    from bigclam_tpu.models.agm import sample_planted_graph as jax_planted

    jg, _ = jax_planted(96, 4, p_in=0.4, rng=np.random.default_rng(5))
    g = _port_graph(jg)
    k = 4
    cfg = BigClamConfig(num_communities=k, dtype="float64", max_iters=4, conv_tol=0.0)
    F0 = np.random.default_rng(3).uniform(0.1, 1.0, (g.num_nodes, k))
    plain = RingBigClamModel(g, cfg, _cpu_mesh(4), balance=False)
    bal = RingBigClamModel(g, cfg, _cpu_mesh(4), balance=True)
    auto = RingBigClamModel(g, cfg, _cpu_mesh(4))
    assert plain._perm is None and bal._perm is not None
    jauto = JaxRing(jg, JaxConfig(**dataclasses.asdict(cfg)), _jax_mesh(4))
    assert (auto._perm is None) == (jauto._perm is None)
    a, b = plain.fit(F0), bal.fit(F0)
    np.testing.assert_allclose(b.llh_history, a.llh_history, rtol=1e-10)
    np.testing.assert_allclose(b.F, a.F, rtol=1e-10, atol=1e-10)


# --- the CLI -----------------------------------------------------------------


def _cli_json(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def edge_file(tmp_path_factory):
    from bigclam_tpu.models.agm import sample_planted_graph as jax_planted

    g, _ = jax_planted(120, 6, p_in=0.35, rng=np.random.default_rng(11))
    path = tmp_path_factory.mktemp("ring") / "g.txt"
    keep = g.src < g.dst
    np.savetxt(path, np.stack([g.src[keep], g.dst[keep]], axis=1), fmt="%d")
    return str(path)


def test_cli_fit_ring_mesh_matches_jax_cli(edge_file):
    argv = ["fit", "--graph", edge_file, "--k", "6", "--max-iters", "5",
            "--dtype", "float64", "--mesh", "2,1", "--schedule", "ring"]
    out = _cli_json(cli.main, argv + ["--device", "cpu"])
    assert out["kernel_path"] == "xla" and out["mesh"] == "2x1"
    ref = _cli_json(jax_main, argv + ["--csr-kernels", "off", "--quiet"])
    assert ref["kernel_path"] == "xla" and ref["mesh"] == "2x1"
    assert out["iters"] == ref["iters"]
    np.testing.assert_allclose(out["llh"], ref["llh"], rtol=1e-10)
    # without --mesh, --schedule is ignored: the single-device fit
    single = _cli_json(cli.main, ["fit", "--graph", edge_file, "--k", "6",
                                  "--max-iters", "5", "--dtype", "float64",
                                  "--device", "cpu", "--schedule", "ring"])
    assert "mesh" not in single and single["kernel_path"] == "xla"
    np.testing.assert_allclose(single["llh"], out["llh"], rtol=1e-10)


@pytest.mark.parametrize(
    "extra, error, words",
    [
        (["--mesh", "2,1", "--distributed", "--partition", "2d"], SystemExit,
         "--partition 2d is single-controller for now"),
        (["--mesh", "2,1", "--representation", "sparse"], SystemExit,
         "--schedule ring is not supported with --representation sparse"),
        (["--mesh", "1,2", "--representation", "sparse"], SystemExit,
         "--schedule ring is not supported with --representation sparse"),
    ],
)
def test_cli_mesh_refusals(edge_file, extra, error, words):
    """What a mesh still refuses by name: --distributed with the 2D
    partition (the JAX CLI's refusal; --distributed itself runs:
    tests/test_torch_multihost.py), and on a sparse mesh the ring schedule,
    with the JAX CLI's words (the sparse exchange is an all-gather of the
    member rows). A K-sharded mesh and K above 1,024 on a mesh, refused
    here before the TP split, run: test_cli_fit_k_sharded_and_k_blocked_meshes;
    the sparse mesh itself: tests/test_torch_sparse_sharded.py."""
    argv = ["fit", "--graph", edge_file, "--max-iters", "2", "--device", "cpu",
            "--schedule", "ring"]
    if "--k" not in extra:
        argv += ["--k", "6"]
    with pytest.raises(error, match=words):
        cli.main(argv + extra)


@pytest.mark.parametrize("schedule", ["allgather", "ring"])
def test_cli_fit_k_sharded_and_k_blocked_meshes(edge_file, schedule):
    """`fit --mesh 2,2` (float64 `xla`, the TP split on the plain versions)
    equals the single-device fit at 1e-10; `--mesh 2,1 --k 1100` with the
    kernels asked for on the CPU takes the K-blocked mesh path (K_loc 1,152
    in 2 windows of 576)."""
    base = ["fit", "--graph", edge_file, "--max-iters", "3", "--device", "cpu",
            "--schedule", schedule]
    single = _cli_json(cli.main, ["fit", "--graph", edge_file, "--k", "6",
                                  "--max-iters", "3", "--dtype", "float64",
                                  "--device", "cpu"])
    out = _cli_json(cli.main, base + ["--k", "6", "--dtype", "float64",
                                      "--mesh", "2,2"])
    assert out["kernel_path"] == "xla" and out["mesh"] == "2x2"
    np.testing.assert_allclose(out["llh_history"], single["llh_history"], rtol=1e-10)
    kb = _cli_json(cli.main, base + ["--k", "1100", "--mesh", "2,1",
                                     "--csr-kernels", "on"])
    want = "csr_ring_fused_kb" if schedule == "ring" else "csr_fused_kb"
    assert kb["kernel_path"] == want and kb["mesh"] == "2x1"
    assert all(np.isfinite(kb["llh_history"]))


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [37, 1024])
def test_cuda_ring_kernels_match_plain(k, cuda_device):
    g = _port_graph(_path_graph(40, 3))
    dp = 3
    n_pad = -(-g.num_nodes // dp) * dp
    rows = n_pad // dp
    host = ring_shard_edges(g, dp, n_pad)
    cfg = BigClamConfig(num_communities=k)
    rng = np.random.default_rng(k)
    F = torch.as_tensor(rng.uniform(0.0, 1.0, (n_pad, k)), dtype=torch.float32)
    G = torch.as_tensor(rng.uniform(-1.5, 1.5, (n_pad, k)), dtype=torch.float32)
    rank = rng.permutation(rows)      # a stand-in pre-balance rank
    for i in range(dp):
        for r in range(dp):
            j = (i + r) % dp
            args = (F[i * rows : (i + 1) * rows], F[j * rows : (j + 1) * rows])
            acc = (torch.rand(rows, k), torch.rand(rows))
            gp, lp = rk.ring_grad_phase(*args, device_csr(*host[i][r], CPU),
                                        acc[0].clone(), acc[1].clone(), cfg)
            gk, lk = rk.ring_grad_phase(
                *(t.contiguous().to(cuda_device) for t in args),
                device_csr(*host[i][r], cuda_device),
                *(t.to(cuda_device) for t in acc), cfg,
            )
            # the bucket with each visit order: the same bits as without one
            for how in VISIT_ORDERS:
                order = torch.as_tensor(visit_order(*host[i][r], how, rank),
                                        device=cuda_device)
                go, lo = rk.ring_grad_phase(
                    *(t.contiguous().to(cuda_device) for t in args),
                    device_csr(*host[i][r], cuda_device)._replace(order=order),
                    *(t.to(cuda_device) for t in acc), cfg,
                )
                assert torch.equal(go, gk) and torch.equal(lo, lk), how
            cb0 = torch.rand(16, rows)
            cp = rk.ring_cand_phase(args[0], G[i * rows : (i + 1) * rows], args[1],
                                    device_csr(*host[i][r], CPU), cb0.clone(), cfg)
            ck = rk.ring_cand_phase(
                args[0].contiguous().to(cuda_device),
                G[i * rows : (i + 1) * rows].contiguous().to(cuda_device),
                args[1].contiguous().to(cuda_device),
                device_csr(*host[i][r], cuda_device), cb0.to(cuda_device), cfg,
            )
            torch.cuda.synchronize()
            for got, want in ((gk, gp), (lk, lp), (ck, cp)):
                np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                           rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_cuda_ring_over_two_cards_matches_one(cuda_device):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    g = _port_graph(_random_graph(0, n=400, p=0.05))
    cfg = BigClamConfig(num_communities=40, max_iters=3, conv_tol=0.0)
    F0 = np.random.default_rng(0).uniform(0.0, 1.0, (g.num_nodes, 40))
    two = RingBigClamModel(g, cfg, make_mesh((2, 1), ["cuda:0", "cuda:1"]),
                           balance=False)
    one = RingBigClamModel(g, cfg, make_mesh((2, 1), ["cuda:0"] * 2), balance=False)
    a, b = two.fit(F0), one.fit(F0)
    assert a.llh_history == b.llh_history
    np.testing.assert_array_equal(a.F, b.F)
