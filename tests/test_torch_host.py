"""The port's host code is bit-identical to the JAX package's: ingest,
the AGM samplers, the {0,1} initializers, conductance seeding, extraction
and evaluation; and the port's `cli fit --device cpu` prints the JAX
`fit` keys."""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from bigclam_tpu import evaluation as jev
from bigclam_tpu.config import BigClamConfig as JaxConfig
from bigclam_tpu.graph import ingest as jing
from bigclam_tpu.models import agm as jagm
from bigclam_tpu.models.bigclam import random_init_F as j_random_init_F
from bigclam_tpu.models.bigclam import rowkeyed_init_F as j_rowkeyed_init_F
from bigclam_tpu.ops import extraction as jext
from bigclam_tpu.ops import seeding as jseed

from bigclam_tpu_torch import cli
from bigclam_tpu_torch import evaluation as pev
from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph import ingest as ping
from bigclam_tpu_torch.models import agm as pagm
from bigclam_tpu_torch.models.bigclam import random_init_F, rowkeyed_init_F
from bigclam_tpu_torch.ops import extraction as pext
from bigclam_tpu_torch.ops import seeding as pseed

torch.set_num_threads(2)


def _same_graph(a, b):
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.raw_ids, b.raw_ids)
    assert a.indptr.dtype == b.indptr.dtype and a.indices.dtype == b.indices.dtype


@pytest.fixture(scope="module")
def planted():
    """(jax graph, port graph, truth) for one planted draw."""
    gj, tj = jagm.sample_planted_graph(240, 10, p_in=0.3, rng=np.random.default_rng(4))
    gp, tp = pagm.sample_planted_graph(240, 10, p_in=0.3, rng=np.random.default_rng(4))
    assert tj == tp
    return gj, gp, tp


def test_edge_list_ingest_is_bit_identical(tmp_path):
    path = tmp_path / "g.txt"
    path.write_text(
        "# comment\n# FromNodeId\tToNodeId\n"
        "10\t20\n20\t10\n30 10\n\n40\t40\n50\t30\n  # indented comment\n30\t50\n7 99\n"
    )
    pj, pp = jing.load_edge_list(str(path)), ping.load_edge_list(str(path))
    np.testing.assert_array_equal(pp, pj)
    _same_graph(ping.build_graph(str(path)), jing.build_graph(str(path)))
    pairs = np.random.default_rng(0).integers(0, 50, (300, 2))
    _same_graph(ping.graph_from_edges(pairs), jing.graph_from_edges(pairs))
    _same_graph(
        ping.graph_from_edges(pairs, num_nodes=60),
        jing.graph_from_edges(pairs, num_nodes=60),
    )
    bad = tmp_path / "bad.txt"
    bad.write_text("1 2\n3\n")
    with pytest.raises(ValueError, match="even number"):
        ping.load_edge_list(str(bad))


def test_agm_samplers_are_bit_identical(planted):
    gj, gp, _ = planted
    _same_graph(gp, gj)
    Fj, tj = jagm.planted_partition_F(60, 6, overlap=2)
    Fp, tp = pagm.planted_partition_F(60, 6, overlap=2)
    np.testing.assert_array_equal(Fp, Fj)
    assert tp == tj
    _same_graph(
        pagm.sample_graph(Fp, np.random.default_rng(2)),
        jagm.sample_graph(Fj, np.random.default_rng(2)),
    )
    gj2, tj2 = jagm.sample_planted_graph(90, 6, overlap=3, rng=np.random.default_rng(9))
    gp2, tp2 = pagm.sample_planted_graph(90, 6, overlap=3, rng=np.random.default_rng(9))
    _same_graph(gp2, gj2)
    assert tp2 == tj2


def test_initializers_are_bit_identical(planted):
    gj, gp, _ = planted
    jc, pc = JaxConfig(num_communities=7, seed=3), BigClamConfig(num_communities=7, seed=3)
    np.testing.assert_array_equal(random_init_F(gp, pc), j_random_init_F(gj, jc))
    np.testing.assert_array_equal(rowkeyed_init_F(gp, pc), j_rowkeyed_init_F(gj, jc))
    np.testing.assert_array_equal(
        rowkeyed_init_F(gp, pc, seed=11), j_rowkeyed_init_F(gj, jc, seed=11)
    )


@pytest.mark.parametrize("dp, n_pad", [(2, 240), (3, 243), (4, 256), (8, 240)])
def test_balance_relabeling_is_bit_identical(planted, dp, n_pad):
    """parallel/balance.py's copy: the same permutation and relabeled
    graph (Graph.permute) as the JAX `balance_graph` for the same
    (g, dp, n_pad)."""
    from bigclam_tpu.parallel.balance import balance_graph as j_balance_graph
    from bigclam_tpu_torch.parallel.balance import balance_graph

    gj, gp, _ = planted
    hj, pj = j_balance_graph(gj, dp, n_pad)
    hp, pp = balance_graph(gp, dp, n_pad)
    np.testing.assert_array_equal(pp, pj)
    assert pp.dtype == pj.dtype
    _same_graph(hp, hj)


def test_conductance_and_seeds_are_bit_identical(planted):
    gj, gp, _ = planted
    np.testing.assert_array_equal(pseed.triangle_counts(gp), jseed.triangle_counts(gj))
    phi_p = pseed.conductance(gp)
    np.testing.assert_array_equal(phi_p, jseed.conductance(gj, backend="numpy"))
    np.testing.assert_array_equal(phi_p, jseed.conductance(gj))     # auto
    jc, pc = JaxConfig(num_communities=10), BigClamConfig(num_communities=10)
    np.testing.assert_array_equal(pseed.rank_seeds(gp, phi_p, pc), jseed.rank_seeds(gj, phi_p, jc))
    seeds_p = pseed.conductance_seeds(gp, pc)
    np.testing.assert_array_equal(seeds_p, jseed.conductance_seeds(gj, jc))
    np.testing.assert_array_equal(
        pseed.init_F(gp, seeds_p, pc), jseed.init_F(gj, seeds_p, jc)
    )
    # more communities than seeds: the random tail columns agree too
    jc40 = JaxConfig(num_communities=400, seed=2)
    pc40 = BigClamConfig(**dataclasses.asdict(jc40))
    np.testing.assert_array_equal(
        pseed.init_F(gp, seeds_p, pc40), jseed.init_F(gj, seeds_p, jc40)
    )
    jcx = JaxConfig(num_communities=10, seed_exclusion=True)
    pcx = BigClamConfig(**dataclasses.asdict(jcx))
    np.testing.assert_array_equal(
        pseed.conductance_seeds(gp, pcx), jseed.conductance_seeds(gj, jcx)
    )


def test_isolated_nodes_rank_at_the_sentinel():
    pairs = np.array([[0, 1], [1, 2], [2, 0], [3, 4]])
    gj = jing.graph_from_edges(pairs, num_nodes=7)
    gp = ping.graph_from_edges(pairs, num_nodes=7)
    phi = pseed.conductance(gp)
    np.testing.assert_array_equal(phi, jseed.conductance(gj, backend="numpy"))
    np.testing.assert_array_equal(
        pseed.rank_seeds(gp, phi), jseed.rank_seeds(gj, phi)
    )


def test_extraction_and_scores_are_bit_identical(planted):
    gj, gp, truth = planted
    F = np.random.default_rng(8).exponential(0.3, (gp.num_nodes, 10))
    F[3] = 0.0                                   # all-zero row: every column
    F[4, :2] = F[4].max() + 1.0                  # a tie on the row max
    assert pext.delta_threshold(gp.num_nodes, gp.num_edges) == jext.delta_threshold(
        gj.num_nodes, gj.num_edges
    )
    cp, cj = pext.extract_communities(F, gp), jext.extract_communities(F, gj)
    assert cp == cj
    pred = list(cp.values())
    assert pev.avg_f1(pred, truth) == jev.avg_f1(pred, truth)
    assert pev.overlapping_nmi(pred, truth) == jev.overlapping_nmi(pred, truth)


def test_communities_round_trip(tmp_path, planted):
    _, gp, truth = planted
    com = {i: sorted(c) for i, c in enumerate(truth)}
    path = str(tmp_path / "c.txt")
    pext.save_communities(path, com)
    assert pext.load_communities(path) == jext.load_communities(path)
    assert pext.load_communities(path) == [com[i] for i in sorted(com)]
    assert pev.avg_f1(pext.load_communities(path), truth) == 1.0


def _cli_json(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_fit_cpu_prints_the_fit_keys_and_matches_jax_fit(tmp_path, planted):
    """`cli fit --device cpu` on a planted edge list: the JAX `fit` keys,
    path `xla` under auto, and — in float64 — the JAX CLI's LLH,
    iteration count and communities."""
    from bigclam_tpu.cli import main as jax_main

    _, gp, truth = planted
    path = tmp_path / "g.txt"
    keep = gp.src < gp.dst
    np.savetxt(path, np.stack([gp.src[keep], gp.dst[keep]], axis=1), fmt="%d")
    argv = ["fit", "--graph", str(path), "--k", "10", "--max-iters", "30",
            "--dtype", "float64"]
    out = _cli_json(cli.main, argv + ["--device", "cpu",
                                      "--out", str(tmp_path / "p.txt")])
    for key in ("llh", "iters", "n", "edges", "k", "representation",
                "kernel_path", "kernel_path_reason", "partition",
                "sec_per_iter", "device_kind"):
        assert key in out, key
    assert out["kernel_path"] == "xla" and out["device_kind"] == "cpu"
    assert out["n"] == gp.num_nodes and out["edges"] == gp.num_edges
    assert out["representation"] == "dense" and out["partition"] == "1d"
    assert out["llh_history"][-1] >= out["llh_history"][0]
    ref = _cli_json(jax_main, argv + ["--csr-kernels", "off", "--quiet",
                                      "--out", str(tmp_path / "j.txt")])
    assert ref["kernel_path"] == out["kernel_path"]
    assert out["iters"] == ref["iters"]
    np.testing.assert_allclose(out["llh"], ref["llh"], rtol=1e-9)
    assert pext.load_communities(str(tmp_path / "p.txt")) == jext.load_communities(
        str(tmp_path / "j.txt")
    )
    assert out["communities"] == ref["communities"]


def test_cli_fit_without_k_trains_at_the_jax_default(tmp_path, planted):
    """`fit --graph g.txt` with no `--k` trains at K = 100 in both CLIs
    (the JAX CLI's default), with equal float64 LLH histories."""
    from bigclam_tpu.cli import main as jax_main

    _, gp, _ = planted
    path = tmp_path / "g.txt"
    keep = gp.src < gp.dst
    np.savetxt(path, np.stack([gp.src[keep], gp.dst[keep]], axis=1), fmt="%d")
    argv = ["fit", "--graph", str(path), "--max-iters", "3", "--dtype", "float64"]
    assert cli.build_parser().parse_args(argv).k == 100
    out = _cli_json(cli.main, argv + ["--device", "cpu"])
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        ref = _cli_json(jax_main, argv + ["--csr-kernels", "off"])
    # the JAX CLI logs one JSON line per iteration on stderr
    ref_hist = [json.loads(ln)["llh"] for ln in err.getvalue().splitlines()
                if ln.startswith("{") and '"iter"' in ln]
    assert out["k"] == ref["k"] == 100
    assert len(out["llh_history"]) == len(ref_hist) == 4
    np.testing.assert_allclose(out["llh_history"], ref_hist, rtol=1e-9)


def test_export_gexf_writes_the_jax_bytes(tmp_path, planted):
    """utils/viz.py is a copy: the same graph, communities and F (with a
    zero row, a tie on a row max and a node in no community) give the JAX
    writer's bytes, with F and without, and under the node cap."""
    from bigclam_tpu.utils.viz import export_gexf as jax_export

    from bigclam_tpu_torch.utils.viz import export_gexf

    gj, gp, _ = planted
    F = np.random.default_rng(8).exponential(0.3, (gp.num_nodes, 10))
    F[3] = 0.0
    F[4, :2] = F[4].max() + 1.0
    com = pext.extract_communities(F, gp)
    com[0] = [u for u in com[0] if u != 7]
    for kw in ({"F": F}, {}, {"F": F, "max_nodes": 100, "max_edges": 200}):
        ours, ref = tmp_path / "p.gexf", tmp_path / "j.gexf"
        export_gexf(str(ours), gp, communities=com, **kw)
        jax_export(str(ref), gj, communities=com, **kw)
        assert ours.read_bytes() == ref.read_bytes()


def test_cli_fit_export_gexf_matches_the_jax_cli(tmp_path, planted):
    """`fit --export-gexf` in float64 on the CPU: the file is the JAX
    writer's bytes for the fit's F (saved beside it), and against the JAX
    CLI's file the nodes, edges and membership counts are equal; the
    primary community (argmax F) may differ only at a near-tie of F."""
    import re

    from bigclam_tpu.cli import main as jax_main
    from bigclam_tpu.utils.viz import export_gexf as jax_export

    gj, gp, _ = planted
    path = tmp_path / "g.txt"
    keep = gp.src < gp.dst
    np.savetxt(path, np.stack([gp.src[keep], gp.dst[keep]], axis=1), fmt="%d")
    argv = ["fit", "--graph", str(path), "--k", "10", "--max-iters", "30",
            "--dtype", "float64", "--quiet"]
    out = _cli_json(cli.main, argv + ["--device", "cpu", "--export-gexf",
                                      str(tmp_path / "p.gexf"), "--save-f",
                                      str(tmp_path / "f.npy")])
    ref = _cli_json(jax_main, argv + ["--csr-kernels", "off", "--export-gexf",
                                      str(tmp_path / "j.gexf")])
    assert out["export_gexf"] == str(tmp_path / "p.gexf")
    assert ref["export_gexf"] == str(tmp_path / "j.gexf")
    F = np.load(tmp_path / "f.npy")
    g_file = jing.build_graph(str(path))
    jax_export(str(tmp_path / "w.gexf"), g_file,
               communities=jext.extract_communities(F, g_file), F=F)
    ours = (tmp_path / "p.gexf").read_bytes()
    assert ours == (tmp_path / "w.gexf").read_bytes()
    node = re.compile(rb'<node id="(\d+)".*?value="(-?\d+)".*?value="(\d+)"')
    a = node.findall(ours)
    b = node.findall((tmp_path / "j.gexf").read_bytes())
    assert len(a) == len(b) == gp.num_nodes
    assert ours.count(b"<edge ") == (tmp_path / "j.gexf").read_bytes().count(b"<edge ")
    assert [(u, m) for u, _, m in a] == [(u, m) for u, _, m in b]
    for (u, ca, _), (_, cb, _) in zip(a, b):
        if ca != cb:
            row = np.sort(F[int(u)])
            assert row[-1] - row[-2] <= 1e-6 * row[-1], (u, row[-2:])
