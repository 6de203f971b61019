"""The port's K sweep (models.model_selection, `cli sweep`) and `cli eval`
against the JAX package: the K grid with the reference's integer-division
quirks, `sweep_k` in float64 on the dense and the sparse trainer (same
grid and chosen K, LLH per K at rtol 1e-10), the sweep_state.json journal
read across the two packages, resume and its rng invariance, mesh and 2D
sweeps against the single device's, and the CLI JSON keys."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from bigclam_tpu.cli import main as jax_main
from bigclam_tpu.config import BigClamConfig as JaxConfig
from bigclam_tpu.graph.ingest import graph_from_edges as jax_graph_from_edges
from bigclam_tpu.models.agm import planted_partition_F, sample_graph
from bigclam_tpu.models.bigclam import BigClamModel as JaxModel
from bigclam_tpu.models.model_selection import build_kset as jax_build_kset
from bigclam_tpu.models.model_selection import sweep_k as jax_sweep_k
from bigclam_tpu.models.sparse import SparseBigClamModel as JaxSparseModel

from bigclam_tpu_torch import cli
from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.models.bigclam import BigClamModel
from bigclam_tpu_torch.models.model_selection import build_kset, sweep_k
from bigclam_tpu_torch.models.sparse import SparseBigClamModel
from bigclam_tpu_torch.ops import seeding
from bigclam_tpu_torch.parallel import (
    ShardedBigClamModel,
    TwoDShardedBigClamModel,
    make_mesh,
    make_mesh_2d,
    twod_mesh_shape,
)

torch.set_num_threads(2)


def _port_graph(g):
    return Graph(indptr=g.indptr, indices=g.indices, raw_ids=g.raw_ids)


@pytest.mark.parametrize(
    "args,want",
    [
        # the pasted run artifact at bigclam4-7.scala:268
        ((50, 200, 15), [50, 54, 59, 64, 70, 76, 83, 91, 99, 108, 118, 129,
                         141, 154, 168, 184, 200]),
        ((1000, 9000, 100), None),     # the default grid: checked by property
        ((5, 10, 1000), [5, 6, 7, 8, 9, 10]),     # stuck walk bumps by 1
        ((7, 9, 100), [7, 8, 9]),                 # ratio 1: a pure +1 walk
    ],
)
def test_build_kset_matches_jax(args, want):
    ks = build_kset(*args)
    assert ks == jax_build_kset(*args)
    if want is not None:
        assert ks == want
    assert ks[0] == args[0] and ks[-1] == args[1]
    assert all(b > a for a, b in zip(ks, ks[1:]))


def test_build_kset_refuses_bad_bounds():
    with pytest.raises(ValueError):
        build_kset(0, 5, 2)
    with pytest.raises(ValueError):
        build_kset(6, 5, 2)


@pytest.fixture(scope="module")
def planted():
    """tests/test_model_selection.py's planted sweep graph (4 blocks)."""
    Fp, _ = planted_partition_F(48, 4, strength=2.0)
    return sample_graph(Fp, rng=np.random.default_rng(11))


def _sweep_cfg(**kw):
    base = dict(num_communities=8, dtype="float64", max_iters=40,
                min_com=2, max_com=8, div_com=4, ksweep_tol=1e-3)
    base.update(kw)
    return base


def _same_sweep(got, want):
    assert got.kset == want.kset
    assert got.chosen_k == want.chosen_k
    assert sorted(got.llh_by_k) == sorted(want.llh_by_k)
    for k in want.llh_by_k:
        np.testing.assert_allclose(got.llh_by_k[k], want.llh_by_k[k], rtol=1e-10)


@pytest.mark.parametrize("caller_rng", [False, True])
def test_dense_sweep_matches_jax(planted, caller_rng):
    kw = _sweep_cfg()
    rng = (lambda: np.random.default_rng(5)) if caller_rng else (lambda: None)
    want = jax_sweep_k(planted, JaxConfig(**kw), rng=rng())
    got = sweep_k(_port_graph(planted), BigClamConfig(**kw), rng=rng(), device="cpu")
    assert len(got.llh_by_k) >= 2
    _same_sweep(got, want)
    np.testing.assert_allclose(
        got.best_fit.F, np.asarray(want.best_fit.F)[: planted.num_nodes, :8], rtol=1e-10
    )


def test_sparse_sweep_matches_jax(planted):
    kw = _sweep_cfg(representation="sparse", sparse_m=3, max_iters=10)
    pg = _port_graph(planted)
    want = jax_sweep_k(planted, JaxConfig(**kw),
                       model_factory=lambda c: JaxSparseModel(planted, c))
    got = sweep_k(pg, BigClamConfig(**kw),
                  model_factory=lambda c: SparseBigClamModel(pg, c, device="cpu"))
    assert len(got.llh_by_k) >= 2
    _same_sweep(got, want)


class _Counting:
    """Counts the fits a sweep runs through a model factory."""

    def __init__(self, make):
        self.make, self.fits = make, 0

    def __call__(self, cfg):
        model = self.make(cfg)
        fit = model.fit

        def counted(*a, **kw):
            self.fits += 1
            return fit(*a, **kw)

        model.fit = counted
        return model


def test_journal_is_shared_with_jax(planted, tmp_path):
    kw = _sweep_cfg(max_iters=8)
    pg = _port_graph(planted)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    ref = jax_sweep_k(planted, JaxConfig(**kw), state_dir=jdir)
    # the port reads the JAX journal: nothing trains
    port_count = _Counting(lambda c: BigClamModel(pg, c, device="cpu"))
    got = sweep_k(pg, BigClamConfig(**kw), model_factory=port_count, state_dir=jdir)
    assert port_count.fits == 0
    assert got.llh_by_k == ref.llh_by_k and got.chosen_k == ref.chosen_k
    # the JAX package reads the port's journal: nothing trains
    own = sweep_k(pg, BigClamConfig(**kw), state_dir=pdir, device="cpu")
    _same_sweep(own, ref)
    jax_count = _Counting(lambda c: JaxModel(planted, c))
    again = jax_sweep_k(planted, JaxConfig(**kw), model_factory=jax_count,
                        state_dir=pdir)
    assert jax_count.fits == 0
    assert again.llh_by_k == own.llh_by_k
    with open(tmp_path / "port" / "sweep_state.json") as f:
        assert set(json.load(f)) == {str(k) for k in own.llh_by_k}


def test_second_run_trains_nothing_and_resume_false_retrains(planted, tmp_path):
    kw = _sweep_cfg(max_iters=8)
    pg = _port_graph(planted)
    d = str(tmp_path / "s")
    first = sweep_k(pg, BigClamConfig(**kw), state_dir=d, device="cpu")
    count = _Counting(lambda c: BigClamModel(pg, c, device="cpu"))
    second = sweep_k(pg, BigClamConfig(**kw), model_factory=count, state_dir=d)
    assert count.fits == 0 and second.llh_by_k == first.llh_by_k
    assert second.best_fit is None
    cold = sweep_k(pg, BigClamConfig(**kw), model_factory=count, state_dir=d,
                   resume=False)
    assert count.fits == len(first.llh_by_k)
    assert cold.llh_by_k == first.llh_by_k
    assert not (tmp_path / "s" / "sweep_state.json.tmp").exists()


def test_resume_mid_grid_equals_uninterrupted_run(tmp_path):
    """tests/test_model_selection.py:103: |seeds| < K, so every K draws
    Bernoulli padding columns; per-K generators make a resumed sweep equal
    the uninterrupted one exactly."""
    edges = [(i, j) for i in range(10) for j in range(i + 1, 10)]
    g = _port_graph(jax_graph_from_edges(edges, num_nodes=10))
    cfg = BigClamConfig(num_communities=6, dtype="float64", max_iters=6,
                        conv_tol=0.0, min_com=3, max_com=6, div_com=2,
                        ksweep_tol=0.0)
    assert len(seeding.conductance_seeds(g, cfg)) < cfg.min_com
    ref = sweep_k(g, cfg, device="cpu")
    (tmp_path / "sweep_state.json").write_text(
        json.dumps({str(ref.kset[0]): ref.llh_by_k[ref.kset[0]]})
    )
    resumed = sweep_k(g, cfg, state_dir=str(tmp_path), device="cpu")
    assert resumed.chosen_k == ref.chosen_k
    assert resumed.llh_by_k == ref.llh_by_k


@pytest.mark.parametrize(
    "kw,annealing",
    [({"quality_mode": True, "mesh_shape": (2, 1)}, False),
     ({"quality_mode": True, "partition": "2d"}, True),
     ({"mesh_shape": (1, 2)}, False),
     ({"mesh_shape": (2, 1)}, False),
     ({"partition": "2d", "replica_cols": 2}, False)],
)
def test_unported_options_are_refused_by_name(planted, kw, annealing):
    """Meshes and the 2D partition, refused (ROADMAP items 14 and 17)
    before the mesh sweep and the 2D trainer landed, now sweep through a
    factory of the trainer over that mesh (as `cli sweep --mesh` and
    `--partition 2d` pass one), with and without quality mode and device
    annealing: the same grid, chosen K and LLH per K (1e-10) as the single
    device's sweep."""
    cfg = BigClamConfig(**_sweep_cfg(**kw))
    g = _port_graph(planted)
    cpu = torch.device("cpu")
    if cfg.partition == "2d":
        mesh = make_mesh_2d(twod_mesh_shape(cfg, 2), [cpu] * 2)
        factory = lambda c: TwoDShardedBigClamModel(g, c, mesh)  # noqa: E731
    else:
        dp, tp = cfg.mesh_shape
        mesh = make_mesh((dp, tp), [cpu] * (dp * tp))
        factory = lambda c: ShardedBigClamModel(g, c, mesh)  # noqa: E731
    got = sweep_k(g, cfg, device_annealing=annealing, device="cpu",
                  model_factory=factory)
    want = sweep_k(g, cfg.replace(mesh_shape=(1, 1), partition="1d",
                                  replica_cols=1),
                   device_annealing=annealing, device="cpu")
    _same_sweep(got, want)


def _edge_file(tmp_path, g):
    path = tmp_path / "g.txt"
    np.savetxt(path, np.stack([g.src, g.dst], 1)[g.src < g.dst], fmt="%d")
    return str(path)


def test_cli_sweep_json_matches_jax_cli(planted, tmp_path, capsys):
    path = _edge_file(tmp_path, planted)
    argv = ["sweep", "--graph", path, "--min-com", "2", "--max-com", "8",
            "--div-com", "4", "--max-iters", "10", "--dtype", "float64"]
    assert cli.main(argv + ["--device", "cpu",
                            "--checkpoint-dir", str(tmp_path / "p")]) == 0
    cap = capsys.readouterr()
    out = json.loads(cap.out.strip().splitlines()[-1])
    per_k = [json.loads(ln) for ln in cap.err.strip().splitlines()]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_main(argv + ["--quiet", "--checkpoint-dir", str(tmp_path / "j")]) == 0
    ref = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert set(out) == set(ref)
    assert {k: out[k] for k in ("chosen_k", "kset", "n", "edges", "representation")} \
        == {k: ref[k] for k in ("chosen_k", "kset", "n", "edges", "representation")}
    assert set(out["llh_by_k"]) == set(ref["llh_by_k"])
    for k, v in ref["llh_by_k"].items():
        np.testing.assert_allclose(out["llh_by_k"][k], v, rtol=1e-10)
    assert [(r["k"], r["llh"]) for r in per_k] == [
        (int(k), v) for k, v in out["llh_by_k"].items()
    ]


def test_cli_sweep_refuses_unported_flags(planted, tmp_path, capsys, monkeypatch):
    """`sweep --distributed` without a coordinator warns in the JAX CLI's
    words and sweeps the same mesh single-process (it was refused as the
    multi-process half of ROADMAP item 14; two ranks:
    tests/test_torch_multihost.py); `sweep --mesh`, refused here before,
    runs: test_cli_sweep_mesh_matches_jax_mesh_factory; --quality and
    --device-annealing are parser flags, and the help lists nothing as not
    ported."""
    for k in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    path = _edge_file(tmp_path, planted)
    base = ["sweep", "--graph", path, "--device", "cpu", "--mesh", "2,1",
            "--min-com", "2", "--max-com", "4", "--div-com", "2",
            "--max-iters", "3", "--quiet"]
    runs = []
    for extra in ([], ["--distributed"]):
        assert cli.main(base + extra) == 0
        cap = capsys.readouterr()
        runs.append((json.loads(cap.out.strip().splitlines()[-1]), cap.err))
    assert "no coordinator found" not in runs[0][1]
    assert "continuing single-process over local devices only" in runs[1][1]
    assert runs[0][0]["llh_by_k"] == runs[1][0]["llh_by_k"]
    args = cli.build_parser().parse_args(
        ["sweep", "--graph", path, "--quality", "--device-annealing"])
    assert args.quality and args.device_annealing
    with pytest.raises(SystemExit):
        cli.main(["sweep", "--help"])
    help_text = "".join(capsys.readouterr().out.split())   # argparse wraps at "-"
    assert "Notportedyet" not in help_text
    for flag in ("--quality", "--device-annealing"):
        assert flag in help_text


@pytest.mark.parametrize("mesh,schedule", [((2, 2), "allgather"), ((2, 1), "ring"),
                                           ((4, 2), "ring")])
def test_cli_sweep_mesh_matches_jax_mesh_factory(planted, tmp_path, capsys, mesh,
                                                  schedule):
    """`sweep --mesh DP,TP` (float64 `xla` on the CPU) builds each K's model
    through fit's mesh factory; against the JAX sweep_k given the JAX
    trainer of the same mesh as its factory (`bigclam_tpu/cli.py`
    `_make_model`): the same grid and chosen K, LLH per K at 1e-10."""
    import jax

    from bigclam_tpu.parallel import RingBigClamModel as JaxRing
    from bigclam_tpu.parallel import ShardedBigClamModel as JaxSharded
    from bigclam_tpu.parallel import make_mesh as jax_make_mesh

    path = _edge_file(tmp_path, planted)
    dp, tp = mesh
    assert cli.main(["sweep", "--graph", path, "--min-com", "2", "--max-com", "8",
                     "--div-com", "4", "--max-iters", "40", "--dtype", "float64",
                     "--device", "cpu", "--mesh", f"{dp},{tp}", "--schedule",
                     schedule]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cls = JaxRing if schedule == "ring" else JaxSharded
    jmesh = jax_make_mesh((dp, tp), jax.devices()[: dp * tp])
    jg = jax_graph_from_edges(np.loadtxt(path, dtype=np.int64))
    jcfg = JaxConfig(num_communities=8, dtype="float64", max_iters=40, min_com=2,
                     max_com=8, div_com=4)
    ref = jax_sweep_k(jg, jcfg, model_factory=lambda c: cls(jg, c, jmesh))
    assert out["kset"] == ref.kset and out["chosen_k"] == ref.chosen_k
    assert sorted(int(k) for k in out["llh_by_k"]) == sorted(ref.llh_by_k)
    for k, v in ref.llh_by_k.items():
        np.testing.assert_allclose(out["llh_by_k"][str(k)], v, rtol=1e-10)


def test_cli_eval_matches_jax_cli(tmp_path, capsys):
    rng = np.random.default_rng(4)
    for name in ("pred", "truth"):
        lines = ["\t".join(map(str, sorted(rng.choice(60, rng.integers(2, 12),
                                                     replace=False))))
                 for _ in range(7)]
        (tmp_path / f"{name}.txt").write_text("\n".join(lines) + "\n")
    for extra in ([], ["--no-nmi"]):
        argv = ["eval", "--pred", str(tmp_path / "pred.txt"),
                "--truth", str(tmp_path / "truth.txt"), *extra]
        assert cli.main(argv) == 0
        out = json.loads(capsys.readouterr().out)
        assert jax_main(argv) == 0
        ref = json.loads(capsys.readouterr().out)
        assert out == ref
        assert set(out) == ({"f1"} if extra else {"f1", "nmi"})
