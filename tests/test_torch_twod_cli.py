"""`--partition 2d` through the port's CLI against the JAX CLI: `fit` and
`sweep` JSON keys (the JAX CLI on its fused interpret config, which its
flags cannot reach, so its `_build` is wrapped; its plain `xla_2d`
fails on this jax), every refusal of `--partition 2d` in the JAX CLI's
words, and `preflight --partition 2d` and the 1d verdict's
`--replica-cols` hint on the same inputs as the JAX preflight."""

import contextlib
import io
import json

import numpy as np
import pytest

from bigclam_tpu import cli as jcli
from bigclam_tpu.models.agm import sample_planted_graph

from bigclam_tpu_torch import cli
from bigclam_tpu_torch.graph.store import compile_graph_cache


@pytest.fixture(scope="module")
def edge_file(tmp_path_factory):
    # 240 nodes: n_blk 60 at p = 4, which the JAX fused block_b 30 divides
    g, _ = sample_planted_graph(240, 4, p_in=0.3, rng=np.random.default_rng(0))
    path = tmp_path_factory.mktemp("g") / "g.txt"
    keep = g.src < g.dst
    np.savetxt(path, np.stack([g.src[keep], g.dst[keep]], axis=1), fmt="%d")
    return str(path)


@pytest.fixture(scope="module")
def cache(edge_file, tmp_path_factory):
    return compile_graph_cache(edge_file, str(tmp_path_factory.mktemp("c") / "c"),
                               num_shards=4)


@pytest.fixture
def jax_fused(monkeypatch):
    """The JAX CLI's config with the fused interpret-mode kernels of
    tests/test_fused2d.py (the JAX CLI has no flags for them)."""
    build = jcli._build

    def fused_build(args, k):
        g, cfg = build(args, k)
        return g, cfg.replace(pallas_interpret=True, csr_block_b=30,
                              csr_tile_t=64)

    monkeypatch.setattr(jcli, "_build", fused_build)


def _json(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cols", [1, 2])
def test_fit_json_keys_match_the_jax_cli(edge_file, jax_fused, cols):
    argv = ["fit", "--graph", edge_file, "--k", "8", "--max-iters", "3",
            "--mesh", "4,1", "--partition", "2d", "--replica-cols", str(cols),
            "--csr-kernels", "on", "--quiet"]
    _, want = _json(jcli.main, argv)
    ours = cli.fit(cli.build_parser().parse_args(argv + ["--device", "cpu"]))[0]
    assert set(want) - {"iters_per_sec"} <= set(ours), set(want) - set(ours)
    for key in ("partition", "grad_exchange", "mesh", "kernel_path", "n",
                "edges", "k", "representation"):
        assert ours[key] == want[key], key
    assert ours["replica_cols"] == cols
    assert ours["grad_exchange"] == ("closure" if cols > 1 else "dense")
    np.testing.assert_allclose(ours["llh"], want["llh"], rtol=1e-5)


def test_sweep_json_keys_match_the_jax_cli(edge_file, jax_fused):
    argv = ["sweep", "--graph", edge_file, "--min-com", "4", "--max-com", "8",
            "--div-com", "2", "--max-iters", "3", "--mesh", "4,1",
            "--partition", "2d", "--replica-cols", "2", "--csr-kernels", "on"]
    _, want = _json(jcli.main, argv + ["--quiet"])
    ours = cli.sweep(cli.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert set(ours) == set(want)
    assert ours["kset"] == want["kset"] and ours["mesh"] == want["mesh"] == "4x1"


def _jax_refusal(argv):
    try:
        jcli.main(argv + ["--quiet"])
    except SystemExit as e:
        return str(e)
    raise AssertionError("the JAX CLI ran")


@pytest.mark.parametrize("extra", [
    [],
    ["--mesh", "4,1", "--distributed"],
    ["--mesh", "4,1", "--representation", "sparse"],
    ["--mesh", "4,1", "--schedule", "ring"],
    ["--mesh", "2,2"],
], ids=["no_mesh", "distributed", "sparse", "ring", "tp2"])
def test_refusals_carry_the_jax_words(edge_file, extra):
    argv = ["fit", "--graph", edge_file, "--k", "8", "--max-iters", "2",
            "--partition", "2d"] + extra
    want = _jax_refusal(argv)
    assert want.startswith("error: --partition 2d")
    with pytest.raises(SystemExit) as e:
        cli.main(argv + ["--device", "cpu"])
    assert str(e.value) == want
    with pytest.raises(SystemExit) as e:
        cli.main(["sweep", "--graph", edge_file, "--min-com", "4", "--max-com",
                  "8", "--partition", "2d", "--device", "cpu"] + extra)
    assert str(e.value) == want


def _preflight(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["preflight", *argv, "--json"])
    return rc, json.loads(buf.getvalue())


def test_preflight_replica_cols_hint_is_the_jax_hint(cache):
    """A 1d verdict that does not fit names the same --replica-cols grid
    as the JAX preflight, both priced from the cache's baked pair counts;
    with --partition 2d both price the combined fused + closure config."""
    argv = ["--graph", cache.directory, "--k", "1000", "--mesh", "4,1",
            "--hbm-gb", "0.001"]
    rc_j, want = _preflight(jcli.main, argv)
    rc_p, ours = _preflight(cli.main, argv)
    assert rc_j == rc_p == 2
    assert (ours["fits"], ours["binding"]) == (want["fits"], want["binding"])
    (kj,) = [k for k in want["knobs"] if "--replica-cols" in k]
    (kp,) = [k for k in ours["knobs"] if "--replica-cols" in k]
    assert "baked closure pair counts" in kp
    assert kp.split("(")[0] == kj.split("(")[0]
    argv = ["--graph", cache.directory, "--k", "1000", "--mesh", "4,1",
            "--partition", "2d", "--replica-cols", "2"]
    rc_j, want = _preflight(jcli.main, argv)
    rc_p, ours = _preflight(cli.main, argv)
    assert rc_j == rc_p == 0 and ours["fits"] == want["fits"]
    for key in ("partition", "replica_cols", "kernel_path", "grad_exchange",
                "mesh"):
        assert ours["workload"][key] == want["workload"][key], key
    assert any("csr_fused_2d" in n for n in ours["notes"])


@pytest.mark.parametrize("argv", [
    ["--nodes", "300000", "--edges", "4256398", "--k", "1000", "--mesh", "4,1",
     "--partition", "2d", "--replica-cols", "2", "--hbm-gb", "80"],
    ["--nodes", "1134890", "--edges", "2987624", "--k", "1000", "--mesh", "8,1",
     "--partition", "2d", "--replica-cols", "2", "--hbm-gb", "0.5"],
])
def test_preflight_2d_verdict_is_the_jax_verdict(edge_file, argv):
    """The verdict and the binding constraint of a 2D price on a text
    graph's given sizes: one that fits, one that does not."""
    argv = ["--graph", edge_file, *argv]
    rc_j, want = _preflight(jcli.main, argv)
    rc_p, ours = _preflight(cli.main, argv)
    assert rc_j == rc_p
    assert (ours["fits"], ours["binding"]) == (want["fits"], want["binding"])
    assert ours["workload"]["partition"] == "2d"


@pytest.mark.parametrize("extra,words", [
    (["--mesh", "4,1", "--schedule", "ring"], "drop --schedule ring"),
    (["--mesh", "2,2"], "requires tp == 1"),
    (["--mesh", "4,1", "--replica-cols", "3"], "does not divide"),
])
def test_preflight_2d_refusals_carry_the_jax_words(capsys, extra, words):
    argv = ["preflight", "--nodes", "1000", "--edges", "5000", "--k", "64",
            "--partition", "2d", *extra]
    assert cli.main(argv) == 1
    err = capsys.readouterr().err
    assert words in err and err.startswith("error:")
