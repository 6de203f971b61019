"""The port's `fit --quality [--device-annealing]` and `sweep --quality
[--device-annealing]` held against the JAX CLI on one planted edge file in
float64: the JSON keys and values (quality_cycles, quality_total_iters,
cycles_llh; chosen_k and llh_by_k), with the port's device noise source
fed JAX's draws; the no-op warning; the --init rowkeyed, sparse and
--follow refusals with the JAX messages; and the sweep's old refusal texts
gone."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigclam_tpu.models.quality as jq
from bigclam_tpu.cli import main as jax_main

from bigclam_tpu_torch import cli
from bigclam_tpu_torch.graph.store import compile_graph_cache
from bigclam_tpu_torch.models import quality as tq
from bigclam_tpu_torch.models.agm import sample_planted_graph

torch.set_num_threads(2)

RTOL = 1e-10


@pytest.fixture(scope="module")
def edge_file(tmp_path_factory):
    g, _ = sample_planted_graph(600, 12, p_in=0.3, rng=np.random.default_rng(7))
    path = tmp_path_factory.mktemp("quality_cli") / "g.txt"
    m = g.src < g.dst
    np.savetxt(path, np.stack([g.src[m], g.dst[m]], 1), fmt="%d")
    return str(path)


def _json_out(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


class JaxDraws:
    """Stands in for models.quality.DeviceNoise: the kicks JAX's
    fit_quality_device draws, from the padded shape of the JAX model it
    was handed (`shapes`, filled by the spy on the JAX side)."""

    shapes: list = []

    def __init__(self, seed, key_salt=0):
        self.base = jax.random.fold_in(
            jax.random.key((seed ^ 0x5EED) & 0xFFFFFFFF), key_salt)

    def __call__(self, tag, live, eps, dtype, device):
        u = jax.random.uniform(jax.random.fold_in(self.base, tag),
                               self.shapes[-1], jnp.float64, 0.0, eps)
        blk = np.array(u)[: live[0], : live[1]]
        return torch.from_numpy(blk).to(device, dtype)


@pytest.fixture
def jax_draws(monkeypatch):
    """Record the padded F shape of every JAX device schedule and give the
    port's schedule JAX's draws."""
    JaxDraws.shapes = []
    orig = jq.fit_quality_device

    def spy(model, F0, *a, **kw):
        JaxDraws.shapes.append(tuple(model.init_state(F0).F.shape))
        return orig(model, F0, *a, **kw)

    monkeypatch.setattr(jq, "fit_quality_device", spy)
    monkeypatch.setattr(tq, "DeviceNoise", JaxDraws)
    return JaxDraws


@pytest.mark.parametrize("annealing", [False, True])
def test_fit_quality_json_matches_jax_cli(edge_file, capsys, jax_draws,
                                          annealing):
    argv = ["fit", "--graph", edge_file, "--k", "12", "--dtype", "float64",
            "--quality", "--restart-cycles", "3", "--quiet"]
    argv += ["--device-annealing"] if annealing else []
    assert jax_main(argv) == 0
    ref = _json_out(capsys)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = _json_out(capsys)
    assert len(jax_draws.shapes) == int(annealing)
    assert set(ref) <= set(out)
    for key in ("iters", "n", "edges", "k", "representation", "kernel_path",
                "partition", "quality_cycles", "quality_total_iters"):
        assert out[key] == ref[key], key
    assert out["quality_cycles"] == 3
    np.testing.assert_allclose(out["llh"], ref["llh"], rtol=RTOL)
    np.testing.assert_allclose(out["cycles_llh"], ref["cycles_llh"],
                               rtol=0, atol=0.011)     # both rounded to 0.01
    assert "upload" not in out["stage_seconds"]        # inside the schedule


@pytest.mark.parametrize("annealing", [False, True])
def test_sweep_quality_matches_jax_cli(edge_file, capsys, jax_draws,
                                       annealing):
    argv = ["sweep", "--graph", edge_file, "--min-com", "6", "--max-com",
            "12", "--div-com", "2", "--dtype", "float64", "--quality"]
    argv += ["--device-annealing"] if annealing else []
    assert jax_main(argv + ["--quiet"]) == 0
    ref = _json_out(capsys)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = _json_out(capsys)
    assert out["chosen_k"] == ref["chosen_k"] and out["kset"] == ref["kset"]
    assert set(out["llh_by_k"]) == set(ref["llh_by_k"])
    for k, v in ref["llh_by_k"].items():
        np.testing.assert_allclose(out["llh_by_k"][k], v, rtol=RTOL)
    if annealing:          # one schedule a K, each salted with its K
        assert len(jax_draws.shapes) == len(ref["llh_by_k"])


def test_quality_flags_warn_without_quality(edge_file, capsys):
    argv = ["fit", "--graph", edge_file, "--k", "6", "--max-iters", "2",
            "--restart-cycles", "3", "--init-noise", "0.01",
            "--device-annealing", "--quiet"]
    assert jax_main(argv) == 0
    ref = capsys.readouterr().err
    assert cli.main(argv + ["--device", "cpu"]) == 0
    err = capsys.readouterr().err
    want = ("warning: ['init_noise', 'restart_cycles', 'device_annealing'] "
            "have no effect without --quality")
    assert want in err and want in ref
    out_seed = ["fit", "--graph", edge_file, "--k", "6", "--max-iters", "2",
                "--seed-exclusion", "1", "--quiet", "--device", "cpu"]
    assert cli.main(out_seed) == 0
    assert "warning" not in capsys.readouterr().err


def _refusal(main, argv):
    with pytest.raises(SystemExit) as exc:
        main(argv)
    return str(exc.value.code)


@pytest.mark.parametrize("extra,want", [
    (["--init", "rowkeyed"], "--init rowkeyed is not supported with --quality"),
    (["--representation", "sparse"],
     "--quality is not supported with --representation sparse yet"),
    (["--follow", "DELTAS", "--publish-dir", "SNAPS"],
     "--follow supports single-chip dense fits for now"),
])
def test_quality_refusals_carry_the_jax_messages(edge_file, tmp_path, extra,
                                                 want):
    cache = str(tmp_path / "cache")
    compile_graph_cache(edge_file, cache, num_shards=2)
    extra = [str(tmp_path / x) if x in ("DELTAS", "SNAPS") else x
             for x in extra]
    argv = ["fit", "--graph", cache, "--k", "6", "--quality", "--quiet",
            *extra]
    ours = _refusal(cli.main, argv + ["--device", "cpu"])
    assert ours == _refusal(jax_main, argv)
    assert ours.startswith("error: ") and want in ours


def test_quality_refuses_store_native_up_front(edge_file, tmp_path):
    """A store-native trainer holds no global CSR, which the discrete stage
    reads: the port refuses before any work (the JAX CLI fails after the
    annealing, at the repair stage)."""
    cache = str(tmp_path / "cache")
    compile_graph_cache(edge_file, cache, num_shards=2)
    msg = _refusal(cli.main, ["fit", "--graph", cache, "--k", "6", "--quality",
                              "--mesh", "2,1", "--store-native", "--device",
                              "cpu", "--quiet"])
    assert "--store-native" in msg and msg.startswith("error: ")


def test_sweep_quality_refuses_sparse_and_mesh(edge_file, capsys, monkeypatch):
    """Sparse quality sweeps stay refused; a quality sweep over a mesh runs
    through fit's mesh factory, the device-resident schedule on a K-sharded
    mesh too (it was refused as item 20; tests/test_torch_quality_tp.py
    holds it against the JAX CLI), and with --distributed but no
    coordinator it warns in the JAX CLI's words and runs the same mesh
    single-process (it was refused as item 14)."""
    for k in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    base = ["sweep", "--graph", edge_file, "--min-com", "6", "--max-com",
            "12", "--div-com", "2", "--quality", "--device", "cpu"]
    assert "--representation sparse" in _refusal(
        cli.main, base + ["--representation", "sparse"])
    runs = []
    for extra in ([], ["--distributed"]):
        assert cli.main(base + ["--mesh", "1,2", "--device-annealing", "--quiet",
                                "--max-iters", "5"] + extra) == 0
        cap = capsys.readouterr()
        runs.append((json.loads(cap.out.strip().splitlines()[-1]), cap.err))
    assert "--distributed but no coordinator found" not in runs[0][1]
    assert "continuing single-process over local devices only" in runs[1][1]
    for out, _ in runs:
        assert out["mesh"] == "1x2" and out["kset"] == [6, 8, 11, 12]
    assert runs[0][0]["llh_by_k"] == runs[1][0]["llh_by_k"]


def test_old_refusal_texts_are_gone(capsys):
    assert not hasattr(cli, "SWEEP_EPILOG")
    with pytest.raises(SystemExit):
        cli.main(["sweep", "--help"])
    help_text = "".join(capsys.readouterr().out.split())
    assert "Notportedyet" not in help_text and "item13" not in help_text
    assert "--quality" in help_text and "--device-annealing" in help_text
    with pytest.raises(SystemExit):
        cli.main(["fit", "--help"])
    fit_help = capsys.readouterr().out
    for flag in ("--quality", "--init-noise", "--restart-cycles",
                 "--restart-tol", "--quality-max-p", "--seed-exclusion",
                 "--device-annealing"):
        assert flag in fit_help
    import bigclam_tpu_torch.models.model_selection as ms

    assert not hasattr(ms, "check_sweep_supported")
