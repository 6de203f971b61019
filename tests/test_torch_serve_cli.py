"""The port's serving entries against the JAX CLI on the CPU in float64:
`fit --publish-dir` (the published F is the saved F, bit for bit), `cli
serve` (its JSON keys the JAX `serve`'s, read answers identical, suggest at
rtol 1e-10 with equal iterations), `cli refit` (keys and numbers the JAX
`refit`'s), `preflight --serve --json` (equal to JAX's), `fit --follow`,
the refusals, and the port's `fit --publish-shards 2` archives served by
the JAX package's fleet router with the answers of the port's
single-process `cli serve`."""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch

from bigclam_tpu.cli import _parse_query_spec as jax_parse_query_spec
from bigclam_tpu.cli import main as jax_main
from bigclam_tpu.serve.fleet import LocalReplica, ShardReplica
from bigclam_tpu.serve.router import FleetRouter

from bigclam_tpu_torch import cli
from bigclam_tpu_torch.graph.store import compile_graph_cache
from bigclam_tpu_torch.models import agm
from bigclam_tpu_torch.serve.snapshot import ServingSnapshot
from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(2)

N, K = 120, 6
FIT = ["fit", "--k", str(K), "--max-iters", "60", "--dtype", "float64",
       "--quiet"]


def _run(main, argv):
    """(exit code, parsed last stdout JSON or None, stdout lines, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            return e.code, None, [], err.getvalue()
    lines = out.getvalue().strip().splitlines()
    last = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
    return rc, last, lines, err.getvalue()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A planted graph (sparse raw ids), its 2-shard cache, and a port fit
    on it published to `snaps` with the F saved beside it."""
    tmp = tmp_path_factory.mktemp("serve_cli")
    g, _ = agm.sample_planted_graph(N, K, p_in=0.8,
                                    rng=np.random.default_rng(3))
    keep = g.src < g.dst
    text = tmp / "g.txt"
    np.savetxt(text, np.stack([g.src[keep], g.dst[keep]], axis=1) * 5 + 2,
               fmt="%d")
    store = compile_graph_cache(str(text), str(tmp / "cache"), num_shards=2)
    snaps = str(tmp / "snaps")
    rc, out, _, err = _run(cli.main, FIT + [
        "--graph", store.directory, "--device", "cpu", "--publish-dir", snaps,
        "--save-f", str(tmp / "f.npy")])
    assert rc == 0, err
    return dict(tmp=tmp, text=str(text), cache=store.directory, snaps=snaps,
                fit=out, F=np.load(tmp / "f.npy"), raw=store.load_graph().raw_ids)


def test_fit_publishes_the_saved_F(world):
    out = world["fit"]
    assert out["generation"] == 1 and out["published"].endswith(
        "snap_000000001.npz")
    snap = ServingSnapshot.load(world["snaps"])
    np.testing.assert_array_equal(snap.F, world["F"])
    assert snap.meta["fit_iters"] == out["iters"]
    assert snap.meta["fit_wall_s"] > 0 and snap.meta["llh"] == out["llh"]


def _query_file(path, raw, rng, n=48):
    lines = []
    for i in range(n):
        r = i % 4
        if r == 0:
            q = {"family": "communities_of", "u": int(rng.choice(raw))}
        elif r == 1:
            q = {"family": "members_of", "c": int(rng.integers(K))}
        elif r == 2:
            q = {"family": "suggest_for", "u": int(rng.choice(raw))}
        else:
            q = {"family": "suggest_for",
                 "neighbors": rng.choice(raw, 5, replace=False).tolist()}
        lines.append(json.dumps(q))
    lines.append(json.dumps({"family": "communities_of", "u": -1}))
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _assert_answers_equal(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        if "suggested" in a or "suggested" in b:
            assert a["iters"] == b["iters"] and a.get("u") == b.get("u")
            np.testing.assert_allclose(a["llh"], b["llh"], rtol=1e-10)
            assert [c for c, _ in a["suggested"]] == [
                c for c, _ in b["suggested"]]
            np.testing.assert_allclose([w for _, w in a["suggested"]],
                                       [w for _, w in b["suggested"]],
                                       rtol=1e-10)
        else:
            assert a == b


def test_cli_serve_matches_the_jax_cli(world, tmp_path):
    q = _query_file(tmp_path / "q.jsonl", world["raw"],
                    np.random.default_rng(1))
    argv = ["serve", "--snapshots", world["snaps"], "--graph", world["cache"],
            "--queries", q, "--repeat", "2", "--latency-budget-ms", "2"]
    rc, ours, _, err = _run(cli.main, argv + [
        "--results", str(tmp_path / "a.jsonl"), "--device", "cpu"])
    rcj, ref, _, _ = _run(jax_main, argv + [
        "--results", str(tmp_path / "b.jsonl")])
    # the out-of-range id errors in both: exit 1, one error per pass
    assert rc == rcj == 1, err
    assert set(ours) == set(ref)
    assert ours["serve_errors"] == ref["serve_errors"] == 2
    assert ours["serve_queries"] == ref["serve_queries"] == 2 * 49
    assert ours["serve_by_family"] == ref["serve_by_family"]
    load = [[json.loads(x) for x in open(tmp_path / f)]
            for f in ("a.jsonl", "b.jsonl")]
    _assert_answers_equal(*load)


def test_zero_rows_are_a_fixed_point_of_the_fit_as_in_jax(tmp_path):
    """An AGM graph fitted from conductance seeds keeps a share of its rows
    at exactly zero once it converges, in the port and in the JAX package
    alike, and more steps at conv_tol 0 lift none of them: the served
    snapshot's argmax fallback then puts each in every community."""
    g, _ = agm.sample_planted_graph(3000, 20, p_in=0.3,
                                    rng=np.random.default_rng(1))
    text = tmp_path / "g.txt"
    np.savetxt(text, np.stack([g.src, g.dst], axis=1)[g.src < g.dst],
               fmt="%d")
    zero = {}
    for tag, main, extra in (("port", cli.main, ["--device", "cpu"]),
                             ("jax", jax_main, ["--csr-kernels", "off"])):
        for iters, tol in (("1000", "1e-4"), ("30", "0")):
            f = tmp_path / f"{tag}_{iters}.npy"
            rc, out, _, err = _run(main, [
                "fit", "--graph", str(text), "--k", "20", "--dtype", "float64",
                "--max-iters", iters, "--conv-tol", tol, "--quiet",
                "--save-f", str(f)] + extra)
            assert rc in (0, None), err
            zero[tag, iters] = np.nonzero(np.load(f).max(axis=1) <= 0)[0]
            if iters == "1000":
                assert out["iters"] < 1000          # converged
    assert 0 < zero["port", "1000"].size < 3000
    for key in zero:
        np.testing.assert_array_equal(zero[key], zero["port", "1000"])


def test_cli_serve_prints_answers_for_a_few_queries(world):
    argv = ["serve", "--snapshots", world["snaps"], "--query",
            "members_of:2", "--query",
            f"communities_of:{int(world['raw'][3])}"]
    rc, ours, lines, _ = _run(cli.main, argv + ["--device", "cpu"])
    rcj, ref, jlines, _ = _run(jax_main, argv)
    assert rc == rcj == 0 and set(ours) == set(ref)
    _assert_answers_equal([json.loads(x) for x in lines[:-1]],
                          [json.loads(x) for x in jlines[:-1]])


def test_cli_serve_refusals(world):
    """--snapshots with --fleet is refused in the JAX CLI's words;
    --fleet-shard and --listen without --fleet leave single-process serve
    as it is (as in the JAX CLI)."""
    base = ["serve", "--snapshots", world["snaps"], "--query", "members_of:1"]
    rc, _, _, err = _run(cli.main, base + ["--fleet", world["snaps"], "--device", "cpu"])
    rcj, _, _, errj = _run(jax_main, base + ["--fleet", world["snaps"]])
    assert rc == rcj == 1 and err == errj
    assert "exactly one of --snapshots" in err
    for extra in (["--listen", "localhost:0"], ["--fleet-shard", "1"]):
        rc, ours, lines, err = _run(cli.main, base + extra + ["--device", "cpu"])
        rcj, ref, jlines, _ = _run(jax_main, base + extra)
        assert rc == rcj == 0, err
        assert lines[:-1] == jlines[:-1] and ours["serve_errors"] == 0
    rc, _, _, err = _run(cli.main, ["serve", "--snapshots",
                                    world["snaps"], "--device", "cpu"])
    assert rc == 1 and "nothing to serve" in err
    if not torch.cuda.is_available():
        from bigclam_tpu_torch.utils.device import DeviceUnavailableError

        with pytest.raises(DeviceUnavailableError):
            cli.main(base)


@pytest.mark.parametrize("spec", ["members_of:3", "communities_of:12",
                                  '{"family": "suggest_for", "u": 1}',
                                  "members_of:abc", "members_of", "nope:1",
                                  "{not json"])
def test_query_specs_parse_as_in_jax(spec):
    def parse(fn):
        try:
            return fn(spec)
        except SystemExit as e:
            return ("exit", str(e))

    assert parse(cli.parse_query_spec) == parse(jax_parse_query_spec)


@pytest.mark.parametrize("rep", ["dense", "sparse"])
def test_cli_refit_matches_the_jax_cli(world, tmp_path, rep):
    rng = np.random.default_rng(17)
    pairs = rng.choice(world["raw"], size=(25, 2))
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    delta = tmp_path / "delta.txt"
    np.savetxt(delta, pairs, fmt="%d")
    outs = {}
    for who, main in (("ours", cli.main), ("ref", jax_main)):
        cache = str(tmp_path / f"cache_{who}")
        snaps = str(tmp_path / f"snaps_{who}")
        shutil.copytree(world["cache"], cache)
        shutil.copytree(world["snaps"], snaps)
        rc, _, _, err = _run(main, ["ingest", "--cache-dir", cache,
                                    "--delta", str(delta)])
        assert rc == 0, err
        argv = ["refit", "--graph", cache, "--snapshots", snaps, "--delta",
                str(delta), "--dtype", "float64", "--refit-rounds", "4",
                "--quiet"]
        if rep == "sparse":
            argv += ["--representation", "sparse", "--sparse-m", str(K)]
        argv += (["--device", "cpu"] if who == "ours"
                 else ["--csr-kernels", "off"])
        rc, out, _, err = _run(main, argv)
        assert rc == 0, err
        outs[who] = (out, snaps)
    (ours, snaps), (ref, jsnaps) = outs["ours"], outs["ref"]
    assert set(ours) == set(ref)
    for key in ("n", "edges", "k", "representation", "from_generation",
                "touched", "refit_nodes", "touched_frac", "halo", "rounds",
                "foldin_iters", "converged", "escalated",
                "escalated_full_fit", "baseline_fit_wall_s", "generation"):
        assert ours[key] == ref[key], key
    assert ours["generation"] == 2 and ours["rounds"] >= 2
    np.testing.assert_allclose(ours["restricted_llh"], ref["restricted_llh"],
                               rtol=1e-10)
    np.testing.assert_allclose(ServingSnapshot.load(snaps).F,
                               ServingSnapshot.load(jsnaps).F,
                               rtol=1e-10, atol=1e-12)
    assert ours["refit_cost_ratio"] > 0


def test_cli_refit_refusals_match_the_jax_cli(world, tmp_path):
    base = ["refit", "--graph", world["cache"], "--delta", world["text"],
            "--dtype", "float64", "--quiet"]
    for main, extra in ((cli.main, ["--device", "cpu"]), (jax_main, [])):
        rc, _, _, err = _run(main, base + ["--snapshots", str(tmp_path / "no")]
                             + extra)
        assert rc == 1 and "no published snapshot" in err
        with pytest.raises(SystemExit, match="does not match the published"):
            main(base + ["--snapshots", world["snaps"], "--k", "7"] + extra)
    with pytest.raises(SystemExit, match="single-device"):
        cli.main(base + ["--snapshots", world["snaps"], "--mesh", "2,1"])


@pytest.mark.parametrize("extra", [
    [],
    ["--representation", "sparse", "--sparse-m", "4", "--serve-shards", "3",
     "--serve-replicas", "2", "--qps-target", "60000"],
    ["--host-ram-gb", "0.000001", "--serve-cache-slots", "32"],
])
def test_preflight_serve_json_equals_jax(world, extra):
    argv = ["preflight", "--graph", world["cache"], "--k", str(K), "--serve",
            "--json", *extra]
    rc, ours, _, _ = _run(cli.main, argv)
    rcj, ref, _, _ = _run(jax_main, argv)
    assert rc == rcj and ours == ref
    text_rc, _, lines, _ = _run(cli.main, [a for a in argv if a != "--json"])
    assert text_rc == rc == (2 if extra else 0)
    assert lines[0].startswith("serve preflight")


def test_publish_shards_served_by_the_jax_fleet(world, tmp_path):
    """The port's fleet publication of the same fit, read by the JAX
    package's replicas behind its router: read answers equal the port's
    single-process `cli serve` on the whole-F snapshot."""
    fleet = str(tmp_path / "fleet")
    rc, out, _, err = _run(cli.main, FIT + [
        "--graph", world["cache"], "--device", "cpu", "--publish-dir", fleet,
        "--publish-shards", "2", "--save-f", str(tmp_path / "f.npy")])
    assert rc == 0, err
    assert out["publish_shards"] == 2 and out["generation"] == 1
    np.testing.assert_array_equal(np.load(tmp_path / "f.npy"), world["F"])
    rng = np.random.default_rng(8)
    queries = ([{"family": "members_of", "c": c} for c in range(K)]
               + [{"family": "communities_of", "u": int(u)}
                  for u in rng.choice(world["raw"], 20, replace=False)])
    qfile = tmp_path / "q.jsonl"
    qfile.write_text("\n".join(json.dumps(q) for q in queries) + "\n")
    rc, _, _, err = _run(cli.main, [
        "serve", "--snapshots", world["snaps"], "--queries", str(qfile),
        "--results", str(tmp_path / "single.jsonl"), "--device", "cpu"])
    assert rc == 0, err
    single = [json.loads(x) for x in open(tmp_path / "single.jsonl")]
    reps = [ShardReplica(fleet, s) for s in range(2)]
    router = FleetRouter(fleet, [LocalReplica(r) for r in reps])
    try:
        routed = [router.route(q) for q in queries]
    finally:
        router.close()
        for r in reps:
            r.close()
    for q, a, b in zip(queries, routed, single):
        key = "members" if q["family"] == "members_of" else "communities"
        assert a[key] == b[key], q


def test_fit_follow_runs_the_loop(world, tmp_path):
    cache = str(tmp_path / "cache")
    shutil.copytree(world["cache"], cache)
    ddir = tmp_path / "deltas"
    ddir.mkdir()
    rng = np.random.default_rng(21)
    pairs = rng.choice(world["raw"], size=(12, 2))
    np.savetxt(ddir / "d1.txt", pairs[pairs[:, 0] != pairs[:, 1]], fmt="%d")
    snaps = str(tmp_path / "snaps")
    rc, out, _, err = _run(cli.main, FIT + [
        "--graph", cache, "--device", "cpu", "--publish-dir", snaps,
        "--follow", str(ddir), "--follow-max", "1", "--follow-interval",
        "0.01", "--refit-rounds", "3", "--refit-halo", "0"])
    assert rc == 0, err
    follow = out["follow"]
    assert out["generation"] == 1
    assert follow["generations"] == 1 and follow["last_step"] == 2
    assert set(follow) >= {"generations", "processed", "skipped_empty",
                           "failed", "escalations", "last_step"}
    assert CheckpointManager(snaps).published_steps() == [1, 2]
    assert ServingSnapshot.load(snaps).meta["refit_rounds"] <= 3


@pytest.mark.parametrize("case", ["text", "no_publish", "shards", "sparse"])
def test_follow_preconditions_refuse_before_the_fit(world, tmp_path, case):
    argv = FIT + ["--device", "cpu", "--follow", str(tmp_path)]
    if case == "text":
        argv += ["--graph", world["text"], "--publish-dir", str(tmp_path)]
        want = "needs a compiled graph cache"
    elif case == "no_publish":
        argv += ["--graph", world["cache"]]
        want = "needs --publish-dir"
    elif case == "shards":
        argv += ["--graph", world["cache"], "--publish-dir", str(tmp_path),
                 "--publish-shards", "2"]
        want = "cannot feed a fleet"
    else:
        argv += ["--graph", world["cache"], "--publish-dir", str(tmp_path),
                 "--representation", "sparse"]
        want = "single-device dense fits"
    rc, _, _, _ = _run(cli.main, argv)
    with pytest.raises(SystemExit, match=want):
        cli.main(argv)
    assert rc != 0
    assert not os.path.exists(os.path.join(tmp_path, "latest.json"))
