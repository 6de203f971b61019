"""The port's serving fleet (bigclam_tpu_torch/serve/router.py, fleet.py,
`cli serve --fleet`, `cli route`) on the CPU in float64: the port's
ShardReplica/ReplicaServer/FleetRouter and the JAX package's ones over the
same fleet archives (published by the port's `fit --publish-shards`) and
the same query stream give equal communities_of answers and members_of
merges; the routed suggest_for is held against the port's single-process
`cli serve` at 1e-6 (the JAX routed suggest flips in the reference, so it
is not the reference here); and the JAX fleet tests' router scenarios:
the cross-shard members_of merge, permuted raw ids, empty shards, the
generation-pinned rollout, unknown-generation failover, the TCP round
trip and the endpoint parser. Replicas fold in on their --device, and a
replica asked for the card without one fails at start."""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

from bigclam_tpu.serve import fleet as jfleet
from bigclam_tpu.serve import router as jrouter

from bigclam_tpu_torch import cli
from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.store import compile_graph_cache
from bigclam_tpu_torch.models import agm
from bigclam_tpu_torch.serve import fleet as pfleet
from bigclam_tpu_torch.serve import router as prouter
from bigclam_tpu_torch.serve.fleet import LocalReplica, ReplicaServer, ShardReplica
from bigclam_tpu_torch.serve.router import FleetRouter, RouterError, TcpReplica
from bigclam_tpu_torch.serve.snapshot import publish_fleet_snapshot
from test_torch_fleet_chaos import SUPERVISOR_LIMIT_S, time_limit

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, K = 120, 6
FIT = ["fit", "--k", str(K), "--max-iters", "60", "--dtype", "float64",
       "--quiet", "--device", "cpu"]
SUGGEST_RTOL = 1e-6


def _run(argv):
    """(exit code, last stdout JSON, stderr) of the port's CLI."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A planted graph with sparse raw ids, its 4-shard cache, the port's
    fit on it published as one archive (`single`) and as a 2-shard fleet
    generation (`fleet`), and a mixed query stream."""
    tmp = tmp_path_factory.mktemp("fleet")
    g, _ = agm.sample_planted_graph(N, K, p_in=0.8, rng=np.random.default_rng(3))
    keep = g.src < g.dst
    text = tmp / "g.txt"
    np.savetxt(text, np.stack([g.src[keep], g.dst[keep]], 1) * 5 + 2, fmt="%d")
    store = compile_graph_cache(str(text), str(tmp / "cache"), num_shards=4)
    single, fleet = str(tmp / "single"), str(tmp / "fleet")
    rc, out, err = _run(FIT + ["--graph", store.directory, "--publish-dir", single])
    assert rc == 0, err
    rc, fout, err = _run(FIT + ["--graph", store.directory, "--publish-dir", fleet,
                                "--publish-shards", "2"])
    assert rc == 0, err
    assert fout["publish_shards"] == 2 and fout["llh"] == out["llh"]
    raw = store.load_graph().raw_ids
    rng = np.random.default_rng(8)
    queries = ([{"family": "members_of", "c": c} for c in range(K)]
               + [{"family": "communities_of", "u": int(u)}
                  for u in rng.choice(raw, 24, replace=False)]
               + [{"family": "suggest_for", "u": int(u)}
                  for u in rng.choice(raw, 6, replace=False)])
    qfile = tmp / "q.jsonl"
    qfile.write_text("\n".join(json.dumps(q) for q in queries) + "\n")
    rc, _, err = _run(["serve", "--snapshots", single, "--graph", store.directory,
                       "--queries", str(qfile), "--results",
                       str(tmp / "single.jsonl"), "--device", "cpu"])
    assert rc == 0, err
    answers = [json.loads(x) for x in open(tmp / "single.jsonl")]
    return dict(tmp=tmp, cache=store.directory, store=store, fleet=fleet,
                queries=queries, qfile=str(qfile), single=answers, raw=raw)


def assert_fleet_answers(routed, single, queries):
    """Reads equal the single-process answers bit for bit; a suggest's
    communities equal and its weights and LLH within SUGGEST_RTOL."""
    assert len(routed) == len(single) == len(queries)
    for q, a, b in zip(queries, routed, single):
        assert "error" not in a, (q, a)
        if q["family"] == "suggest_for":
            assert a["u"] == b["u"] and a["iters"] == b["iters"]
            assert [c for c, _ in a["suggested"]] == [c for c, _ in b["suggested"]]
            np.testing.assert_allclose([w for _, w in a["suggested"]],
                                       [w for _, w in b["suggested"]],
                                       rtol=SUGGEST_RTOL)
            np.testing.assert_allclose(a["llh"], b["llh"], rtol=SUGGEST_RTOL)
        else:
            key = "members" if q["family"] == "members_of" else "communities"
            assert a[key] == b[key], q


def _reads(answers, queries):
    return [(q["family"], a.get("members", a.get("communities")))
            for q, a in zip(queries, answers) if q["family"] != "suggest_for"]


@pytest.mark.parametrize("transport", ["local", "tcp"])
def test_port_fleet_matches_the_jax_fleet(world, transport):
    """The same archives and queries through both packages' replicas and
    routers: the reads equal each other (and the single-process serve),
    and the port's routed suggest holds against its single-process serve."""
    def run(mod_fleet, mod_router, **kw):
        reps = [mod_fleet.ShardReplica(world["fleet"], s, store=world["store"], **kw)
                for s in range(2)]
        servers = []
        if transport == "tcp":
            servers = [mod_fleet.ReplicaServer(r, port=0) for r in reps]
            eps = [mod_router.TcpReplica(s.host, s.port, timeout_s=30.0)
                   for s in servers]
        else:
            eps = [mod_fleet.LocalReplica(r) for r in reps]
        router = mod_router.FleetRouter(world["fleet"], eps)
        try:
            answers = [router.route(q) for q in world["queries"]]
            assert router.stats()["serve_errors"] == 0
            assert router.stats()["mixed_generation"] == 0
        finally:
            router.close()
            for s in servers:
                s.close()
            for r in reps:
                r.close()
        return answers

    ours = run(pfleet, prouter, device="cpu")
    ref = run(jfleet, jrouter)
    assert _reads(ours, world["queries"]) == _reads(ref, world["queries"])
    assert_fleet_answers(ours, world["single"], world["queries"])


def test_cli_serve_fleet_and_route_match_single_process(world, tmp_path):
    """Two `cli serve --fleet` replica processes on the CPU, `cli route`
    over them (answers equal the single-process `cli serve`), then `route
    --stop` tears them down; each replica's hello and final name its
    device."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with time_limit(SUPERVISOR_LIMIT_S):
        _serve_fleet_and_route(world, tmp_path, env)


def _serve_fleet_and_route(world, tmp_path, env):
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bigclam_tpu_torch.cli", "serve", "--fleet",
         world["fleet"], "--fleet-shard", str(s), "--listen", "127.0.0.1:0",
         "--graph", world["cache"], "--device", "cpu", "--quiet"],
        stdout=subprocess.PIPE, text=True, env=env) for s in range(2)]
    try:
        hellos = [json.loads(p.stdout.readline()) for p in procs]
        assert [h["shard"] for h in hellos] == [0, 1]
        assert all(h["device"] == "cpu" and h["generations"] == [1] for h in hellos)
        eps = ",".join(h["listening"] for h in hellos)
        results = tmp_path / "routed.jsonl"
        rc, out, err = _run(["route", "--fleet", world["fleet"], "--endpoints", eps,
                             "--queries", world["qfile"], "--results", str(results)])
        assert rc == 0, err
        assert out["serve_errors"] == 0 and out["mixed_generation"] == 0
        assert out["serve_queries"] == len(world["queries"])
        routed = [json.loads(x) for x in open(results)]
        assert_fleet_answers(routed, world["single"], world["queries"])
        rc, out, _ = _run(["route", "--fleet", world["fleet"], "--endpoints", eps,
                           "--stop"])
        assert rc == 0 and out == {"stopped": 2, "already_down": 0, "of": 2}
        finals = [json.loads(p.stdout.read().strip().splitlines()[-1]) for p in procs]
        assert [p.wait(timeout=30) for p in procs] == [0, 0]
        assert all(f["device"] == "cpu" and f["errors"] == 0 for f in finals)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_serve_fleet_refusals_carry_the_jax_messages(world):
    from bigclam_tpu.cli import main as jax_main

    def both(argv):
        out = []
        port_extra = ["--device", "cpu"] if argv[0] == "serve" else []
        for main, extra in ((cli.main, port_extra), (jax_main, [])):
            err = io.StringIO()
            with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
                rc = main(argv + extra)
            out.append((rc, err.getvalue().strip().splitlines()[-1]))
        assert out[0] == out[1]
        return out[0]

    rc, msg = both(["serve", "--fleet", world["fleet"]])
    assert rc == 1 and msg == "error: --fleet needs --listen HOST:PORT"
    rc, msg = both(["serve", "--fleet", world["fleet"], "--listen", "127.0.0.1:x"])
    assert rc == 1 and "port must be an integer" in msg
    rc, msg = both(["serve", "--fleet", world["fleet"], "--listen", "127.0.0.1:0",
                    "--graph", str(world["tmp"] / "g.txt")])
    assert rc == 1 and "compiled cache --graph" in msg
    rc, msg = both(["route", "--fleet", world["fleet"]])
    assert rc == 1 and msg == "error: route needs --endpoints and/or --members"


def test_replica_folds_in_on_its_device(world):
    rep = ShardReplica(world["fleet"], 0, store=world["store"], device="cpu")
    try:
        assert rep.device.type == "cpu" and rep.status()["device"] == "cpu"
        q = next(q for q in world["queries"] if q["family"] == "suggest_for")
        router = FleetRouter(world["fleet"], [LocalReplica(rep), LocalReplica(
            ShardReplica(world["fleet"], 1, store=world["store"], device="cpu"))])
        try:
            assert "suggested" in router.route(q)
        finally:
            router.close()
        (eng,) = rep._engines.values()
        assert eng.device.type == "cpu" and eng.dtype == torch.float64
    finally:
        rep.close()
    if not torch.cuda.is_available():
        from bigclam_tpu_torch.utils.device import DeviceUnavailableError

        with pytest.raises(DeviceUnavailableError):
            ShardReplica(world["fleet"], 0)          # the default is the card


# ------------------------------------------------ the router's scenarios
def _fleet(directory, shards, replicas=1, **kw):
    reps = [ShardReplica(directory, s, device="cpu", **kw)
            for s in range(shards) for _ in range(replicas)]
    return FleetRouter(directory, [LocalReplica(r) for r in reps]), reps


def _publish(d, ranges, F, raw, k):
    return publish_fleet_snapshot(d, ranges, F=F, raw_ids=raw, num_edges=4 * len(raw),
                                  meta={"k": k})


def test_members_cross_shard_dedup():
    """A raw id on two shards appears once in the merged answer."""
    F = np.zeros((10, 2))
    F[:, 1] = 1.0
    F[[5, 8], 0] = 1.0
    raw = np.array([0, 1, 2, 3, 4, 100, 6, 7, 100, 9], np.int64)
    with tempfile.TemporaryDirectory() as d:
        _publish(d, [(0, 6), (6, 10)], F, raw, 2)
        router, _ = _fleet(d, 2)
        try:
            assert router.route({"family": "members_of", "c": 0})["members"] == [100]
        finally:
            router.close()


def test_members_sorted_by_raw_id_under_permuted_cache():
    n = 12
    raw = np.random.default_rng(0).permutation(np.arange(100, 100 + n)).astype(np.int64)
    F = np.zeros((n, 2))
    F[:, 1] = 1.0
    rows = [0, 3, 5, 7, 8, 11]
    F[rows, 0] = 1.0
    F[5, 1] = 0.0
    with tempfile.TemporaryDirectory() as d:
        _publish(d, [(0, 4), (4, 8), (8, 12)], F, raw, 2)
        router, _ = _fleet(d, 3)
        try:
            got = router.route({"family": "members_of", "c": 0})
            assert got["members"] == sorted(int(raw[r]) for r in rows)
            ans = router.route({"family": "communities_of", "u": int(raw[5])})
            assert [c for c, _ in ans["communities"]] == [0]
        finally:
            router.close()


def test_empty_and_zero_width_shards():
    n = 8
    F = np.zeros((n, 3))
    F[:, 1] = 1.0
    F[[0, 2], 0] = 1.0
    with tempfile.TemporaryDirectory() as d:
        _publish(d, [(0, 4), (4, 4), (4, 8)], F, np.arange(n, dtype=np.int64), 3)
        router, _ = _fleet(d, 3)
        try:
            assert router.route({"family": "members_of", "c": 0})["members"] == [0, 2]
            assert router.route({"family": "members_of", "c": 2})["members"] == []
            ans = router.route({"family": "communities_of", "u": 6})
            assert [c for c, _ in ans["communities"]] == [1]
        finally:
            router.close()


def _ranges(n, shards):
    return [(s * n // shards, (s + 1) * n // shards) for s in range(shards)]


def test_rollout_pins_common_generation(world, tmp_path):
    """One replica a generation behind keeps the fleet on the common
    generation; once it loads, one refresh flips the whole fleet."""
    F = np.random.default_rng(1).uniform(0, 1, (N, K))
    d = str(tmp_path / "fleet")
    cfg = BigClamConfig(num_communities=K)
    publish_fleet_snapshot(d, _ranges(N, 2), F=F, num_edges=400, cfg=cfg)
    reps = [ShardReplica(d, s, device="cpu") for s in (0, 0, 1, 1)]
    router = FleetRouter(d, [LocalReplica(r) for r in reps])
    try:
        gen1 = router.stats()["serving_generation"]
        publish_fleet_snapshot(d, _ranges(N, 2), F=F, num_edges=400, cfg=cfg)
        for r in reps[:3]:
            assert r.maybe_load_next() is not None
        router.refresh()
        assert router.stats()["serving_generation"] == gen1
        assert "error" not in router.route({"family": "communities_of", "u": 0})
        assert router.stats()["rollouts"] == 0
        assert reps[3].maybe_load_next() is not None
        router.refresh()
        st = router.stats()
        assert st["serving_generation"] == gen1 + 1 and st["rollouts"] == 1
        assert "error" not in router.route({"family": "members_of", "c": 0})
        assert router.stats()["mixed_generation"] == 0
    finally:
        router.close()


def test_replica_holds_two_generations_and_answers_pinned(tmp_path):
    F = np.random.default_rng(2).uniform(0, 1, (N, K))
    d = str(tmp_path / "fleet")
    cfg = BigClamConfig(num_communities=K)
    s1, _ = publish_fleet_snapshot(d, _ranges(N, 2), F=F, num_edges=400, cfg=cfg)
    rep = ShardReplica(d, 0, device="cpu")
    s2, _ = publish_fleet_snapshot(d, _ranges(N, 2), F=F, num_edges=400, cfg=cfg)
    assert rep.maybe_load_next() == s2 and rep.generations == [s1, s2]
    assert rep.answer({"family": "communities_of", "u": 0, "gen": s1})["gen"] == s1
    gone = rep.answer({"family": "communities_of", "u": 0, "gen": s2 + 99})
    assert gone["error"] == "unknown_generation"


def test_router_fails_over_on_unknown_generation(world):
    rep0, rep1 = (ShardReplica(world["fleet"], s, device="cpu") for s in (0, 1))

    class Amnesiac(LocalReplica):
        def request(self, q, timeout=None, handle=None):
            if q.get("family") != "status":
                return {"error": "unknown_generation", "gen": q.get("gen")}
            return super().request(q, timeout)

    router = FleetRouter(world["fleet"], [Amnesiac(rep0), LocalReplica(rep0),
                                          LocalReplica(rep1)])
    try:
        u = int(world["raw"][0])
        for _ in range(4):
            assert "error" not in router.route({"family": "communities_of", "u": u})
        assert router.stats()["serve_errors"] == 0
    finally:
        router.close()


def test_replica_server_tcp_roundtrip_and_stop(world):
    rep = ShardReplica(world["fleet"], 0, device="cpu")
    srv = ReplicaServer(rep, port=0, budget_s=0.001)
    t = TcpReplica(srv.host, srv.port, timeout_s=10.0)
    try:
        st = t.request({"family": "status"})
        assert st["shard"] == 0 and "depth" in st and st["device"] == "cpu"
        ans = t.request({"family": "communities_of", "u": int(world["raw"][0]),
                         "gen": rep.generations[-1]})
        assert ans["gen"] == rep.generations[-1]
        assert t.request({"family": "stop"})["ok"] is True
        t0 = time.monotonic()
        assert srv.serve_until_stopped(10.0) and time.monotonic() - t0 < 10.0
    finally:
        t.close()
        srv.close()


def test_parse_endpoints_rejects_garbage():
    eps = cli.parse_endpoints("127.0.0.1:70,localhost:71", 5.0)
    assert [(e.host, e.port) for e in eps] == [("127.0.0.1", 70), ("localhost", 71)]
    for spec in ("nope", ""):
        with pytest.raises(SystemExit):
            cli.parse_endpoints(spec, 5.0)


def test_router_without_a_fleet_raises_router_error(tmp_path):
    with pytest.raises(RouterError):
        FleetRouter(str(tmp_path / "none"), [])
