"""The port's self-healing fleet on the CPU (the scenarios of the JAX
package's tests/test_fleet_chaos.py): the replica's drain wire op,
wire-fault recovery (torn frame, garbage line, connect refuse, stall)
through the router's bounded reader and failover, per-query deadlines,
tail-latency hedging, the membership-file reload, the FleetSupervisor's
restart / quarantine / drain / add-replica ladder over real
`bigclam_tpu_torch.cli serve --fleet --device cpu` child processes, the
`cli fleet` entry point, the router daemon wire and the idempotent `route
--stop`. Every supervisor test runs under a time limit of its own."""

import contextlib
import io
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from bigclam_tpu_torch import cli
from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.resilience.faults import FaultPlan, install_plan
from bigclam_tpu_torch.resilience.retry import RetryPolicy
from bigclam_tpu_torch.serve.fleet import LocalReplica, ReplicaServer, ShardReplica
from bigclam_tpu_torch.serve.router import FleetRouter, RouterServer, TcpReplica
from bigclam_tpu_torch.serve.snapshot import publish_fleet_snapshot
from bigclam_tpu_torch.serve.supervise import FleetSupervisor

pytestmark = pytest.mark.chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, K = 24, 3
# seconds a supervisor test may take before it is failed
SUPERVISOR_LIMIT_S = 90


def _wait_for(pred, timeout=30.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


@contextlib.contextmanager
def time_limit(seconds):
    """Fail the test with TimeoutError when it runs past `seconds`."""
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {seconds} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


def _replica(d):
    return ShardReplica(d, 0, device="cpu")


@pytest.fixture(scope="module")
def fleet1(tmp_path_factory):
    """A single-shard fleet publication: every replica covers the whole
    row range, so shard-0 replica sets of any size are valid."""
    F = np.random.default_rng(7).uniform(0.0, 1.0, size=(N, K))
    d = str(tmp_path_factory.mktemp("fleet1") / "snaps")
    publish_fleet_snapshot(d, [(0, N)], F=F, num_edges=40,
                           cfg=BigClamConfig(num_communities=K))
    return d


@pytest.fixture()
def faults():
    """install_plan with guaranteed cleanup (the plan is process-global)."""
    def install(*specs, seed=0):
        return install_plan(FaultPlan.from_spec({"seed": seed, "faults": list(specs)}))

    yield install
    install_plan(None)


@pytest.fixture()
def child_env(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))


def test_replica_drain_wire_op_acks_then_exits(fleet1):
    srv = ReplicaServer(_replica(fleet1), port=0)
    t = TcpReplica(srv.host, srv.port, timeout_s=10.0)
    try:
        assert "draining" not in t.request({"family": "status"})
        ack = t.request({"family": "drain"})
        assert ack["ok"] is True and ack["draining"] is True
        assert srv.serve_until_stopped(10.0)
        with pytest.raises((ConnectionError, TimeoutError, OSError)):
            TcpReplica(srv.host, srv.port, timeout_s=0.5).request({"family": "status"})
    finally:
        t.close()
        srv.close()


@pytest.mark.parametrize("kind", ["torn_frame", "garbage_line"])
def test_wire_fault_recovered_on_fresh_connection(fleet1, faults, kind):
    """Half a frame, or a non-JSON line, in place of an answer: the bounded
    reader classifies it as a transport failure and the retry on a fresh
    connection wins, without a wedged reader."""
    faults({"kind": kind, "site": "replica.answer_write", "at": 0})
    srv = ReplicaServer(_replica(fleet1), port=0)
    t = TcpReplica(srv.host, srv.port, timeout_s=10.0)
    try:
        t0 = time.perf_counter()
        ans = t.request({"family": "communities_of", "u": 1})
        assert "communities" in ans and "error" not in ans
        assert time.perf_counter() - t0 < 5.0
    finally:
        t.close()
        srv.close()


def test_connect_refuse_consumed_once_then_reaches_replica(fleet1, faults):
    faults({"kind": "connect_refuse", "site": "wire.connect", "at": 0})
    srv = ReplicaServer(_replica(fleet1), port=0)
    t = TcpReplica(srv.host, srv.port, timeout_s=10.0)
    try:
        assert t.request({"family": "status"})["shard"] == 0
    finally:
        t.close()
        srv.close()


def test_stalled_replica_bounded_then_failover(fleet1, faults):
    faults({"kind": "stall", "site": "replica.answer_write", "seconds": 3.0, "at": 0})
    srvs = [ReplicaServer(_replica(fleet1), port=0) for _ in range(2)]
    eps = [TcpReplica(s.host, s.port, timeout_s=10.0) for s in srvs]
    router = FleetRouter(fleet1, eps, request_timeout_s=0.4)
    try:
        t0 = time.perf_counter()
        ans = router.route({"family": "communities_of", "u": 2})
        assert "error" not in ans and "communities" in ans
        assert time.perf_counter() - t0 < 3.0
        st = router.stats()
        assert st["transport_failovers"] >= 1 and st["router_retries"] >= 1
    finally:
        router.close()
        for s in srvs:
            s.close()


def test_router_deadline_exceeded_is_typed_and_counted(fleet1, monkeypatch):
    monkeypatch.setenv("BIGCLAM_QTRACE_FAULT", json.dumps({"hop": "decode",
                                                           "delay_s": 5.0}))
    srv = ReplicaServer(_replica(fleet1), port=0)
    monkeypatch.delenv("BIGCLAM_QTRACE_FAULT")
    router = FleetRouter(fleet1, [TcpReplica(srv.host, srv.port, timeout_s=10.0)],
                         request_timeout_s=10.0, deadline_s=0.15, retry_rounds=1)
    try:
        t0 = time.perf_counter()
        assert router.route({"family": "communities_of", "u": 0}) == {
            "error": "deadline_exceeded"}
        assert time.perf_counter() - t0 < 3.0
        st = router.stats()
        assert st["deadline_exceeded"] == 1 and st["deadline_exceeded_rate"] > 0
    finally:
        router.close()
        srv.close()


def test_hedged_read_wins_on_slow_primary(fleet1):
    class Slow(LocalReplica):
        def request(self, q, timeout=None, handle=None):
            if q.get("family") != "status":
                time.sleep(0.25)
            return super().request(q, timeout=timeout, handle=handle)

    rep = _replica(fleet1)
    router = FleetRouter(fleet1, [Slow(rep), LocalReplica(rep)], hedge=True,
                         hedge_delay_s=0.02)
    try:
        for u in range(3):
            ans = router.route({"family": "communities_of", "u": u})
            assert "error" not in ans and "communities" in ans
        st = router.stats()
        assert st["hedged"] >= 1 and st["hedge_wins"] >= 1
        assert st["hedged_rate"] > 0 and st["serve_errors"] == 0
    finally:
        router.close()


def _write_members(path, seq, members):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"version": 1, "seq": seq, "control": "127.0.0.1:0",
                   "members": members}, f)
    os.replace(tmp, path)


def test_membership_file_reload_reconciles_endpoints(fleet1, tmp_path):
    srvs = [ReplicaServer(_replica(fleet1), port=0) for _ in range(2)]
    path = str(tmp_path / "members.json")

    def entry(i, state):
        return {"id": f"s0r{i}", "shard": 0,
                "endpoint": f"{srvs[i].host}:{srvs[i].port}", "state": state,
                "pid": 0, "restarts": 0}

    _write_members(path, 1, [entry(0, "up"), entry(1, "up")])
    router = FleetRouter(fleet1, members_file=path)
    try:
        assert len(router.endpoints) == 2 and router.membership_reloads == 1
        assert "error" not in router.route({"family": "members_of", "c": 0})
        _write_members(path, 2, [entry(0, "up"), entry(1, "draining")])
        router.refresh()
        assert len(router.endpoints) == 1 and router.membership_reloads == 2
        assert "error" not in router.route({"family": "members_of", "c": 0})
        with open(path, "w") as f:
            f.write("{not json")
        router.refresh()
        assert len(router.endpoints) == 1
    finally:
        router.close()
        for s in srvs:
            s.close()


def test_supervisor_spawns_the_port_cli_on_its_device(fleet1, tmp_path, monkeypatch):
    """Each replica is `python -m bigclam_tpu_torch.cli serve --fleet` with
    the supervisor's --device (no process starts here)."""
    seen = []

    class FakePopen:
        pid = 4242
        stdout = io.BytesIO(b"")

        def __init__(self, argv, **kw):
            seen.append(argv)

    monkeypatch.setattr("bigclam_tpu_torch.serve.supervise.subprocess.Popen", FakePopen)
    sup = FleetSupervisor(fleet1, str(tmp_path / "m.json"), device="cuda")
    sup._spawn(sup._slots[0])
    (argv,) = seen
    assert argv[1:5] == ["-m", "bigclam_tpu_torch.cli", "serve", "--fleet"]
    assert argv[argv.index("--device") + 1] == "cuda"
    assert "bigclam_tpu.cli" not in argv


def test_supervisor_restarts_killed_replica(fleet1, tmp_path, child_env):
    members = str(tmp_path / "members.json")
    sup = FleetSupervisor(fleet1, members, shards=1, replicas=1,
                          policy=RetryPolicy(base_s=0.05, max_s=0.2, seed=0),
                          stable_s=30.0, poll_s=0.05, hello_timeout_s=60.0,
                          device="cpu")
    with time_limit(SUPERVISOR_LIMIT_S):
        sup.up()
        try:
            assert sup.wait_all_up(timeout=60.0)
            with open(members) as f:
                doc = json.load(f)
            (m,) = doc["members"]
            assert m["state"] == "up" and m["endpoint"]
            pid0 = m["pid"]
            os.kill(pid0, signal.SIGKILL)

            def healed():
                st = sup.status()
                (mm,) = st["members"]
                return (st["replica_restarts"] >= 1 and mm["state"] == "up"
                        and mm["pid"] not in (None, pid0))

            assert _wait_for(healed, timeout=60.0)
            (m2,) = sup.status()["members"]
            t = TcpReplica(*m2["endpoint"].rsplit(":", 1), timeout_s=10.0)
            try:
                ans = t.request({"family": "status"})
                assert ans["shard"] == 0 and ans["generations"]
                assert ans["device"] == "cpu"
            finally:
                t.close()
            with open(members) as f:
                doc2 = json.load(f)
            assert doc2["seq"] > doc["seq"] and doc2["members"][0]["restarts"] >= 1
        finally:
            sup.down()


def test_supervisor_quarantines_crash_loop(fleet1, tmp_path, monkeypatch, child_env):
    """A kill at replica.start in every spawned child: after
    quarantine_after consecutive failures the slot is parked."""
    monkeypatch.setenv("BIGCLAM_FAULTS", json.dumps({"faults": [
        {"kind": "kill", "site": "replica.start", "at": 0}]}))
    members = str(tmp_path / "members.json")
    sup = FleetSupervisor(fleet1, members, shards=1, replicas=1,
                          policy=RetryPolicy(base_s=0.02, max_s=0.05, seed=0),
                          quarantine_after=2, stable_s=30.0, poll_s=0.05,
                          device="cpu")
    with time_limit(SUPERVISOR_LIMIT_S):
        sup.up()
        try:
            assert _wait_for(lambda: sup.status()["quarantined"] >= 1, timeout=60.0)
            st = sup.status()
            (m,) = st["members"]
            assert m["state"] == "quarantined" and st["replica_restarts"] == 2
            with open(members) as f:
                assert json.load(f)["members"][0]["state"] == "quarantined"
        finally:
            assert sup.down()["quarantined"] == 1


def test_supervisor_drain_and_add_replica(fleet1, tmp_path, child_env):
    members = str(tmp_path / "members.json")
    sup = FleetSupervisor(fleet1, members, shards=1, replicas=1,
                          policy=RetryPolicy(base_s=0.05, max_s=0.2, seed=0),
                          stable_s=30.0, poll_s=0.05, drain_grace_s=0.05,
                          device="cpu")
    with time_limit(SUPERVISOR_LIMIT_S):
        sup.up()
        try:
            assert sup.wait_all_up(timeout=60.0)
            assert sup.add_replica(0)["id"] == "s0r1"
            assert sup.wait_all_up(timeout=60.0)
            assert sup.drain("s0r0", timeout=30.0)
            states = {m["id"]: m["state"] for m in sup.status()["members"]}
            assert states == {"s0r0": "stopped", "s0r1": "up"}
            with open(members) as f:
                assert [m["id"] for m in json.load(f)["members"]] == ["s0r1"]
            assert not sup.drain("s0r0")
        finally:
            sup.down()


def _cli(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue().strip().splitlines(), err.getvalue()


def test_cli_fleet_up_status_drain_down(fleet1, tmp_path, child_env):
    """`cli fleet up --device cpu` in a process of its own, driven by `cli
    fleet status|add-replica|drain|down` and routed by `cli route
    --members`; the offline `status --members` and the refusals."""
    members = str(tmp_path / "members.json")
    with time_limit(SUPERVISOR_LIMIT_S):
        up = subprocess.Popen(
            [sys.executable, "-m", "bigclam_tpu_torch.cli", "fleet", "up", "--fleet",
             fleet1, "--shards", "1", "--replicas", "1", "--members", members,
             "--device", "cpu", "--drain-grace-s", "0.05"],
            stdout=subprocess.PIPE, text=True, start_new_session=True)
        try:
            hello = json.loads(up.stdout.readline())
            assert hello["all_up"] and hello["fleet_members"] == ["s0r0"]
            ctl = ["--control", hello["control"]]
            rc, lines, _ = _cli(["fleet", "add-replica", "--shard", "0"] + ctl)
            assert rc == 0 and json.loads(lines[-1])["member"]["id"] == "s0r1"
            assert _wait_for(lambda: all(
                m["state"] == "up" for m in json.load(open(members))["members"]),
                timeout=60.0)
            rc, lines, err = _cli(["route", "--fleet", fleet1, "--members", members,
                                   "--query", "members_of:0", "--query",
                                   "communities_of:3"])
            assert rc == 0, err
            assert json.loads(lines[-1])["serve_errors"] == 0
            rc, lines, _ = _cli(["fleet", "drain", "--member", "s0r0"] + ctl)
            assert rc == 0 and json.loads(lines[-1])["ok"]
            rc, lines, _ = _cli(["fleet", "status"] + ctl)
            st = json.loads(lines[-1])
            assert {m["id"]: m["state"] for m in st["members"]} == {
                "s0r0": "stopped", "s0r1": "up"}
            rc, lines, _ = _cli(["fleet", "status", "--members", members])
            assert rc == 0 and [m["id"] for m in json.loads(lines[-1])["members"]] == [
                "s0r1"]
            rc, _, _ = _cli(["fleet", "down"] + ctl)
            assert rc == 0
            final = json.loads(up.stdout.read().strip().splitlines()[-1])
            assert up.wait(timeout=30) == 0
            assert final["fleet_members"]["s0r1"]["state"] == "stopped"
        finally:
            if up.poll() is None:        # the supervisor and its replicas
                os.killpg(up.pid, signal.SIGKILL)
                up.wait()
    assert _cli(["fleet", "up"])[0] == 1
    assert _cli(["fleet", "drain", "--control", "127.0.0.1:1"])[0] == 1
    rc, _, err = _cli(["fleet", "status", "--members", str(tmp_path / "none.json")])
    assert rc == 1 and "error:" in err


def test_router_server_wire_roundtrip_status_and_stop(fleet1):
    server = RouterServer(FleetRouter(fleet1, [LocalReplica(_replica(fleet1))]))
    try:
        with socket.create_connection((server.host, server.port), timeout=10.0) as sock:
            sock.settimeout(10.0)
            f = sock.makefile("rb")

            def ask(q):
                sock.sendall((json.dumps(q) + "\n").encode())
                return json.loads(f.readline())

            assert ask({"family": "status"})["serving_generation"] is not None
            ans = ask({"family": "communities_of", "u": 0})
            assert "communities" in ans and "error" not in ans
            assert ask({"family": "not_a_family"}).get("error")
            assert ask({"family": "stop"})["ok"] is True
        assert server.serve_until_stopped(10.0)
    finally:
        server.close()


def test_route_stop_with_dead_endpoint_exits_zero(fleet1):
    srv = ReplicaServer(_replica(fleet1), port=0)
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    dead_port = probe.getsockname()[1]
    probe.close()
    try:
        rc, lines, err = _cli(["route", "--fleet", fleet1, "--endpoints",
                               f"{srv.host}:{srv.port},127.0.0.1:{dead_port}",
                               "--stop"])
        assert rc == 0
        assert json.loads(lines[-1]) == {"stopped": 1, "already_down": 1, "of": 2}
        assert "already down" in err
        assert srv.serve_until_stopped(10.0)
    finally:
        srv.close()
