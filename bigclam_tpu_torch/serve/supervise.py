# Copied from bigclam_tpu/serve/supervise.py (the replicas it spawns are `bigclam_tpu_torch.cli serve --fleet` on the supervisor's device).
"""FleetSupervisor: the serving fleet's process parent.

The TRAINING path has a failure model — supervisor resume, the
transient/fatal taxonomy, rollback, quarantine. Without a parent, a `cli
serve --fleet` replica that dies stays dead, and the router's endpoint
set is frozen at start. This module is the fleet's
`resilience/supervisor.py`:

  * it SPAWNS every replica process (`cli serve --fleet --listen host:0`,
    endpoint discovered from the replica's hello line), tagging each with
    a member id ``s{shard}r{idx}`` via the BIGCLAM_FLEET_MEMBER env;
  * it RESTARTS a replica on unplanned exit, backing off with the
    ``RetryPolicy`` schedule (deterministic per-member jitter, seeded by
    crc32 of the member id — the same discipline call_with_retry uses);
    a restarted replica rejoins at the NEWEST generation because every
    replica runs with ``--watch-snapshots``;
  * it QUARANTINES a crash-looping slot: more than ``quarantine_after``
    consecutive failures (a success = surviving ``stable_s`` seconds)
    parks the member in state "quarantined" — the fleet degrades to its
    surviving replicas instead of burning CPU on a doomed respawn loop;
  * it PUBLISHES the roster to a membership file (atomic tmp+rename,
    monotonic ``seq``) that the router watches — elastic membership:
    ``add_replica`` and ``drain`` reshape the fleet mid-stream with zero
    dropped queries (drain = flip the member to "draining", wait one
    router reload interval so new dispatch stops, then send the wire
    ``drain`` op — the replica closes its admission door, finishes
    in-flight batches, and exits clean);
  * it ANSWERS a control socket (same newline-framed JSON wire) with
    ops ``status`` / ``add_replica`` / ``drain`` / ``down`` — what
    ``cli fleet status/add-replica/drain/down`` talk to.

Membership file (version 1):

    {"version": 1, "seq": 7, "control": "127.0.0.1:4444",
     "members": [{"id": "s0r0", "shard": 0, "endpoint": "127.0.0.1:4567",
                  "state": "up", "pid": 31337, "restarts": 1}, ...]}

States: starting → up → (restarting → up)* | quarantined | draining →
stopped. The router admits only state == "up".

Telemetry: schema'd ``replica_restart`` / ``replica_quarantined`` /
``membership`` events; the fleet final carries ``replica_restarts`` and
``quarantined`` for the perf ledger.

subprocess + threading + json + numpy only — `cli fleet` never imports
torch into a process-herding parent. Each replica is `python -m
bigclam_tpu_torch.cli serve --fleet ...` with the supervisor's
`--device`.
"""

from __future__ import annotations

import json
import os
import socket
import socketserver
import subprocess
import sys
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np

from bigclam_tpu_torch.resilience.retry import RetryPolicy

MEMBER_ENV = "BIGCLAM_FLEET_MEMBER"
MEMBERSHIP_VERSION = 1


def _tel_event(kind: str, **fields) -> None:
    from bigclam_tpu_torch.obs import telemetry as _obs

    tel = _obs.current()
    if tel is not None:
        tel.event(kind, **fields)


class _MemberSlot:
    """One replica slot: the process, its lifecycle state, and its
    failure ledger. All mutation happens under the supervisor lock."""

    __slots__ = (
        "id", "shard", "proc", "endpoint", "state", "pid", "restarts",
        "failures", "started_at", "next_attempt_at", "stopping", "rng",
        "log_fh",
    )

    def __init__(self, member_id: str, shard: int, rng):
        self.id = member_id
        self.shard = int(shard)
        self.proc: Optional[subprocess.Popen] = None
        self.endpoint: Optional[str] = None
        self.state = "starting"
        self.pid: Optional[int] = None
        self.restarts = 0          # lifetime respawn count for this slot
        self.failures = 0          # CONSECUTIVE failures (reset by uptime)
        self.started_at = 0.0
        self.next_attempt_at = 0.0
        self.stopping = False      # planned exit (drain/down): not a fault
        self.rng = rng
        self.log_fh = None

    def roster_entry(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "shard": self.shard,
            "endpoint": self.endpoint,
            "state": self.state,
            "pid": self.pid,
            "restarts": self.restarts,
        }


class FleetSupervisor:
    """See module docstring. Lifecycle: ``up()`` spawns the fleet +
    monitor + control server; ``down()`` (or the wire ``down`` op) tears
    everything back out. The membership file at ``members_path`` is the
    only thing the router needs."""

    def __init__(
        self,
        fleet_dir: str,
        members_path: str,
        shards: int = 1,
        replicas: int = 1,
        host: str = "127.0.0.1",
        control_port: int = 0,
        policy: Optional[RetryPolicy] = None,
        quarantine_after: int = 3,
        stable_s: float = 5.0,
        poll_s: float = 0.25,
        drain_grace_s: float = 0.5,
        hello_timeout_s: float = 60.0,
        replica_args: Optional[List[str]] = None,
        graph: Optional[str] = None,
        watch_snapshots_s: float = 1.0,
        log_dir: Optional[str] = None,
        seed: int = 0,
        device: Optional[str] = None,
    ):
        self.fleet_dir = fleet_dir
        self.device = device     # each replica's --device (None: its default)
        self.members_path = members_path
        self.host = host
        self.policy = policy or RetryPolicy(base_s=0.25, max_s=10.0,
                                            seed=seed)
        self.quarantine_after = max(int(quarantine_after), 1)
        self.stable_s = max(float(stable_s), 0.0)
        self.poll_s = max(float(poll_s), 0.05)
        self.drain_grace_s = max(float(drain_grace_s), 0.0)
        self.hello_timeout_s = float(hello_timeout_s)
        self.replica_args = list(replica_args or [])
        self.graph = graph
        self.watch_snapshots_s = float(watch_snapshots_s)
        self.log_dir = log_dir
        self.seed = int(seed)
        self._lock = threading.RLock()
        self._slots: List[_MemberSlot] = []
        self._next_idx: Dict[int, int] = {}   # shard -> next replica idx
        self._seq = 0
        self._stop_ev = threading.Event()
        self._down_ev = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._control: Optional[_ControlServer] = None
        self.control_port = int(control_port)
        self.total_restarts = 0
        self.total_quarantined = 0
        for s in range(max(int(shards), 1)):
            for _ in range(max(int(replicas), 1)):
                self._new_slot(s)

    # ------------------------------------------------------------ slots
    def _new_slot(self, shard: int) -> _MemberSlot:
        idx = self._next_idx.get(shard, 0)
        self._next_idx[shard] = idx + 1
        member_id = f"s{shard}r{idx}"
        rng = np.random.default_rng(
            [self.policy.seed, zlib.crc32(member_id.encode())]
        )
        slot = _MemberSlot(member_id, shard, rng)
        self._slots.append(slot)
        return slot

    def _spawn(self, slot: _MemberSlot) -> None:
        """Launch one replica process and hand its hello line to a reader
        thread (a crash before hello closes stdout → failure; the monitor
        thread sees the exit)."""
        argv = [
            sys.executable, "-m", "bigclam_tpu_torch.cli", "serve",
            "--fleet", self.fleet_dir,
            "--fleet-shard", str(slot.shard),
            "--listen", f"{self.host}:0",
            "--quiet",
        ]
        if self.device:
            argv += ["--device", self.device]
        if self.watch_snapshots_s > 0:
            argv += ["--watch-snapshots", str(self.watch_snapshots_s)]
        if self.graph:
            argv += ["--graph", self.graph]
        argv += self.replica_args
        env = dict(os.environ)
        env[MEMBER_ENV] = slot.id
        stderr = subprocess.DEVNULL
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
            if slot.log_fh is None:
                slot.log_fh = open(
                    os.path.join(self.log_dir, f"{slot.id}.log"), "ab"
                )
            stderr = slot.log_fh
        slot.proc = subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=stderr, env=env
        )
        slot.pid = slot.proc.pid
        slot.endpoint = None
        slot.started_at = time.monotonic()
        slot.state = "starting"
        threading.Thread(
            target=self._read_hello, args=(slot, slot.proc),
            name=f"bigclam-fleet-hello-{slot.id}", daemon=True,
        ).start()

    def _read_hello(self, slot: _MemberSlot, proc: subprocess.Popen) -> None:
        line = b""
        try:
            line = proc.stdout.readline()
        except Exception:
            pass
        hello = None
        try:
            hello = json.loads(line.decode())
        except Exception:
            pass
        with self._lock:
            if slot.proc is proc and hello and hello.get("listening"):
                slot.endpoint = str(hello["listening"])
                slot.state = "up"
                self._publish_locked()
        # keep draining stdout so the replica's exit prints never block
        # it on a full pipe
        try:
            while proc.stdout.read(65536):
                pass
        except Exception:
            pass

    # ------------------------------------------------------- membership
    def _publish_locked(self) -> None:
        self._seq += 1
        doc = {
            "version": MEMBERSHIP_VERSION,
            "seq": self._seq,
            "control": f"{self.host}:{self.control_port}",
            "members": [s.roster_entry() for s in self._slots
                        if s.state != "stopped"],
        }
        tmp = self.members_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self.members_path)
        _tel_event(
            "membership", seq=self._seq, members=len(doc["members"]),
            roster=[
                {"id": m["id"], "shard": m["shard"], "state": m["state"],
                 "restarts": m["restarts"]}
                for m in doc["members"]
            ],
        )

    def publish(self) -> None:
        with self._lock:
            self._publish_locked()

    # ---------------------------------------------------------- monitor
    def _monitor_loop(self) -> None:
        while not self._stop_ev.wait(self.poll_s):
            with self._lock:
                now = time.monotonic()
                for slot in self._slots:
                    if slot.state in ("quarantined", "stopped", "draining"):
                        continue
                    if slot.state == "restarting":
                        if now >= slot.next_attempt_at:
                            slot.restarts += 1
                            self.total_restarts += 1
                            _tel_event("replica_restart", member=slot.id,
                                       shard=slot.shard,
                                       restarts=slot.restarts)
                            self._spawn(slot)
                            self._publish_locked()
                        continue
                    proc = slot.proc
                    if proc is None or proc.poll() is None:
                        continue
                    if slot.stopping:
                        slot.state = "stopped"
                        self._publish_locked()
                        continue
                    # unplanned exit: a fault, an OOM kill, a crash
                    uptime = now - slot.started_at
                    slot.failures = (1 if uptime >= self.stable_s
                                     else slot.failures + 1)
                    slot.endpoint = None
                    slot.pid = None
                    if slot.failures > self.quarantine_after:
                        slot.state = "quarantined"
                        self.total_quarantined += 1
                        _tel_event("replica_quarantined", member=slot.id,
                                   shard=slot.shard,
                                   failures=slot.failures)
                        print(
                            f"[fleet] {slot.id} crash-looped "
                            f"({slot.failures} consecutive failures): "
                            "QUARANTINED",
                            file=sys.stderr, flush=True,
                        )
                        self._publish_locked()
                        continue
                    backoff = self.policy.backoff_s(
                        slot.failures - 1, slot.rng
                    )
                    slot.state = "restarting"
                    slot.next_attempt_at = now + backoff
                    print(
                        f"[fleet] {slot.id} exited "
                        f"(rc={proc.returncode}, uptime={uptime:.2f}s): "
                        f"restart in {backoff:.2f}s",
                        file=sys.stderr, flush=True,
                    )
                    self._publish_locked()

    # -------------------------------------------------------- lifecycle
    def up(self) -> "FleetSupervisor":
        with self._lock:
            for slot in self._slots:
                self._spawn(slot)
            self._control = _ControlServer(self, self.host,
                                           self.control_port)
            self.control_port = self._control.port
            self._publish_locked()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="bigclam-fleet-monitor",
            daemon=True,
        )
        self._monitor.start()
        return self

    def wait_all_up(self, timeout: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                pending = [s for s in self._slots
                           if s.state in ("starting", "restarting")]
            if not pending:
                return True
            time.sleep(0.05)
        return False

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "seq": self._seq,
                "control": f"{self.host}:{self.control_port}",
                "members": [s.roster_entry() for s in self._slots],
                "replica_restarts": self.total_restarts,
                "quarantined": self.total_quarantined,
            }

    def add_replica(self, shard: int) -> Dict[str, Any]:
        with self._lock:
            slot = self._new_slot(int(shard))
            self._spawn(slot)
            self._publish_locked()
            return slot.roster_entry()

    def _wire_op(self, endpoint: str, op: dict,
                 timeout: float = 10.0) -> Optional[dict]:
        host, port = endpoint.rsplit(":", 1)
        try:
            with socket.create_connection((host, int(port)),
                                          timeout=timeout) as sock:
                sock.settimeout(timeout)
                sock.sendall((json.dumps(op) + "\n").encode())
                f = sock.makefile("rb")
                line = f.readline()
            return json.loads(line.decode()) if line else None
        except (OSError, ValueError):
            return None

    def drain(self, member_id: str, timeout: float = 30.0) -> bool:
        """Zero-drop detach: flip to "draining" + publish (the router
        stops dispatching within one reload interval), wait the grace,
        then the wire drain op — the replica closes its admission door,
        finishes in-flight, and exits. Ack'd only after the exit."""
        with self._lock:
            slot = next((s for s in self._slots if s.id == member_id),
                        None)
            if slot is None or slot.state != "up" or not slot.endpoint:
                return False
            slot.state = "draining"
            slot.stopping = True
            endpoint = slot.endpoint
            proc = slot.proc
            self._publish_locked()
        time.sleep(self.drain_grace_s)
        self._wire_op(endpoint, {"family": "drain"})
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=5.0)
        with self._lock:
            slot.state = "stopped"
            slot.endpoint = None
            slot.pid = None
            self._publish_locked()
        return True

    def down(self, timeout: float = 30.0) -> Dict[str, Any]:
        """Tear the fleet out: stop ops to live replicas, SIGKILL any
        straggler, publish the emptied roster, leave counters for the
        caller's telemetry final."""
        self._stop_ev.set()
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
            self._monitor = None
        with self._lock:
            live = [s for s in self._slots
                    if s.proc is not None and s.proc.poll() is None]
            for slot in live:
                slot.stopping = True
        for slot in live:
            if slot.endpoint:
                self._wire_op(slot.endpoint, {"family": "stop"},
                              timeout=5.0)
        deadline = time.monotonic() + timeout
        for slot in live:
            rem = max(deadline - time.monotonic(), 0.1)
            try:
                slot.proc.wait(timeout=rem)
            except subprocess.TimeoutExpired:
                slot.proc.kill()
                try:
                    slot.proc.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    pass
        with self._lock:
            for slot in self._slots:
                if slot.state != "quarantined":
                    slot.state = "stopped"
                slot.endpoint = None
                slot.pid = None
            self._publish_locked()
            for slot in self._slots:
                if slot.log_fh is not None:
                    slot.log_fh.close()
                    slot.log_fh = None
        if self._control is not None:
            self._control.close()
            self._control = None
        return {
            "replica_restarts": self.total_restarts,
            "quarantined": self.total_quarantined,
        }

    def wait_down(self, timeout: Optional[float] = None) -> bool:
        """Block until a wire `down` op (or signal handler) tears the
        fleet out — what `cli fleet up` parks on."""
        return self._down_ev.wait(timeout)


class _ControlServer:
    """Newline-framed JSON control wire (the same framing the replicas
    and the router daemon speak): status / add_replica / drain / down."""

    def __init__(self, sup: FleetSupervisor, host: str, port: int):
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for raw in self.rfile:
                    try:
                        op = json.loads(raw.decode())
                    except (ValueError, UnicodeDecodeError):
                        self._reply({"error": "bad json"})
                        continue
                    name = op.get("op")
                    if name == "status":
                        self._reply(sup.status())
                    elif name == "add_replica":
                        entry = sup.add_replica(int(op.get("shard", 0)))
                        self._reply({"ok": True, "member": entry})
                    elif name == "drain":
                        ok = sup.drain(str(op.get("member", "")))
                        self._reply({"ok": ok})
                    elif name == "down":
                        self._reply({"ok": True})
                        threading.Thread(
                            target=outer._do_down, daemon=True
                        ).start()
                        return
                    else:
                        self._reply({"error": f"unknown op {name!r}"})

            def _reply(self, doc):
                self.wfile.write((json.dumps(doc) + "\n").encode())
                self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self.sup = sup
        self._srv = Server((host, int(port)), Handler)
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(
            target=self._srv.serve_forever,
            name="bigclam-fleet-control", daemon=True,
        )
        self._thread.start()

    def _do_down(self):
        self.sup.down()
        self.sup._down_ev.set()

    def close(self):
        self._srv.shutdown()
        self._srv.server_close()


def control_op(control: str, op: dict, timeout: float = 60.0) -> dict:
    """One request/response round-trip against a supervisor's control
    endpoint (`cli fleet status/down/add-replica/drain`)."""
    host, port = control.rsplit(":", 1)
    with socket.create_connection((host, int(port)),
                                  timeout=timeout) as sock:
        sock.settimeout(timeout)
        sock.sendall((json.dumps(op) + "\n").encode())
        f = sock.makefile("rb")
        line = f.readline()
    if not line:
        raise ConnectionError(f"no answer from control {control}")
    return json.loads(line.decode())
