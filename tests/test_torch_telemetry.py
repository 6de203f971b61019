"""The port's run telemetry (obs.telemetry, obs.trace, obs.heartbeat,
utils.metrics, utils.profiling): every event a port fit writes passes the
JAX package's schema validator and its jax-free `cli report` renders the
directory; the stall heartbeat escalates after N deadlines and a beat
re-arms it; spans with telemetry off are the shared no-op; the fit loop's
phase spans, stage events, metrics records and build events land where the
run report reads them."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from bigclam_tpu.obs.report import render as jax_render
from bigclam_tpu.obs.schema import EVENT_KINDS as JAX_EVENT_KINDS
from bigclam_tpu.obs.schema import SCHEMA_VERSION as JAX_SCHEMA_VERSION
from bigclam_tpu.obs.schema import validate_events_file as jax_validate

from bigclam_tpu_torch import cli
from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.models.agm import sample_planted_graph
from bigclam_tpu_torch.models.bigclam import BigClamModel
from bigclam_tpu_torch.obs import (
    EVENT_KINDS,
    SCHEMA_VERSION,
    RunTelemetry,
    install,
    note_compile,
    span,
    uninstall,
)
from bigclam_tpu_torch.obs import trace
from bigclam_tpu_torch.obs.telemetry import EVENTS_NAME
from bigclam_tpu_torch.resilience import FaultPlan, install_plan
from bigclam_tpu_torch.utils.metrics import MetricsLogger
from bigclam_tpu_torch.utils.profiling import StageProfile

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _events(directory):
    with open(os.path.join(directory, EVENTS_NAME)) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture
def telem(tmp_path):
    tel = install(RunTelemetry(str(tmp_path / "telem"), entry="test"))
    try:
        yield tel
    finally:
        tel.finalize()
        uninstall(tel)
        install_plan(None)


def _edge_file(tmp_path):
    g, _ = sample_planted_graph(240, 6, p_in=0.3, rng=np.random.default_rng(0))
    path = tmp_path / "g.txt"
    np.savetxt(path, np.stack([g.src, g.dst], 1)[g.src < g.dst], fmt="%d")
    return str(path)


def test_schema_is_the_jax_schema():
    assert SCHEMA_VERSION == JAX_SCHEMA_VERSION == 2
    assert EVENT_KINDS == JAX_EVENT_KINDS


def test_cli_fit_events_validate_and_render_with_the_jax_tools(tmp_path):
    """A fit with checkpoints, a rollback, health and metrics: every event
    passes the JAX validator and `cli report` renders the directory."""
    tdir = tmp_path / "tel"
    install_plan(FaultPlan([{"kind": "nan_inject", "site": "fit.step", "at": 3}]))
    try:
        out, _, _ = cli.fit(cli.build_parser().parse_args([
            "fit", "--graph", _edge_file(tmp_path), "--k", "6", "--device",
            "cpu", "--max-iters", "6", "--conv-tol", "0", "--quiet",
            "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "2",
            "--telemetry-dir", str(tdir), "--health-every", "2",
            "--metrics", str(tmp_path / "m.jsonl"), "--csr-kernels", "on"]))
    finally:
        install_plan(None)
    n, errors = jax_validate(str(tdir / EVENTS_NAME))
    assert errors == [] and n > 20
    kinds = {e["kind"] for e in _events(tdir)}
    assert {"start", "stage", "span", "step", "health", "checkpoint",
            "rollback", "fault_injected", "end"} <= kinds
    text, rc = jax_render(str(tdir))
    assert rc == 0
    assert "span breakdown" in text and "model health" in text
    rep = json.load(open(tdir / "run_report.json"))
    assert rep["final"]["kernel_path"] == "csr_fused"
    assert rep["fingerprint"]["backend"] == "cpu"
    # the steps kept, the NaN step, and iterations 0-2 replayed from the
    # snapshot taken at 0
    assert rep["spans"]["counts"]["fit/fit_loop/sync"] == out["steps"] + 1 + 3
    assert set(out["stage_seconds"]) == {"graph", "model_build", "seeding",
                                         "upload", "fit"}
    lines = open(tmp_path / "m.jsonl").read().splitlines()
    assert len(lines) == out["steps"] + 3     # the replayed iterations too
    assert all("accept_hist" in json.loads(line) for line in lines)


def test_heartbeat_escalates_after_consecutive_stalls(tmp_path):
    hits = []
    tel = RunTelemetry(str(tmp_path / "t"), entry="test", heartbeat_s=0.05,
                       quiet=True, heartbeat_escalate=2)
    tel.heartbeat.on_escalate = hits.append
    time.sleep(0.5)
    tel.finalize()
    ev = _events(tel.directory)
    stalls = [e for e in ev if e["kind"] == "stall"]
    esc = [e for e in ev if e["kind"] == "stall_escalated"]
    assert len(stalls) >= 2
    assert len(esc) == 1 and esc[0]["stalls"] == 2
    assert len(hits) == 1 and hits[0]["stalls"] == 2
    assert tel.report()["heartbeat"]["escalations"] == 1
    assert jax_validate(os.path.join(tel.directory, EVENTS_NAME))[1] == []


def test_heartbeat_beat_rearms_escalation(tmp_path):
    tel = RunTelemetry(str(tmp_path / "t"), entry="test", heartbeat_s=0.06,
                       quiet=True, heartbeat_escalate=3)
    t0 = time.monotonic()
    while time.monotonic() - t0 < 0.45:
        tel.heartbeat.beat(iter=1)
        time.sleep(0.01)
    tel.finalize()
    assert not [e for e in _events(tel.directory)
                if e["kind"] == "stall_escalated"]


def test_stall_reports_host_state_only(tmp_path):
    """The stall event carries the open span stack, the last health sample
    and the main thread's last device snapshot; the watchdog reads no
    device itself, and a failing escalation hook is reported."""
    tel = install(RunTelemetry(str(tmp_path / "t"), entry="test",
                               heartbeat_s=0.05, quiet=True,
                               heartbeat_escalate=1))
    tel.last_devices = [{"device": "cuda:0", "bytes_in_use": 1}]
    tel.event("health", iter=4, grad_norm=1.0)

    def broken(info):
        raise RuntimeError("hook failed")

    tel.heartbeat.on_escalate = broken
    try:
        with span("fit"):
            with span("fit_loop/sync", emit=False):
                time.sleep(0.3)
    finally:
        tel.finalize()
        uninstall(tel)
    ev = _events(tel.directory)
    stall = [e for e in ev if e["kind"] == "stall"][0]
    assert stall["spans"][-1] == "fit/fit_loop/sync"
    assert stall["health"]["iter"] == 4
    assert stall["devices"] == [{"device": "cuda:0", "bytes_in_use": 1}]
    notes = [e for e in ev if e["kind"] == "note"]
    assert notes and "hook failed" in notes[0]["error"]


def test_span_off_is_the_shared_noop():
    assert trace.span("x") is trace.NULL_SPAN
    assert trace.span("y", emit=False, a=1) is trace.NULL_SPAN
    with trace.span("z") as s:
        s.set(a=1)
    assert trace.open_spans() == []


def test_fit_loop_phase_spans_and_no_events_per_iteration(telem):
    g, _ = sample_planted_graph(240, 6, p_in=0.3, rng=np.random.default_rng(0))
    cfg = BigClamConfig(num_communities=6, max_iters=4, conv_tol=0.0)
    res = BigClamModel(g, cfg, device="cpu").fit(None)
    counts = telem.report()["spans"]["counts"]
    steps = len(res.llh_history)
    for phase in ("dispatch", "sync"):
        assert counts[f"fit_loop/{phase}"] == steps
    assert counts["fit_loop/extract_F"] == 1
    names = [e["path"] for e in _events(telem.directory) if e["kind"] == "span"]
    assert names == ["fit_loop/extract_F"]


def test_stage_profile_forwards_to_telemetry(telem):
    prof = StageProfile()
    with prof.stage("graph"):
        with prof.stage("seeding"):
            time.sleep(0.01)
    ev = _events(telem.directory)
    assert [e["name"] for e in ev if e["kind"] == "stage"] == ["seeding", "graph"]
    assert [e["path"] for e in ev if e["kind"] == "span"] == ["graph/seeding", "graph"]
    assert telem.report()["stages"]["seconds"]["seeding"] >= 0.01
    assert set(prof.seconds) == {"graph", "seeding"}


def test_metrics_logger_records_and_telemetry_steps(tmp_path, telem):
    path = tmp_path / "m.jsonl"
    with MetricsLogger(str(path), echo=False) as ml:
        cb = ml.step_callback(100, path="xla", num_nodes=10)
        cb(0, -50.0, {"accept_hist": [3, 2, 5]})
        cb(1, -40.0)
        ml.log({"k": 3, "llh": -40.0})
    recs = [json.loads(line) for line in open(path)]
    assert recs[0]["accept_rate"] == 0.5 and "load_s" in recs[0]
    assert recs[1]["rel_dllh"] == pytest.approx(0.2)
    kinds = [e["kind"] for e in _events(telem.directory)]
    assert kinds.count("step") == 2 and kinds.count("metric") == 1


def test_build_events_are_compile_events(telem):
    note_compile("nvcc:kernels", 12.5)
    note_compile("g++:native", 0.01, cached=True)
    comp = telem.report()["compiles"]
    assert comp["count"] == comp["backend_compiles"] == 1
    assert comp["loads"] == 1 and comp["backend_compile_s"] == 12.5
    assert comp["by_key"]["nvcc:kernels"]["builds"] == 1
    ev = [e for e in _events(telem.directory) if e["kind"] == "compile"]
    assert [(e["name"], e["cached"]) for e in ev] == [
        ("nvcc:kernels", False), ("g++:native", True)]


def test_native_library_load_is_a_compile_event(tmp_path):
    """In a fresh process the host library's load (or build) lands in the
    telemetry as `compile` g++:native."""
    from bigclam_tpu_torch.graph import native

    if not native.status()["loaded"]:
        pytest.skip("the native host library does not build here")
    tdir = tmp_path / "t"
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "bigclam_tpu_torch.cli", "fit", "--graph",
         _edge_file(tmp_path), "--k", "4", "--device", "cpu", "--max-iters",
         "2", "--quiet", "--telemetry-dir", str(tdir)],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr
    ev = [e for e in _events(tdir) if e["kind"] == "compile"]
    assert [e["name"] for e in ev] == ["g++:native"]


def test_telemetry_off_costs_no_events(tmp_path):
    """With no telemetry installed the loop writes nothing and the fit is
    the same fit."""
    g, _ = sample_planted_graph(240, 6, p_in=0.3, rng=np.random.default_rng(0))
    cfg = BigClamConfig(num_communities=6, max_iters=3, conv_tol=0.0,
                        health_every=1)
    a = BigClamModel(g, cfg, device="cpu").fit(None)
    tel = install(RunTelemetry(str(tmp_path), entry="test"))
    try:
        b = BigClamModel(g, cfg, device="cpu").fit(None)
    finally:
        tel.finalize()
        uninstall(tel)
    assert a.llh_history == b.llh_history
    np.testing.assert_array_equal(a.F, b.F)
