"""`cli report` and `cli watch` of the port (bigclam_tpu_torch/obs/report.py
and watch.py, copies of the JAX modules): the sources are the JAX sources
with the imports renamed, the port's `report --json` equals the JAX
`report --json` on a port telemetry directory (its `comms` and
`memory_model` sections included), and `watch` renders a frame of it."""

import json

import numpy as np
import pytest

from bigclam_tpu.cli import main as jax_main

from bigclam_tpu_torch import cli
from bigclam_tpu_torch.obs import report as preport
from bigclam_tpu_torch.obs import watch as pwatch

from test_torch_ledger import copied_source_matches


@pytest.mark.parametrize("name", ["report", "watch"])
def test_renderers_are_verbatim_copies(name):
    copied_source_matches(name)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A port ring fit with telemetry and health samples: comms, balance,
    memory_model, health and step events."""
    d = tmp_path_factory.mktemp("report")
    rng = np.random.default_rng(7)
    lines = sorted({(min(u, v), max(u, v))
                    for u, v in rng.integers(0, 80, (400, 2)) if u != v})
    graph = d / "g.txt"
    graph.write_text("\n".join(f"{u} {v}" for u, v in lines))
    tel = d / "tel"
    assert cli.main(["fit", "--graph", str(graph), "--k", "5", "--device",
                     "cpu", "--max-iters", "6", "--quiet", "--mesh", "2,1",
                     "--schedule", "ring", "--telemetry-dir", str(tel),
                     "--health-every", "2"]) == 0
    return tel


def test_port_report_json_equals_the_jax_report(port_run, capsys):
    capsys.readouterr()
    assert cli.main(["report", str(port_run), "--json"]) == 0
    port = json.loads(capsys.readouterr().out)
    assert jax_main(["report", str(port_run), "--json"]) == 0
    ref = json.loads(capsys.readouterr().out)
    assert port == ref
    assert port["comms"]["bytes_per_step"] > 0
    assert set(port["comms"]["sites"]) == {
        "ring/ppermute_F_rot", "ring/psum_sumF", "ring/psum_scalars"}
    assert port["memory_model"]["hbm_bytes_per_device"] > 0
    assert port["memory_model"]["addressable_bytes"] > 0
    assert port["errors"] == 0 and port["schema_errors"] == []


def test_port_report_text_equals_the_jax_report(port_run, capsys):
    capsys.readouterr()
    assert cli.main(["report", str(port_run)]) == 0
    port = capsys.readouterr().out
    assert jax_main(["report", str(port_run)]) == 0
    assert port == capsys.readouterr().out
    assert "memory model (per device, modeled)" in port
    assert "collective traffic (modeled)" in port


def test_watch_renders_a_frame(port_run, capsys):
    capsys.readouterr()
    assert cli.main(["watch", str(port_run), "--once", "--width", "16"]) == 0
    frame = capsys.readouterr().out
    assert "[finalized]" in frame and "llh" in frame
    assert "comms" in frame and "hbm modeled" in frame
    assert frame.strip() == pwatch.render_frame(str(port_run), width=16).strip()
    assert preport.load_events(str(port_run))


def test_report_of_a_missing_dir_exits_1(tmp_path, capsys):
    assert cli.main(["report", str(tmp_path / "nothing")]) == 1
    assert cli.main(["report", str(tmp_path / "nothing"), "--json"]) == 1
