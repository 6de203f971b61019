"""A run's result line: its keys, the metrics each mode reports, and no
result without a card."""

import json
import subprocess
import sys
import time

import pytest

from conftest import CELLS, REPO, tiny_config
from clambench import harness, registry

BASE = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(bench, cell_name, trace):
    cell, config = tiny_config(bench, cell_name)
    result, log = harness.run(bench, cell, config, registry.mix(cell["traffic"]),
                              registry.limits(cell_name), 2**31 + 77, 1.0, bool(trace),
                              time.perf_counter(), device="cpu")
    want = BASE + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == want
    json.loads(json.dumps(result, allow_nan=False))
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    if trace:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        names = {m["name"] for m in registry.per_layer_for(bench, cell_name)}
        # on the CPU the readers of the device trace find nothing to read
        assert set(result["metrics"]) <= names
        assert {"setup.graph_s", "setup.seeding_s"} <= set(result["metrics"])
        assert "step_mfu" not in result["metrics"]          # no device time here
    else:
        assert set(result["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    for c in result["checks"].values():
        assert c["value"] <= c["limit"]
    assert log["iterations"] >= 1


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "clambench/run.py", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_e2e_metrics_take_every_iteration():
    win = {"stamps": [0.0, 0.1, 0.2, 0.3, 0.9, 1.0]}
    m = harness.e2e_metrics(win, edges=1000, peak=2_000_000_000, setup_s=3.0)
    assert m["edges_per_s"] == pytest.approx(5 * 1000 / 1.0)
    assert m["iter_ms_p90"] == pytest.approx(400.0)   # inclusive p90 of 100 x4, 600
    assert m["peak_gb"] == 2.0 and m["setup_s"] == 3.0
