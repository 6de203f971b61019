"""The port's perf ledger (bigclam_tpu_torch/obs/ledger.py, a copy of the
JAX module): its source is the JAX source with the imports renamed, its
records, match keys and diffs equal the JAX module's on the same run
reports, a port record never baselines against a JAX record in one shared
ledger (in either package's `perf diff`), and the config digest tells two
fits apart by their step config (`--alpha`) but not by whether they built
or loaded the kernel libraries."""

import json
import pathlib

import numpy as np
import pytest

from bigclam_tpu.cli import main as jax_main
from bigclam_tpu.obs import ledger as jled

from bigclam_tpu_torch import cli
from bigclam_tpu_torch.obs import ledger as pled
from bigclam_tpu_torch.obs import note_compile
from bigclam_tpu_torch.obs.report import load_reports

REPO = pathlib.Path(__file__).resolve().parent.parent


def copied_source_matches(name: str) -> None:
    """The port's copy of bigclam_tpu/obs/<name>.py is the JAX file with a
    first note line and the imports renamed."""
    port = (REPO / "bigclam_tpu_torch" / "obs" / f"{name}.py").read_text()
    ref = (REPO / "bigclam_tpu" / "obs" / f"{name}.py").read_text()
    note, _, body = port.partition("\n")
    assert note.startswith(f"# Copied from bigclam_tpu/obs/{name}.py")
    assert body.replace("bigclam_tpu_torch.obs", "bigclam_tpu.obs") == ref


def test_ledger_is_a_verbatim_copy():
    copied_source_matches("ledger")
    assert pled.LEDGER_ENV == jled.LEDGER_ENV
    assert pled.DEFAULT_PATH == jled.DEFAULT_PATH == "perf/ledger.jsonl"


@pytest.fixture(scope="module")
def graph_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("ledger")
    rng = np.random.default_rng(3)
    edges = set()
    for base in (0, 30, 60):
        for _ in range(120):
            u, v = rng.integers(base, base + 30, 2)
            if u != v:
                edges.add((min(u, v), max(u, v)))
    edges.add((29, 30))
    edges.add((59, 60))
    path = d / "g.txt"
    path.write_text("\n".join(f"{u}\t{v}" for u, v in sorted(edges)))
    return path


def _port_fit(graph, tel, ledger, *extra):
    assert cli.main(["fit", "--graph", str(graph), "--k", "4", "--device",
                     "cpu", "--max-iters", "4", "--quiet", "--telemetry-dir",
                     str(tel), "--perf-ledger", str(ledger), *extra]) == 0


def _jax_fit(graph, tel, ledger):
    assert jax_main(["fit", "--graph", str(graph), "--k", "4", "--platform",
                     "cpu", "--max-iters", "4", "--quiet", "--telemetry-dir",
                     str(tel), "--perf-ledger", str(ledger),
                     "--csr-kernels", "off"]) == 0


def _digest(ledger):
    return [r["cfg_digest"] for r in pled.PerfLedger(str(ledger)).load()]


def test_records_keys_and_diffs_equal_the_jax_module(tmp_path, graph_file, capsys):
    led = tmp_path / "led.jsonl"
    _port_fit(graph_file, tmp_path / "a", led)
    _port_fit(graph_file, tmp_path / "b", led, "--mesh", "2,1")
    capsys.readouterr()
    reps = [load_reports(str(tmp_path / d))[0] for d in ("a", "b")]
    secs = [[0.01, 0.012, 0.011], [0.02, 0.019]]
    eps = [[1e6, 1.1e6, 0.9e6], []]
    recs = []
    for rep, s, e in zip(reps, secs, eps):
        p = pled.build_record(rep, s, e, note="n")
        j = jled.build_record(rep, s, e, note="n")
        p["ts"] = j["ts"] = 1.0           # the wall clock of the build
        assert p == j
        assert pled.match_key(p) == jled.match_key(j)
        assert pled.validate_record(p) == jled.validate_record(j) == []
        recs.append(p)
    assert recs[1]["comms_bytes_per_step"] > 0 and recs[1]["mesh"] == "2x1"
    assert recs[0]["hbm_modeled_bytes"] > 0
    for tol in (0.25, 0.01):
        d = pled.diff_records(recs[0], recs[1], tolerance=tol)
        assert d == jled.diff_records(recs[0], recs[1], tolerance=tol)
        assert pled.render_diff(d) == jled.render_diff(d)
    for rec in recs:
        from_dir = pled.record_from_dir(str(tmp_path / ("a" if rec is recs[0] else "b")))
        ref = jled.record_from_dir(str(tmp_path / ("a" if rec is recs[0] else "b")))
        from_dir["ts"] = ref["ts"] = 1.0
        assert from_dir == ref


def test_port_records_never_baseline_against_jax_records(tmp_path, graph_file, capsys):
    """port, JAX, port in one ledger: the last port run's baseline is the
    first port run in both packages' `perf diff`, not the JAX run between
    them (whose fingerprint also says cpu here)."""
    led = tmp_path / "shared.jsonl"
    _port_fit(graph_file, tmp_path / "p1", led)
    _jax_fit(graph_file, tmp_path / "j1", led)
    _port_fit(graph_file, tmp_path / "p2", led)
    capsys.readouterr()
    recs = pled.PerfLedger(str(led)).load()
    assert [r["run"] for r in recs] == [
        (tmp_path / d / "run_id").read_text() for d in ("p1", "j1", "p2")]
    port1, jax1, port2 = recs
    assert port2["cfg_keys"] == port1["cfg_keys"] != jax1["cfg_keys"]
    assert all(k.startswith("torch:") for k in port1["cfg_keys"])
    for main in (cli.main, jax_main):
        # a matched baseline: 0, or 2 when CPU timing noise crosses the
        # band (1 would mean no baseline)
        assert main(["perf", "diff", "--ledger", str(led)]) in (0, 2)
        assert f"vs baseline {port1['run']}" in capsys.readouterr().out
    base = pled.PerfLedger(str(led)).baseline_for(port2, recs)
    assert base["run"] == port1["run"]
    assert jled.PerfLedger(str(led)).baseline_for(jax1, recs) is None


def test_alpha_changes_the_digest_and_builds_do_not(tmp_path, graph_file, capsys):
    led = tmp_path / "led.jsonl"
    _port_fit(graph_file, tmp_path / "a", led)
    _port_fit(graph_file, tmp_path / "b", led)
    _port_fit(graph_file, tmp_path / "c", led, "--alpha", "0.1")
    capsys.readouterr()
    d = _digest(led)
    assert d[0] == d[1] != d[2]
    assert cli.main(["perf", "diff", "--ledger", str(led)]) == 1
    assert "no matched baseline" in capsys.readouterr().err
    # a library build in one run and a load in the other leave the digest
    # alone (the build counters live under compiles.by_library)
    rep = load_reports(str(tmp_path / "a"))[0]
    built = json.loads(json.dumps(rep))
    built["compiles"]["by_library"] = {"nvcc:kernels": {"builds": 1}}
    loaded = json.loads(json.dumps(rep))
    loaded["compiles"]["by_library"] = {"nvcc:kernels": {"loads": 1}}
    assert (pled.build_record(built)["cfg_digest"]
            == pled.build_record(loaded)["cfg_digest"] == d[0])


def test_build_events_stay_out_of_the_digest(tmp_path):
    from bigclam_tpu_torch.obs import RunTelemetry

    with RunTelemetry(str(tmp_path / "t"), entry="fit") as tel:
        note_compile("nvcc:kernels", 3.0)
        assert pled.build_record(tel.report())["cfg_digest"] == "none"


def test_perf_record_show_and_exit_codes(tmp_path, graph_file, capsys):
    led = tmp_path / "led.jsonl"
    _port_fit(graph_file, tmp_path / "a", led)
    assert cli.main(["perf", "record", "--telemetry-dir", str(tmp_path / "a"),
                     "--ledger", str(led), "--note", "again"]) == 0
    capsys.readouterr()
    assert cli.main(["perf", "show", "--ledger", str(led), "-n", "5"]) == 0
    shown = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(shown) == 2 and shown[1]["note"] == "again"
    # a run re-recorded is never its own baseline
    assert cli.main(["perf", "diff", "--ledger", str(led)]) == 1
    assert cli.main(["perf", "diff", "--ledger", str(tmp_path / "none")]) == 1
    assert cli.main(["perf", "record", "--telemetry-dir",
                     str(tmp_path / "missing"), "--ledger", str(led)]) == 1
    # a regression exits 2: both records' spread (p90 - p50) is set to 0,
    # so the noise band diff_records widens by it cannot swallow the 10x
    # slowdown whatever this 4-step fit's measured step times were
    p50 = shown[0]["step_p50"] or 1
    slow = dict(shown[0], run="slow", step_p50=10 * p50, step_p90=10 * p50,
                steps=3)
    base = dict(shown[0], step_p50=p50, step_p90=p50, steps=3)
    pled.PerfLedger(str(tmp_path / "r.jsonl")).append(base)
    pled.PerfLedger(str(tmp_path / "r.jsonl")).append(slow)
    assert cli.main(["perf", "diff", "--ledger", str(tmp_path / "r.jsonl")]) == 2
