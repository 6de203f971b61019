"""Profiler capture of the port (bigclam_tpu_torch/utils/profiling.py and
obs/trace.py): `cli profile` runs on the CPU, writes its capture and
prints the JAX `profile` keys; a capture marks its span names and steps
on the timeline; a capture that must see the card and records no CUDA
kernel refuses to pass; the step-time and overlap helpers; and, on the
card, the capture names the hand kernels of the profiled path."""

import json

import numpy as np
import pytest
import torch

from bigclam_tpu.cli import main as jax_main
from bigclam_tpu.utils import profiling as jprof

from bigclam_tpu_torch import cli
from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.models.agm import sample_planted_graph
from bigclam_tpu_torch.obs import RunTelemetry
from bigclam_tpu_torch.obs import trace as ptrace
from bigclam_tpu_torch.parallel import RingBigClamModel, make_mesh
from bigclam_tpu_torch.utils import profiling as pprof


@pytest.fixture(scope="module")
def graph_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("profile")
    g, _ = sample_planted_graph(200, 6, p_in=0.3, rng=np.random.default_rng(2))
    path = d / "g.txt"
    path.write_text("\n".join(f"{u}\t{v}" for u, v in zip(g.src, g.dst) if u < v))
    return path


def test_cli_profile_runs_and_prints_the_jax_keys(tmp_path, graph_file, capsys):
    common = ["profile", "--graph", str(graph_file), "--k", "6", "--steps",
              "2", "--warmup", "1", "--quiet"]
    pdir = tmp_path / "prof"
    assert cli.main(common + ["--device", "cpu", "--profile-dir", str(pdir),
                              "--telemetry-dir", str(tmp_path / "tel")]) == 0
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_main(common + ["--platform", "cpu", "--profile-dir",
                              str(tmp_path / "jprof")]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(ref) <= set(port)
    assert port["steps"] == 2 and port["kernel_path"] == "xla"
    assert port["profile_dir"] == str(pdir)
    assert port["top_kernels"] == []                  # no card here
    for name in (pprof.TRACE_NAME, pprof.TABLE_NAME, pprof.KERNELS_NAME):
        assert (pdir / name).is_file()
    trace = json.loads((pdir / pprof.TRACE_NAME).read_text())
    names = {e.get("name") for e in trace.get("traceEvents", [])}
    # the step annotations and the span names ride the timeline
    assert {"train#0", "train#1", "profiled_steps/step"} <= names
    rep = json.loads((tmp_path / "tel" / "run_report.json").read_text())
    assert rep["steps_timed"] >= 1 and rep["final"]["kernel_path"] == "xla"
    assert rep["spans"]["counts"]["profiled_steps/step"] == 2


def test_cli_profile_refuses_zero_steps(graph_file):
    with pytest.raises(SystemExit, match="--steps must be >= 1"):
        cli.main(["profile", "--graph", str(graph_file), "--device", "cpu",
                  "--steps", "0"])


def test_capture_that_must_see_the_card_refuses_an_empty_table(tmp_path):
    with pytest.raises(pprof.NoDeviceKernelsError, match="no CUDA kernel"):
        with pprof.trace(str(tmp_path / "p"), require_device=True):
            torch.ones(8).sum()
    # the files are written all the same, for the post-mortem
    assert (tmp_path / "p" / pprof.TRACE_NAME).is_file()
    with pprof.trace(None) as cap:
        assert cap is None


def test_spans_annotate_only_during_a_capture(tmp_path):
    with RunTelemetry(str(tmp_path / "t"), entry="fit"):
        assert not ptrace.capture_active()
        with ptrace.span("outside", emit=False) as s:
            assert s._ann is None
        with pprof.trace(str(tmp_path / "p")):
            assert ptrace.capture_active()
            with ptrace.span("inside", emit=False) as s:
                assert s._ann is not None
                assert ptrace.current_path() == "inside"
            ptrace.add_span("measured", 0.5)
        assert not ptrace.capture_active()
        ids = {ptrace.new_trace_id() for _ in range(5)}
    assert len(ids) == 5
    assert ptrace.step_annotation(3).name == "train#3"


def test_comm_hidden_fraction_equals_the_jax_one():
    for o, s in ((1.0, 2.0), (2.0, 1.0), (0.5, 0.0), (0.3, 0.3)):
        assert pprof.comm_hidden_fraction(o, s) == jprof.comm_hidden_fraction(o, s)


def test_step_time_and_overlap_report_on_a_repeated_device():
    g, _ = sample_planted_graph(150, 5, p_in=0.3, rng=np.random.default_rng(1))
    m = RingBigClamModel(g, BigClamConfig(num_communities=5),
                         make_mesh((2, 1), [torch.device("cpu")] * 2))
    state = m.init_state()
    assert pprof.step_time(m._step, state, steps=2, warmup=1) > 0
    cfg0, step0 = m.cfg, m._step
    rep = pprof.overlap_report(m, state, steps=1, warmup=0)
    assert set(rep) == {"sec_per_step", "comm_hidden_fraction",
                        "distinct_devices"}
    assert rep["distinct_devices"] == 1
    assert set(rep["sec_per_step"]) == {"overlap", "serial"}
    assert m.cfg is cfg0 and m._step is not step0


# --- on the card ---------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_profile_names_the_hand_kernels(tmp_path, graph_file, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    assert cli.main(["profile", "--graph", str(graph_file), "--k", "6",
                     "--steps", "2", "--quiet", "--profile-dir",
                     str(tmp_path / "p")]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    names = [k["name"] for k in out["top_kernels"]]
    assert out["kernel_path"] == "csr_fused"
    assert any("fused_superstep_kernel" in n for n in names), names
    assert all(k["device_ms"] > 0 for k in out["top_kernels"])
