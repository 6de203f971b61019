"""The port's resilience (resilience/, the rollback of run_fit_loop, the
CLI's resume and retry) against the JAX package: the same fault plan gives
the same rollback events and LLH histories in both packages (dense, and
the dp = 4 sharded and ring trainers), both raise FloatingPointError once
the budget is spent, rollback on and off agree bit for bit without a
fault, a NaN in F gives a non-finite LLH on every kernel path, the retry
taxonomy and backoff equal JAX's, the supervisor retries with resume, and
the port CLI killed by BIGCLAM_FAULTS resumes bit-identically."""

import dataclasses
import json
import os
import subprocess
import sys
import zipfile
import zlib

import numpy as np
import pytest
import torch

import jax

from bigclam_tpu import resilience as jres
from bigclam_tpu.cli import main as jax_main
from bigclam_tpu.config import BigClamConfig as JaxConfig
from bigclam_tpu.graph.ingest import graph_from_edges as jax_graph_from_edges
from bigclam_tpu.models.bigclam import BigClamModel as JaxModel
from bigclam_tpu.obs import RunTelemetry as JaxTelemetry
from bigclam_tpu.obs import install as jax_install
from bigclam_tpu.obs import uninstall as jax_uninstall
from bigclam_tpu.parallel import RingBigClamModel as JaxRing
from bigclam_tpu.parallel import ShardedBigClamModel as JaxSharded
from bigclam_tpu.parallel import make_mesh as jax_make_mesh

from bigclam_tpu_torch import cli
from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.models.bigclam import BigClamModel
from bigclam_tpu_torch.models.sparse import SparseBigClamModel
from bigclam_tpu_torch.obs import RunTelemetry, install, uninstall
from bigclam_tpu_torch.obs.telemetry import EVENTS_NAME
from bigclam_tpu_torch.parallel import (
    RingBigClamModel,
    ShardedBigClamModel,
    make_mesh,
)
from bigclam_tpu_torch.resilience import (
    FatalError,
    FaultPlan,
    RetryPolicy,
    Supervisor,
    TransientError,
    call_with_retry,
    classify,
    install_plan,
)
from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

pytestmark = pytest.mark.chaos
torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    install_plan(None)
    jres.install_plan(None)


def _two_cliques():
    cliq = []
    for base in (0, 4):
        for i in range(4):
            for j in range(i + 1, 4):
                cliq.append((base + i, base + j))
    cliq.append((3, 4))
    return jax_graph_from_edges(cliq)


def _port_graph(g):
    return Graph(indptr=g.indptr, indices=g.indices, raw_ids=g.raw_ids)


def _problem(max_iters=10, **kw):
    g = _two_cliques()
    jc = JaxConfig(num_communities=2, dtype="float64", max_iters=max_iters,
                   conv_tol=0.0, **kw)
    F0 = np.random.default_rng(5).uniform(0.1, 1.0, size=(g.num_nodes, 2))
    return g, jc, BigClamConfig(**dataclasses.asdict(jc)), F0


def _events(directory):
    with open(os.path.join(directory, EVENTS_NAME)) as f:
        return [json.loads(line) for line in f if line.strip()]


def _rollbacks(directory):
    return [(e["iter"], e["rollbacks"], e["resume_iter"], e["step_scale"])
            for e in _events(directory) if e["kind"] == "rollback"]


def _models(kind, g, jc, cfg):
    if kind == "dense":
        return JaxModel(g, jc), BigClamModel(_port_graph(g), cfg, device="cpu")
    jmesh = jax_make_mesh((4, 1), jax.devices()[:4])
    pmesh = make_mesh((4, 1), [CPU] * 4)
    if kind == "sharded":
        return (JaxSharded(g, jc, jmesh),
                ShardedBigClamModel(_port_graph(g), cfg, pmesh))
    return (JaxRing(g, jc, jmesh, balance=False),
            RingBigClamModel(_port_graph(g), cfg, pmesh, balance=False))


def _fit_both(kind, plan, tmp_path, **kw):
    """(jax result, port result, jax rollback events, port rollback events)
    of the same problem under the same fault plan."""
    g, jc, cfg, F0 = _problem(**kw)
    jm, pm = _models(kind, g, jc, cfg)
    out = []
    for name, tel_cls, inst, uninst, install_p, plan_cls, model in (
        ("jax", JaxTelemetry, jax_install, jax_uninstall, jres.install_plan,
         jres.FaultPlan, jm),
        ("port", RunTelemetry, install, uninstall, install_plan, FaultPlan, pm),
    ):
        tel = inst(tel_cls(str(tmp_path / name), entry="test"))
        install_p(plan_cls.from_spec(plan))
        try:
            out.append(model.fit(F0))
        finally:
            install_p(None)
            tel.finalize()
            uninst(tel)
    return out[0], out[1], _rollbacks(tmp_path / "jax"), _rollbacks(tmp_path / "port")


NAN_AT_3 = {"faults": [{"kind": "nan_inject", "site": "fit.step", "at": 3}]}


@pytest.mark.parametrize("kind", ["dense", "sharded", "ring"])
def test_same_fault_plan_same_rollback_in_both_packages(tmp_path, kind):
    rj, rp, ej, ep = _fit_both(kind, NAN_AT_3, tmp_path,
                               rollback_budget=3, rollback_shrink=0.1)
    assert ej == ep == [(3, 1, 0, 0.1)]
    assert len(rj.llh_history) == len(rp.llh_history) == 11
    np.testing.assert_allclose(rp.llh_history, rj.llh_history, rtol=1e-10)
    assert np.isfinite(rp.F).all()


def test_rollback_after_a_snapshot_resumes_from_it(tmp_path):
    plan = {"faults": [{"kind": "nan_inject", "site": "fit.step", "at": 6,
                        "index": [5, 1]}]}
    rj, rp, ej, ep = _fit_both("dense", plan, tmp_path,
                               rollback_snapshot_every=2)
    assert ej == ep and ep[0][0] == 6 and ep[0][2] in (4, 5, 6)
    np.testing.assert_allclose(rp.llh_history, rj.llh_history, rtol=1e-10)


@pytest.mark.parametrize("budget", [0, 2])
def test_spent_budget_raises_in_both_packages(budget):
    g, jc, cfg, F0 = _problem(max_iters=20, rollback_budget=budget)
    bad = F0.copy()
    bad[3, 1] = np.nan
    match = "rollback budget" if budget else "non-finite LLH"
    with pytest.raises(FloatingPointError, match=match):
        JaxModel(g, jc).fit(bad)
    with pytest.raises(FloatingPointError, match=match):
        BigClamModel(_port_graph(g), cfg, device="cpu").fit(bad)


def test_abort_dumps_diagnostics_to_the_telemetry(tmp_path):
    g, jc, cfg, F0 = _problem(max_iters=20, rollback_budget=1)
    bad = F0.copy()
    bad[0, 0] = np.inf
    tel = install(RunTelemetry(str(tmp_path), entry="test"))
    try:
        with pytest.raises(FloatingPointError, match="diagnostics dumped"):
            BigClamModel(_port_graph(g), cfg, device="cpu").fit(bad)
    finally:
        uninstall(tel)
    ev = _events(tmp_path)
    nf = [e for e in ev if e["kind"] == "nonfinite"]
    assert len(nf) == 1 and nf[0]["rollbacks"] == 1
    assert os.path.exists(tmp_path / "nonfinite_dump.npz")
    assert os.path.exists(tmp_path / "run_report.json")


def _port_path_models(cfg, g):
    """One port model per kernel path, on the kernels' plain versions."""
    pg = _port_graph(g)
    f32 = cfg.replace(dtype="float32")
    mesh = make_mesh((2, 1), [CPU] * 2)
    return {
        "csr_fused": BigClamModel(pg, f32.replace(use_pallas_csr=True), device="cpu"),
        "csr": BigClamModel(pg, f32.replace(use_pallas_csr=True, csr_fused=False),
                            device="cpu"),
        "csr_fused_kb": BigClamModel(pg, f32.replace(use_pallas_csr=True,
                                                     csr_k_block=32), device="cpu"),
        "csr_grouped_kb": BigClamModel(
            pg, f32.replace(use_pallas_csr=True, csr_k_block=32, csr_fused=False),
            device="cpu"),
        "pallas_vmem": BigClamModel(pg, f32.replace(use_pallas=True), device="cpu"),
        "xla": BigClamModel(pg, cfg, device="cpu"),
        "sparse_merge_pallas": SparseBigClamModel(
            pg, f32.replace(representation="sparse", sparse_m=2,
                            sparse_pallas_merge=True), device="cpu"),
        "sparse_xla": SparseBigClamModel(
            pg, cfg.replace(representation="sparse", sparse_m=2), device="cpu"),
        "csr_ring_fused": RingBigClamModel(pg, f32.replace(use_pallas_csr=True),
                                           mesh, balance=False),
        "csr_ring": RingBigClamModel(
            pg, f32.replace(use_pallas_csr=True, csr_fused=False), mesh,
            balance=False),
    }


PATHS = ("csr_fused", "csr", "csr_fused_kb", "csr_grouped_kb", "pallas_vmem",
         "xla", "sparse_merge_pallas", "sparse_xla", "csr_ring_fused", "csr_ring")


@pytest.mark.parametrize("path", PATHS)
def test_nan_in_F_gives_nonfinite_llh_and_rollback_on_every_path(tmp_path, path):
    g, _, cfg, F0 = _problem(max_iters=8)
    model = _port_path_models(cfg, g)[path]
    assert model.engaged_path == path
    tel = install(RunTelemetry(str(tmp_path), entry="test"))
    install_plan(FaultPlan([{"kind": "nan_inject", "site": "fit.step", "at": 3,
                             "index": [2, 1]}]))
    try:
        res = model.fit(F0)
    finally:
        tel.finalize()
        uninstall(tel)
    rb = _rollbacks(tmp_path)
    assert len(rb) == 1 and rb[0][0] == 3 and rb[0][3] == pytest.approx(0.1)
    assert np.isfinite(res.llh_history).all() and len(res.llh_history) == 9
    assert model.cfg.step_scale == 1.0


def test_nan_inject_leaves_the_callers_state_alone():
    g, _, cfg, F0 = _problem(max_iters=4)
    m = BigClamModel(_port_graph(g), cfg, device="cpu")
    state = m.init_state(F0)
    before = state.F.clone()
    install_plan(FaultPlan([{"kind": "nan_inject", "site": "fit.step", "at": 0}]))
    m.fit_state(state)
    assert torch.equal(state.F, before)


@pytest.mark.parametrize("path", ["xla", "csr_fused", "csr_fused_kb",
                                  "sparse_xla", "csr_ring_fused"])
def test_rollback_on_and_off_identical_without_faults(path):
    g, _, cfg, F0 = _problem(max_iters=6)
    on = _port_path_models(cfg, g)[path]
    off = _port_path_models(cfg.replace(rollback_budget=0), g)[path]
    a, b = on.fit(F0), off.fit(F0)
    np.testing.assert_array_equal(a.F, b.F)
    assert a.llh_history == b.llh_history


def test_model_cfg_restored_after_rollback():
    g, _, cfg, F0 = _problem(max_iters=8)
    model = BigClamModel(_port_graph(g), cfg, device="cpu")
    install_plan(FaultPlan.from_spec(NAN_AT_3))
    assert np.isfinite(model.fit(F0).llh)
    assert model.cfg == cfg
    assert cfg.replace(step_scale=0.5).step_candidates[0] == 0.5


# --------------------------------------------------------------------------
# fault plans, retry, supervisor
# --------------------------------------------------------------------------


def test_fault_plan_matching_equals_jax():
    spec = {"seed": 3, "faults": [
        {"kind": "delay", "site": "fit.step", "at": 2, "seconds": 0.0},
        {"kind": "corrupt_checkpoint", "site": "checkpoint.save", "step": 4},
        {"kind": "nan_inject", "site": "fit.step", "at": 5, "index": [1, 0]},
    ]}
    p, j = FaultPlan.from_spec(spec), jres.FaultPlan.from_spec(spec)
    hits = [("fit.step", {"it": i}) for i in range(7)] + [
        ("checkpoint.save", {"step": s, "path": "x"}) for s in (2, 4, 4)]
    for site, ctx in hits:
        assert p.fire(site, **ctx) == j.fire(site, **ctx)
    assert p.fired == j.fired and len(p.fired) == 3


def test_fault_plan_env_round_trip(tmp_path, monkeypatch):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(NAN_AT_3))
    for raw in (json.dumps(NAN_AT_3), f"@{path}"):
        monkeypatch.setenv("BIGCLAM_FAULTS", raw)
        assert FaultPlan.from_env().faults == jres.FaultPlan.from_env().faults


def test_classify_equals_jax():
    errors = [OSError("x"), FileNotFoundError("x"), EOFError(), TimeoutError(),
              ConnectionError(), zlib.error("x"), zipfile.BadZipFile("x"),
              ValueError("x"), FloatingPointError("x"), RuntimeError("x"),
              KeyError("x"), TransientError("x"), FatalError("x"),
              jres.TransientError("x"), jres.FatalError("x")]
    got = [classify(e) for e in errors]
    assert got[:11] == [jres.classify(e) for e in errors[:11]]
    assert got[11:13] == ["transient", "fatal"]
    assert jres.classify(errors[13]) == "transient"


@pytest.mark.parametrize("seed", [0, 7])
def test_backoff_equals_jax(seed):
    def slept(mod, policy_cls):
        out = []
        with pytest.raises(OSError):
            mod(lambda: (_ for _ in ()).throw(OSError("down")), "load",
                policy_cls(transient_attempts=4, seed=seed), sleep=out.append)
        return out

    a = slept(call_with_retry, RetryPolicy)
    b = slept(jres.call_with_retry, jres.RetryPolicy)
    assert a == b and len(a) == 3


def test_retry_events_and_fatal_never_retried(tmp_path):
    tel = install(RunTelemetry(str(tmp_path), entry="test"))
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("once")
        return "ok"

    try:
        assert call_with_retry(flaky, "load", RetryPolicy(base_s=0.0)) == "ok"
        fatal = {"n": 0}

        def bad():
            fatal["n"] += 1
            raise ValueError("config")

        with pytest.raises(ValueError):
            call_with_retry(bad, "fit", RetryPolicy(base_s=0.0))
        assert fatal["n"] == 1
    finally:
        tel.finalize()
        uninstall(tel)
    kinds = [e["kind"] for e in _events(tmp_path)]
    assert kinds.count("retry") == 1 and kinds.count("recovered") == 1
    assert kinds.count("gave_up") == 1


def test_supervisor_retries_with_resume(tmp_path):
    g, _, cfg, F0 = _problem(max_iters=6)
    cfg = cfg.replace(checkpoint_every=2)
    pg = _port_graph(g)
    full = BigClamModel(pg, cfg, device="cpu").fit(F0)
    cm = CheckpointManager(str(tmp_path))
    model = BigClamModel(pg, cfg, device="cpu")
    attempts = {"n": 0}

    def attempt():
        attempts["n"] += 1
        if attempts["n"] == 1:
            BigClamModel(pg, cfg.replace(max_iters=3), device="cpu").fit(
                F0, checkpoints=cm)
            raise OSError("simulated I/O loss mid-fit")
        return model.fit(F0, checkpoints=cm)

    res = Supervisor(RetryPolicy(transient_attempts=2, base_s=0.0)).run_fit(attempt)
    assert attempts["n"] == 2 and cm.latest_step() is not None
    np.testing.assert_array_equal(res.F, full.F)
    assert res.llh_history == full.llh_history


def test_supervisor_never_retries_a_fatal_error():
    attempts = {"n": 0}

    def attempt():
        attempts["n"] += 1
        raise FloatingPointError("non-finite LLH")

    with pytest.raises(FloatingPointError):
        Supervisor(RetryPolicy(transient_attempts=5, base_s=0.0)).run_fit(attempt)
    assert attempts["n"] == 1


# --------------------------------------------------------------------------
# the CLI: kill -> --resume auto, --resume never, the JAX flags
# --------------------------------------------------------------------------


def _write_cli_graph(tmp_path):
    graph = tmp_path / "g.txt"
    edges = []
    for base in (0, 10):
        for i in range(10):
            for j in range(i + 1, 10):
                edges.append((base + i, base + j))
    edges.append((9, 10))
    graph.write_text("\n".join(f"{u} {v}" for u, v in edges))
    return graph


def _run_port_cli(*argv, env_extra=None, check=True):
    env = {k: v for k, v in os.environ.items() if k != "BIGCLAM_FAULTS"}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    r = subprocess.run(
        [sys.executable, "-m", "bigclam_tpu_torch.cli", *argv],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env,
    )
    if check:
        assert r.returncode == 0, r.stderr
    return r


def test_cli_kill_then_resume_auto_bit_identical(tmp_path):
    from bigclam_tpu.obs.schema import validate_events_file
    from bigclam_tpu_torch.resilience import read_lineage

    graph = _write_cli_graph(tmp_path)
    base = ["fit", "--graph", str(graph), "--k", "2", "--dtype", "float64",
            "--max-iters", "12", "--conv-tol", "0", "--init", "random",
            "--quiet", "--device", "cpu", "--checkpoint-every", "3"]
    _run_port_cli(*base, "--checkpoint-dir", str(tmp_path / "ck_ref"),
                  "--save-f", str(tmp_path / "ref.npy"))
    tdir = str(tmp_path / "telem")
    r = _run_port_cli(
        *base, "--checkpoint-dir", str(tmp_path / "ck"), "--telemetry-dir", tdir,
        env_extra={"BIGCLAM_FAULTS": json.dumps(
            {"faults": [{"kind": "kill", "site": "fit.step", "at": 8}]})},
        check=False,
    )
    assert r.returncode != 0 and "FAULT kill" in r.stderr
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 6
    r2 = _run_port_cli(*base, "--checkpoint-dir", str(tmp_path / "ck"),
                       "--telemetry-dir", tdir, "--save-f",
                       str(tmp_path / "resumed.npy"))
    np.testing.assert_array_equal(np.load(tmp_path / "resumed.npy"),
                                  np.load(tmp_path / "ref.npy"))
    out = json.loads(r2.stdout.strip().splitlines()[-1])
    assert out["iters"] == 12 and out["steps"] == 13
    lineage = read_lineage(tdir)
    assert len(lineage) == 1 and lineage[0]["resumed_step"] == 6
    n, errors = validate_events_file(os.path.join(tdir, EVENTS_NAME))
    assert errors == [], errors


def test_cli_resume_never_cold_starts(tmp_path):
    graph = _write_cli_graph(tmp_path)

    def base(iters):
        return ["fit", "--graph", str(graph), "--k", "2", "--dtype", "float64",
                "--max-iters", str(iters), "--conv-tol", "0", "--init",
                "random", "--quiet", "--device", "cpu",
                "--checkpoint-every", "2", "--checkpoint-dir",
                str(tmp_path / "ck")]

    args = cli.build_parser().parse_args(base(6))
    assert cli.fit(args)[0]["iters"] == 6
    args = cli.build_parser().parse_args(base(4) + ["--resume", "never"])
    assert cli.fit(args)[0]["iters"] == 4
    args = cli.build_parser().parse_args(base(4))
    assert cli.fit(args)[0]["iters"] == 6        # restored past its own max
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 6


def test_cli_checkpoint_dir_defaults_the_cadence(tmp_path, capsys):
    graph = _write_cli_graph(tmp_path)
    args = cli.build_parser().parse_args([
        "fit", "--graph", str(graph), "--k", "2", "--device", "cpu",
        "--max-iters", "2", "--quiet", "--checkpoint-dir", str(tmp_path / "c")])
    out, _, _ = cli.fit(args)
    assert "defaulting to every 50 iterations" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--perf-ledger", "--profile-dir"])
def test_cli_refuses_unported_observability_flags(tmp_path, flag, capsys):
    """The two flags are ported now: --perf-ledger without
    --telemetry-dir warns as the JAX CLI does (and writes nothing), and
    --profile-dir writes its capture."""
    graph = _write_cli_graph(tmp_path)
    target = tmp_path / "x"
    assert cli.main(["fit", "--graph", str(graph), "--device", "cpu", "--k",
                     "2", "--max-iters", "2", "--quiet", flag,
                     str(target)]) == 0
    err = capsys.readouterr().err
    if flag == "--perf-ledger":
        assert "--perf-ledger has no effect without --telemetry-dir" in err
        assert not target.exists()
    else:
        assert (target / "trace.json").is_file()
        assert (target / "key_averages.txt").is_file()


def test_cli_fit_flags_match_the_jax_cli(tmp_path, capsys):
    """--alpha, --beta, --max-backtracks, --edge-chunk and --save-f in
    float64: LLH at 1e-9 and the saved F at 1e-9."""
    graph = _write_cli_graph(tmp_path)
    common = ["fit", "--graph", str(graph), "--k", "3", "--dtype", "float64",
              "--max-iters", "15", "--conv-tol", "0", "--init", "random",
              "--alpha", "0.1", "--beta", "0.3", "--max-backtracks", "9",
              "--edge-chunk", "64", "--csr-kernels", "off", "--quiet"]
    assert cli.main(common + ["--device", "cpu", "--save-f",
                              str(tmp_path / "p.npy")]) == 0
    port = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_main(common + ["--platform", "cpu", "--save-f",
                              str(tmp_path / "j.npy")]) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_allclose(port["llh"], ref["llh"], rtol=1e-9)
    assert port["iters"] == ref["iters"] == 15
    np.testing.assert_allclose(np.load(tmp_path / "p.npy"),
                               np.load(tmp_path / "j.npy"), rtol=1e-9, atol=1e-12)


def test_cli_sweep_within_k_checkpoints_and_telemetry(tmp_path):
    from bigclam_tpu.obs.schema import validate_events_file

    graph = _write_cli_graph(tmp_path)
    tdir = tmp_path / "tel"
    args = cli.build_parser().parse_args([
        "sweep", "--graph", str(graph), "--min-com", "2", "--max-com", "4",
        "--div-com", "2", "--max-iters", "6", "--device", "cpu",
        "--checkpoint-dir", str(tmp_path / "s"), "--checkpoint-every", "2",
        "--telemetry-dir", str(tdir), "--retry-budget", "1"])
    out = cli.sweep(args)
    assert out["kset"] == [2, 3, 4]
    assert not [p for p in os.listdir(tmp_path / "s") if p.startswith("k_")]
    ev = _events(tdir)
    assert [e["k"] for e in ev if e["kind"] == "metric"] == [
        int(k) for k in out["llh_by_k"]]
    assert sum(e["kind"] == "checkpoint" for e in ev) >= 2
    assert validate_events_file(str(tdir / EVENTS_NAME))[1] == []


def test_retry_budget_resumes_a_transiently_failed_cli_fit(tmp_path, monkeypatch):
    graph = _write_cli_graph(tmp_path)
    base = ["fit", "--graph", str(graph), "--k", "2", "--dtype", "float64",
            "--max-iters", "8", "--conv-tol", "0", "--init", "random",
            "--quiet", "--device", "cpu", "--checkpoint-every", "2"]
    ref, _, _ = cli.fit(cli.build_parser().parse_args(
        base + ["--checkpoint-dir", str(tmp_path / "a")]))
    from bigclam_tpu_torch.resilience import faults

    real = faults.maybe_fire
    died = {"n": 0}

    def flaky(site, **ctx):
        if site == "fit.step" and ctx.get("it") == 5 and not died["n"]:
            died["n"] += 1
            raise OSError("transient")
        return real(site, **ctx)

    monkeypatch.setattr(faults, "maybe_fire", flaky)
    out, _, _ = cli.fit(cli.build_parser().parse_args(
        base + ["--checkpoint-dir", str(tmp_path / "b"), "--telemetry-dir",
                str(tmp_path / "t")]))
    assert died["n"] == 1
    assert out["llh_history"] == ref["llh_history"]
    kinds = [e["kind"] for e in _events(tmp_path / "t")]
    assert kinds.count("retry") == 1 and kinds.count("restore") == 1


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_nan_gives_rollback_on_every_card_path(tmp_path, cuda_device):
    """The kernels on the card: a NaN in F reaches the LLH (the survival
    clamp's fmaxf drops NaN, so this is shown, not assumed) and rolls
    back on each path."""
    g, _, cfg, F0 = _problem(max_iters=6)
    pg = _port_graph(g)
    f32 = cfg.replace(dtype="float32")
    mesh = make_mesh((2, 1), [cuda_device] * 2)
    models = {
        "csr_fused": BigClamModel(pg, f32, device=cuda_device),
        "csr": BigClamModel(pg, f32.replace(csr_fused=False), device=cuda_device),
        "csr_fused_kb": BigClamModel(pg, f32.replace(csr_k_block=32),
                                     device=cuda_device),
        "csr_grouped_kb": BigClamModel(pg, f32.replace(csr_k_block=32,
                                                       csr_fused=False),
                                       device=cuda_device),
        "pallas_vmem": BigClamModel(pg, f32.replace(use_pallas_csr=False),
                                    device=cuda_device),
        "sparse_merge_pallas": SparseBigClamModel(
            pg, f32.replace(representation="sparse", sparse_m=2),
            device=cuda_device),
        "csr_ring_fused": RingBigClamModel(pg, f32, mesh, balance=False),
    }
    for path, model in models.items():
        assert model.engaged_path == path
        d = tmp_path / path
        tel = install(RunTelemetry(str(d), entry="test"))
        install_plan(FaultPlan.from_spec(NAN_AT_3))
        try:
            res = model.fit(F0)
        finally:
            install_plan(None)
            tel.finalize()
            uninstall(tel)
        assert len(_rollbacks(d)) == 1, path
        assert np.isfinite(res.llh_history).all(), path
