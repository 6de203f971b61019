"""The device-resident quality schedule on a K-sharded mesh (tp = 2):
`fit_quality_device` on the port's (2, 2) all-gather and ring trainers,
whose state F is a tuple of shards' tuples of column blocks, held against
the JAX single-device `fit_quality_device` fed the same (JAX) draws, in
float64 on the CPU, at the tolerances of tests/test_torch_quality_device.py;
repair-round checkpoints resuming bit for bit at (2, 2); and `fit`/`sweep
--mesh 2,2 --quality --device-annealing` through the CLI against the JAX
CLI on the same mesh."""

import json

import numpy as np
import pytest
import torch

from bigclam_tpu.cli import main as jax_main

from bigclam_tpu_torch import cli
from bigclam_tpu_torch.parallel import (
    RingBigClamModel,
    ShardedBigClamModel,
    make_mesh,
)
from bigclam_tpu_torch.utils.checkpoint import CheckpointManager
# the single-device schedule's cases, JAX draws and comparisons
from test_torch_quality_device import (
    _assert_device_equal,
    _case,
    jax_noise,
    tq,
)
from test_torch_quality_cli import edge_file, jax_draws  # noqa: F401  (fixtures)
from test_torch_refit import assert_rows_close

torch.set_num_threads(2)

SCHEDULES = {"allgather": ShardedBigClamModel, "ring": RingBigClamModel}


def _mesh22():
    return make_mesh((2, 2), [torch.device("cpu")] * 4)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("name", ["planted", "repairs"])
def test_tp_device_schedule_matches_jax(name, schedule):
    """K split over two column blocks (K_loc 6 and 25): the kicks, the
    merge/split edits ("repairs" accepts one) and the atomize plan land in
    the block that owns each column; cycles, LLHs, counts and F agree with
    the JAX single-device schedule."""
    _, g, cfg, F0, jmodel, ref = _case(name)
    model = SCHEDULES[schedule](g, cfg, _mesh22(), balance=False)
    assert model.tp == 2 and isinstance(model.init_state(F0).F[0], tuple)
    ours = tq.fit_quality_device(model, F0, noise=jax_noise(
        jmodel, F0, cfg.seed, perm=model._perm))
    _assert_device_equal(ours, ref)
    assert_rows_close(ours.fit.F, ref.fit.F)
    assert ours.num_repairs >= 1


def test_tp_device_repair_checkpoint_resume(tmp_path):
    """Repair-round checkpoints at (2, 2): a second run restores the
    stage (it refits only the cycles) and ends bit for bit on the first
    run's F; resume=False refits again and lands on the same LLH."""
    _, g, cfg, F0, jmodel, _ = _case("repairs")
    model = ShardedBigClamModel(g, cfg, _mesh22())
    noise = jax_noise(jmodel, F0, cfg.seed, perm=model._perm)
    cm = CheckpointManager(str(tmp_path / "q"))
    r1 = tq.fit_quality_device(model, F0, checkpoints=cm, noise=noise)
    calls = []
    orig = model.fit_state
    model.fit_state = lambda st, **kw: calls.append(1) or orig(st, **kw)
    r2 = tq.fit_quality_device(model, F0, checkpoints=cm, noise=noise)
    assert len(calls) == r2.num_cycles
    assert (r2.fit.llh, r2.num_repairs) == (r1.fit.llh, r1.num_repairs)
    np.testing.assert_array_equal(r2.fit.F, r1.fit.F)
    meta = CheckpointManager(str(tmp_path / "q" / "repair")).restore()[2]
    assert meta["rng"] == "device" and meta["done"]
    calls.clear()
    r3 = tq.fit_quality_device(model, F0, checkpoints=cm, resume=False,
                               noise=noise)
    assert len(calls) > r3.num_cycles
    assert r3.fit.llh == r1.fit.llh


def _json_out(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("schedule", ["allgather", "ring"])
def test_cli_fit_tp_device_annealing_matches_jax_cli(edge_file, capsys,  # noqa: F811
                                                     jax_draws, schedule):
    argv = ["fit", "--graph", edge_file, "--k", "12", "--dtype", "float64",
            "--quality", "--device-annealing", "--restart-cycles", "3",
            "--mesh", "2,2", "--schedule", schedule, "--quiet"]
    assert jax_main(argv) == 0
    ref = _json_out(capsys)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = _json_out(capsys)
    assert len(jax_draws.shapes) == 1
    for key in ("iters", "n", "edges", "k", "mesh", "quality_cycles",
                "quality_total_iters"):
        assert out[key] == ref[key], key
    np.testing.assert_allclose(out["llh"], ref["llh"], rtol=1e-10)
    np.testing.assert_allclose(out["cycles_llh"], ref["cycles_llh"],
                               rtol=0, atol=0.011)     # both rounded to 0.01


def test_cli_sweep_tp_device_annealing_matches_jax_cli(edge_file, capsys,  # noqa: F811
                                                       jax_draws):
    argv = ["sweep", "--graph", edge_file, "--min-com", "6", "--max-com",
            "12", "--div-com", "2", "--dtype", "float64", "--quality",
            "--device-annealing", "--mesh", "2,2", "--quiet"]
    assert jax_main(argv) == 0
    ref = _json_out(capsys)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = _json_out(capsys)
    assert len(jax_draws.shapes) == len(ref["kset"])
    assert (out["kset"], out["chosen_k"], out["mesh"]) == (
        ref["kset"], ref["chosen_k"], ref["mesh"])
    for k, v in ref["llh_by_k"].items():
        np.testing.assert_allclose(out["llh_by_k"][k], v, rtol=1e-10)
