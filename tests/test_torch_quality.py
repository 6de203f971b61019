"""The port's host quality loop (bigclam_tpu_torch/models/quality.py
`fit_quality` and its discrete stage) held against the JAX package's, in
float64: the copied host functions pinned by AST; `fit_quality` on the
planted N=2,400 K=12 fixture (and a merge/split case) with cycles_llh at
1e-10, equal cycles, iterations and repairs, and F within the refit tests'
row-relative band; the recovery gate; resume at cycle and within-cycle
granularity and after a patience stop; the shape, kick_cols and max_p
stamp refusals; the MAX_P_ relaxation reaching the step and the parity
step coming back; kick_cols padding; a non-finite cycle after cycle 0;
and the all-gather and ring trainers equal to one device."""

import ast
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from bigclam_tpu.config import BigClamConfig as JaxConfig
from bigclam_tpu.models import BigClamModel as JaxModel
from bigclam_tpu.models import quality as jq

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.evaluation import avg_f1
from bigclam_tpu_torch.models import bigclam as tb
from bigclam_tpu_torch.models import quality as tq
from bigclam_tpu_torch.models.agm import sample_planted_graph
from bigclam_tpu_torch.models.bigclam import BigClamModel
from bigclam_tpu_torch.obs import RunTelemetry, install, uninstall
from bigclam_tpu_torch.ops import extraction, seeding
from bigclam_tpu_torch.ops.csr_kernels import kernel_constants
from bigclam_tpu_torch.parallel import (
    RingBigClamModel,
    ShardedBigClamModel,
    make_mesh,
)
from bigclam_tpu_torch.utils.checkpoint import CheckpointManager
# the refit tests' row-relative F band: float64 summation order moves a row
# by up to ~1e-10 of its norm over hundreds of iterations
from test_torch_refit import assert_rows_close

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-10


def planted_graph(n, k, p_in, seed=7):
    return sample_planted_graph(n, k, p_in=p_in, rng=np.random.default_rng(seed))


@pytest.fixture(scope="module")
def planted():
    """The JAX quality tests' graph: coverage failure at K = 12."""
    return planted_graph(2400, 12, 0.15)


def seeded_F0(g, cfg):
    seeds = seeding.conductance_seeds(g, cfg)
    return seeding.init_F(g, seeds, cfg, np.random.default_rng(0))


def _score(F, g, truth):
    com = extraction.extract_communities(np.asarray(F), g)
    return avg_f1(list(com.values()), truth)


# ----------------------------------------------------------- copy pins
def _docless_function_ast(path: pathlib.Path, package: str, name: str) -> str:
    tree = ast.parse(path.read_text().replace(package + ".", "PKG."))
    node = next(n for n in tree.body
                if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                and n.name == name)
    for sub in ast.walk(node):
        body = getattr(sub, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            sub.body = body[1:] or [ast.Pass()]
    return ast.dump(node)


COPIES = [
    ("models/quality.py", name) for name in (
        "_cycle_event", "auto_quality_max_p", "_relax_params",
        "_graph_components", "_graph_components_bfs", "_gather_neighbors",
        "_internal_density", "_column_atoms_host", "_plan_atoms",
        "_atom_strength", "apply_repair_edits", "QualityResult",
        "_repair_stamp", "_repair_ckpt_open", "fit_quality",
    )
] + [("ops/components.py", "components_from_labels")]


@pytest.mark.parametrize("rel,name", COPIES)
def test_host_copies_are_their_jax_sources(rel, name):
    ours = _docless_function_ast(REPO / "bigclam_tpu_torch" / rel,
                                 "bigclam_tpu_torch", name)
    ref = _docless_function_ast(REPO / "bigclam_tpu" / rel, "bigclam_tpu",
                                name)
    assert ours == ref


# ------------------------------------------------------ parity with JAX
PARITY = {
    # the recovery fixture: annealing, then an accepted atomize round
    "planted": (2400, 12, 0.15, {}),
    # merge/split with the polish kicks ([seed, 0xF17, round, polish])
    "merge_split": (1200, 50, 0.3, {"quality_reassign": False}),
}


def _pair(case, **extra):
    n, k, p_in, kw = PARITY[case]
    g, truth = planted_graph(n, k, p_in)
    base = dict(num_communities=k, quality_mode=True, restart_cycles=4,
                dtype="float64", **kw, **extra)
    cfg = BigClamConfig(**base)
    jcfg = JaxConfig(use_pallas=False, use_pallas_csr=False, **base)
    return g, truth, cfg, jcfg, seeded_F0(g, cfg)


def assert_quality_equal(ours, ref):
    assert (ours.num_cycles, ours.total_iters, ours.num_repairs) == (
        ref.num_cycles, ref.total_iters, ref.num_repairs)
    np.testing.assert_allclose(ours.cycles_llh, ref.cycles_llh, rtol=RTOL)
    np.testing.assert_allclose(ours.fit.llh, ref.fit.llh, rtol=RTOL)
    assert ours.fit.num_iters == ref.fit.num_iters
    np.testing.assert_allclose(ours.fit.llh_history, ref.fit.llh_history,
                               rtol=RTOL)
    assert_rows_close(ours.fit.F, ref.fit.F)


@pytest.mark.parametrize("case", sorted(PARITY))
def test_fit_quality_matches_jax(case):
    g, _, cfg, jcfg, F0 = _pair(case)
    ours = tq.fit_quality(BigClamModel(g, cfg, device="cpu"), F0)
    ref = jq.fit_quality(JaxModel(g, jcfg), F0)
    assert_quality_equal(ours, ref)
    assert ours.num_repairs >= 1            # the discrete stage accepted
    assert set(ours.stages["seconds"]) == {"anneal", "repair"}


def test_quality_mode_recovers_planted(planted):
    """The JAX gate on the port (float32 on the CPU): quality F1 >= 0.8 and
    0.2 above the faithful fit from the reference seeding."""
    g, truth = planted
    k = len(truth)
    cfg = BigClamConfig(num_communities=k, quality_mode=True,
                        restart_cycles=8)
    cfg_ref = cfg.replace(quality_mode=False, seed_exclusion=False)
    model = BigClamModel(g, cfg, device="cpu")
    res_faithful = model.fit(seeded_F0(g, cfg_ref))
    f1_faithful = _score(res_faithful.F, g, truth)
    qres = tq.fit_quality(model, seeded_F0(g, cfg))
    f1_quality = _score(qres.fit.F, g, truth)
    assert f1_quality >= 0.8, (f1_quality, f1_faithful)
    assert f1_quality > f1_faithful + 0.2, (f1_quality, f1_faithful)
    assert qres.fit.llh > res_faithful.llh
    kept = np.maximum.accumulate(qres.cycles_llh)
    assert np.all(np.diff(kept) >= 0)
    if qres.num_repairs:
        assert qres.fit.llh > kept[-1]
    else:
        assert qres.fit.llh == pytest.approx(kept[-1])


# --------------------------------------------------------------- resume
def _cfg(k, **kw):
    return BigClamConfig(num_communities=k, quality_mode=True, **kw)


def test_quality_resume_exact(planted, tmp_path):
    """Cycle checkpoints: 2 cycles, then a resume to 3, equal the
    uninterrupted 3-cycle schedule bit for bit."""
    g, truth = planted
    k = len(truth)
    F0 = seeded_F0(g, BigClamConfig(num_communities=k))
    model = lambda c: BigClamModel(
        g, _cfg(k, restart_cycles=c, restart_tol=0.0, quality_repair=False),
        device="cpu")
    ref = tq.fit_quality(model(3), F0)
    assert ref.num_cycles == 3
    cm = CheckpointManager(str(tmp_path / "q"))
    part = tq.fit_quality(model(2), F0, checkpoints=cm)
    assert part.num_cycles == 2
    resumed = tq.fit_quality(model(3), F0, checkpoints=cm)
    assert resumed.num_cycles == 3
    np.testing.assert_array_equal(resumed.cycles_llh, ref.cycles_llh)
    np.testing.assert_array_equal(resumed.fit.F, ref.fit.F)
    # resume=False: a cold start that ignores the saved cycles
    cold = tq.fit_quality(model(2), F0, checkpoints=cm, resume=False)
    np.testing.assert_array_equal(cold.cycles_llh, part.cycles_llh)


def test_quality_resume_after_patience_stop(planted, tmp_path):
    g, truth = planted
    k = len(truth)
    model = BigClamModel(g, _cfg(k, restart_cycles=20, restart_tol=1.0,
                                 restart_patience=2), device="cpu")
    F0 = np.zeros((g.num_nodes, k))
    cm = CheckpointManager(str(tmp_path / "q"))
    ref = tq.fit_quality(model, F0, checkpoints=cm)
    assert ref.num_cycles == 3                  # cycle 0 + 2 gainless
    meta = cm.restore()[2]
    assert meta["gainless"] == 2 and meta["quality_nk"] == [g.num_nodes, k]
    rerun = tq.fit_quality(model, F0, checkpoints=cm)
    assert rerun.num_cycles == ref.num_cycles
    np.testing.assert_array_equal(rerun.fit.F, ref.fit.F)
    np.testing.assert_array_equal(rerun.cycles_llh, ref.cycles_llh)


def test_quality_within_cycle_checkpoint_resume(planted, tmp_path):
    """checkpoint_every > 0: a crash 3 iterations into cycle 0 resumes
    inside it (cycle_00000/) and equals the uninterrupted schedule; the
    journaled cycles delete their within-cycle directories."""
    g, truth = planted
    k = len(truth)
    cfg = _cfg(k, restart_cycles=3, restart_tol=0.0, checkpoint_every=2,
               quality_max_p=0.9999)
    F0 = seeded_F0(g, cfg)
    model = BigClamModel(g, cfg, device="cpu")
    ref = tq.fit_quality(model, F0, checkpoints=CheckpointManager(
        str(tmp_path / "ref")))
    cm = CheckpointManager(str(tmp_path / "q"))
    _, eps = tq._relax_params(model, g.num_nodes)
    kick = np.random.default_rng([cfg.seed, 0x5EED, 0]).uniform(
        0.0, eps, size=F0.shape)
    partial = BigClamModel(g, cfg.replace(conv_tol=cfg.quality_conv_tol,
                                          max_iters=3), device="cpu")
    cyc0 = str(tmp_path / "q" / "cycle_00000")
    partial.fit(np.clip(F0 + kick, cfg.min_f, cfg.max_f),
                checkpoints=CheckpointManager(cyc0))
    assert os.path.exists(cyc0)
    resumed = tq.fit_quality(model, F0, checkpoints=cm)
    np.testing.assert_array_equal(resumed.cycles_llh, ref.cycles_llh)
    np.testing.assert_array_equal(resumed.fit.F, ref.fit.F)
    assert not os.path.exists(cyc0)
    assert not os.path.exists(str(tmp_path / "q" / "cycle_00002"))


def test_repair_stage_resume_and_invalidation(planted, tmp_path):
    """A finished discrete stage short-circuits on resume; another
    post-annealing LLH, kick scale or component floor discards it."""
    g, truth = planted
    k = len(truth)
    model = BigClamModel(g, _cfg(k), device="cpu")
    base = model.fit(seeded_F0(g, model.cfg))
    calls = []
    orig_fit = model.fit
    model.fit = lambda F, **kw: calls.append(1) or orig_fit(F, **kw)
    cm = CheckpointManager(str(tmp_path / "q"))
    eps = 0.001
    best1, nrep1, it1 = tq._repair_stage(model, base, k, eps, None,
                                         checkpoints=cm)
    assert calls
    calls.clear()
    best2, nrep2, it2 = tq._repair_stage(model, base, k, eps, None,
                                         checkpoints=cm)
    assert not calls
    assert (best2.llh, nrep2, it2) == (best1.llh, nrep1, it1)
    np.testing.assert_array_equal(best2.F, best1.F)
    bumped = tb.FitResult(F=base.F, sumF=base.sumF, llh=base.llh + 1.0,
                          num_iters=base.num_iters,
                          llh_history=base.llh_history)
    for kw in ({"best": bumped}, {"eps": eps * 2}, {"min_comp": 7}):
        tq._repair_stage(model, base, k, eps, None, checkpoints=cm)
        calls.clear()
        tq._repair_stage(model, kw.get("best", base), k, kw.get("eps", eps),
                         None, checkpoints=cm, min_comp=kw.get("min_comp", 5))
        assert calls, kw


# ----------------------------------------------------------- refusals
def test_checkpoint_stamp_refusals(planted, tmp_path):
    g, truth = planted
    k = len(truth)
    F0 = np.zeros((g.num_nodes, k))
    relaxed = 1.0 - 1e-6
    cfg = _cfg(k, restart_cycles=1, quality_max_p=relaxed)
    cm = CheckpointManager(str(tmp_path / "q"))
    tq.fit_quality(BigClamModel(g, cfg, device="cpu"), F0, checkpoints=cm,
                   kick_cols=k - 2)
    other_k = BigClamModel(g, cfg.replace(num_communities=k - 1), device="cpu")
    with pytest.raises(ValueError, match="incompatible: nk="):
        tq.fit_quality(other_k, np.zeros((g.num_nodes, k - 1)), checkpoints=cm)
    with pytest.raises(ValueError, match="incompatible: kick_cols="):
        tq.fit_quality(BigClamModel(g, cfg, device="cpu"), F0, checkpoints=cm)
    other_p = BigClamModel(g, cfg.replace(quality_max_p=1.0 - 1e-7), device="cpu")
    with pytest.raises(ValueError, match="written under max_p="):
        tq.fit_quality(other_p, F0, checkpoints=cm, kick_cols=k - 2)
    # a checkpoint without the stamp cannot resume a relaxing run
    old = CheckpointManager(str(tmp_path / "old"))
    old.save(0, {"F": F0}, meta={"best_llh": -1.0, "cycles_llh": [-1.0],
                                 "quality_nk": [g.num_nodes, k],
                                 "kick_cols": k})
    with pytest.raises(ValueError, match="predates the quality_max_p"):
        tq.fit_quality(BigClamModel(g, cfg, device="cpu"), F0, checkpoints=old)
    with pytest.raises(ValueError, match="kick_cols="):
        tq.fit_quality(BigClamModel(g, cfg, device="cpu"), F0, kick_cols=k + 1)
    with pytest.raises(ValueError, match="out of range"):
        tq.fit_quality(BigClamModel(g, cfg.replace(quality_max_p=1.0),
                                    device="cpu"), F0)
    with pytest.warns(UserWarning, match="BELOW the parity clip"):
        tq._relax_params(BigClamModel(g, cfg.replace(quality_max_p=0.9),
                                      device="cpu"), g.num_nodes)


# ------------------------------------------------------ clip relaxation
def test_max_p_relaxation_rescues_frozen_annealing():
    """The JAX test on the port: with the clip pinned at 0.9 every kick is
    frozen; the auto relaxation recovers the planted partition, and the
    parity cfg comes back after the schedule."""
    g, truth = planted_graph(600, 25, 0.3)
    k = len(truth)

    def run(**kw):
        cfg = _cfg(k, **kw)
        model = BigClamModel(g, cfg, device="cpu")
        qres = tq.fit_quality(model, seeded_F0(g, cfg))
        assert model.cfg == cfg
        return _score(qres.fit.F, g, truth)

    f1_pinned = run(quality_max_p=0.9)
    f1_auto = run()
    assert f1_auto >= 0.8, (f1_auto, f1_pinned)
    assert f1_auto > f1_pinned + 0.3, (f1_auto, f1_pinned)


@pytest.mark.parametrize("trainer", ["dense", "allgather", "ring"])
def test_relaxed_clip_reaches_the_kernels_and_parity_returns(monkeypatch,
                                                             trainer):
    """On the CSR kernel paths (their plain versions on the CPU:
    `csr_fused` on one device and on the all-gather mesh, `csr_ring_fused`
    on the ring) every step of both schedules takes omp_lo = float32(1 -
    max_p_q), and the parity value after them: the trainers' rebuild_step
    rebuilds the kernels' constants from the current cfg."""
    import bigclam_tpu_torch.parallel.ring as ring_mod
    import bigclam_tpu_torch.parallel.sharded as sharded_mod

    g, truth = planted_graph(600, 25, 0.3)
    k = len(truth)
    relaxed = 1.0 - 1e-6
    cfg = _cfg(k, restart_cycles=2, quality_max_p=relaxed,
               use_pallas_csr=True, max_iters=30)
    seen = []
    module, name = {"dense": (tb, "fused_superstep"),
                    "allgather": (sharded_mod, "fused_superstep"),
                    "ring": (ring_mod, "ring_grad_phase")}[trainer]
    orig = getattr(module, name)

    def spy(*a):
        seen.append(kernel_constants(a[-1] if trainer == "ring" else a[3])
                    ["omp_lo"])
        return orig(*a)

    monkeypatch.setattr(module, name, spy)
    for fit in (tq.fit_quality, tq.fit_quality_device):
        if trainer == "dense":
            model = BigClamModel(g, cfg, device="cpu")
        else:
            cls = RingBigClamModel if trainer == "ring" else ShardedBigClamModel
            model = cls(g, cfg, make_mesh((2, 1), [torch.device("cpu")] * 2),
                        balance=True)
        model.rebuild_step()               # the ring binds its kernels here
        assert model.engaged_path == (
            "csr_ring_fused" if trainer == "ring" else "csr_fused")
        seen.clear()
        qres = fit(model, np.zeros((g.num_nodes, k)))
        assert len(seen) >= qres.total_iters and seen
        assert set(seen) == {float(np.float32(1.0 - relaxed))}
        assert model.cfg.max_p == cfg.max_p
        seen.clear()
        model.fit_state(model.init_state(np.zeros((g.num_nodes, k))))
        assert set(seen) == {float(np.float32(1.0 - cfg.max_p))}


def test_auto_max_p_rule():
    assert tq.auto_quality_max_p(2400, 27.0, floor=0.9999) == 0.9999
    assert tq.auto_quality_max_p(300_000, 33.0, floor=0.9999) == \
        1.0 - 33.0 / (16.0 * 300_000)
    assert tq.auto_quality_max_p(10**18, 1.0) == 1.0 - 1e-15


def test_quality_kick_cols_keeps_padding_inert(planted):
    g, truth = planted
    k = len(truth)
    k0 = k - 4
    model = BigClamModel(g, _cfg(k, restart_cycles=3), device="cpu")
    F0 = np.zeros((g.num_nodes, k))
    qres = tq.fit_quality(model, F0, kick_cols=k0)
    assert np.all(qres.fit.F[:, k0:] == 0.0)
    assert np.any(qres.fit.F[:, :k0] > 0.0)


def test_nonfinite_cycle_after_cycle0_keeps_best(planted, tmp_path):
    """A cycle past cycle 0 that aborts non-finite reverts to the kept
    state and ends the annealing with a warning and a `note` event; in
    cycle 0 there is nothing to keep, so the error propagates."""
    g, truth = planted
    k = len(truth)
    model = BigClamModel(g, _cfg(k, restart_cycles=4, restart_tol=0.0,
                                 quality_repair=False), device="cpu")
    orig_fit = model.fit
    calls = []

    def flaky(F, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise FloatingPointError("non-finite LLH nan at iteration 3")
        return orig_fit(F, **kw)

    model.fit = flaky
    F0 = seeded_F0(g, model.cfg)
    tdir = str(tmp_path / "tel")
    tel = install(RunTelemetry(tdir, entry="test"))
    try:
        with pytest.warns(UserWarning, match="aborted non-finite"):
            qres = tq.fit_quality(model, F0)
    finally:
        tel.finalize()
        uninstall(tel)
    assert qres.num_cycles == 1 and len(calls) == 2
    assert qres.fit.llh == qres.cycles_llh[0]
    with open(os.path.join(tdir, "events.jsonl")) as f:
        events = [json.loads(ln) for ln in f]
    notes = [e for e in events if e.get("kind", e.get("event")) == "note"]
    assert any(e.get("msg") == "quality_cycle_nonfinite_abort"
               and e.get("cycle") == 1 for e in notes), notes
    cycles = [e for e in events if e.get("kind", e.get("event")) == "cycle"]
    assert [e["cycle"] for e in cycles] == [0]
    calls.clear()
    calls.append(1)          # the next call is the second: cycle 0 fails
    with pytest.raises(FloatingPointError):
        tq.fit_quality(model, F0)


# ------------------------------------------------------------- meshes
@pytest.mark.parametrize("cls,dp,balance", [
    (ShardedBigClamModel, 2, False), (ShardedBigClamModel, 4, True),
    (RingBigClamModel, 2, True), (RingBigClamModel, 4, True),
])
def test_fit_quality_over_mesh_trainers_equals_one_device(planted, cls, dp,
                                                          balance):
    g, truth = planted
    k = len(truth)
    cfg = _cfg(k, restart_cycles=2, restart_tol=0.0, dtype="float64")
    F0 = seeded_F0(g, cfg)
    one = tq.fit_quality(BigClamModel(g, cfg, device="cpu"), F0)
    mesh = make_mesh((dp, 1), [torch.device("cpu")] * dp)
    ours = tq.fit_quality(cls(g, cfg, mesh, balance=balance), F0)
    assert (ours.num_cycles, ours.total_iters, ours.num_repairs) == (
        one.num_cycles, one.total_iters, one.num_repairs)
    np.testing.assert_allclose(ours.cycles_llh, one.cycles_llh, rtol=1e-12)
    np.testing.assert_allclose(ours.fit.F, one.fit.F, rtol=1e-12, atol=1e-12)
