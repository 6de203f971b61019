"""The port's warm-start refit and follow loop (bigclam_tpu_torch/models/
refit.py and the trainers' fold-in hooks) held against the JAX package's
on one cache and delta (the refit world of tests/test_delta.py), in
float64: the halo and the touched rows equal, `warm_start_refit` on the
dense and sparse trainers with the round history at rtol 1e-10 and equal
rounds, touched, refit_nodes and escalation, the plateau escalation, and
`follow_deltas` publishing the JAX loop's generations, strictly
monotonic, with the same F."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from bigclam_tpu.config import BigClamConfig as JaxConfig
from bigclam_tpu.graph.store import compile_graph_cache as jax_compile
from bigclam_tpu.models import BigClamModel as JaxModel
from bigclam_tpu.models import SparseBigClamModel as JaxSparseModel
from bigclam_tpu.models import refit as jrefit
from bigclam_tpu.serve.snapshot import ServingSnapshot as JaxSnapshot

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.store import GraphStore, compile_graph_cache
from bigclam_tpu_torch.models import refit as trefit
from bigclam_tpu_torch.models.bigclam import BigClamModel, random_init_F
from bigclam_tpu_torch.models.sparse import SparseBigClamModel
from bigclam_tpu_torch.obs import RunTelemetry, install, uninstall
from bigclam_tpu_torch.obs.schema import validate_events_file
from bigclam_tpu_torch.serve.snapshot import publish_snapshot
from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(2)

SHARDS = 4
K = 6
RTOL = 1e-10
# F after hundreds of float64 fold-in iterations is compared row by row:
# max|dF_u| <= ROW_TOL * ||F_ref,u|| + 1e-12. Summation order alone moves
# a row by up to 1.04e-10 of its norm over this file's six comparisons
# (the follow loop's 873 iterations), the same as a one-ulp change of the
# port's own F0 (5.5e-12 over the plateau refit); every integer outcome
# and the LLH history stay exact at RTOL.
ROW_TOL = 1e-9


def _write_edges(path, edges):
    with open(path, "w") as f:
        for u, v in edges:
            f.write(f"{u}\t{v}\n")
    return str(path)


def _base_edges(n, extra, seed):
    """Ring (every id present => internal row == raw id) + random (the
    generator of tests/test_delta.py)."""
    rng = np.random.default_rng(seed)
    edges = [(i, (i + 1) % n) for i in range(n)]
    edges += [(int(u), int(v)) for u, v in rng.integers(0, n, (extra, 2))
              if u != v]
    return edges


def _delta_edges(lo=0, hi=50, stride=2, shift=9):
    """Edges confined to rows [lo, hi)."""
    return [(i, lo + (i + shift - lo) % (hi - lo))
            for i in range(lo, hi, stride)
            if i != lo + (i + shift - lo) % (hi - lo)]


def _cfg(**kw):
    return BigClamConfig(num_communities=K, max_iters=200, seed=0,
                         dtype="float64", **kw)


def _jcfg(**kw):
    return JaxConfig(num_communities=K, max_iters=200, seed=0,
                     dtype="float64", use_pallas_csr=False, **kw)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both packages' caches of one graph (150 nodes), the port's converged
    float64 fit on it, one delta applied to both, and the graphs after."""
    tmp = tmp_path_factory.mktemp("refit")
    text = _write_edges(tmp / "g.txt", _base_edges(150, 450, 3))
    ours = compile_graph_cache(text, str(tmp / "ours"), num_shards=SHARDS)
    ref = jax_compile(text, str(tmp / "ref"), num_shards=SHARDS)
    g0 = ours.load_graph()
    model0 = BigClamModel(g0, _cfg(), device="cpu")
    F0 = model0.fit(random_init_F(g0, _cfg())).F
    delta = _write_edges(tmp / "delta.txt",
                         _delta_edges(lo=0, hi=40, stride=3, shift=11))
    info = ours.apply_delta(delta)
    jinfo = ref.apply_delta(delta)
    np.testing.assert_array_equal(info["touched_rows"], jinfo["touched_rows"])
    return dict(tmp=tmp, text=text, ours=ours, ref=ref, F0=F0, delta=delta,
                info=info, g=ours.load_graph(), jg=ref.load_graph())


def test_halo_and_touched_rows_match_jax(world):
    g, jg = world["g"], world["jg"]
    touched = np.asarray([0, 5, 77])
    for hops in (0, 1, 2):
        np.testing.assert_array_equal(
            trefit.expand_halo(g.indptr, g.indices, touched, hops),
            jrefit.expand_halo(jg.indptr, jg.indices, touched, hops))
    rows = trefit.touched_rows_from_delta(g.raw_ids, world["delta"])
    np.testing.assert_array_equal(
        rows, jrefit.touched_rows_from_delta(jg.raw_ids, world["delta"]))
    np.testing.assert_array_equal(rows, world["info"]["touched_rows"])


def assert_rows_close(F, F_ref):
    F, F_ref = np.asarray(F), np.asarray(F_ref)
    assert F.shape == F_ref.shape
    bound = ROW_TOL * np.linalg.norm(F_ref, axis=1) + 1e-12
    worst = np.abs(F - F_ref).max(axis=1) - bound
    assert (worst <= 0).all(), (
        f"rows {np.flatnonzero(worst > 0).tolist()} beyond the row band")


def _assert_refit_equal(ours, ref):
    for field in ("rounds", "touched", "refit_nodes", "touched_frac", "halo",
                  "converged", "escalated", "foldin_iters"):
        assert getattr(ours, field) == getattr(ref, field), field
    np.testing.assert_allclose(ours.history, ref.history, rtol=RTOL)
    np.testing.assert_allclose(ours.llh, ref.llh, rtol=RTOL)
    assert_rows_close(ours.F, ref.F)
    assert [a["check"] for a in ours.anomalies] == [
        a["check"] for a in ref.anomalies]


@pytest.mark.parametrize("rep", ["dense", "sparse"])
@pytest.mark.parametrize("halo,batch", [(1, 512), (0, 16)])
def test_warm_start_refit_matches_jax(world, rep, halo, batch):
    touched = world["info"]["touched_rows"]
    if rep == "dense":
        ours = BigClamModel(world["g"], _cfg(), device="cpu")
        ref = JaxModel(world["jg"], _jcfg())
    else:
        ours = SparseBigClamModel(
            world["g"], _cfg(representation="sparse", sparse_m=K),
            device="cpu")
        ref = JaxSparseModel(world["jg"],
                             _jcfg(representation="sparse", sparse_m=K))
    kw = dict(halo=halo, max_rounds=6, batch=batch)
    r_ours = ours.warm_start_refit(world["F0"], touched, **kw)
    r_ref = ref.warm_start_refit(world["F0"], touched, **kw)
    _assert_refit_equal(r_ours, r_ref)
    assert r_ours.rounds >= 2 and r_ours.refit_nodes >= r_ours.touched
    if halo == 0:
        # rows outside the refit set are the previous F, bit for bit
        keep = np.setdiff1d(np.arange(world["g"].num_nodes), touched)
        np.testing.assert_array_equal(r_ours.F[keep], world["F0"][keep])


def test_refit_escalates_on_plateau_like_jax(world):
    touched = world["info"]["touched_rows"]
    # the per-node stop stays above float64 noise (a 1e-12 stop would
    # compare LLH changes of a few ulps, where summation order decides)
    kw = dict(halo=1, max_rounds=10, conv_tol=1e-12, foldin_conv_tol=1e-8,
              thresholds={"plateau_floor": 0.5, "plateau_patience": 2})
    r_ours = BigClamModel(world["g"], _cfg(), device="cpu").warm_start_refit(
        world["F0"], touched, **kw)
    r_ref = JaxModel(world["jg"], _jcfg()).warm_start_refit(
        world["F0"], touched, **kw)
    assert r_ours.escalated
    assert any(a["check"] == "plateau" for a in r_ours.anomalies)
    _assert_refit_equal(r_ours, r_ref)


def test_refit_commit_matches_apply_rows(world):
    """The dense commit writes the rows and moves sumF by their delta; the
    sparse commit re-sparsifies and re-reduces sumF."""
    g = world["g"]
    rows = np.random.default_rng(2).uniform(0, 1, (3, K))
    nodes = [4, 40, 140]
    dense = BigClamModel(g, _cfg(), device="cpu")
    st = dense.refit_commit(dense.init_state(world["F0"]), nodes, rows)
    F = world["F0"].copy()
    F[nodes] = rows
    np.testing.assert_array_equal(dense.extract_F(st), F)
    np.testing.assert_allclose(st.sumF.numpy(), F.sum(0), rtol=1e-12)
    sparse = SparseBigClamModel(
        g, _cfg(representation="sparse", sparse_m=2), device="cpu")
    sst = sparse.refit_commit(sparse.init_state(world["F0"]), nodes, rows)
    got = sparse.extract_F(sst)[nodes]
    top2 = np.argsort(-rows, axis=1, kind="stable")[:, :2]
    want = np.zeros_like(rows)
    np.put_along_axis(want, top2, np.take_along_axis(rows, top2, 1), 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(sst.sumF.numpy(),
                               sparse.extract_F(sst).sum(0), rtol=1e-12)


def test_follow_deltas_publishes_the_jax_generations(world, tmp_path):
    """Two deltas and a duplicate-only one through both loops, each from
    its own copy of the cache: strictly monotonic generations 2 and 3 over
    the fit's 1, the empty delta skipped, and the same published F."""
    ddir = tmp_path / "deltas"
    ddir.mkdir()
    _write_edges(ddir / "a.txt", _delta_edges(lo=50, hi=90, stride=4, shift=7))
    _write_edges(ddir / "b.txt", _delta_edges(lo=100, hi=140, stride=5,
                                              shift=13))
    _write_edges(ddir / "0.txt", [(0, 1)])          # already an edge
    out = {}
    for pkg in ("ours", "ref"):
        cache = str(tmp_path / f"cache_{pkg}")
        shutil.copytree(world[pkg].directory, cache)
        snaps = str(tmp_path / f"snaps_{pkg}")
        g = world["g"]
        publish_snapshot(snaps, step=None, F=world["F0"], raw_ids=g.raw_ids,
                         num_edges=g.num_edges, cfg=_cfg())
        if pkg == "ours":
            res = trefit.follow_deltas(
                GraphStore.open(cache), _cfg(), world["F0"], snaps, str(ddir),
                max_rounds=4, interval_s=0.01, max_deltas=2, quiet=True,
                device="cpu")
        else:
            from bigclam_tpu.graph.store import GraphStore as JaxStore

            res = jrefit.follow_deltas(
                JaxStore.open(cache), _jcfg(), world["F0"], snaps, str(ddir),
                max_rounds=4, interval_s=0.01, max_deltas=2, quiet=True)
        out[pkg] = (res, snaps)
    (ours, snaps), (ref, jsnaps) = out["ours"], out["ref"]
    assert ours["generations"] == ref["generations"] == 2
    assert ours["last_step"] == ref["last_step"] == 3
    assert len(ours["skipped_empty"]) == len(ref["skipped_empty"]) == 1
    assert [os.path.basename(p) for p in ours["processed"]] == ["a.txt",
                                                               "b.txt"]
    cm = CheckpointManager(snaps)
    assert cm.published_steps() == [1, 2, 3] and cm.latest() == 3
    for step in (2, 3):
        a = JaxSnapshot.load(snaps, step=step)
        b = JaxSnapshot.load(jsnaps, step=step)
        assert a.meta["refit"] and a.meta["delta_seq"] == b.meta["delta_seq"]
        assert_rows_close(a.F, b.F)


def test_refit_events_are_schema_valid(world, tmp_path):
    tdir = str(tmp_path / "tel")
    tel = install(RunTelemetry(tdir, entry="refit"))
    try:
        model = BigClamModel(world["g"], _cfg(), device="cpu")
        model.warm_start_refit(world["F0"], world["info"]["touched_rows"],
                               halo=0, max_rounds=3)
    finally:
        tel.finalize()
        uninstall(tel)
    path = os.path.join(tdir, "events.jsonl")
    n, errors = validate_events_file(path)
    assert not errors, errors[:5]
    kinds = [json.loads(line)["kind"] for line in open(path)]
    assert "refit" in kinds
