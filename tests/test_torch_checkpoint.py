"""The port's checkpoints (utils.checkpoint, restore_checkpoint, the
trainers' _ckpt_meta / _state_to_arrays / _state_from_arrays, within-K
sweep checkpoints) against the JAX package: archives written by either
package restore in the other (arrays, sidecar keys, crc and meta equal),
the truncate/corrupt faults fall back to the older archive, rotation never
deletes the newest valid archive, a resume from a JAX-written checkpoint
continues the JAX trajectory at 1e-10, mismatches are refused by name."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax

from bigclam_tpu.config import BigClamConfig as JaxConfig
from bigclam_tpu.graph.ingest import graph_from_edges as jax_graph_from_edges
from bigclam_tpu.models.bigclam import BigClamModel as JaxModel
from bigclam_tpu.models.sparse import SparseBigClamModel as JaxSparseModel
from bigclam_tpu.parallel import ShardedBigClamModel as JaxSharded
from bigclam_tpu.parallel import make_mesh as jax_make_mesh
from bigclam_tpu.resilience import install_plan as jax_install_plan
from bigclam_tpu.utils.checkpoint import CheckpointManager as JaxManager

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.models.bigclam import BigClamModel, CheckpointMismatchError
from bigclam_tpu_torch.models.model_selection import sweep_k
from bigclam_tpu_torch.models.sparse import SparseBigClamModel
from bigclam_tpu_torch.parallel import ShardedBigClamModel, make_mesh
from bigclam_tpu_torch.resilience import FaultPlan, faults, install_plan
from bigclam_tpu_torch.utils.checkpoint import (
    CheckpointCorruption,
    CheckpointManager,
)

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    install_plan(None)
    jax_install_plan(None)


def _graph(seed=0, n=48, p=0.15):
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < p
    edges = [(i, j) for i in range(n) for j in range(i + 1, n) if a[i, j]]
    edges.append((0, n - 1))
    return jax_graph_from_edges(edges, num_nodes=n)


def _port_graph(g):
    return Graph(indptr=g.indptr, indices=g.indices, raw_ids=g.raw_ids)


def _cfgs(**kw):
    base = dict(num_communities=5, dtype="float64", max_iters=10,
                conv_tol=0.0, edge_chunk=64)
    base.update(kw)
    jc = JaxConfig(**base)
    return jc, BigClamConfig(**dataclasses.asdict(jc))


def _f0(g, k, seed=1):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (g.num_nodes, k))


def _arrays():
    rng = np.random.default_rng(3)
    return {
        "F": rng.random((7, 4)).astype(np.float32),
        "sumF": rng.random(4).astype(np.float32),
        "llh": np.asarray(-12.5, np.float32),
        "it": np.asarray(6, np.int32),
    }


# --------------------------------------------------------------------------
# the archive format, across packages
# --------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_archive_restores_in_the_other_package(tmp_path, writer):
    arrays, meta = _arrays(), {"llh_history": [-20.0, -12.5], "k": 4}
    W, R = (JaxManager, CheckpointManager) if writer == "jax" else (
        CheckpointManager, JaxManager)
    path = W(str(tmp_path)).save(6, arrays, meta=meta)
    step, got, got_meta = R(str(tmp_path)).restore()
    assert step == 6
    assert set(got) == set(arrays)
    for name, a in arrays.items():
        np.testing.assert_array_equal(got[name], a)
        assert got[name].dtype == a.dtype
    side = json.load(open(path + ".json"))
    assert got_meta == side
    assert set(side) == {"step", "array_crc32", "llh_history", "k"}


def test_both_packages_write_the_same_sidecar(tmp_path):
    arrays = _arrays()
    meta = {"llh_history": [-3.0], "seed": 0}
    pj = JaxManager(str(tmp_path / "j")).save(2, arrays, meta=meta)
    pp = CheckpointManager(str(tmp_path / "p")).save(2, arrays, meta=meta)
    assert json.load(open(pj + ".json")) == json.load(open(pp + ".json"))


@pytest.mark.parametrize("kind", ["truncate_checkpoint", "corrupt_checkpoint"])
def test_file_faults_fall_back_to_the_older_archive(tmp_path, kind, capsys):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"F": np.full((4, 3), 1.0)})
    install_plan(FaultPlan([{"kind": kind, "site": "checkpoint.save",
                             "step": 2}]))
    cm.save(2, {"F": np.full((4, 3), 2.0)})
    install_plan(None)
    step, arrays, _ = cm.restore()
    assert step == 1
    np.testing.assert_array_equal(arrays["F"], np.full((4, 3), 1.0))
    assert cm.latest_step() == 2 and cm.latest_valid_step() == 1
    assert "trying an older one" in capsys.readouterr().err
    # the JAX manager reads the same directory the same way
    assert JaxManager(str(tmp_path)).restore()[0] == 1


def test_silent_corruption_detected_and_skipped(tmp_path, capsys):
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, {"F": np.ones((4, 3))}, meta={"llh_history": [-5.0]})
    cm.save(2, {"F": np.full((4, 3), 2.0)}, meta={"llh_history": [-4.0]})
    side_path = cm._path(2) + ".json"
    side = json.load(open(side_path))
    side["array_crc32"]["F"] ^= 0xFFFF
    json.dump(side, open(side_path, "w"))
    with pytest.raises(CheckpointCorruption, match="checksum mismatch"):
        cm.restore(2)
    assert cm.restore()[0] == 1
    assert "silently corrupted" in capsys.readouterr().err


def test_rotation_never_deletes_newest_valid_checkpoint(tmp_path):
    cm = CheckpointManager(str(tmp_path), keep=2)
    cm.save(1, {"F": np.full((4, 3), 1.0)})
    cm.save(2, {"F": np.full((4, 3), 2.0)})
    install_plan(FaultPlan([
        {"kind": "truncate_checkpoint", "site": "checkpoint.save", "step": 3,
         "frac": 0.3},
        {"kind": "corrupt_checkpoint", "site": "checkpoint.save", "step": 4},
    ]))
    cm.save(3, {"F": np.full((4, 3), 3.0)})
    cm.save(4, {"F": np.full((4, 3), 4.0)})
    install_plan(None)
    assert set(cm.steps()) >= {1, 2}
    step, arrays, _ = cm.restore()
    assert step == 2
    np.testing.assert_array_equal(arrays["F"], np.full((4, 3), 2.0))
    cm.save(5, {"F": np.full((4, 3), 5.0)})
    cm.save(6, {"F": np.full((4, 3), 6.0)})
    assert cm.restore()[0] == 6
    assert 1 not in cm.steps()


def test_latest_valid_step_skips_corrupt_newest(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save(2, {"F": np.ones((3, 2))})
    cm.save(4, {"F": np.ones((3, 2)) * 2})
    assert cm.latest_valid_step() == 4
    p4 = cm._path(4)
    with open(p4, "r+b") as f:
        f.truncate(os.path.getsize(p4) // 2)
    assert cm.latest_step() == 4
    assert cm.latest_valid_step() == 2


# --------------------------------------------------------------------------
# trainer checkpoints across packages
# --------------------------------------------------------------------------


def _port_model(kind, pg, cfg):
    if kind == "sharded":
        return ShardedBigClamModel(pg, cfg, make_mesh((4, 1), [CPU] * 4))
    return BigClamModel(pg, cfg, device="cpu")


def _jax_model(kind, g, jc):
    if kind == "sharded":
        return JaxSharded(g, jc, jax_make_mesh((4, 1), jax.devices()[:4]))
    return JaxModel(g, jc)


@pytest.mark.parametrize("kind", ["dense", "sharded"])
def test_resume_from_jax_checkpoint_continues_the_jax_fit(tmp_path, kind):
    """JAX fits 6 iterations, checkpointing every 3; the port resumes
    from its archive (K re-padded, rows cropped) and runs to 10: the LLH
    history equals the uninterrupted JAX fit's at 1e-10."""
    g = _graph()
    jc, cfg = _cfgs(checkpoint_every=3)
    F0 = _f0(g, 5)
    full = _jax_model(kind, g, jc).fit(F0)
    jm = _jax_model(kind, g, jc.replace(max_iters=6))
    jm.fit(F0, checkpoints=JaxManager(str(tmp_path)))
    cm = CheckpointManager(str(tmp_path))
    assert cm.latest_valid_step() == 6
    res = _port_model(kind, _port_graph(g), cfg).fit(F0, checkpoints=cm)
    assert len(res.llh_history) == len(full.llh_history)
    np.testing.assert_allclose(res.llh_history, full.llh_history, rtol=1e-10)
    np.testing.assert_allclose(res.F, full.F, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("kind", ["dense", "sharded"])
def test_port_checkpoint_resumes_in_jax(tmp_path, kind):
    g = _graph(1)
    jc, cfg = _cfgs(checkpoint_every=4)
    F0 = _f0(g, 5, 2)
    full = _port_model(kind, _port_graph(g), cfg).fit(F0)
    _port_model(kind, _port_graph(g), cfg.replace(max_iters=4)).fit(
        F0, checkpoints=CheckpointManager(str(tmp_path)))
    jres = _jax_model(kind, g, jc).fit(F0, checkpoints=JaxManager(str(tmp_path)))
    np.testing.assert_allclose(jres.llh_history, full.llh_history, rtol=1e-10)


def test_port_archive_holds_the_jax_keys_and_meta(tmp_path):
    g = _graph(2)
    jc, cfg = _cfgs(checkpoint_every=2, max_iters=2)
    F0 = _f0(g, 5, 3)
    JaxModel(g, jc).fit(F0, checkpoints=JaxManager(str(tmp_path / "j")))
    BigClamModel(_port_graph(g), cfg, device="cpu").fit(
        F0, checkpoints=CheckpointManager(str(tmp_path / "p")))
    _, aj, mj = JaxManager(str(tmp_path / "j")).restore()
    _, ap, mp = CheckpointManager(str(tmp_path / "p")).restore()
    assert set(aj) == set(ap) == {"F", "sumF", "llh", "it"}
    for name in aj:
        assert aj[name].dtype == ap[name].dtype, name
    assert int(aj["it"]) == int(ap["it"]) == 2
    assert set(mj) == set(mp)
    for key in ("num_nodes", "num_directed_edges", "k", "seed", "n_pad", "step"):
        assert mj[key] == mp[key], key
    np.testing.assert_allclose(mj["llh_history"], mp["llh_history"], rtol=1e-10)
    # K pads to 32 in the port and stays 5 in the JAX xla layout: the live
    # region agrees
    np.testing.assert_allclose(ap["F"][:, :5], aj["F"][:, :5], rtol=1e-10)


def test_sparse_checkpoint_round_trip_across_packages(tmp_path):
    g = _graph(3)
    jc, cfg = _cfgs(representation="sparse", sparse_m=3, checkpoint_every=3,
                    max_iters=8)
    F0 = _f0(g, 5, 4)
    full = JaxSparseModel(g, jc).fit(F0)
    JaxSparseModel(g, jc.replace(max_iters=3)).fit(
        F0, checkpoints=JaxManager(str(tmp_path)))
    pm = SparseBigClamModel(_port_graph(g), cfg, device="cpu")
    if pm.n_pad != JaxSparseModel(g, jc).n_pad:
        pytest.skip("the packages pad the sparse rows differently here")
    res = pm.fit(F0, checkpoints=CheckpointManager(str(tmp_path)))
    np.testing.assert_allclose(res.llh_history, full.llh_history, rtol=1e-10)


@pytest.mark.parametrize(
    "change,key",
    [("graph", "num_nodes"), ("k", "k"), ("seed", "seed")],
)
def test_mismatched_checkpoint_refused_by_name(tmp_path, change, key):
    g = _graph(4)
    _, cfg = _cfgs(checkpoint_every=2, max_iters=2)
    F0 = _f0(g, 5)
    BigClamModel(_port_graph(g), cfg, device="cpu").fit(
        F0, checkpoints=CheckpointManager(str(tmp_path)))
    g2, cfg2 = g, cfg
    if change == "graph":
        g2 = _graph(4, n=50)
    elif change == "k":
        cfg2 = cfg.replace(num_communities=6)
    else:
        cfg2 = cfg.replace(seed=9)
    m = BigClamModel(_port_graph(g2), cfg2, device="cpu")
    with pytest.raises(CheckpointMismatchError, match=f"{key}="):
        m.fit(_f0(g2, cfg2.num_communities),
              checkpoints=CheckpointManager(str(tmp_path)))


def test_dense_checkpoint_refused_by_sparse_fit(tmp_path):
    g = _graph(5)
    _, cfg = _cfgs(checkpoint_every=2, max_iters=2)
    F0 = _f0(g, 5)
    BigClamModel(_port_graph(g), cfg, device="cpu").fit(
        F0, checkpoints=CheckpointManager(str(tmp_path)))
    sp = SparseBigClamModel(_port_graph(g), cfg.replace(representation="sparse",
                                                        sparse_m=3), device="cpu")
    with pytest.raises(CheckpointMismatchError):
        sp.fit(F0, checkpoints=CheckpointManager(str(tmp_path)))


def test_balanced_archive_of_another_padding_is_refused(tmp_path):
    """A balanced layout's rows follow a permutation of n_pad: an archive
    of another n_pad cannot be cropped into place."""
    g = _graph(6)
    _, cfg = _cfgs(checkpoint_every=2, max_iters=2)
    F0 = _f0(g, 5)
    pg = _port_graph(g)
    m = ShardedBigClamModel(pg, cfg, make_mesh((4, 1), [CPU] * 4), balance=True)
    cm = CheckpointManager(str(tmp_path))
    m.fit(F0, checkpoints=cm)
    step, arrays, meta = cm.restore()
    arrays = dict(arrays)
    arrays["F"] = np.concatenate([arrays["F"], np.zeros((4, arrays["F"].shape[1]))])
    meta = {k: v for k, v in meta.items() if k not in ("step", "array_crc32")}
    meta["n_pad"] = arrays["F"].shape[0]
    shutil.rmtree(tmp_path)
    CheckpointManager(str(tmp_path)).save(step, arrays, meta=meta)
    m2 = ShardedBigClamModel(pg, cfg, make_mesh((4, 1), [CPU] * 4), balance=True)
    with pytest.raises(CheckpointMismatchError, match="balanced layout"):
        m2.fit(F0, checkpoints=CheckpointManager(str(tmp_path)))


def test_resume_never_cold_starts_and_still_saves(tmp_path):
    g = _graph(7)
    _, cfg = _cfgs(checkpoint_every=2, max_iters=6)
    F0 = _f0(g, 5)
    pg = _port_graph(g)
    BigClamModel(pg, cfg, device="cpu").fit(
        F0, checkpoints=CheckpointManager(str(tmp_path)))
    cold = BigClamModel(pg, cfg.replace(max_iters=4), device="cpu").fit(
        F0, checkpoints=CheckpointManager(str(tmp_path)), resume=False)
    assert cold.num_iters == 4
    ref = BigClamModel(pg, cfg.replace(max_iters=4), device="cpu").fit(F0)
    assert cold.llh_history == ref.llh_history
    assert CheckpointManager(str(tmp_path)).latest_step() == 6


def test_within_k_sweep_checkpoint_resumes(tmp_path, monkeypatch):
    """A sweep killed inside a K resumes inside it from state_dir/k_<K>/
    and ends with the uninterrupted sweep's LLHs; a journaled K's
    checkpoints are gone."""
    from bigclam_tpu_torch.models.agm import sample_planted_graph

    g, _ = sample_planted_graph(200, 4, p_in=0.3,
                                rng=np.random.default_rng(0))
    cfg = BigClamConfig(num_communities=8, dtype="float64", max_iters=8,
                        conv_tol=0.0, min_com=2, max_com=8, div_com=2,
                        ksweep_tol=-1.0, checkpoint_every=2)
    ref = sweep_k(g, cfg, state_dir=str(tmp_path / "ref"), device="cpu")
    real = faults.maybe_fire
    hits = {"n": 0}

    def dying(site, **ctx):
        # the second K dies at iteration 5, after its checkpoint at 4
        if site == "fit.step" and ctx.get("it") == 5:
            hits["n"] += 1
            if hits["n"] == 2:
                raise OSError("simulated preemption")
        return real(site, **ctx)

    monkeypatch.setattr(faults, "maybe_fire", dying)
    state = tmp_path / "run"
    with pytest.raises(OSError):
        sweep_k(g, cfg, state_dir=str(state), device="cpu")
    k2 = ref.kset[1]
    assert CheckpointManager(str(state / f"k_{k2:06d}")).latest_step() == 4
    assert not (state / f"k_{ref.kset[0]:06d}").exists()
    monkeypatch.setattr(faults, "maybe_fire", real)
    resumed = sweep_k(g, cfg, state_dir=str(state), device="cpu")
    assert resumed.llh_by_k == ref.llh_by_k
    assert resumed.chosen_k == ref.chosen_k
    assert not [p for p in os.listdir(state) if p.startswith("k_")]
