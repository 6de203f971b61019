"""Multi-process meshes of the port (parallel/multihost.py, utils/dist.py,
the single-writer gates, `cli fit --distributed`): the single-process
semantics of the helpers, and real two-process gloo groups on the CPU
(tests/_torch_multihost_worker.py) whose trajectories equal the port's
single-controller runs of the same mesh shape bit for bit, and the dense
fit within rtol 1e-12 of the JAX `BigClamModel`, as tests/test_multihost.py
holds the JAX package's own. The modes share a few spawns; each spawn has
a 120 s limit and its survivor is killed."""

import importlib.util
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from bigclam_tpu_torch.parallel import multihost as mh
from bigclam_tpu_torch.parallel.mesh import make_mesh
from bigclam_tpu_torch.utils import dist as udist

HERE = os.path.dirname(os.path.abspath(__file__))
_WORKER = os.path.join(HERE, "_torch_multihost_worker.py")
_JAX_WORKER = os.path.join(HERE, "_multihost_worker.py")
CPU = torch.device("cpu")
SPAWN_TIMEOUT = 120
COORD_ENVS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", mh.BACKEND_ENV)


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


W = _module(_WORKER, "_torch_mh_worker")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(rank: int, names: str, port: int) -> dict:
    """The parent's environment without coordinator variables, plus this
    rank's: the JAX names ("jax") or torchrun's ("torchrun")."""
    env = {k: v for k, v in os.environ.items() if k not in COORD_ENVS}
    env["PYTHONPATH"] = os.path.dirname(HERE)
    if names == "jax":
        env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(rank))
    else:
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                   RANK=str(rank), LOCAL_RANK=str(rank))
    return env


def _run_pair(argv_of, names: str = "jax") -> list:
    """Spawn two ranks (argv_of(rank)), wait at most SPAWN_TIMEOUT s, kill
    any survivor, and assert both exit 0; returns their (stdout, stderr)."""
    port = _free_port()
    procs = []
    for r in range(2):
        procs.append(subprocess.Popen(argv_of(r), env=_env(r, names, port),
                                      cwd=os.path.dirname(HERE),
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    try:
        outs = [p.communicate(timeout=SPAWN_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [f"rank {r} exited {p.returncode}:\n{so}\n{se}"
           for r, (p, (so, se)) in enumerate(zip(procs, outs)) if p.returncode]
    assert not bad, "\n".join(bad)
    return outs


def _worker_pair(out_dir, root, modes, names="jax"):
    return _run_pair(lambda r: [sys.executable, _WORKER, str(r), str(out_dir),
                                str(root), ",".join(modes)], names)


def _write_text_graph(path, g):
    path.write_text("\n".join(f"{u} {v}" for u, v in zip(g.src.tolist(), g.dst.tolist())
                              if u < v))


MODES = ("telemetry", "fit", "ring", "tp12", "ring22", "store", "store-ring",
         "quality-device", "sparse", "ckpt-write")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """One two-rank spawn of every mode but the resumes (JAX names)."""
    from bigclam_tpu_torch.graph.store import compile_graph_cache

    root = tmp_path_factory.mktemp("mh")
    out = root / "out"
    out.mkdir()
    g, cfg, F0 = W.problem()
    _write_text_graph(root / "g.txt", g)
    compile_graph_cache(str(root / "g.txt"), str(root / "cache"), num_shards=4,
                        chunk_bytes=256)
    _worker_pair(out, root, MODES)
    return root, out


def _got(out, mode):
    return np.load(out / f"{mode}.npz")


def _assert_same(got, res):
    assert np.array_equal(got["F"], res.F)
    assert np.array_equal(got["llh_history"], np.asarray(res.llh_history))


def _single(cls, shape, cfg=None, **kw):
    from bigclam_tpu_torch.parallel.ring import RingBigClamModel

    g, cfg0, F0 = W.problem()
    if cls is RingBigClamModel:
        kw.setdefault("balance", False)
    return cls(g, cfg or cfg0, make_mesh(shape, [CPU] * (shape[0] * shape[1])), **kw)


def _jax_fit():
    """The JAX BigClamModel on the JAX worker's identical problem."""
    from bigclam_tpu.models import BigClamModel

    jw = _module(_JAX_WORKER, "_jax_mh_worker")
    g, cfg, F0 = jw.problem()
    return BigClamModel(g, cfg).fit(F0)


# ------------------------------------------------------ single process


def test_initialize_distributed_noop_without_coordinator(monkeypatch):
    for k in COORD_ENVS:
        monkeypatch.delenv(k, raising=False)
    assert mh.initialize_distributed(device="cpu") is False
    assert udist.process_index() == 0 and udist.process_count() == 1
    assert udist.is_primary()


def test_coordinator_without_world_size_is_refused(monkeypatch):
    for k in COORD_ENVS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1")
    with pytest.raises(ValueError, match="world size or rank"):
        mh.initialize_distributed(device="cpu")


@pytest.mark.parametrize("env,want", [
    ({"MASTER_ADDR": "h", "MASTER_PORT": "9", "WORLD_SIZE": "4", "RANK": "3"},
     ("h:9", 4, 3)),
    ({"JAX_COORDINATOR_ADDRESS": "j:7", "JAX_NUM_PROCESSES": "2",
      "JAX_PROCESS_ID": "1"}, ("j:7", 2, 1)),
    ({"COORDINATOR_ADDRESS": "c:5", "JAX_NUM_PROCESSES": "2",
      "JAX_PROCESS_ID": "0"}, ("c:5", 2, 0)),
    ({}, (None, None, None)),
])
def test_launch_resolution_order(monkeypatch, env, want):
    for k in COORD_ENVS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert mh._resolve_launch(None, None, None) == want
    if want[0] is not None:        # explicit arguments come first
        assert mh._resolve_launch("x:1", 8, 5) == ("x:1", 8, 5)


def test_backend_follows_the_device(monkeypatch):
    monkeypatch.delenv(mh.BACKEND_ENV, raising=False)
    assert mh.backend_for("cpu") == "gloo"
    assert mh.backend_for("cuda") == "nccl"
    monkeypatch.setenv(mh.BACKEND_ENV, "gloo")
    assert mh.backend_for("cuda") == "gloo"
    monkeypatch.setenv(mh.BACKEND_ENV, "nccl")
    with pytest.raises(ValueError, match="needs a cuda device"):
        mh.backend_for("cpu")
    monkeypatch.setenv(mh.BACKEND_ENV, "mpi")
    with pytest.raises(ValueError, match="use gloo or nccl"):
        mh.backend_for("cuda")


def test_rank_without_card_raises_device_unavailable():
    from bigclam_tpu_torch.utils.device import DeviceUnavailableError

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(DeviceUnavailableError):
        mh.rank_device("cuda")
    assert mh.rank_device("cpu") == CPU


def test_slice_groups():
    assert mh.slice_groups() == {0: [0]}
    assert mh.slice_groups(["a", "a", "b", "b"]) == {0: [0, 1], 1: [2, 3]}


@pytest.mark.parametrize("shape,positions", [((4, 1), 4), ((2, 2), 4), ((1, 3), 3),
                                             (None, 1)])
def test_make_multihost_mesh_single_process(shape, positions):
    mesh = mh.make_multihost_mesh(shape, "cpu")
    assert not mesh.distributed and mesh.size == positions
    assert mh.ring_peers(mesh) is None
    assert mh.addressable_row_bounds(mesh, 8 * mesh.shape["nodes"]) == \
        (0, 8 * mesh.shape["nodes"])


@pytest.mark.parametrize("shape,world,msg", [
    ((3, 1), 2, "not a multiple of the 2 processes"),
    ((2, 3), 3, "neither whole rows"),
])
def test_owner_plan_refuses_uneven_grids(shape, world, msg):
    with pytest.raises(ValueError, match=msg):
        mh._owner_plan(*shape, world)
    assert mh._owner_plan(4, 1, 2) == 2 and mh._owner_plan(1, 4, 2) == 2


def test_owner_is_slice_major():
    # (4, 2) over 4 ranks: a node row a rank; (2, 4) over 4: half a row
    assert [mh.owner(i, j, 2, 2) for i in range(4) for j in range(2)] == \
        [0, 0, 1, 1, 2, 2, 3, 3]
    assert [mh.owner(i, j, 4, 2) for i in range(2) for j in range(4)] == \
        [0, 0, 1, 1, 2, 2, 3, 3]


def test_host_shard_ids():
    assert mh.host_shard_ids(8, 1, 4) == range(2, 4)
    assert mh.host_shard_ids(4) == range(0, 4)
    with pytest.raises(ValueError, match="not divisible"):
        mh.host_shard_ids(6, 0, 4)


def test_global_max_int_is_identity_single_process():
    assert mh.global_max_int(7) == 7


def test_put_sharded_and_fetch_global_are_identity_single_process():
    x = np.arange(32, dtype=np.float64).reshape(8, 4)
    mesh = mh.make_multihost_mesh((4, 2), "cpu")
    blocks = mh.put_sharded(x, mesh)
    assert len(blocks) == 4 and all(len(r) == 2 for r in blocks)
    layout = tuple(tuple(r) for r in blocks)
    assert np.array_equal(mh.fetch_global(layout, mesh), x)
    assert np.array_equal(mh.fetch_global(torch.from_numpy(x)), x)
    local = mh.put_host_local(x, mesh, x.shape)
    assert all(torch.equal(a, b) for ra, rb in zip(local, blocks)
               for a, b in zip(ra, rb))
    with pytest.raises(ValueError, match="addressable block"):
        mh.put_host_local(x[:4], mesh, x.shape)


def test_load_host_shard_reads_the_whole_cache_single_process(tmp_path):
    from bigclam_tpu_torch.graph.store import GraphStore, compile_graph_cache

    g, _, _ = W.problem()
    _write_text_graph(tmp_path / "g.txt", g)
    compile_graph_cache(str(tmp_path / "g.txt"), str(tmp_path / "c"), num_shards=4,
                        chunk_bytes=256)
    store = GraphStore.open(str(tmp_path / "c"))
    hs = mh.load_host_shard(store)
    assert hs.shard_ids == (0, 1, 2, 3) and (hs.lo, hs.hi) == (0, 24)
    ss = mh.load_host_seed_scores(store, 1, 2)
    assert set(ss.files_read) == {"shard_00002.phi.npy", "shard_00003.phi.npy"}


# ------------------------------------------------------ two processes


def test_two_rank_fit_equals_single_controller_and_jax(pair):
    from bigclam_tpu_torch.parallel.sharded import ShardedBigClamModel

    _, out = pair
    _, _, F0 = W.problem()
    got = _got(out, "fit")
    _assert_same(got, _single(ShardedBigClamModel, (4, 1)).fit(F0))
    ref = _jax_fit()
    np.testing.assert_allclose(got["F"], ref.F, rtol=1e-12)
    np.testing.assert_allclose(got["llh_history"], np.asarray(ref.llh_history),
                               rtol=1e-12)


@pytest.mark.parametrize("mode,shape", [("ring", (4, 1)), ("ring22", (2, 2))])
def test_two_rank_ring_equals_single_controller(pair, mode, shape):
    from bigclam_tpu_torch.parallel.ring import RingBigClamModel

    _, out = pair
    _, _, F0 = W.problem()
    _assert_same(_got(out, mode), _single(RingBigClamModel, shape).fit(F0))


def test_two_rank_k_axis_crossing_ranks_equals_single_controller(pair):
    from bigclam_tpu_torch.parallel.sharded import ShardedBigClamModel

    _, out = pair
    _, _, F0 = W.problem()
    _assert_same(_got(out, "tp12"), _single(ShardedBigClamModel, (1, 2)).fit(F0))


@pytest.mark.parametrize("mode", ["store", "store-ring"])
def test_two_rank_store_reads_own_shards_and_equals_single_controller(pair, mode):
    from bigclam_tpu_torch.graph.store import GraphStore
    from bigclam_tpu_torch.parallel.ring import StoreRingBigClamModel
    from bigclam_tpu_torch.parallel.sharded import StoreShardedBigClamModel

    root, out = pair
    _, cfg, F0 = W.problem()
    cls = StoreShardedBigClamModel if mode == "store" else StoreRingBigClamModel
    model = cls(GraphStore.open(str(root / "cache")), cfg,
                make_mesh((4, 1), [CPU] * 4))
    got = _got(out, mode)
    _assert_same(got, model.fit(F0))
    if mode == "store":
        assert np.array_equal(got["F_rowkeyed"], model.fit().F)


def test_two_rank_telemetry_single_writer(pair):
    from bigclam_tpu_torch.obs.report import load_reports, merge_reports
    from bigclam_tpu_torch.obs.schema import validate_events_file
    from bigclam_tpu_torch.parallel.sharded import ShardedBigClamModel

    root, out = pair
    tdir = root / "tel"
    _, _, F0 = W.problem()
    _assert_same(_got(out, "telemetry"), _single(ShardedBigClamModel, (4, 1)).fit(F0))
    n, errors = validate_events_file(str(tdir / "events.jsonl"))
    assert errors == [] and n > 0
    events = [json.loads(line) for line in open(tdir / "events.jsonl")]
    assert all(e["pid"] == 0 for e in events)
    kinds = [e["kind"] for e in events]
    # `start` was buffered before the join and flushed by it
    assert kinds[0] == "start" and "distributed_init" in kinds and "step" in kinds
    assert [e for e in events if e["kind"] == "distributed_init"][0]["processes"] == 2
    reports = load_reports(str(tdir))
    assert [r["pid"] for r in reports] == [0, 1]
    assert all(r["processes"] == 2 for r in reports)
    assert len({r["run"] for r in reports}) == 1
    assert merge_reports(reports)["processes_reported"] == 2
    # the metrics JSONL: one writer
    assert (root / "m0.jsonl").stat().st_size > 0 and not (root / "m1.jsonl").exists()


def test_two_rank_quality_device_equals_single_controller(pair):
    from bigclam_tpu_torch.models.quality import fit_quality_device
    from bigclam_tpu_torch.parallel.sharded import ShardedBigClamModel

    _, out = pair
    _, cfg, F0 = W.problem()
    ref = fit_quality_device(_single(ShardedBigClamModel, (4, 1), W.quality_cfg(cfg)), F0)
    got = _got(out, "quality-device")
    assert np.array_equal(got["cycles"], np.asarray(ref.cycles_llh))
    assert np.array_equal(got["F"], ref.fit.F)


@pytest.mark.parametrize("tag,path", [("sparse", "sparse_xla_spall"),
                                      ("sparse-cap8", "sparse_xla_spall")])
def test_two_rank_sparse_equals_single_controller(pair, tag, path):
    """The sparse sharded trainer across ranks: the capped exchange, and a
    cap of 8 that falls back to the dense psum, bit for bit the single
    controller's."""
    from bigclam_tpu_torch.parallel.sparse_sharded import SparseShardedBigClamModel

    _, out = pair
    g, cfgs, F0 = W.sparse_problem()
    model = SparseShardedBigClamModel(g, cfgs[tag], make_mesh((4, 1), [CPU] * 4))
    got = _got(out, tag)
    _assert_same(got, model.fit(F0))
    # the path after the init's touched counts refined the exchange
    assert str(got["path"]) == model.engaged_path == path


def test_two_rank_checkpoint_single_writer_resume(pair, tmp_path):
    """ckpt-write wrote into each rank's own directory (only rank 0's got
    files); a fresh pair, launched with torchrun's variables, resumes from
    rank 0's to max_iters=8 and lands on the uninterrupted run."""
    import shutil

    from bigclam_tpu_torch.parallel.sharded import ShardedBigClamModel

    root, _ = pair
    ck = tmp_path / "ckpt"
    shutil.copytree(root / "ckpt", ck)
    assert any(f.endswith(".npz") for f in os.listdir(ck / "p0"))
    assert not (ck / "p1").exists() or not os.listdir(ck / "p1")
    out = tmp_path / "out"
    out.mkdir()
    _worker_pair(out, tmp_path, ["ckpt-resume"], names="torchrun")
    _, _, F0 = W.problem()
    got = _got(out, "ckpt-resume")
    _assert_same(got, _single(ShardedBigClamModel, (4, 1)).fit(F0))
    ref = _jax_fit()
    np.testing.assert_allclose(got["F"], ref.F, rtol=1e-12)


def test_two_rank_corrupt_checkpoints_fall_back_on_every_rank(pair, tmp_path):
    import shutil

    from bigclam_tpu_torch.parallel.sharded import ShardedBigClamModel
    from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

    root, _ = pair
    shutil.copytree(root / "ckpt", tmp_path / "ckpt")
    shared = tmp_path / "ckpt" / "p0"
    cm = CheckpointManager(str(shared))
    assert cm.steps() == [2, 4]
    p4 = cm._path(4)
    with open(p4, "r+b") as f:                   # corrupt the newest
        f.truncate(os.path.getsize(p4) // 2)
    (shared / "ckpt_000000006.npz").write_bytes(b"PK\x03\x04 bogus")
    out = tmp_path / "out"
    out.mkdir()
    _worker_pair(out, tmp_path, ["corrupt-resume"], names="torchrun")
    _, _, F0 = W.problem()
    _assert_same(_got(out, "corrupt-resume"),
                 _single(ShardedBigClamModel, (4, 1)).fit(F0))


def test_cli_fit_distributed_two_ranks_jax_names(pair, tmp_path):
    """`cli fit --distributed --mesh 4,1 --device cpu` on two ranks found
    by the JAX names: both print the single-controller run's JSON
    trajectory, and only rank 0 writes its --out."""
    from bigclam_tpu_torch import cli

    root, _ = pair
    args = ["--graph", str(root / "g.txt"), "--k", "2", "--device", "cpu",
            "--dtype", "float64", "--max-iters", "8", "--conv-tol", "0",
            "--mesh", "4,1", "--quiet"]
    outs = _run_pair(lambda r: [sys.executable, "-m", "bigclam_tpu_torch.cli", "fit",
                                *args, "--distributed",
                                "--out", str(tmp_path / f"c{r}.txt")])
    ref, _, _ = cli.fit(cli.build_parser().parse_args(
        ["fit", *args, "--out", str(tmp_path / "ref.txt")]))
    for so, _ in outs:
        got = json.loads(so.strip().splitlines()[-1])
        assert got["llh_history"] == ref["llh_history"]
        assert got["mesh"] == "4x1"
    assert (tmp_path / "c0.txt").read_bytes() == (tmp_path / "ref.txt").read_bytes()
    assert not (tmp_path / "c1.txt").exists()


def test_cli_sweep_distributed_two_ranks_single_writer(pair, tmp_path):
    """`cli sweep --distributed` on two ranks found by torchrun's
    variables: both print the single-controller sweep's JSON, and only
    rank 0 writes the per-K journal into its --checkpoint-dir."""
    from bigclam_tpu_torch import cli

    root, _ = pair
    args = ["--graph", str(root / "g.txt"), "--min-com", "2", "--max-com", "4",
            "--div-com", "2", "--device", "cpu", "--dtype", "float64",
            "--max-iters", "4", "--mesh", "4,1", "--quiet"]
    outs = _run_pair(lambda r: [sys.executable, "-m", "bigclam_tpu_torch.cli", "sweep",
                                *args, "--distributed",
                                "--checkpoint-dir", str(tmp_path / f"ck{r}")],
                     names="torchrun")
    ref = cli.sweep(cli.build_parser().parse_args(["sweep", *args]))
    for so, _ in outs:
        got = json.loads(so.strip().splitlines()[-1])
        assert got["llh_by_k"] == ref["llh_by_k"] and got["chosen_k"] == ref["chosen_k"]
    assert os.listdir(tmp_path / "ck0")
    assert not (tmp_path / "ck1").exists() or not os.listdir(tmp_path / "ck1")
