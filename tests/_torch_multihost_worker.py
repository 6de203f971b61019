"""Worker of the two-process torch.distributed tests of the port
(tests/test_torch_multihost.py; the counterpart of _multihost_worker.py).

Launched as `python _torch_multihost_worker.py <rank> <out_dir> <root>
<mode,mode,...>` twice, with the coordinator in the environment (the JAX
names or torchrun's): each rank holds two CPU positions of a (4, 1) mesh
(or one position of a (1, 2) mesh, or one node row of a (2, 2) mesh) on
a gloo group, runs each mode in turn and rank 0 writes each mode's
trajectory to <out_dir>/<mode>.npz for the parent to compare against the
port's single-controller run. Imports torch and numpy only.

Modes:
  telemetry      runs first, with RunTelemetry(<root>/tel, auto_gate=False)
                 constructed before the group is joined: only rank 0 holds
                 the events handle
  fit            ShardedBigClamModel on (4, 1); fetch_global round trip
  ring           RingBigClamModel(balance=False) on (4, 1)
  tp12           ShardedBigClamModel on (1, 2): the k axis crosses ranks
  ring22         RingBigClamModel on (2, 2): one node row a rank
  store          StoreShardedBigClamModel from the cache at <root>/cache:
                 each rank reads only shards [2r, 2r + 2); F0 given and
                 the row-keyed init
  store-ring     StoreRingBigClamModel; load_host_seed_scores reads only
                 this rank's phi blobs
  quality-device fit_quality_device; device extraction of a multi-rank
                 state equals the host extraction of the fetched F
  sparse         SparseShardedBigClamModel on (4, 1) (sparse_problem):
                 the capped exchange ("sparse"), and a cap of 8 that
                 overflows into the dense psum every step ("sparse-cap8")
  ckpt-write     max_iters=4, checkpoint_every=2 into <root>/ckpt/p<rank>:
                 only rank 0's directory gets files
  ckpt-resume    resume from the SHARED <root>/ckpt/p0 (every rank reads)
  corrupt-resume the same after the parent corrupted the newest
                 checkpoints: every rank falls back to step 2
"""

import os
import sys

import numpy as np

# repo root on sys.path: the package is run from a checkout, not installed
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def problem():
    """Deterministic (graph, cfg, F0) shared by worker and parent test: the
    JAX worker's two 12-cliques and a bridge, K = 2, float64, 8 steps."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.graph.ingest import graph_from_edges

    edges = []
    for base in (0, 12):
        for i in range(12):
            for j in range(i + 1, 12):
                edges.append((base + i, base + j))
    edges.append((11, 12))
    g = graph_from_edges(np.asarray(edges, dtype=np.int64), num_nodes=24)
    cfg = BigClamConfig(num_communities=2, dtype="float64", max_iters=8,
                        conv_tol=0.0)
    F0 = np.random.default_rng(5).uniform(0.1, 1.0, size=(24, 2))
    return g, cfg, F0


def sparse_problem():
    """The sparse trainer's config and F0 on problem()'s graph: K = 256,
    M = 4, small init weights; sparse_dense_fallback 1.0 keeps the capped
    exchange ("sparse" mode), sparse_comm_cap 8 overflows it."""
    g, cfg, _ = problem()
    cfg = cfg.replace(num_communities=256, representation="sparse", sparse_m=4,
                      sparse_dense_fallback=1.0)
    F0 = np.random.default_rng(7).uniform(0.05, 0.3, size=(24, 256))
    return g, {"sparse": cfg, "sparse-cap8": cfg.replace(sparse_comm_cap=8)}, F0


def quality_cfg(cfg):
    """The quality-device schedule, one source for worker and parent."""
    return cfg.replace(quality_mode=True, restart_cycles=3, restart_tol=0.0,
                       max_iters=6)


def _save(out_dir, mode, res, **extra):
    np.savez(os.path.join(out_dir, f"{mode}.npz"), F=res.F,
             llh_history=np.asarray(res.llh_history), **extra)


def _own_files(store, rank):
    return {f"shard_{s:05d}.{kind}.npy" for s in (2 * rank, 2 * rank + 1)
            for kind in ("indptr", "indices")}


def main() -> None:
    rank, out_dir, root, modes = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                  sys.argv[4].split(","))
    import torch.distributed as dist

    from bigclam_tpu_torch.obs import RunTelemetry, install, uninstall
    from bigclam_tpu_torch.parallel import multihost as mh
    from bigclam_tpu_torch.parallel.ring import RingBigClamModel, StoreRingBigClamModel
    from bigclam_tpu_torch.parallel.sharded import (
        ShardedBigClamModel,
        StoreShardedBigClamModel,
    )
    from bigclam_tpu_torch.utils.dist import is_primary, process_count

    g, cfg, F0 = problem()
    tel = None
    if "telemetry" in modes:
        # the CLI's sequence: telemetry first, the gate committed by the join
        tel = install(RunTelemetry(os.path.join(root, "tel"), entry="worker-fit",
                                   auto_gate=False))
    assert mh.initialize_distributed(device="cpu") is True
    assert process_count() == 2 and dist.get_rank() == rank
    assert dist.get_backend() == "gloo"
    mesh = mh.make_multihost_mesh((4, 1), "cpu")
    assert mesh.distributed and mesh.origin == (2 * rank, 0)
    assert len(mesh.devices) == 2

    for mode in modes:
        if mode == "telemetry":
            from bigclam_tpu_torch.utils.metrics import MetricsLogger

            model = ShardedBigClamModel(g, cfg, mesh)
            with MetricsLogger(os.path.join(root, f"m{rank}.jsonl"), echo=False) as ml:
                res = model.fit(F0, callback=ml.step_callback(
                    g.num_directed_edges, num_nodes=g.num_nodes))
            tel.set_final({"llh": res.llh, "iters": res.num_iters})
            assert (tel._fh is not None) == (rank == 0), tel._fh
            tel.finalize()
            uninstall(tel)
            if is_primary():
                _save(out_dir, mode, res)
        elif mode == "fit":
            model = ShardedBigClamModel(g, cfg, mesh)
            res = model.fit(F0)
            state = model.init_state(F0)
            F_rt = mh.fetch_global(state.F, mesh)[:24, :2]
            assert np.array_equal(F_rt, F0)
            if is_primary():
                _save(out_dir, mode, res)
        elif mode == "ring":
            res = RingBigClamModel(g, cfg, mesh, balance=False).fit(F0)
            if is_primary():
                _save(out_dir, mode, res)
        elif mode == "tp12":
            m12 = mh.make_multihost_mesh((1, 2), "cpu")
            assert m12.origin == (0, rank) and m12.row_groups[0] is not None
            res = ShardedBigClamModel(g, cfg, m12).fit(F0)
            if is_primary():
                _save(out_dir, mode, res)
        elif mode == "ring22":
            m22 = mh.make_multihost_mesh((2, 2), "cpu")
            assert m22.origin == (rank, 0) and mh.ring_peers(m22) == (1 - rank,) * 2
            res = RingBigClamModel(g, cfg, m22, balance=False).fit(F0)
            if is_primary():
                _save(out_dir, mode, res)
        elif mode in ("store", "store-ring"):
            from bigclam_tpu_torch.graph.store import GraphStore

            store = GraphStore.open(os.path.join(root, "cache"))
            cls = StoreShardedBigClamModel if mode == "store" else StoreRingBigClamModel
            model = cls(store, cfg, mesh)
            hs = model.host_shard
            assert hs.shard_ids == (2 * rank, 2 * rank + 1), hs.shard_ids
            rows = store.rows_per_shard
            assert (hs.lo, hs.hi) == (2 * rank * rows,
                                      min((2 * rank + 2) * rows, store.num_nodes))
            assert set(hs.files_read) == _own_files(store, rank), hs.files_read
            assert [set(f) for f in model.files_read] == [
                {f"shard_{s:05d}.indptr.npy", f"shard_{s:05d}.indices.npy"}
                for s in hs.shard_ids]
            res = model.fit(F0)
            extra = {}
            if mode == "store":
                extra["F_rowkeyed"] = model.fit().F
            else:
                ss = mh.load_host_seed_scores(store)
                assert (ss.lo, ss.hi) == (hs.lo, hs.hi)
                assert set(ss.files_read) == {
                    f"shard_{s:05d}.phi.npy" for s in hs.shard_ids}, ss.files_read
            if is_primary():
                _save(out_dir, mode, res, **extra)
        elif mode == "quality-device":
            from bigclam_tpu_torch.models.quality import fit_quality_device
            from bigclam_tpu_torch.ops.extraction import (
                extract_communities,
                extract_communities_device,
            )

            model = ShardedBigClamModel(g, quality_cfg(cfg), mesh)
            qres = fit_quality_device(model, F0)
            final, _llh, _it, _hist = model.fit_state(model.init_state(F0))
            dev = extract_communities_device(final.F, model.g, num_communities=2,
                                             chunk_rows=7, mesh=model.mesh)
            host = extract_communities(model.extract_F(final), g)
            assert dev == host, (dev, host)
            if is_primary():
                _save(out_dir, mode, qres.fit, cycles=np.asarray(qres.cycles_llh))
        elif mode == "sparse":
            from bigclam_tpu_torch.parallel.sparse_sharded import (
                SparseShardedBigClamModel,
            )

            gs, cfgs, Fs = sparse_problem()
            for tag, c in cfgs.items():
                model = SparseShardedBigClamModel(gs, c, mesh)
                res = model.fit(Fs)
                if is_primary():
                    _save(out_dir, tag, res, path=model.engaged_path)
        elif mode == "ckpt-write":
            from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

            my_dir = os.path.join(root, "ckpt", f"p{rank}")
            model = ShardedBigClamModel(g, cfg.replace(max_iters=4, checkpoint_every=2),
                                        mesh)
            model.fit(F0, checkpoints=CheckpointManager(my_dir))
            files = [f for f in os.listdir(my_dir) if f.endswith(".npz")] \
                if os.path.isdir(my_dir) else []
            assert bool(files) == (rank == 0), files
        elif mode in ("ckpt-resume", "corrupt-resume"):
            from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

            ckpt = CheckpointManager(os.path.join(root, "ckpt", "p0"))
            if mode == "ckpt-resume":
                assert ckpt.latest_step() == 4, ckpt.steps()
            else:
                assert ckpt.latest_step() > 2, ckpt.steps()
                assert ckpt.restore()[0] == 2, "fallback did not engage"
            dist.barrier()       # every rank has read before rank 0 writes
            model = ShardedBigClamModel(g, cfg.replace(checkpoint_every=2), mesh)
            res = model.fit(F0, checkpoints=ckpt)
            if is_primary():
                _save(out_dir, mode, res)
        else:
            raise ValueError(f"unknown mode {mode!r}")
    mh.shutdown_distributed()


if __name__ == "__main__":
    main()
