"""Command line of the PyTorch port: `fit`, `sweep` and `eval`.

Port of the single-device `fit`, `sweep` and `eval` of bigclam_tpu/cli.py.
`fit` loads a text edge list, seeds F by conductance (or a {0,1} random /
row-keyed init), trains to convergence on the chosen device and kernel
path, extracts the communities by the delta threshold (`--out`: written
through ops.extraction's arrays, the bytes of the JAX writer), and prints
one JSON line with the same keys as the JAX `fit` (`llh`, `iters`, `n`, `edges`,
`k`, `representation`, `kernel_path`, `kernel_path_reason`, `partition`)
plus `sec_per_iter`, `device_kind` and the LLH history. `sweep` trains
across the log-spaced K grid (models.model_selection) and prints the JAX
keys `chosen_k`, `kset`, `llh_by_k`, `n`, `edges`, `representation`, with
one `{"k", "llh"}` line per K on stderr. `eval` scores a community file
against a ground truth (`f1`, `nmi`).

    python -m bigclam_tpu_torch.cli fit --graph g.txt --k 100
    python -m bigclam_tpu_torch.cli fit --graph g.txt --k 100 --device cpu
    python -m bigclam_tpu_torch.cli fit --graph g.txt --k 3000   # csr_fused_kb
    python -m bigclam_tpu_torch.cli fit --graph g.txt --k 1000 \
        --csr-kernels off                                      # pallas_vmem
    python -m bigclam_tpu_torch.cli fit --graph g.txt --k 1000 \
        --representation sparse --sparse-m 64                  # sparse_merge_pallas
    python -m bigclam_tpu_torch.cli sweep --graph g.txt --min-com 50 \
        --max-com 200 --div-com 15 --checkpoint-dir sweep/
    python -m bigclam_tpu_torch.cli fit --graph g.txt --k 1000 \
        --mesh 4,1 --schedule ring                             # csr_ring_fused
    python -m bigclam_tpu_torch.cli eval --pred cmty.txt --truth truth.txt

`fit` and `sweep` run on `cuda` unless `--device cpu` is given, and refuse
to start when no card is present. `fit --mesh DP,1` shards the nodes over
the first DP cards (`--device cpu`: DP shards on the CPU) on the
all-gather schedule (`csr_fused`, `csr` with `--csr-fused off`) or, with
`--schedule ring`, the ring (`csr_ring_fused`, `csr_ring`); `xla` on the
CPU. Its JSON adds `mesh` ("4x1"). A K-sharded mesh (TP > 1), K above
1024 on a mesh, `--mesh` with `--representation sparse` and `sweep
--mesh` are refused by name. Above K = 1024 the single-device model takes
the K-blocked path by itself (`kernel_path` in the JSON says which).
`--csr-kernels off` takes the non-CSR step: `pallas_vmem` (the candidate
edge-terms CUDA kernel) on cuda, `xla` on the CPU. `--representation
sparse` trains the top-M member lists of models.sparse instead of a dense
F, with the member-lookup CUDA kernel on the card (`sparse_xla`, the plain
lookup, on the CPU); its JSON adds `sparse_m`. `--seeding-degree-cap`
and `--seed-backend` choose the conductance scorer as in the JAX CLI
(ops.seeding.conductance; its device backends run on `--device`); the
port reads no graph cache, so `--seed-backend baked` exits with the JAX
CLI's message for a text graph.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np


SWEEP_EPILOG = (
    "Not ported yet (the parser refuses these JAX `sweep` flags by name): "
    "--quality and --device-annealing (quality mode, ROADMAP queue 1 item "
    "13); --checkpoint-every, --telemetry-dir and --retry-budget "
    "(within-K checkpoints, telemetry and the retry supervisor, item 8)."
)


def _add_train_flags(p: argparse.ArgumentParser) -> None:
    """The flags `fit` and `sweep` share."""
    p.add_argument("--graph", required=True, help="SNAP edge-list path")
    p.add_argument("--max-iters", type=int, default=1000)
    p.add_argument("--conv-tol", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--csr-kernels", default="auto", choices=["auto", "on", "off"],
        help="CSR edge kernels (auto: on for cuda; on: require — on cpu "
             "their plain versions run; off: the non-CSR step — "
             "`pallas_vmem` on cuda, `xla` on cpu)",
    )
    p.add_argument(
        "--csr-fused", default="auto", choices=["auto", "off"],
        help="fused schedule (auto: wherever the CSR kernels engage — "
             "`csr_fused`, or `csr_fused_kb` above K=1024; off: the split "
             "schedule — `csr`, or `csr_grouped_kb` above K=1024)",
    )
    p.add_argument(
        "--representation", default="dense", choices=["dense", "sparse"],
        help="affiliation-state representation: dense (N, K) F (default) "
             "or sparse per-node top-M member lists (models/sparse.py) — "
             "device memory and bytes per edge scale with --sparse-m, not K",
    )
    p.add_argument(
        "--sparse-m", type=int, default=64,
        help="member slots per node on --representation sparse (M; "
             "clamped to K — M >= K reproduces the dense trajectory)",
    )
    p.add_argument(
        "--support-every", type=int, default=1,
        help="iterations between sparse support updates (candidate-"
             "community admission from neighbour lists; 1 = every step, "
             "required for dense parity)",
    )
    p.add_argument(
        "--seeding-degree-cap", type=int, default=None,
        help="sample at most this many neighbors per node in conductance "
             "seeding (exact pass is edge-quadratic on hubs; exact when "
             "cap >= max degree)",
    )
    p.add_argument(
        "--seed-backend", default="auto",
        choices=["auto", "baked", "numpy", "dense", "sampled",
                 "sampled_device"],
        help="conductance scorer backend (ops.seeding.conductance): numpy "
             "(exact host counts, native when the host library builds), "
             "dense (A@A on --device, N <= 16,384), sampled (the "
             "degree-capped estimator on the host), sampled_device (the "
             "same estimator on --device); auto: sampled when "
             "--seeding-degree-cap binds, dense where it fits, else numpy. "
             "baked needs a graph cache with ingest-baked scores, which "
             "the port cannot read yet",
    )
    p.add_argument(
        "--dtype", default="float32", choices=["float32", "float64"],
        help="F dtype (float64 runs on cpu only)",
    )
    p.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="device to train on (default cuda; there is no silent CPU "
             "fallback)",
    )
    p.add_argument(
        "--mesh", default=None,
        help="'DP,TP' device mesh, e.g. 4,1: the nodes sharded over the "
             "first DP cards (with --device cpu, DP shards on the CPU); "
             "TP > 1 is not ported (default: single device)",
    )
    p.add_argument(
        "--balance", action="store_true",
        help="degree-balanced node relabeling before sharding (evens "
             "per-shard edge counts on power-law graphs; results are mapped "
             "back to original ids)",
    )
    p.add_argument(
        "--schedule", default="allgather", choices=["allgather", "ring"],
        help="F-row exchange schedule for --mesh runs: allgather gives each "
             "shard a full F; ring rotates the shards around the mesh "
             "(O(N/DP) F rows per device)",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bigclam_tpu_torch.cli",
        description="BigCLAM overlapping community detection (PyTorch/CUDA)",
    )
    sub = p.add_subparsers(dest="command", required=True)
    f = sub.add_parser("fit", help="train at a fixed K and extract communities")
    _add_train_flags(f)
    f.add_argument("--k", type=int, default=100,
                   help="number of communities (default 100, as in the JAX CLI)")
    f.add_argument(
        "--init", default="conductance",
        choices=["conductance", "random", "rowkeyed"],
        help="F initialization: conductance seeding (the reference "
             "default), a {0,1} Bernoulli(0.5) random init, or the "
             "row-keyed counter init",
    )
    f.add_argument("--out", default=None, help="write communities (SNAP cmty)")

    w = sub.add_parser("sweep", help="automatic K selection over a log grid",
                       epilog=SWEEP_EPILOG)
    _add_train_flags(w)
    w.add_argument("--min-com", type=int, default=1000)
    w.add_argument("--max-com", type=int, default=9000)
    w.add_argument("--div-com", type=int, default=100)
    w.add_argument("--ksweep-tol", type=float, default=1e-3)
    w.add_argument(
        "--checkpoint-dir", default=None,
        help="journal each trained K's LLH in <dir>/sweep_state.json and "
             "skip journaled Ks when the sweep is run again",
    )
    w.add_argument(
        "--resume", default="auto", choices=["auto", "never"],
        help="auto: resume from the --checkpoint-dir journal; never: "
             "retrain every K (still journaling)",
    )

    e = sub.add_parser("eval", help="score predicted vs ground-truth communities")
    e.add_argument("--pred", required=True)
    e.add_argument("--truth", required=True)
    e.add_argument("--no-nmi", action="store_true")
    return p


def config_from_args(args):
    from bigclam_tpu_torch.config import BigClamConfig

    sweep = args.command == "sweep"
    return BigClamConfig(
        num_communities=args.max_com if sweep else args.k,
        dtype=args.dtype,
        max_iters=args.max_iters,
        conv_tol=args.conv_tol,
        seed=args.seed,
        seeding_degree_cap=args.seeding_degree_cap,
        use_pallas_csr={"auto": None, "on": True, "off": False}[args.csr_kernels],
        csr_fused={"auto": None, "off": False}[args.csr_fused],
        representation=args.representation,
        sparse_m=args.sparse_m,
        support_every=args.support_every,
        **(dict(min_com=args.min_com, max_com=args.max_com,
                div_com=args.div_com, ksweep_tol=args.ksweep_tol)
           if sweep else {}),
    )


def parse_mesh(text: str) -> tuple:
    """'DP,TP' -> (dp, tp)."""
    try:
        dp, tp = (int(x) for x in text.split(","))
    except ValueError:
        raise SystemExit(f"error: --mesh wants 'DP,TP', got {text!r}") from None
    return dp, tp


def make_mesh_model(g, cfg, device, mesh, schedule="allgather", balance=False):
    """The sharded trainer of `schedule` on a `mesh` ('DP,TP') of the first
    DP*TP cards, or of DP*TP shards on the CPU for device `cpu`."""
    import torch

    from bigclam_tpu_torch.parallel import (
        RingBigClamModel,
        ShardedBigClamModel,
        make_mesh,
    )
    from bigclam_tpu_torch.utils.device import resolve_device

    if cfg.representation == "sparse":
        raise SystemExit(
            "error: --mesh is not supported with --representation sparse yet "
            "(the sparse sharded trainer is ROADMAP queue 1 item 16)"
        )
    dp, tp = parse_mesh(mesh)
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devices = devices[: dp * tp]
    else:
        devices = [dev] * (dp * tp)
    cls = RingBigClamModel if schedule == "ring" else ShardedBigClamModel
    return cls(g, cfg, make_mesh((dp, tp), devices), balance=balance)


def make_model(g, cfg, device):
    """The single-device trainer of cfg.representation on `device`."""
    if cfg.representation == "sparse":
        if cfg.use_pallas_csr:
            # "on" means require: the CSR edge kernels take a dense F, so
            # honouring it with sparse member lists means refusing
            raise SystemExit(
                "error: --csr-kernels on is not supported with "
                "--representation sparse (the CSR edge kernels take a dense "
                "F; the sparse path has its own CUDA member-lookup kernel, "
                "csrc/member_lookup.cu, engaged by itself on cuda — use "
                "--csr-kernels auto)"
            )
        from bigclam_tpu_torch.models.sparse import SparseBigClamModel

        return SparseBigClamModel(g, cfg, device=device)
    from bigclam_tpu_torch.models.bigclam import BigClamModel

    return BigClamModel(g, cfg, device=device)


BAKED_REFUSAL = (
    "error: --seed-backend baked needs the graph to come from a compiled "
    "cache with baked seed scores (run `cli ingest` and pass the cache dir "
    "as --graph)"
)


def check_seed_backend(backend: str) -> None:
    """`baked` reads ingest-baked scores from a graph cache; the port reads
    text edge lists only, so it exits as the JAX CLI does for a text
    --graph."""
    if backend == "baked":
        raise SystemExit(BAKED_REFUSAL)


def init_F(g, cfg, init: str, backend: str = "auto",
           device=None) -> Optional[np.ndarray]:
    """Host F0 for `--init`; None for rowkeyed (the model generates it).
    Conductance seeding scores with `backend`, its device backends on
    `device`."""
    from bigclam_tpu_torch.models.bigclam import random_init_F
    from bigclam_tpu_torch.ops import seeding

    if init == "rowkeyed":
        return None
    if init == "conductance":
        check_seed_backend(backend)
        seeds = seeding.conductance_seeds(g, cfg, backend=backend, device=device)
        return seeding.init_F(g, seeds, cfg)
    return random_init_F(g, cfg)


def fit(args):
    """Run `fit` for parsed arguments. Returns (the JSON-ready result dict,
    the FitResult, the final train state)."""
    from bigclam_tpu_torch.graph.ingest import build_graph
    from bigclam_tpu_torch.models.bigclam import FitResult, run_fit_loop
    from bigclam_tpu_torch.ops import extraction
    from bigclam_tpu_torch.utils.device import device_kind

    cfg = config_from_args(args)
    stages = {}
    clock = time.perf_counter()

    def stage(name):
        nonlocal clock
        now = time.perf_counter()
        stages[name] = now - clock
        clock = now

    g = build_graph(args.graph)
    stage("graph")
    if args.mesh:
        model = make_mesh_model(g, cfg, args.device, args.mesh, args.schedule,
                                args.balance)
    else:
        model = make_model(g, cfg, args.device)
    stage("model_build")
    F0 = init_F(g, cfg, args.init, args.seed_backend, args.device)
    stage("seeding")
    state = model.init_state(F0)
    stage("upload")
    step_ends = []
    t0 = time.perf_counter()
    state, llh, iters, hist = run_fit_loop(
        model._step, state, cfg,
        callback=lambda it, llh: step_ends.append(time.perf_counter()),
    )
    F = model.extract_F(state)
    res = FitResult(F=F, sumF=F.sum(axis=0), llh=llh, num_iters=iters,
                    llh_history=hist)
    stage("fit")
    steps = len(res.llh_history)
    out = {
        "llh": res.llh,
        "iters": res.num_iters,
        "n": g.num_nodes,
        "edges": g.num_edges,
        "k": cfg.num_communities,
        "representation": cfg.representation,
        "kernel_path": model.engaged_path,
        "kernel_path_reason": model.path_reason,
        "partition": cfg.partition,
        # wall time per step of the train loop (each step ends in the
        # host's read of its LLH), F upload and host extraction excluded
        "sec_per_iter": (step_ends[-1] - t0) / steps,
        "device_kind": device_kind(model.device),
        "steps": steps,
        "llh_history": list(res.llh_history),
    }
    if cfg.representation == "sparse":
        out["sparse_m"] = model.m
    if args.mesh:
        out["mesh"] = model.mesh.label()
    if args.out:
        com = extraction.extract_community_arrays(res.F, g)
        extraction.write_communities(args.out, com)
        out["communities"] = len(com)
        out["out"] = args.out
        stage("extract")
    out["stage_seconds"] = stages
    return out, res, state


def sweep(args, callback=None) -> dict:
    """Run `sweep` for parsed arguments; callback(k, llh) after each K.
    Returns the JSON-ready result dict."""
    from bigclam_tpu_torch.graph.ingest import build_graph
    from bigclam_tpu_torch.models.model_selection import sweep_k

    if args.mesh:
        raise SystemExit(
            "error: `sweep --mesh` is not ported yet (ROADMAP queue 1 item 14: "
            "a sweep over a device mesh); the port sweeps on one device"
        )
    cfg = config_from_args(args)
    check_seed_backend(args.seed_backend)
    g = build_graph(args.graph)
    res = sweep_k(
        g, cfg,
        model_factory=lambda c: make_model(g, c, args.device),
        callback=callback,
        state_dir=args.checkpoint_dir,
        resume=args.resume != "never",
        seed_backend=args.seed_backend,
    )
    return {
        "chosen_k": res.chosen_k,
        "kset": res.kset,
        "llh_by_k": {str(k): v for k, v in res.llh_by_k.items()},
        "n": g.num_nodes,
        "edges": g.num_edges,
        "representation": cfg.representation,
    }


def evaluate(args) -> dict:
    """Run `eval`: F1 (and the overlapping NMI unless --no-nmi) of the
    --pred communities against the --truth ones."""
    from bigclam_tpu_torch.evaluation import avg_f1, overlapping_nmi
    from bigclam_tpu_torch.ops.extraction import load_communities

    pred = load_communities(args.pred)
    truth = load_communities(args.truth)
    out = {"f1": avg_f1(pred, truth)}
    if not args.no_nmi:
        out["nmi"] = overlapping_nmi(pred, truth)
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "fit":
        out, _, _ = fit(args)
    elif args.command == "sweep":
        out = sweep(args, callback=lambda k, llh: print(
            json.dumps({"k": k, "llh": llh}), file=sys.stderr, flush=True))
    else:
        out = evaluate(args)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
