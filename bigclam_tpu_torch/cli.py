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

A fit survives and reports itself as in the JAX CLI: `--checkpoint-dir`
saves the state every `--checkpoint-every` iterations (50 when only the
directory is given) and `--resume auto` continues from the newest valid
checkpoint (`never`: a cold start that still saves); a non-finite LLH
rolls back to the last finite state with a cut Armijo ladder
(cfg.rollback_budget, default 3) before it aborts; `--retry-budget`
retries a transiently failed fit, resuming; `--telemetry-dir` writes
events.jsonl and run_report.json (stages, spans, device-memory
watermarks, kernel builds, `--health-every` model-health samples, the
`--heartbeat-s` stall watchdog); `--metrics` appends one JSON record per
step; `--save-f` writes the final F as .npy. `BIGCLAM_FAULTS` (inline
JSON or @path) injects faults at the fit.step and checkpoint.save sites.
`--perf-ledger` and `--profile-dir` are refused by name: they come with
the rest of the observability layer.
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
    "13)."
)

NOT_PORTED_FIT_FLAGS = {
    "perf_ledger": "--perf-ledger (the perf ledger, obs/ledger.py)",
    "profile_dir": "--profile-dir (the torch.profiler capture)",
}


def _add_train_flags(p: argparse.ArgumentParser) -> None:
    """The flags `fit` and `sweep` share."""
    p.add_argument("--graph", required=True, help="SNAP edge-list path")
    p.add_argument("--max-iters", type=int, default=1000)
    p.add_argument("--conv-tol", type=float, default=1e-4)
    p.add_argument("--alpha", type=float, default=0.05)
    p.add_argument("--beta", type=float, default=0.1)
    p.add_argument("--max-backtracks", type=int, default=15)
    p.add_argument(
        "--edge-chunk", type=int, default=None,
        help="directed edges per chunk of the plain edge sweeps (default: "
             "config default)",
    )
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
    p.add_argument(
        "--checkpoint-every", type=int, default=0,
        help="iterations between checkpoints into --checkpoint-dir (sweep: "
             "within each K, in <dir>/k_<K>/; 0 = off)",
    )
    p.add_argument(
        "--telemetry-dir", default=None,
        help="run-telemetry directory (bigclam_tpu_torch.obs): events.jsonl "
             "+ run_report.json — step metrics, stage transitions, device-"
             "memory watermarks, kernel builds, stall heartbeat; the JAX "
             "package's `cli report <dir>` renders it",
    )
    p.add_argument(
        "--retry-budget", type=int, default=2,
        help="transient-failure retries for the whole fit attempt "
             "(resilience supervisor: each retry RESUMES from the newest "
             "checkpoint; fatal errors never retry; 0 disables)",
    )


def _add_fit_flags(p: argparse.ArgumentParser) -> None:
    """The resilience and observability flags of `fit` (JAX CLI
    defaults)."""
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument(
        "--resume", default="auto", choices=["auto", "never"],
        help="auto (default): restore the newest VALID checkpoint from "
             "--checkpoint-dir (falling back past truncated/corrupt newer "
             "ones), record the attempt in the telemetry resume lineage, "
             "and continue the trajectory; never: cold-start (existing "
             "checkpoints are kept but ignored; new ones still save)",
    )
    p.add_argument("--save-f", default=None,
                   help="write the final (N, K) F as a .npy file")
    p.add_argument("--metrics", default=None, help="JSONL metrics path")
    p.add_argument(
        "--heartbeat-s", type=float, default=300.0,
        help="stall-heartbeat deadline with --telemetry-dir: emit a stall "
             "event when no step/stage completes within this many seconds "
             "(0 disables; --quiet silences the stderr echo, never the "
             "JSONL)",
    )
    p.add_argument(
        "--heartbeat-escalate", type=int, default=3,
        help="consecutive stall-heartbeat deadlines before a "
             "stall_escalated event fires (0 disables escalation; the "
             "watchdog then only keeps emitting stall events)",
    )
    p.add_argument(
        "--health-every", type=int, default=10,
        help="iterations between model-health samples (grad/update norms, "
             "effective Armijo step, dead communities, membership churn; "
             "sparse runs add support churn), emitted as `health` events "
             "with anomaly detection (divergence/plateau/oscillation/dead-"
             "communities) when --telemetry-dir is active (without it the "
             "steps compute no pack). 0 disables — the step then computes "
             "nothing and the trajectory is bit-identical either way",
    )
    p.add_argument(
        "--quiet", action="store_true",
        help="silence the per-step echo and the heartbeat's stderr "
             "warnings (telemetry JSONL stays complete)",
    )
    for dest in NOT_PORTED_FIT_FLAGS:
        p.add_argument("--" + dest.replace("_", "-"), default=None,
                       help=argparse.SUPPRESS)


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
    _add_fit_flags(f)

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
    checkpoint_every = args.checkpoint_every
    if not sweep and args.checkpoint_dir and checkpoint_every <= 0:
        # a checkpoint dir without a cadence would restore but never save
        checkpoint_every = 50
        print(
            "note: --checkpoint-dir given without --checkpoint-every; "
            "defaulting to every 50 iterations",
            file=sys.stderr,
        )
    return BigClamConfig(
        num_communities=args.max_com if sweep else args.k,
        dtype=args.dtype,
        max_iters=args.max_iters,
        conv_tol=args.conv_tol,
        alpha=args.alpha,
        beta=args.beta,
        max_backtracks=args.max_backtracks,
        edge_chunk=args.edge_chunk or BigClamConfig.edge_chunk,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=checkpoint_every,
        metrics_path=getattr(args, "metrics", None),
        # the steps compute health packs only for a monitor to read: with
        # no --telemetry-dir there is none, and they compute nothing
        health_every=(max(getattr(args, "health_every", 0) or 0, 0)
                      if getattr(args, "telemetry_dir", None) else 0),
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


def refuse_unported(args) -> None:
    """Exit naming a JAX `fit` flag whose layer is not ported yet."""
    for dest, what in NOT_PORTED_FIT_FLAGS.items():
        if getattr(args, dest, None) is not None:
            raise SystemExit(
                f"error: {what} is not ported yet (ROADMAP queue 1 item 8b, "
                "the rest of the observability layer)"
            )


def make_supervisor(args, cfg, tel):
    """The entry-point retry supervisor: --retry-budget extra attempts for
    transient-classified failures (each re-entering the fit WITH its
    checkpoints, so a retry is a resume), its stall-escalation hook
    attached to the telemetry heartbeat when one runs."""
    from bigclam_tpu_torch.resilience import RetryPolicy, Supervisor

    sup = Supervisor(RetryPolicy(
        transient_attempts=max(getattr(args, "retry_budget", 2), 0) + 1,
        seed=cfg.seed,
    ))
    if tel is not None:
        sup.attach(tel)
    return sup


def open_telemetry(args, entry: str):
    """Create + install the run telemetry when --telemetry-dir was given
    (None otherwise)."""
    tdir = getattr(args, "telemetry_dir", None)
    if not tdir:
        return None
    from bigclam_tpu_torch.obs import RunTelemetry, install

    return install(RunTelemetry(
        tdir,
        entry=entry,
        heartbeat_s=getattr(args, "heartbeat_s", 0.0),
        quiet=getattr(args, "quiet", False),
        heartbeat_escalate=getattr(args, "heartbeat_escalate", 0),
    ))


def close_telemetry(tel) -> None:
    if tel is None:
        return
    from bigclam_tpu_torch.obs import uninstall

    tel.finalize()
    uninstall(tel)


def fit(args):
    """Run `fit` for parsed arguments. Returns (the JSON-ready result dict,
    the FitResult, the final train state)."""
    refuse_unported(args)
    tel = open_telemetry(args, "fit")
    try:
        return _fit(args, tel)
    finally:
        close_telemetry(tel)


def _fit(args, tel):
    from bigclam_tpu_torch.graph.ingest import build_graph
    from bigclam_tpu_torch.models.bigclam import FitResult
    from bigclam_tpu_torch.obs import trace
    from bigclam_tpu_torch.ops import extraction
    from bigclam_tpu_torch.utils.checkpoint import CheckpointManager
    from bigclam_tpu_torch.utils.device import device_kind
    from bigclam_tpu_torch.utils.metrics import MetricsLogger
    from bigclam_tpu_torch.utils.profiling import StageProfile

    cfg = config_from_args(args)
    # stage ends forward into the telemetry (event + device-memory
    # watermark + heartbeat beat) when --telemetry-dir is active
    prof = StageProfile()
    with prof.stage("graph"):
        g = build_graph(args.graph)
    with prof.stage("model_build"):
        if args.mesh:
            model = make_mesh_model(g, cfg, args.device, args.mesh,
                                    args.schedule, args.balance)
        else:
            model = make_model(g, cfg, args.device)
    with prof.stage("seeding"):
        F0 = init_F(g, cfg, args.init, args.seed_backend, args.device)
    with prof.stage("upload"):
        state0 = model.init_state(F0)
    ckpt = CheckpointManager(args.checkpoint_dir) if args.checkpoint_dir else None
    resume = args.resume != "never"
    if ckpt is not None and resume:
        # record the resume attempt (event + lineage file) BEFORE the fit,
        # so even a re-crashed attempt leaves its trace; the step is the
        # newest VALID one, the one restore will use
        valid_step = ckpt.latest_valid_step()
        if valid_step is not None:
            from bigclam_tpu_torch.resilience import record_resume

            record_resume(args.telemetry_dir, valid_step)
    sup = make_supervisor(args, cfg, tel)
    mesh = getattr(model, "mesh", None)
    step_ends = []
    with MetricsLogger(args.metrics, echo=not args.quiet) as ml:
        log_step = ml.step_callback(
            g.num_directed_edges, chips=mesh.size if mesh is not None else 1,
            path=model.engaged_path, num_nodes=g.num_nodes,
        )

        def callback(it, llh, extras=None):
            step_ends.append(time.perf_counter())
            log_step(it, llh, extras)

        with prof.stage("fit"):
            t0 = time.perf_counter()
            # the supervisor retries transient-classified failures: each
            # retried attempt re-enters the fit WITH the checkpoints, so a
            # retry resumes instead of restarting
            state, llh, iters, hist = sup.run_fit(
                lambda: model.fit_state(state0, callback, checkpoints=ckpt,
                                        resume=resume)
            )
            with trace.span("fit_loop/extract_F"):
                F = model.extract_F(state)
    res = FitResult(F=F, sumF=F.sum(axis=0), llh=llh, num_iters=iters,
                    llh_history=hist)
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
        # wall time per step this run evaluated (each step ends in the
        # host's read of its LLH), F upload and host extraction excluded
        "sec_per_iter": (step_ends[-1] - t0) / len(step_ends),
        "device_kind": device_kind(model.device),
        "steps": len(res.llh_history),
        "llh_history": list(res.llh_history),
    }
    if cfg.representation == "sparse":
        out["sparse_m"] = model.m
    if args.mesh:
        out["mesh"] = model.mesh.label()
    if args.out or args.save_f:
        with prof.stage("extract"):
            if args.out:
                com = extraction.extract_community_arrays(res.F, g)
                extraction.write_communities(args.out, com)
                out["communities"] = len(com)
                out["out"] = args.out
            if args.save_f:
                np.save(args.save_f, res.F)
                out["save_f"] = args.save_f
    out["stage_seconds"] = dict(prof.seconds)
    if tel is not None:
        tel.set_final({k: v for k, v in out.items() if k != "llh_history"})
    return out, res, state


def sweep(args, callback=None) -> dict:
    """Run `sweep` for parsed arguments; callback(k, llh) after each K.
    Returns the JSON-ready result dict."""
    if args.mesh:
        raise SystemExit(
            "error: `sweep --mesh` is not ported yet (ROADMAP queue 1 item 14: "
            "a sweep over a device mesh); the port sweeps on one device"
        )
    tel = open_telemetry(args, "sweep")
    try:
        return _sweep(args, callback, tel)
    finally:
        close_telemetry(tel)


def _sweep(args, callback, tel) -> dict:
    from bigclam_tpu_torch.graph.ingest import build_graph
    from bigclam_tpu_torch.models.model_selection import sweep_k

    cfg = config_from_args(args)
    check_seed_backend(args.seed_backend)
    g = build_graph(args.graph)

    def per_k(k, llh):
        if tel is not None:
            tel.metric_record({"k": k, "llh": llh})
        if callback is not None:
            callback(k, llh)

    # retried sweep attempts resume from sweep_state.json (the per-K
    # journal) and the within-K checkpoints; --resume never ignores the
    # journal on the first attempt only
    sup = make_supervisor(args, cfg, tel)
    first_attempt = [True]

    def attempt():
        first, first_attempt[0] = first_attempt[0], False
        return sweep_k(
            g, cfg,
            model_factory=lambda c: make_model(g, c, args.device),
            callback=per_k,
            state_dir=args.checkpoint_dir,
            resume=args.resume != "never" or not first,
            seed_backend=args.seed_backend,
        )

    res = sup.run_fit(attempt, site="sweep")
    out = {
        "chosen_k": res.chosen_k,
        "kset": res.kset,
        "llh_by_k": {str(k): v for k, v in res.llh_by_k.items()},
        "n": g.num_nodes,
        "edges": g.num_edges,
        "representation": cfg.representation,
    }
    if tel is not None:
        tel.set_final(out)
    return out


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
