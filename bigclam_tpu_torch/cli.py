"""Command line of the PyTorch port: `fit`, `sweep`, `eval`, `ingest`,
`serve`, `refit`, `profile`, `perf`, `report`, `watch` and `preflight`.

Port of those subcommands of bigclam_tpu/cli.py.
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
    python -m bigclam_tpu_torch.cli fit --graph g.txt --k 3000 \
        --mesh 2,2                                             # csr_fused_kb, K sharded
    python -m bigclam_tpu_torch.cli fit --graph g.txt --k 1000 \
        --mesh 4,1 --partition 2d --replica-cols 2             # csr_fused_2d, 2x2 grid
    python -m bigclam_tpu_torch.cli eval --pred cmty.txt --truth truth.txt
    python -m bigclam_tpu_torch.cli ingest --graph g.txt --cache-dir g.cache \
        --shards 4                                             # graph store
    python -m bigclam_tpu_torch.cli fit --graph g.cache --k 100
    python -m bigclam_tpu_torch.cli fit --graph g.cache --k 100 \
        --mesh 4,1 --store-native                              # a shard a position
    python -m bigclam_tpu_torch.cli ingest --cache-dir g.cache --delta d.txt
    python -m bigclam_tpu_torch.cli fit --graph g.txt --k 100 \
        --telemetry-dir run1/ --perf-ledger perf/ledger.jsonl
    python -m bigclam_tpu_torch.cli perf diff --ledger perf/ledger.jsonl
    python -m bigclam_tpu_torch.cli report run1/ [--json]
    python -m bigclam_tpu_torch.cli watch run1/ --once
    python -m bigclam_tpu_torch.cli profile --graph g.txt --k 100 \
        --steps 20 --profile-dir prof/
    python -m bigclam_tpu_torch.cli preflight --nodes 1134890 \
        --edges 2987624 --k 8385 --device-kind "NVIDIA H100 80GB HBM3"
    python -m bigclam_tpu_torch.cli fit --graph g.cache --k 100 \
        --publish-dir snaps/                                   # a snapshot
    python -m bigclam_tpu_torch.cli serve --snapshots snaps/ --graph g.cache \
        --query members_of:3 --query suggest_for:12
    python -m bigclam_tpu_torch.cli ingest --cache-dir g.cache --delta d.txt
    python -m bigclam_tpu_torch.cli refit --graph g.cache --snapshots snaps/ \
        --delta d.txt
    python -m bigclam_tpu_torch.cli fit --graph g.cache --k 100 \
        --publish-dir snaps/ --follow deltas/                  # continuous
    python -m bigclam_tpu_torch.cli fit --graph g.txt --k 100 --quality
    python -m bigclam_tpu_torch.cli fit --graph g.txt --k 100 --quality \
        --device-annealing                                     # F stays on the card
    python -m bigclam_tpu_torch.cli sweep --graph g.txt --min-com 50 \
        --max-com 200 --div-com 15 --quality [--device-annealing]

`fit` and `sweep` run on `cuda` unless `--device cpu` is given, and refuse
to start when no card is present. `fit --mesh DP,TP` shards the nodes
over DP shards and each shard's K columns over TP blocks, one mesh
position a card (fewer cards: the positions share them round-robin;
`--device cpu`: DP*TP positions on the CPU), on the all-gather schedule
(`csr_fused`, `csr` with `--csr-fused off`) or, with `--schedule ring`,
the ring (`csr_ring_fused`, `csr_ring`); `xla` on the CPU. Above K_loc =
1024 columns a block, or with `--csr-k-block W`, a mesh takes the
K-blocked paths (`csr_fused_kb`, `csr_grouped_kb`, `csr_ring_fused_kb`,
`csr_ring_kb`), as the single-device model does above K = 1024. Its JSON
adds `mesh` ("4x1"). `sweep --mesh` trains each K on fit's mesh model.
`--mesh DP,1 --representation sparse` trains the top-M member lists on
DP node shards with the capped sparse allreduce of sumF
(parallel/sparse_sharded.py; path `sparse_merge_pallas_spall` or
`_psum`, `sparse_xla_*` on the CPU; its JSON adds `sparse_comm` and
`sparse_comm_cap`); with sparse, `--schedule ring`, TP > 1, `--balance`,
`--store-native`, `--quality` and `--partition 2d` are refused with the
JAX CLI's words. `fit`/`sweep --distributed` run every rank of a
torch.distributed process group (torchrun's variables or the JAX names;
parallel/multihost.py) on one card each, `--mesh` optional ((ranks, 1)
by default); rank 0 alone writes `--out`, `--publish-dir`,
`--export-gexf`, checkpoints and telemetry events; without a coordinator
it warns in the JAX CLI's words and runs single-process; `--partition
2d`, `refit` and `--follow` are refused as in the JAX CLI. `--mesh P,1
--partition 2d [--replica-cols C]` trains the 2D edge-block partition on
a (P / C, C) grid (parallel/twod.py: path
`csr_fused_2d`, `csr_fused_2d_kb` above K = 1,024, `xla_2d` on the CPU;
`--store-native` from a cache of P shards); its JSON adds `replica_cols`
and `grad_exchange`, and `mesh` is "rowsxcols". Without `--mesh`, with
`--distributed`, sparse, `--schedule ring` or TP > 1 it is refused with
the JAX CLI's words; `sweep` and `preflight` take the same flags.
`--csr-kernels off` takes the non-CSR step: `pallas_vmem` (the candidate
edge-terms CUDA kernel) on cuda, `xla` on the CPU. `--representation
sparse` trains the top-M member lists of models.sparse instead of a dense
F, with the member-lookup CUDA kernel on the card (`sparse_xla`, the plain
lookup, on the CPU); its JSON adds `sparse_m`. `--seeding-degree-cap`
and `--seed-backend` choose the conductance scorer as in the JAX CLI
(ops.seeding.conductance; its device backends run on `--device`).

`--graph` takes a SNAP edge list or a graph-cache directory compiled by
`ingest` (graph/store.py, the JAX package's format byte for byte);
`--cache-dir` compiles a text `--graph` into a cache on first use and
reloads from it after. A cache shard that fails its crc32 is quarantined
and rebuilt from the source edge list unless `--no-self-heal`. On a cache,
`--seed-backend auto` reads the ingest-baked conductance scores when their
cap and seed match the run (else it notes why and scores the graph), and
`baked` requires them. `--store-native` with `--mesh DP,TP` feeds each mesh
position from its own shard file (a cache of DP shards; balance comes from
`ingest --balance`). `ingest` compiles a cache, or with `--delta` appends
an edge file to one, touching no device.

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
`--perf-ledger` appends the run's perf record at the end (with
`--telemetry-dir`), and `--profile-dir` captures the fit (or the sweep)
with torch.profiler; on a card a capture that records no CUDA kernel
exits 1 naming that. The fit JSON carries the trainer's modeled device
bytes (`hbm_modeled_bytes`, obs.memory) and, on a mesh, its modeled
collective bytes a step (`comms_bytes_per_step`, obs.comms).

Serving (JAX `serve`/`refit` keys and defaults): `fit --publish-dir`
publishes the final F as the next snapshot generation (`--publish-shards
S`: S row-range archives of a fleet generation); `serve` answers
communities_of / members_of from the snapshot and suggest_for by fold-in
on `--device` (no card raises, as `fit` does), with `--watch-snapshots`
hot swaps; `refit` folds the rows a delta touched (plus a halo) into the
latest snapshot and publishes the next generation; `fit --follow DIR`
runs delta ingest -> refit -> publish per new edge file; `fit
--export-gexf PATH` writes the graph and its communities as GEXF.
The sharded fleet: `serve --fleet DIR --fleet-shard S --listen HOST:PORT`
is one shard's replica (fold-in on `--device`), `route` routes queries
over the replicas, and `fleet up|status|add-replica|drain|down`
supervises them (`fleet --device` goes to every replica it spawns);
`preflight --serve` prices a serving fleet.

Quality mode (models/quality.py; NOT reference semantics): `fit
--quality` runs the noise-floor init, restart annealing under the relaxed
MAX_P_ clip and the discrete repair/atomize stage on the host loop (one F
round trip a cycle), `--device-annealing` keeps the whole schedule on the
device (one upload, at most one F fetch a repair round);
`--init-noise`, `--restart-cycles`, `--restart-tol`, `--quality-max-p` and
`--seed-exclusion` tune it (without `--quality` they warn and do nothing,
apart from `--seed-exclusion`). Its JSON adds `quality_cycles`,
`quality_total_iters` and `cycles_llh`. `sweep --quality
[--device-annealing]` runs the schedule at each K. Quality mode refuses
`--init rowkeyed`, `--representation sparse` and `--follow`, with the JAX
CLI's messages.

`profile` runs N steps under a torch.profiler capture and prints the
JAX keys plus the top device kernels; `perf record|diff|show` keeps and
gates the perf ledger; `report` and `watch` render a telemetry
directory; `preflight` prices a configuration's device memory, host RSS
and collective bytes without a card (exit 0 fits, 2 does not, 1 bad
input).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import numpy as np


# device kernels `profile` prints, by device time
PROFILE_TOP = 12

QUALITY_SPARSE_REFUSAL = (
    "error: --quality is not supported with --representation sparse yet "
    "(the annealing schedule is dense-state-resident)"
)


def _add_train_flags(p: argparse.ArgumentParser) -> None:
    """The flags `fit` and `sweep` share."""
    p.add_argument(
        "--graph", required=True,
        help="SNAP edge-list path, or a graph-cache dir from `ingest`",
    )
    p.add_argument(
        "--cache-dir", default=None,
        help="graph-cache directory: compile the text --graph into it on "
             "first use (see `ingest`), then reload from the binary shards",
    )
    p.add_argument(
        "--no-self-heal", action="store_true",
        help="disable shard quarantine + re-ingest: a crc-failed cache "
             "shard rejects the run (default: quarantine the blob, rebuild "
             "it from the source edge list, continue)",
    )
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
        "--csr-k-block", type=int, default=0,
        help="columns a K block of the K-blocked paths (0: the model picks, "
             "blocks of at most 1,024 above K = 1,024; a width forces the "
             "K-blocked path at any K, one card or a mesh's K_loc)",
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
             "On a graph-cache --graph, auto reads the INGEST-BAKED scores "
             "when present and matching; baked requires them (error with a "
             "re-ingest hint otherwise)",
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
        help="'DP,TP' device mesh, e.g. 4,1 or 2,2: the nodes sharded over "
             "DP shards and each shard's K columns over TP blocks, one mesh "
             "position a card (with --device cpu, DP*TP positions on the "
             "CPU; default: single device)",
    )
    p.add_argument(
        "--distributed", action="store_true",
        help="multi-process run: join the torch.distributed process group "
             "(coordinator from MASTER_ADDR/MASTER_PORT as torchrun sets it, "
             "or JAX_COORDINATOR_ADDRESS) and build the mesh over every "
             "rank's card, host-major (one card a rank: cuda:LOCAL_RANK; "
             "--mesh defaults to (ranks, 1)). Run the same command on every "
             "rank; rank 0 alone writes files",
    )
    p.add_argument(
        "--balance", action="store_true",
        help="degree-balanced node relabeling before sharding (evens "
             "per-shard edge counts on power-law graphs; results are mapped "
             "back to original ids)",
    )
    p.add_argument(
        "--store-native", action="store_true",
        help="with --mesh DP,TP and a graph-cache --graph of DP shards: feed "
             "each mesh position from its own shard file (StoreSharded/"
             "StoreRing; no global CSR on the training path). Balance comes "
             "from the cache (`ingest --balance`); trajectories are bit-"
             "identical to the in-memory trainers on the same layout",
    )
    p.add_argument(
        "--schedule", default="allgather", choices=["allgather", "ring"],
        help="F-row exchange schedule for --mesh runs: allgather gives each "
             "shard a full F; ring rotates the shards around the mesh "
             "(O(N/DP) F rows per device)",
    )
    p.add_argument(
        "--partition", default="1d", choices=["1d", "2d"],
        help="node-axis partition for --mesh runs: 1d (default) shards "
             "nodes dp ways and all-gathers F; 2d tiles the edge set over a "
             "(rows, cols) grid — each position gathers only its row "
             "group's src blocks plus the capped closure rows its edges "
             "touch",
    )
    p.add_argument(
        "--replica-cols", type=int, default=1,
        help="columns of the --partition 2d grid (rows = p / cols; must "
             "divide the position count; 1 reproduces the 1d trajectory "
             "bit-for-bit on the 2d schedule)",
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
    p.add_argument(
        "--profile-dir", default=None,
        help="torch.profiler capture of the fit (sweep) into this "
             "directory: trace.json, key_averages.txt, kernels.json",
    )
    p.add_argument(
        "--perf-ledger", default=None,
        help="append this run's perf record (step-time percentiles, eps, "
             "compile count, per-span totals, config/host digest) to a "
             "perf-ledger JSONL at finalize; compare runs with `cli perf "
             "diff`. Equivalent to setting BIGCLAM_PERF_LEDGER. Requires "
             "--telemetry-dir",
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
    _add_run_flags(p)


INIT_CHOICES = ["conductance", "random", "rowkeyed"]


def _add_ignored_init(p: argparse.ArgumentParser) -> None:
    """`--init` on `sweep` and `refit`: the JAX CLI's `_add_common` gives
    them the flag and they ignore it (a sweep seeds each K by conductance,
    a refit warm-starts from the snapshot)."""
    p.add_argument(
        "--init", default="conductance", choices=INIT_CHOICES,
        help="accepted and ignored, as in the JAX CLI (a sweep seeds by "
             "conductance; a refit starts from the published snapshot)",
    )


def _add_run_flags(p: argparse.ArgumentParser) -> None:
    """The metrics, heartbeat, health and --quiet flags that `fit`,
    `sweep` and `refit` share with the JAX CLI's `_add_common`."""
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
        "--init", default="conductance", choices=INIT_CHOICES,
        help="F initialization: conductance seeding (the reference "
             "default), a {0,1} Bernoulli(0.5) random init, or the "
             "row-keyed counter init",
    )
    f.add_argument(
        "--quality", action="store_true",
        help="quality mode (NOT reference semantics): noise-floor init + "
             "restart annealing — recovers community structure at large K "
             "where the faithful dynamics freeze all-zero rows "
             "(models/quality.py)",
    )
    f.add_argument(
        "--init-noise", type=float, default=None,
        help="noise-kick scale (default: auto, "
             "min(0.02, 4*(avg_degree+1)/N) — see config.init_noise)",
    )
    # None = keep the config.py default (single source of truth)
    f.add_argument("--restart-cycles", type=int, default=None)
    f.add_argument("--restart-tol", type=float, default=None)
    f.add_argument(
        "--quality-max-p", type=float, default=None,
        help="pin the annealing-cycle MAX_P_ clip (default: auto, "
             "1 - avg_deg/(16 N) — see config.quality_max_p)",
    )
    f.add_argument(
        "--seed-exclusion", type=int, choices=(0, 1), default=None,
        help="coverage-aware seed selection (default: auto, on iff "
             "--quality; see config.seed_exclusion)",
    )
    f.add_argument(
        "--device-annealing", action="store_true",
        help="with --quality: keep the annealing schedule device-resident "
             "(models.quality.fit_quality_device — no per-cycle host F "
             "round trip; the discrete repair stage fetches F at most once "
             "a repair round)",
    )
    f.add_argument("--out", default=None, help="write communities (SNAP cmty)")
    f.add_argument(
        "--export-gexf", default=None,
        help="write a Gephi-compatible GEXF with community attributes",
    )
    _add_fit_flags(f)
    _add_publish_flags(f)

    w = sub.add_parser("sweep", help="automatic K selection over a log grid")
    _add_train_flags(w)
    _add_run_flags(w)
    _add_ignored_init(w)
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
    w.add_argument(
        "--quality", action="store_true",
        help="train each K with the quality-mode annealing schedule "
             "(models/quality.py; NOT reference semantics)",
    )
    w.add_argument(
        "--device-annealing", action="store_true",
        help="with --quality: device-resident annealing per K "
             "(fit_quality_device; no per-cycle host F round trips)",
    )

    e = sub.add_parser("eval", help="score predicted vs ground-truth communities")
    e.add_argument("--pred", required=True)
    e.add_argument("--truth", required=True)
    e.add_argument("--no-nmi", action="store_true")
    _add_ingest_parser(sub)
    _add_obs_parsers(sub)
    _add_serve_parsers(sub)
    _add_fleet_parsers(sub)
    return p


def _add_publish_flags(p: argparse.ArgumentParser) -> None:
    """`fit`'s serving flags (the JAX CLI's): snapshot publication and the
    continuous delta -> refit -> publish loop."""
    p.add_argument(
        "--publish-dir", default=None,
        help="publish the final F as a serving snapshot (atomic "
             "fsync-rename + crc sidecar + latest.json pointer, "
             "utils.checkpoint.publish): `cli serve --snapshots <dir>` "
             "loads it, and a running server hot-swaps to it",
    )
    p.add_argument(
        "--publish-shards", type=int, default=0, metavar="S",
        help="with --publish-dir: publish the generation as S per-shard "
             "row-range archives + a fleet manifest instead of one whole-F "
             "archive (the JAX package's fleet replicas and router serve "
             "them); store-backed fits slice on the cache's host ranges "
             "when S divides the shard count (0/1 = single archive)",
    )
    p.add_argument(
        "--follow", default=None, metavar="DELTA_DIR",
        help="after the fit + publish, watch this directory for new "
             "edge-delta files and run the continuous loop per file: "
             "delta re-ingest (touched shard ranges only) -> warm-start "
             "refit -> publish the next snapshot generation (needs a cache "
             "--graph and --publish-dir; a running `cli serve "
             "--watch-snapshots` hot-swaps each generation)",
    )
    p.add_argument(
        "--follow-max", type=int, default=0,
        help="stop after this many deltas (0 = keep watching)",
    )
    p.add_argument(
        "--follow-interval", type=float, default=0.5,
        help="seconds between delta-directory polls",
    )
    p.add_argument(
        "--follow-timeout", type=float, default=None,
        help="exit when no new delta arrives for this many seconds "
             "(default: watch forever)",
    )
    p.add_argument(
        "--refit-halo", type=int, default=1,
        help="--follow refits touched rows plus this many hops of "
             "neighbours (0 = strictly touched rows)",
    )
    p.add_argument(
        "--refit-rounds", type=int, default=12,
        help="--follow block-coordinate sweep cap per delta (health "
             "detectors may escalate to a full fit earlier)",
    )


def _add_serve_parsers(sub) -> None:
    """`serve` and `refit`: the JAX CLI's flags and defaults, with the
    port's --device."""
    sv = sub.add_parser(
        "serve",
        help="answer membership queries from a published F snapshot: "
             "communities_of / members_of / suggest_for (fold-in on "
             "--device) through a latency-budgeted request batcher, with "
             "hot-swap to newly published snapshots",
    )
    sv.add_argument(
        "--snapshots", default=None,
        help="snapshot directory (`cli fit --publish-dir` / "
             "utils.checkpoint.publish): the latest published snapshot "
             "is served, falling back past corrupt ones",
    )
    sv.add_argument(
        "--fleet", default=None, metavar="DIR",
        help="fleet-replica mode: serve ONE shard of a fleet publication "
             "(`cli fit --publish-shards`) over TCP line-framed JSON — "
             "needs --fleet-shard and --listen; `cli route` is the client "
             "(XOR --snapshots)",
    )
    sv.add_argument(
        "--fleet-shard", type=int, default=0, metavar="S",
        help="which shard of the fleet manifest this replica serves",
    )
    sv.add_argument(
        "--listen", default=None, metavar="HOST:PORT",
        help="bind address for --fleet replica mode (port 0 picks a free "
             "port; the chosen endpoint is printed as JSON on stdout "
             "before serving starts)",
    )
    sv.add_argument(
        "--max-queue-depth", type=int, default=0,
        help="admission control: reject new queries with a fast "
             "'overloaded' error once the batcher queue holds this many "
             "requests (0 = unbounded; sheds are counted, not errors)",
    )
    sv.add_argument(
        "--shed-wait-ms", type=float, default=0.0,
        help="admission control: shed queued queries that waited longer "
             "than this before their batch flushed (0 = never)",
    )
    sv.add_argument(
        "--graph", default=None,
        help="graph-cache dir (preferred: manifest-verified against the "
             "snapshot) or SNAP text path — the adjacency suggest_for "
             "needs for graph nodes; read-only queries work without it",
    )
    sv.add_argument(
        "--query", action="append", default=None, metavar="FAMILY:ARG",
        help="one query: communities_of:<u>, members_of:<c>, "
             "suggest_for:<u>, or a JSON object (repeatable)",
    )
    sv.add_argument("--queries", default=None,
                    help="JSONL file of query objects (one per line)")
    sv.add_argument(
        "--results", default=None,
        help="write one JSON answer per query line here (default: "
             "answers echo to stdout only for <= 16 queries)",
    )
    sv.add_argument(
        "--repeat", type=int, default=1,
        help="run the query set this many times (load testing; stats "
             "accumulate, results keep the last pass)",
    )
    sv.add_argument(
        "--latency-budget-ms", type=float, default=5.0,
        help="request-batcher window: a lone query waits at most this "
             "long for batch-mates (the p99 knob)",
    )
    sv.add_argument(
        "--max-batch", type=int, default=64,
        help="flush a batch at this many requests even inside the window",
    )
    sv.add_argument(
        "--cache-slots", type=int, default=64,
        help="hot-community cache capacity (members_of), admission keyed "
             "by community mass share (0 disables)",
    )
    sv.add_argument("--foldin-max-iters", type=int, default=200,
                    help="fold-in row-ascent iteration cap per suggest query")
    sv.add_argument(
        "--foldin-conv-tol", type=float, default=None,
        help="per-node fold-in convergence tolerance (default: the "
             "trainer's conv_tol from the snapshot config)",
    )
    sv.add_argument(
        "--foldin-max-deg", type=int, default=4096,
        help="neighbour cap per suggest query (hub truncation; counted in "
             "the stats when it engages)",
    )
    sv.add_argument(
        "--watch-snapshots", type=float, default=0.0,
        help="poll the snapshot dir every this many seconds and hot-swap "
             "when a newer snapshot is published (0 = off; swaps drain "
             "in-flight batches and drop no queries)",
    )
    sv.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="device of the suggest family's fold-in (default cuda; no "
             "card raises, there is no CPU fallback)",
    )
    sv.add_argument(
        "--telemetry-dir", default=None,
        help="run-telemetry directory: per-batch `serve` events, "
             "snapshot_swap events and the final serving stats",
    )
    sv.add_argument(
        "--heartbeat-s", type=float, default=300.0,
        help="stall-heartbeat deadline with --telemetry-dir (0 disables)",
    )
    sv.add_argument(
        "--perf-ledger", default=None,
        help="append this serve run's record (serve p99/QPS/cache hit "
             "rate) to a perf-ledger JSONL",
    )
    # a serving replica opens the cache READ-ONLY: there is no self-heal
    # knob (a heal racing the delta pipeline would rebuild pre-delta
    # blobs over the writer's work)
    sv.add_argument("--quiet", action="store_true")

    rf = sub.add_parser(
        "refit",
        help="warm-start incremental refit: start from the latest "
             "published snapshot, re-optimize only the rows a delta "
             "touched (+ halo) by batched fold-in, publish the next "
             "generation; health detectors escalate drift to a full fit",
    )
    _add_train_flags(rf)
    _add_fit_flags(rf)
    _add_ignored_init(rf)
    rf.add_argument(
        "--snapshots", required=True,
        help="snapshot directory (`cli fit --publish-dir`): the latest "
             "published F is the warm start, and the refit publishes the "
             "next generation here",
    )
    rf.add_argument(
        "--delta", required=True, metavar="EDGE_FILE",
        help="the delta edge file that was applied to the cache (`cli "
             "ingest --delta`): its endpoints are the touched rows",
    )
    rf.add_argument(
        "--k", type=int, default=None,
        help="community count (default: the snapshot's k; a mismatch "
             "refuses — a refit continues the same model)",
    )
    rf.add_argument("--halo", type=int, default=1,
                    help="refit touched rows plus this many hops of "
                         "neighbours")
    rf.add_argument("--refit-rounds", type=int, default=12,
                    help="block-coordinate sweep cap (detectors may stop "
                         "earlier)")
    rf.add_argument("--refit-batch", type=int, default=512,
                    help="fold-in rows per device batch (padded to a power "
                         "of two)")
    rf.add_argument("--foldin-max-iters", type=int, default=100,
                    help="per-node fold-in iteration cap inside each batch")
    rf.add_argument(
        "--escalate", default="full", choices=["full", "never"],
        help="on a divergence/plateau detector firing against the "
             "restricted objective: run a full fit warm-started from the "
             "refit F (full, default), or publish the refit F anyway with "
             "the escalated flag recorded (never)",
    )
    rf.add_argument("--no-publish", action="store_true",
                    help="skip publishing the result (measurement runs)")


def _add_fleet_parsers(sub) -> None:
    """`route` and `fleet`: the JAX CLI's flags and defaults, with the
    port's `fleet --device` (passed to every replica it spawns)."""
    p_rt = sub.add_parser(
        "route",
        help="fleet query router: dispatch "
             "membership queries over `cli serve --fleet` replicas by "
             "node range, scatter-gather members_of across shards, pin "
             "every query to the fleet-wide serving generation "
             "(barrier-free rollout), pick the least-loaded healthy "
             "replica",
    )
    p_rt.add_argument(
        "--fleet", required=True, metavar="DIR",
        help="fleet publication directory (`cli fit --publish-shards`):"
             " the manifest's row ranges are the routing table",
    )
    p_rt.add_argument(
        "--endpoints", default=None, metavar="HOST:PORT,...",
        help="comma-separated replica endpoints (every replica of "
             "every shard; shard ownership is discovered from their "
             "status answers); alternative: --members",
    )
    p_rt.add_argument(
        "--members", default=None, metavar="FILE",
        help="watched membership file (published by `cli fleet up`): "
             "the endpoint set follows it — add-replica/drain reshape "
             "the fleet mid-stream with zero dropped queries",
    )
    p_rt.add_argument(
        "--wait-fleet-s", type=float, default=30.0,
        help="with --members: how long to wait for the fleet to come "
             "up before erroring (kills the start-order race between "
             "`fleet up` and `route`)",
    )
    p_rt.add_argument(
        "--daemon", action="store_true",
        help="serve the router itself over the replica wire (newline-"
             "framed JSON TCP, --listen): a long-lived tier instead of "
             "a one-shot batch — `{\"family\": \"status\"}` answers "
             "router.stats(), `{\"family\": \"stop\"}` shuts it down",
    )
    p_rt.add_argument(
        "--listen", default=None, metavar="HOST:PORT",
        help="--daemon bind address (port 0 picks a free port; the "
             "chosen endpoint is printed as JSON before serving)",
    )
    p_rt.add_argument(
        "--deadline-s", type=float, default=0.0,
        help="per-query wall deadline: a routed query past it answers "
             "{\"error\": \"deadline_exceeded\"} (counted + rate-"
             "verdicted; 0 = off)",
    )
    p_rt.add_argument(
        "--retry-rounds", type=int, default=1,
        help="refresh+re-dispatch rounds an idempotent read sub-query "
             "gets after EVERY replica of its shard failed — the "
             "window in which the supervisor restarts a killed "
             "replica (0 = fail immediately)",
    )
    p_rt.add_argument(
        "--hedge", action="store_true",
        help="tail-latency hedging: duplicate a slow read sub-query "
             "to a second replica after --hedge-delay-s (first answer "
             "wins, loser cancelled; hedged/hedge_wins counted)",
    )
    p_rt.add_argument(
        "--hedge-delay-s", type=float, default=0.0,
        help="explicit hedge delay (0 = derive from the rolling wire "
             "p99 once --hedge-min-samples accumulated)",
    )
    p_rt.add_argument(
        "--hedge-min-samples", type=int, default=64,
        help="wire-latency samples needed before a derived hedge "
             "delay engages",
    )
    p_rt.add_argument(
        "--query", action="append", default=None, metavar="FAMILY:ARG",
        help="one query: communities_of:<u>, members_of:<c>, "
             "suggest_for:<u>, or a JSON object (repeatable)",
    )
    p_rt.add_argument(
        "--queries", default=None,
        help="JSONL file of query objects (one per line) — the load-"
             "test path",
    )
    p_rt.add_argument(
        "--results", default=None,
        help="write one JSON answer per query line here (default: "
             "answers echo to stdout only for <= 16 queries)",
    )
    p_rt.add_argument(
        "--repeat", type=int, default=1,
        help="run the query set this many times (load testing)",
    )
    p_rt.add_argument(
        "--max-workers", type=int, default=16,
        help="concurrent in-flight queries (the open-loop driver's "
             "parallelism)",
    )
    p_rt.add_argument(
        "--health-interval-s", type=float, default=0.0,
        help="re-health-check replicas and re-evaluate the serving "
             "generation every this many seconds (0 = only at startup; "
             "the barrier-free rollout needs this to flip mid-stream)",
    )
    p_rt.add_argument(
        "--request-timeout-s", type=float, default=60.0,
        help="per-sub-query TCP timeout before failing over to the "
             "next replica of the shard",
    )
    p_rt.add_argument(
        "--stop", action="store_true",
        help="send a stop op to every endpoint and exit (fleet "
             "teardown; no queries run)",
    )
    p_rt.add_argument(
        "--telemetry-dir", default=None,
        help="run-telemetry directory: route events + the final router "
             "stats (render with `cli report`)",
    )
    p_rt.add_argument(
        "--heartbeat-s", type=float, default=300.0,
        help="stall-heartbeat deadline with --telemetry-dir "
             "(0 disables)",
    )
    p_rt.add_argument(
        "--perf-ledger", default=None,
        help="append this route run's record (router p50/p99/QPS/shed "
             "rate, shards x replicas in the match key) to a "
             "perf-ledger JSONL; `cli perf diff` VERDICTS them",
    )
    p_rt.add_argument("--quiet", action="store_true")

    p_fl = sub.add_parser(
        "fleet",
        help="fleet supervisor: own the `serve "
             "--fleet` replica processes — restart-on-exit with "
             "RetryPolicy backoff, crash-loop quarantine, membership "
             "published to a watched file `cli route --members` "
             "follows; up/status/down/add-replica/drain",
    )
    p_fl.add_argument(
        "action",
        choices=["up", "status", "down", "add-replica", "drain"],
        help="up: spawn + supervise (parks until a down op); the rest "
             "talk to a running supervisor's --control endpoint",
    )
    p_fl.add_argument(
        "--fleet", default=None, metavar="DIR",
        help="fleet publication directory (`cli fit --publish-shards`)",
    )
    p_fl.add_argument(
        "--shards", type=int, default=1,
        help="up: shards in the fleet manifest",
    )
    p_fl.add_argument(
        "--replicas", type=int, default=1,
        help="up: replicas per shard",
    )
    p_fl.add_argument("--host", default="127.0.0.1",
                      help="bind host for replicas + control")
    p_fl.add_argument(
        "--control-port", type=int, default=0,
        help="up: control socket port (0 picks; printed in the hello)",
    )
    p_fl.add_argument(
        "--control", default=None, metavar="HOST:PORT",
        help="status/down/add-replica/drain: the control endpoint "
             "`fleet up` printed",
    )
    p_fl.add_argument(
        "--members", default=None, metavar="FILE",
        help="membership file path (default: <fleet>/members.json); "
             "status can read it directly without --control",
    )
    p_fl.add_argument(
        "--graph", default=None,
        help="compiled graph cache passed to every replica "
             "(suggest_for needs it)",
    )
    p_fl.add_argument(
        "--watch-snapshots", type=float, default=1.0,
        help="replica snapshot poll interval: how a RESTARTED replica "
             "rejoins at the newest generation (0 = off)",
    )
    p_fl.add_argument(
        "--replica-args", default=None, metavar="'ARGS...'",
        help="extra `cli serve` flags passed through to every replica "
             "(shell-quoted string, e.g. '--max-queue-depth 256')",
    )
    p_fl.add_argument(
        "--log-dir", default=None,
        help="per-member replica stderr logs (default: discarded)",
    )
    p_fl.add_argument(
        "--restart-base-s", type=float, default=0.25,
        help="restart backoff base (RetryPolicy schedule: base * "
             "factor^n with deterministic per-member jitter)",
    )
    p_fl.add_argument(
        "--restart-max-s", type=float, default=10.0,
        help="restart backoff ceiling",
    )
    p_fl.add_argument(
        "--quarantine-after", type=int, default=3,
        help="consecutive failures (never up for --stable-s) before a "
             "slot is quarantined — crash-loop detection",
    )
    p_fl.add_argument(
        "--stable-s", type=float, default=5.0,
        help="uptime that resets a member's failure count",
    )
    p_fl.add_argument(
        "--drain-grace-s", type=float, default=0.5,
        help="drain: wait this long after publishing state=draining "
             "before the wire drain op (one router reload interval — "
             "the zero-drop handshake)",
    )
    p_fl.add_argument(
        "--up-timeout-s", type=float, default=60.0,
        help="up: how long to wait for every replica's hello before "
             "printing all_up=false (supervision continues either way)",
    )
    p_fl.add_argument(
        "--member", default=None, metavar="ID",
        help="drain: which member (e.g. s0r1)",
    )
    p_fl.add_argument(
        "--shard", type=int, default=0,
        help="add-replica: which shard the new replica serves",
    )
    p_fl.add_argument("--seed", type=int, default=0,
                      help="backoff-jitter seed")
    p_fl.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="up / add-replica: each replica's --device, where its "
             "suggest family folds in (default cuda; a replica without a "
             "card exits at start, there is no CPU fallback)",
    )
    p_fl.add_argument(
        "--telemetry-dir", default=None,
        help="run-telemetry directory: membership / replica_restart / "
             "replica_quarantined events + the final supervision "
             "counters (render with `cli report`)",
    )
    p_fl.add_argument(
        "--heartbeat-s", type=float, default=0.0,
        help="stall-heartbeat deadline with --telemetry-dir "
             "(0 disables)",
    )
    p_fl.add_argument(
        "--perf-ledger", default=None,
        help="append the supervision record (replica_restarts) to a "
             "perf-ledger JSONL",
    )
    p_fl.add_argument("--quiet", action="store_true")


def _add_ingest_parser(sub) -> None:
    """`ingest`: the JAX CLI's flags and defaults."""
    p = sub.add_parser(
        "ingest",
        help="compile a SNAP edge list into a binary graph-shard cache "
             "(streaming, memory-bounded; reports edges/sec + peak RSS)",
    )
    p.add_argument(
        "--graph", default=None,
        help="SNAP edge-list path (required for a full compile; "
             "ignored with --delta, which appends to an existing cache)",
    )
    p.add_argument("--cache-dir", required=True)
    p.add_argument(
        "--delta", default=None, metavar="EDGE_FILE",
        help="append this edge file to the EXISTING --cache-dir by "
             "rebuilding only the touched node ranges (untouched shard "
             "blobs stay byte-identical, seed scores re-bake for touched "
             "shards only, manifest bumps delta_seq; new node ids refuse — "
             "re-run a full ingest)",
    )
    p.add_argument(
        "--shards", type=int, default=8,
        help="node-range shards (match the target mesh's node-shard count "
             "for --store-native)",
    )
    p.add_argument(
        "--chunk-bytes", type=int, default=64 << 20,
        help="streaming parse chunk size — the host-RSS budget knob",
    )
    p.add_argument(
        "--workers", type=int, default=0,
        help="parallel parse workers (spawn pool; 0 = in-process)",
    )
    p.add_argument(
        "--balance", action="store_true",
        help="bake the degree-balance permutation (parallel/balance.py) "
             "into the shards, so store-native meshes load balanced rows",
    )
    p.add_argument(
        "--no-seed-bake", action="store_true",
        help="skip baking per-node conductance seed scores into the cache "
             "(default: bake — fit-time seeding on the cache then reads "
             "scores instead of re-scoring the graph)",
    )
    p.add_argument(
        "--seed-cap", type=int, default=None,
        help="degree cap for the baked conductance scorer (the exact "
             "triangle pass is edge-quadratic on hubs; same splitmix64 "
             "estimator as --seeding-degree-cap, exact when cap >= max "
             "degree)",
    )
    p.add_argument(
        "--seed", type=int, default=0,
        help="PRNG seed the capped scorer's sample stream derives from "
             "(match the fit's --seed for identical rankings)",
    )
    p.add_argument(
        "--no-closure-bake", action="store_true",
        help="skip baking the per-shard-pair closure gather lists "
             "(manifest v3; default: bake)",
    )
    p.add_argument(
        "--closure-cap", type=int, default=0,
        help="rows per (requester, contributor) closure list before the "
             "pair degrades to the full dst block (0 = uncapped)",
    )
    p.add_argument("--overwrite", action="store_true")
    p.add_argument(
        "--telemetry-dir", default=None,
        help="run-telemetry directory (events.jsonl + run_report.json; "
             "no device sampling on this entry)",
    )
    p.add_argument(
        "--heartbeat-s", type=float, default=300.0,
        help="stall-heartbeat deadline with --telemetry-dir (0 disables)",
    )
    p.add_argument("--quiet", action="store_true")


def _add_obs_parsers(sub) -> None:
    """The observability subcommands (the JAX CLI's flags and defaults)."""
    pr = sub.add_parser(
        "profile",
        help="run N instrumented steps under a torch.profiler capture: the "
             "timeline carries the span names (obs.trace), per-step timings "
             "land in --telemetry-dir / the perf ledger",
    )
    _add_train_flags(pr)
    _add_fit_flags(pr)
    pr.add_argument("--k", type=int, default=100)
    pr.add_argument(
        "--init", default="conductance",
        choices=["conductance", "random", "rowkeyed"],
    )
    pr.add_argument(
        "--steps", type=int, default=20,
        help="profiled steps (after --warmup un-captured steps)",
    )
    pr.add_argument("--warmup", type=int, default=2)

    pp = sub.add_parser(
        "perf",
        help="perf-regression ledger: record a run, diff the latest run "
             "against its matched baseline (nonzero exit on regression), "
             "or show recent records",
    )
    perf_sub = pp.add_subparsers(dest="action", required=True)
    rec = perf_sub.add_parser(
        "record", help="append a record built from a finished --telemetry-dir",
    )
    rec.add_argument("--telemetry-dir", required=True)
    rec.add_argument("--ledger", default="perf/ledger.jsonl")
    rec.add_argument("--note", default="")
    diff = perf_sub.add_parser(
        "diff",
        help="latest run vs its matched baseline (same entry/config/"
             "backend/device/host) with noise bands; exit 2 on regression",
    )
    diff.add_argument("--ledger", default="perf/ledger.jsonl")
    diff.add_argument(
        "--tolerance", type=float, default=0.25,
        help="minimum relative noise band (the run's own p50->p90 spread "
             "widens it)",
    )
    diff.add_argument(
        "--run", default=None,
        help="diff this run id instead of the ledger's last record",
    )
    show = perf_sub.add_parser("show", help="print recent records")
    show.add_argument("--ledger", default="perf/ledger.jsonl")
    show.add_argument("-n", type=int, default=10)

    rp = sub.add_parser(
        "report",
        help="render a --telemetry-dir human-readable (stage seconds, "
             "memory watermarks and models, compile counts, stalls; "
             "validates the event schema)",
    )
    rp.add_argument("dir", help="telemetry directory of a finished run")
    rp.add_argument("--json", action="store_true",
                    help="machine-readable output; exit codes unchanged")
    rp.add_argument("--fleet", action="store_true",
                    help="treat DIR as a fleet root whose subdirectories "
                         "are member telemetry dirs")

    wp = sub.add_parser(
        "watch",
        help="live-tail a telemetry dir: LLH/grad-norm/churn sparklines "
             "from health events, anomalies, stalls (reads events.jsonl "
             "only; exits when the run finalizes)",
    )
    wp.add_argument("dir", help="telemetry directory of a running run")
    wp.add_argument("--interval", type=float, default=2.0,
                    help="seconds between refreshes")
    wp.add_argument("--once", action="store_true",
                    help="render one frame and exit (CI / piped use)")
    wp.add_argument("--width", type=int, default=48,
                    help="sparkline width in samples")
    wp.add_argument("--fleet", action="store_true",
                    help="treat DIR as a fleet root (subdirectories = "
                         "member telemetry dirs)")

    pf = sub.add_parser(
        "preflight",
        help="capacity verdict without a card: predicted per-device memory, "
             "per-host RSS and collective bytes a step for a config + graph "
             "+ device target, with the binding constraint and the knobs "
             "that relax it (exit 0 fits / 2 does not fit / 1 bad input)",
    )
    pf.add_argument(
        "--graph", default=None,
        help="a compiled cache dir (exact manifest numbers, per-shard edge "
             "counts included) or a SNAP text path (+ --nodes; edges "
             "estimated from its size unless --edges); optional when "
             "--nodes and --edges are given",
    )
    pf.add_argument("--k", type=int, required=True)
    pf.add_argument("--nodes", type=int, default=None)
    pf.add_argument("--edges", type=int, default=None,
                    help="undirected edge count")
    pf.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    pf.add_argument("--mesh", default=None,
                    help="'DP,TP' target mesh (default: --devices,1)")
    pf.add_argument("--devices", type=int, default=1,
                    help="target card count when --mesh is not given")
    pf.add_argument(
        "--device-kind", default=None,
        help="device memory from the port's table, by the name "
             "torch.cuda.get_device_name gives (--hbm-gb overrides); a "
             "kind the table lacks is refused",
    )
    pf.add_argument("--hbm-gb", type=float, default=None,
                    help="per-device memory budget in GiB")
    pf.add_argument("--hbm-bytes", type=float, default=None,
                    help="exact per-device memory budget in bytes")
    pf.add_argument("--host-ram-gb", type=float, default=None,
                    help="per-host RAM budget in GiB")
    pf.add_argument("--processes", type=int, default=1)
    pf.add_argument("--representation", default="dense",
                    choices=["dense", "sparse"])
    pf.add_argument("--sparse-m", type=int, default=64)
    pf.add_argument("--support-every", type=int, default=1)
    pf.add_argument("--schedule", default="allgather",
                    choices=["allgather", "ring"])
    pf.add_argument("--store-native", action="store_true",
                    help="price the store-native mesh (a shard file per "
                         "mesh position, no host-global CSR)")
    pf.add_argument(
        "--partition", default="1d", choices=["1d", "2d"],
        help="price the 1d all-gather layout or the 2d closure-gather "
             "layout (a 1d does-not-fit verdict names --partition 2d when "
             "it would relax the binding gather)",
    )
    pf.add_argument("--replica-cols", type=int, default=1,
                    help="columns of the --partition 2d grid (rows = p / cols)")
    pf.add_argument("--health-every", type=int, default=10)
    pf.add_argument("--max-backtracks", type=int, default=15)
    pf.add_argument("--edge-chunk", type=int, default=None)
    pf.add_argument("--chunk-bytes", type=int, default=0,
                    help="include the ingest stage in the host model at "
                         "this chunk budget (0 = fit-only stages)")
    pf.add_argument("--csr-block-b", type=int, default=256,
                    help="TPU tile shape; no port use (the kernels read "
                         "the CSR)")
    pf.add_argument(
        "--serve", action="store_true",
        help="price a serving fleet instead of training: per-replica RSS "
             "(snapshot, inverted index, hot cache, adjacency slice) and "
             "QPS capacity against --host-ram-gb / --qps-target",
    )
    pf.add_argument("--serve-shards", type=int, default=1)
    pf.add_argument("--serve-replicas", type=int, default=1)
    pf.add_argument("--qps-target", type=float, default=0.0)
    pf.add_argument("--qps-per-replica", type=float, default=9000.0)
    pf.add_argument("--serve-cache-slots", type=int, default=64)
    pf.add_argument("--avg-memberships", type=float, default=2.0)
    pf.add_argument("--json", action="store_true",
                    help="machine-readable verdict")


def config_from_args(args):
    from bigclam_tpu_torch.config import BigClamConfig

    refuse_partition_2d(args)
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
        metrics_path=args.metrics,
        # the steps compute health packs only for a monitor to read: with
        # no --telemetry-dir there is none, and they compute nothing
        health_every=(max(args.health_every, 0) if args.telemetry_dir else 0),
        seeding_degree_cap=args.seeding_degree_cap,
        use_pallas_csr={"auto": None, "on": True, "off": False}[args.csr_kernels],
        csr_fused={"auto": None, "off": False}[args.csr_fused],
        csr_k_block=max(int(getattr(args, "csr_k_block", 0) or 0), 0),
        representation=args.representation,
        sparse_m=args.sparse_m,
        support_every=args.support_every,
        partition=getattr(args, "partition", "1d"),
        replica_cols=max(getattr(args, "replica_cols", 1) or 1, 1),
        **(dict(min_com=args.min_com, max_com=args.max_com,
                div_com=args.div_com, ksweep_tol=args.ksweep_tol)
           if sweep else {}),
    )


SPARSE_2D_REFUSAL = (
    "error: --partition 2d runs the dense-F closure-gather schedule, and "
    "the sparse top-M member exchange shards members over the 1d node "
    "axis — the two layouts have no common F placement to train on. "
    "Alternatives: keep --representation sparse on the 1d mesh (its capped "
    "member exchange already avoids the dense all-gather), or go dense to "
    "take the 2d closure schedule (`cli preflight --partition 2d` prices "
    "both)"
)

SPARSE_RING_REFUSAL = (
    "error: --schedule ring is not supported with --representation sparse "
    "yet (the sparse exchange is an M-column all_gather + sparse allreduce)"
)


RING_2D_REFUSAL = (
    "error: --partition 2d is its own closure-gather schedule — each chip "
    "gathers only the closure rows its edge block touches, so there is no "
    "resident F ring to rotate (ring shards dst-F around the 1d node axis). "
    "Alternatives: drop --schedule ring (2d replaces what ring saves), or "
    "keep --schedule ring on the 1d mesh"
)


def refuse_partition_2d(args) -> None:
    """The JAX CLI's refusals of --partition 2d, in its words and order:
    no --mesh, --distributed (the 2D mesh is single-controller), a sparse
    representation, the ring schedule, a K-sharded mesh (TP > 1)."""
    if getattr(args, "partition", "1d") != "2d":
        return
    if not args.mesh:
        raise SystemExit(
            "error: --partition 2d needs --mesh p,1 (the 2D edge-block "
            "layout is a sharded schedule)"
        )
    if getattr(args, "distributed", False):
        raise SystemExit(
            "error: --partition 2d is single-controller for now (the "
            "multi-host 2D mesh rides the ROADMAP item 1 pod drill)"
        )
    if args.representation == "sparse":
        raise SystemExit(SPARSE_2D_REFUSAL)
    if args.schedule == "ring":
        raise SystemExit(RING_2D_REFUSAL)
    if parse_mesh(args.mesh)[1] != 1:
        raise SystemExit(
            "error: --partition 2d needs --mesh p,1 — the k axis rides the "
            "2D mesh unsharded (use --replica-cols to shape the (rows, "
            "cols) grid)"
        )


def quality_config(args, cfg):
    """`fit`'s quality-mode config (the JAX `cmd_fit` rules): an explicit
    --seed-exclusion applies to any fit; --quality engages quality mode
    with the given --init-noise/--restart-cycles/--restart-tol/
    --quality-max-p, which without it warn and do nothing (as does
    --device-annealing). Refuses --init rowkeyed and --representation
    sparse in quality mode (the JAX CLI's messages), and --store-native,
    whose trainers hold no global CSR for the discrete stage (the JAX
    CLI fails there, after the annealing)."""
    if args.seed_exclusion is not None:
        cfg = cfg.replace(seed_exclusion=bool(args.seed_exclusion))
    quality_kw = {
        key: val
        for key, val in (
            ("init_noise", args.init_noise),
            ("restart_cycles", args.restart_cycles),
            ("restart_tol", args.restart_tol),
            ("quality_max_p", args.quality_max_p),
        )
        if val is not None
    }
    if args.quality:
        cfg = cfg.replace(quality_mode=True, **quality_kw)
    elif quality_kw or args.device_annealing:
        noop = sorted(quality_kw) + (
            ["device_annealing"] if args.device_annealing else []
        )
        print(f"warning: {noop} have no effect without --quality",
              file=sys.stderr)
    if args.init == "rowkeyed" and cfg.quality_mode:
        raise SystemExit(
            "error: --init rowkeyed is not supported with --quality "
            "(the annealing schedule owns its noise-floor init)"
        )
    if cfg.quality_mode and cfg.representation == "sparse":
        raise SystemExit(QUALITY_SPARSE_REFUSAL)
    if cfg.quality_mode and args.store_native:
        raise SystemExit(
            "error: --quality is not supported with --store-native yet (the "
            "discrete repair stage reads the global CSR, which a "
            "store-native trainer never loads); drop --store-native"
        )
    return cfg


def parse_mesh(text: str) -> tuple:
    """'DP,TP' -> (dp, tp)."""
    try:
        dp, tp = (int(x) for x in text.split(","))
    except ValueError:
        raise SystemExit(f"error: --mesh wants 'DP,TP', got {text!r}") from None
    return dp, tp


NO_COORDINATOR_WARNING = (
    "warning: --distributed but no coordinator found (set "
    "JAX_COORDINATOR_ADDRESS + JAX_NUM_PROCESSES + JAX_PROCESS_ID, or "
    "torchrun's MASTER_ADDR + MASTER_PORT + WORLD_SIZE + RANK, on every "
    "host); continuing single-process over local devices only"
)


def distributed_mesh(device, mesh):
    """--distributed: join the process group (parallel/multihost.py
    `initialize_distributed`; idempotent), or warn in the JAX CLI's words
    and run single-process where no coordinator is named; then the mesh
    (multihost.make_multihost_mesh): `mesh` ('DP,TP', optional) over every
    rank's card, (ranks, 1) by default."""
    from bigclam_tpu_torch.parallel.multihost import (
        initialize_distributed,
        make_multihost_mesh,
    )
    from bigclam_tpu_torch.utils.dist import process_count

    if not initialize_distributed(device=device) and process_count() == 1:
        print(NO_COORDINATOR_WARNING, file=sys.stderr)
    try:
        return make_multihost_mesh(parse_mesh(mesh) if mesh else None, device)
    except ValueError as e:
        raise SystemExit(f"error: {e}") from None


def make_mesh_model(g, cfg, device, mesh, schedule="allgather", balance=False,
                    store=None, distributed=False):
    """The sharded trainer of `schedule` on a `mesh` ('DP,TP') of the first
    DP*TP cards, or of DP*TP shards on the CPU for device `cpu`; with
    `store` (a GraphStore, --store-native) the store-backed trainer, one
    cache shard per mesh position; with --representation sparse the sparse
    sharded trainer on a (DP, 1) mesh (the ring schedule, TP > 1 and
    --balance refused with the JAX CLI's words); with cfg.partition "2d"
    the 2D edge-block trainer on a (DP / C, C) grid, C = replica_cols.
    `distributed`: the mesh spans the process group's ranks
    (distributed_mesh), `mesh` optional."""
    import torch

    from bigclam_tpu_torch.parallel import (
        RingBigClamModel,
        ShardedBigClamModel,
        SparseShardedBigClamModel,
        StoreRingBigClamModel,
        StoreShardedBigClamModel,
        StoreTwoDShardedBigClamModel,
        TwoDShardedBigClamModel,
        make_mesh,
        make_mesh_2d,
        twod_mesh_shape,
    )
    from bigclam_tpu_torch.utils.device import resolve_device

    if cfg.representation == "sparse":
        if schedule == "ring":
            raise SystemExit(SPARSE_RING_REFUSAL)
        refuse_sparse_csr_kernels(cfg)
    if store is not None and balance:
        raise SystemExit(
            "error: --store-native takes balance from the cache; "
            "re-ingest with `cli ingest --balance` instead of --balance"
        )
    if distributed:
        m = distributed_mesh(device, mesh)
        tp = m.shape["k"]
        if store is not None:
            cls = StoreRingBigClamModel if schedule == "ring" else StoreShardedBigClamModel
            return cls(store, cfg, m)
        if cfg.representation == "sparse":
            try:
                return SparseShardedBigClamModel(g, cfg, m, balance=balance)
            except ValueError as e:
                if tp > 1 or balance:
                    raise SystemExit(f"error: {e}") from None
                raise
        cls = RingBigClamModel if schedule == "ring" else ShardedBigClamModel
        return cls(g, cfg, m, balance=balance)
    dp, tp = parse_mesh(mesh)
    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if len(cards) < dp * tp:
            # a mesh of more positions than cards shares them round-robin
            # (a device may repeat, parallel/mesh.py): the trajectory is
            # the mesh's, the hops between shared positions are no-ops
            print(f"note: --mesh {mesh} on {len(cards)} card(s): mesh "
                  "positions share cards round-robin", file=sys.stderr)
        devices = [cards[i % len(cards)] for i in range(dp * tp)]
    else:
        devices = [dev] * (dp * tp)
    if cfg.partition == "2d":
        try:
            grid = make_mesh_2d(twod_mesh_shape(cfg, dp), devices)
        except ValueError as e:
            raise SystemExit(f"error: {e}") from None
        if store is not None:
            return StoreTwoDShardedBigClamModel(store, cfg, grid)
        return TwoDShardedBigClamModel(g, cfg, grid, balance=balance)
    if store is not None:
        cls = StoreRingBigClamModel if schedule == "ring" else StoreShardedBigClamModel
        return cls(store, cfg, make_mesh((dp, tp), devices))
    if cfg.representation == "sparse":
        try:
            return SparseShardedBigClamModel(
                g, cfg, make_mesh((dp, tp), devices), balance=balance)
        except ValueError as e:
            if tp > 1 or balance:
                raise SystemExit(f"error: {e}") from None
            raise
    cls = RingBigClamModel if schedule == "ring" else ShardedBigClamModel
    return cls(g, cfg, make_mesh((dp, tp), devices), balance=balance)


def store_for_model(args, cfg):
    """The GraphStore a --store-native run trains from (None without the
    flag), after the JAX CLI's refusals."""
    if not getattr(args, "store_native", False):
        return None
    if not (args.mesh or getattr(args, "distributed", False)):
        raise SystemExit(
            "error: --store-native needs a sharded run (--mesh) — the store "
            "trainers load one shard file per mesh position"
        )
    if cfg.representation == "sparse":
        raise SystemExit(
            "error: --store-native is not supported with --representation "
            "sparse yet (the sparse trainers build member-list state from "
            "the in-memory graph)"
        )
    store = getattr(args, "_store", None)
    if store is None:
        raise SystemExit(
            "error: --store-native needs --graph (or --cache-dir) to be a "
            "compiled graph cache (run `cli ingest` first)"
        )
    return store


def build_model(g, cfg, args):
    """The trainer `fit` and `profile` run: the mesh's (store-backed with
    --store-native) or the single device's."""
    store = store_for_model(args, cfg)
    if args.mesh or getattr(args, "distributed", False):
        return make_mesh_model(g, cfg, args.device, args.mesh, args.schedule,
                               args.balance, store=store,
                               distributed=getattr(args, "distributed", False))
    return make_model(g, cfg, args.device)


def load_graph(args):
    """The graph of fit, sweep and profile (JAX `_load_graph`): a text
    --graph with --cache-dir compiles the cache once and reloads from it
    after; a cache dir as --graph opens the store; any other text parses.
    Cache loads self-heal crc-failed shards unless --no-self-heal. The
    opened GraphStore (None for text) is kept on args._store for seeding
    and --store-native."""
    from bigclam_tpu_torch.graph import build_graph
    from bigclam_tpu_torch.graph.store import (
        GraphStore,
        compile_graph_cache,
        is_cache_dir,
    )

    heal = not getattr(args, "no_self_heal", False)
    path = args.graph
    cache = getattr(args, "cache_dir", None)
    args._store = None
    if cache and not is_cache_dir(path):
        if not is_cache_dir(cache):
            print(f"note: compiling graph cache {cache} from {path}",
                  file=sys.stderr)
            args._store = compile_graph_cache(
                path, cache,
                seed=getattr(args, "seed", 0),
                # the fit's cap, so the bake runs the estimator the run
                # will trust (ShardSeedScores.matches)
                seed_cap=getattr(args, "seeding_degree_cap", None),
            )
            return args._store.load_graph()
        args._store = GraphStore.open(cache, self_heal=heal)
        return args._store.load_graph()
    if is_cache_dir(path):
        args._store = GraphStore.open(path, self_heal=heal)
        return args._store.load_graph()
    return build_graph(path, self_heal=heal)


def refuse_sparse_csr_kernels(cfg) -> None:
    """--csr-kernels on means require: the CSR edge kernels take a dense
    F, so honouring it with sparse member lists means refusing."""
    if cfg.representation == "sparse" and cfg.use_pallas_csr:
        raise SystemExit(
            "error: --csr-kernels on is not supported with "
            "--representation sparse (the CSR edge kernels take a dense "
            "F; the sparse path has its own CUDA member-lookup kernel, "
            "csrc/member_lookup.cu, engaged by itself on cuda — use "
            "--csr-kernels auto)"
        )


def make_model(g, cfg, device):
    """The single-device trainer of cfg.representation on `device`."""
    if cfg.representation == "sparse":
        refuse_sparse_csr_kernels(cfg)
        from bigclam_tpu_torch.models.sparse import SparseBigClamModel

        return SparseBigClamModel(g, cfg, device=device)
    from bigclam_tpu_torch.models.bigclam import BigClamModel

    return BigClamModel(g, cfg, device=device)


BAKED_REFUSAL = (
    "error: --seed-backend baked needs the graph to come from a compiled "
    "cache with baked seed scores (run `cli ingest` and pass the cache dir "
    "as --graph)"
)


def baked_phi(store, cfg, backend: str, quiet: bool = False):
    """The ingest-baked conductance scores a conductance init reads (JAX
    `_init_F`): on a cache under `auto` or `baked`, when the bake's cap
    and seed match the run; None where the graph is to be scored. `baked`
    exits where `auto` falls back with a note: on a text graph, on a cache
    without scores, or on scores of another cap or seed."""
    if backend not in ("auto", "baked"):
        return None
    if store is None:
        if backend == "baked":
            raise SystemExit(BAKED_REFUSAL)
        return None
    try:
        scores = store.load_seed_scores()
    except ValueError as e:
        if backend == "baked":
            raise SystemExit(f"error: {e}")
        if not quiet:
            print(f"note: {e}; falling back to the streaming conductance "
                  "pass", file=sys.stderr)
        return None
    if scores.matches(cfg.seeding_degree_cap, cfg.seed):
        if not quiet:
            print("[bigclam] seeding: using ingest-baked seed scores from "
                  "the graph cache", file=sys.stderr)
        return scores.phi
    # the bake's estimator disagrees with this run's seeding config:
    # using it would change the ranking against the same fit on the text
    msg = (
        f"baked seed scores (cap={scores.cap}, seed={scores.seed}) do not "
        f"match this run (--seeding-degree-cap {cfg.seeding_degree_cap}, "
        f"--seed {cfg.seed}); re-ingest with matching --seed-cap/--seed"
    )
    if backend == "baked":
        raise SystemExit(f"error: {msg}")
    if not quiet:
        print(f"note: {msg} — falling back to the streaming conductance "
              "pass", file=sys.stderr)
    return None


def init_F(g, cfg, init: str, backend: str = "auto", device=None,
           store=None, quiet: bool = False) -> Optional[np.ndarray]:
    """Host F0 for `--init`; None for rowkeyed (the model generates it).
    Conductance seeding reads the store's baked scores where baked_phi
    gives them, else scores with `backend` (`auto` for `baked`), its
    device backends on `device`."""
    from bigclam_tpu_torch.models.bigclam import random_init_F
    from bigclam_tpu_torch.ops import seeding

    if init == "rowkeyed":
        return None
    if init == "conductance":
        phi = baked_phi(store, cfg, backend, quiet)
        seeds = seeding.conductance_seeds(
            g, cfg, backend="auto" if backend == "baked" else backend,
            phi=phi, device=device,
        )
        return seeding.init_F(g, seeds, cfg)
    return random_init_F(g, cfg)


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
    ledger = getattr(args, "perf_ledger", None)
    if ledger and not tdir:
        print(
            "warning: --perf-ledger has no effect without "
            "--telemetry-dir (no run telemetry, no perf record)",
            file=sys.stderr,
        )
    if not tdir:
        return None
    from bigclam_tpu_torch.obs import RunTelemetry, install

    return install(RunTelemetry(
        tdir,
        entry=entry,
        heartbeat_s=args.heartbeat_s,
        quiet=args.quiet,
        # ingest, serve, route and fleet have no --heartbeat-escalate
        heartbeat_escalate=getattr(args, "heartbeat_escalate", 0),
        # passed through, not via os.environ: an env mutation would leak
        # the ledger into later in-process main() calls
        ledger_path=ledger,
        # a --distributed run decides the single-writer gate once the
        # process group is joined (multihost.initialize_distributed)
        auto_gate=not getattr(args, "distributed", False),
    ))


def close_telemetry(tel) -> None:
    if tel is None:
        return
    from bigclam_tpu_torch.obs import uninstall

    tel.finalize()
    uninstall(tel)


def stamp_partition(out: dict, cfg, model) -> None:
    """The 2D run's identity beside `partition`: its grid's cols and the
    EFFECTIVE grad exchange the trainer resolved (the perf ledger's match
    key reads it; absent on 1d models, as in the JAX JSON)."""
    if cfg.partition == "2d":
        out["replica_cols"] = cfg.replica_cols
    gx = getattr(model, "grad_exchange", None)
    if gx is not None:
        out["grad_exchange"] = gx


def stamp_models(out: dict, model) -> None:
    """The trainer's modeled device bytes (obs.memory) and, on a mesh, its
    modeled collective bytes a step (obs.comms), as the JAX fit JSON
    carries them."""
    cm = getattr(model, "comms", None)
    if cm is not None:
        out["comms_bytes_per_step"] = round(cm.bytes_per_step(), 1)
    mem = getattr(model, "memory", None)
    if mem is not None:
        out["hbm_modeled_bytes"] = round(mem.hbm_bytes(), 1)


def check_follow(args, cfg) -> None:
    """`fit --follow`'s preconditions (the JAX CLI's), checked BEFORE the
    fit: a misconfigured loop refuses up front, not after the fit it would
    have discarded."""
    if getattr(args, "_store", None) is None:
        raise SystemExit(
            "error: --follow needs a compiled graph cache (--graph "
            "<cache-dir> or --cache-dir): deltas re-ingest shard ranges, "
            "not text files"
        )
    if not args.publish_dir:
        raise SystemExit(
            "error: --follow needs --publish-dir (each refit publishes a "
            "snapshot generation the server swaps to)"
        )
    if args.publish_shards > 1:
        raise SystemExit(
            "error: --follow publishes single archives — it cannot feed a "
            "fleet yet (drop --publish-shards; re-run `cli fit "
            "--publish-shards` per generation instead)"
        )
    if cfg.quality_mode or getattr(args, "distributed", False):
        raise SystemExit(
            "error: --follow supports single-chip dense fits for now (the "
            "sharded/sparse refit loop rides the ROADMAP item 1 pod drill)"
        )
    if args.mesh or cfg.representation == "sparse":
        raise SystemExit(
            "error: --follow supports single-device dense fits for now "
            "(drop --mesh / --representation sparse)"
        )


def publish_fit(args, cfg, g, res, out: dict, fit_wall_s: float, tel) -> None:
    """Publish the fit's F as a serving snapshot (JAX `cmd_fit`): one
    archive of the next generation, or with --publish-shards S > 1 a fleet
    generation of S row-range archives (sparse fits publish their top-M
    member lists). A running `cli serve --watch-snapshots` swaps to it."""
    from bigclam_tpu_torch.serve.snapshot import (
        publish_fleet_snapshot,
        publish_snapshot,
    )
    from bigclam_tpu_torch.utils.checkpoint import published_step_of

    # fit_wall_s/iters: the full-fit cost baseline `cli refit` prices its
    # refit_cost_ratio against
    pub_meta = {"llh": res.llh, "seed": cfg.seed, "fit_wall_s": fit_wall_s,
                "fit_iters": res.num_iters}
    shards = int(args.publish_shards or 0)
    if shards <= 1:
        # step=None: the NEXT generation under the publish lock
        path = publish_snapshot(
            args.publish_dir, step=None, F=res.F, raw_ids=g.raw_ids,
            num_edges=g.num_edges, cfg=cfg, meta=pub_meta,
        )
        out["published"] = path
        out["generation"] = published_step_of(path)
        return
    # a store-backed fit slices on the store's host ranges (each serving
    # shard then covers whole cache shards); others take equal slices
    store = getattr(args, "_store", None)
    ranges = None
    if store is not None:
        try:
            ranges = store.host_ranges(shards)
        except ValueError:
            pass        # shards does not divide the cache
    if ranges is None:
        n = g.num_nodes
        ranges = [(s * n // shards, (s + 1) * n // shards)
                  for s in range(shards)]
    if cfg.representation == "sparse":
        # M-sized member lists, never a densified N*K block (lossless
        # whenever M held the live support, which the fit's cap guarantees)
        from bigclam_tpu_torch.ops.sparse_members import from_dense

        m_pub = int(out.get("sparse_m", cfg.sparse_m))
        ids_pub, w_pub, _ = from_dense(res.F, m_pub, cfg.num_communities,
                                       g.num_nodes)
        kw = {"ids": ids_pub, "w": w_pub}
    else:
        kw = {"F": res.F}
    step, path = publish_fleet_snapshot(
        args.publish_dir, ranges, raw_ids=g.raw_ids, num_edges=g.num_edges,
        cfg=cfg, meta=pub_meta, **kw,
    )
    out["published"] = path
    out["generation"] = step
    out["publish_shards"] = shards
    if tel is not None:
        tel.event("fleet_publish", step=step, shards=shards)


def fit(args):
    """Run `fit` for parsed arguments. Returns (the JSON-ready result dict,
    the FitResult, the final train state, or in quality mode the
    models.quality.QualityResult)."""
    tel = open_telemetry(args, "fit")
    try:
        return _fit(args, tel)
    finally:
        close_telemetry(tel)


def _fit(args, tel):
    from bigclam_tpu_torch.models.bigclam import FitResult
    from bigclam_tpu_torch.obs import trace
    from bigclam_tpu_torch.ops import extraction
    from bigclam_tpu_torch.utils.checkpoint import CheckpointManager
    from bigclam_tpu_torch.utils.device import device_kind
    from bigclam_tpu_torch.utils.dist import is_primary
    from bigclam_tpu_torch.utils.metrics import MetricsLogger
    from bigclam_tpu_torch.utils.profiling import StageProfile
    from bigclam_tpu_torch.utils.profiling import trace as capture

    cfg = quality_config(args, config_from_args(args))
    # stage ends forward into the telemetry (event + device-memory
    # watermark + heartbeat beat) when --telemetry-dir is active
    prof = StageProfile()
    with prof.stage("graph"):
        g = load_graph(args)
    if getattr(args, "follow", None):
        check_follow(args, cfg)
    with prof.stage("model_build"):
        model = build_model(g, cfg, args)
    with prof.stage("seeding"):
        F0 = init_F(g, cfg, args.init, args.seed_backend, args.device,
                    store=args._store, quiet=args.quiet)
    if not cfg.quality_mode:
        # (quality mode uploads F0 inside its schedule)
        with prof.stage("upload"):
            state0 = model.init_state(F0)
        if tel is not None:
            # the memory model against the live tensors (a `memory_drift`
            # anomaly past its band)
            model.memory_reconcile(state0)
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

        def run_quality():
            from bigclam_tpu_torch.models import quality

            if args.device_annealing:
                # --checkpoint-dir wires REPAIR-ROUND checkpoints here;
                # cycle checkpoints are a host-loop feature
                return quality.fit_quality_device(
                    model, F0, callback=callback, checkpoints=ckpt,
                    resume=resume)
            return quality.fit_quality(
                model, F0, callback=callback, checkpoints=ckpt,
                resume=resume)

        with prof.stage("fit"), capture(args.profile_dir):
            t0 = time.perf_counter()
            # the supervisor retries transient-classified failures: each
            # retried attempt re-enters the fit WITH the checkpoints, so a
            # retry resumes instead of restarting
            if cfg.quality_mode:
                state = sup.run_fit(run_quality)
                res = state.fit
            else:
                state, llh, iters, hist = sup.run_fit(
                    lambda: model.fit_state(state0, callback,
                                            checkpoints=ckpt, resume=resume)
                )
                with trace.span("fit_loop/extract_F"):
                    F = model.extract_F(state)
                res = FitResult(F=F, sumF=F.sum(axis=0), llh=llh,
                                num_iters=iters, llh_history=hist)
            # the full-fit cost baseline `cli refit` prices against
            fit_wall_s = round(time.perf_counter() - t0, 4)
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
        if hasattr(model, "comm_mode"):
            out["sparse_comm"] = model.comm_mode
            out["sparse_comm_cap"] = model.comm_cap
    if args.mesh or args.distributed:
        out["mesh"] = model.mesh.label()
    stamp_partition(out, cfg, model)
    stamp_models(out, model)
    if cfg.quality_mode:
        out["quality_cycles"] = state.num_cycles
        out["quality_total_iters"] = state.total_iters
        out["cycles_llh"] = [round(v, 2) for v in state.cycles_llh]
    # every rank holds res.F (fetched); rank 0 alone writes files
    if (args.out or args.save_f or args.publish_dir or args.export_gexf) \
            and is_primary():
        with prof.stage("extract"):
            if args.out:
                com = extraction.extract_community_arrays(res.F, g)
                extraction.write_communities(args.out, com)
                out["communities"] = len(com)
                out["out"] = args.out
            if args.publish_dir:
                publish_fit(args, cfg, g, res, out, fit_wall_s, tel)
            if args.save_f:
                np.save(args.save_f, res.F)
                out["save_f"] = args.save_f
            if args.export_gexf:
                from bigclam_tpu_torch.utils.viz import export_gexf

                # res.F is the fit's F, already fetched to the host; the
                # writer indexes nodes by row, so the members are rows (the
                # JAX CLI passes raw ids, which index past the rows of a
                # graph whose raw ids are not 0..n-1)
                delta = extraction.delta_threshold(g.num_nodes, g.num_edges)
                nodes, comms = np.nonzero(extraction.membership_mask(res.F, delta))
                rows = extraction._group_pairs(nodes, comms,
                                               np.arange(g.num_nodes))
                export_gexf(args.export_gexf, g, communities=rows, F=res.F)
                out["export_gexf"] = args.export_gexf
    if args.follow:
        # the continuous fit -> publish -> serve loop: per new edge file in
        # the delta directory, delta re-ingest -> warm-start refit ->
        # publish the next generation (preconditions checked before the fit)
        from bigclam_tpu_torch.models.refit import follow_deltas

        with prof.stage("follow"):
            out["follow"] = follow_deltas(
                args._store, cfg, res.F, args.publish_dir, args.follow,
                halo=args.refit_halo,
                max_rounds=args.refit_rounds,
                interval_s=args.follow_interval,
                max_deltas=args.follow_max,
                timeout_s=args.follow_timeout,
                quiet=args.quiet,
                device=args.device,
            )
    out["stage_seconds"] = dict(prof.seconds)
    if tel is not None:
        tel.set_final({k: v for k, v in out.items() if k != "llh_history"})
    return out, res, state


def sweep(args, callback=None) -> dict:
    """Run `sweep` for parsed arguments; callback(k, llh) after each K.
    Each K's {"k", "llh"} goes to the --metrics JSONL and, unless --quiet,
    to stderr (the JAX CLI's MetricsLogger). Returns the JSON-ready result
    dict."""
    tel = open_telemetry(args, "sweep")
    try:
        return _sweep(args, callback, tel)
    finally:
        close_telemetry(tel)


def _sweep(args, callback, tel) -> dict:
    from bigclam_tpu_torch.models.model_selection import sweep_k

    cfg = config_from_args(args)
    if args.quality:
        cfg = cfg.replace(quality_mode=True)
        if cfg.representation == "sparse":
            raise SystemExit(QUALITY_SPARSE_REFUSAL)
    g = load_graph(args)
    store = store_for_model(args, cfg)  # refuses --store-native without --mesh
    # the sweep seeds once, at K_max, with the same seeding config
    phi = baked_phi(args._store, cfg, args.seed_backend, args.quiet)
    from bigclam_tpu_torch.utils.metrics import MetricsLogger

    ml = MetricsLogger(args.metrics, echo=not args.quiet)

    def per_k(k, llh):
        ml.log({"k": k, "llh": llh})     # the telemetry's metric record too
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
            # each K's model through fit's factory: the mesh's with --mesh
            # (JAX `_make_model`), else the single device's
            model_factory=(
                (lambda c: make_mesh_model(g, c, args.device, args.mesh,
                                           args.schedule, args.balance, store=store,
                                           distributed=args.distributed))
                if args.mesh or args.distributed
                else (lambda c: make_model(g, c, args.device))
            ),
            callback=per_k,
            state_dir=args.checkpoint_dir,
            device_annealing=args.device_annealing,
            resume=args.resume != "never" or not first,
            seed_backend="auto" if args.seed_backend == "baked" else args.seed_backend,
            phi=phi,
        )

    from bigclam_tpu_torch.utils.profiling import trace as capture

    with ml, capture(args.profile_dir):
        res = sup.run_fit(attempt, site="sweep")
    out = {
        "chosen_k": res.chosen_k,
        "kset": res.kset,
        "llh_by_k": {str(k): v for k, v in res.llh_by_k.items()},
        "n": g.num_nodes,
        "edges": g.num_edges,
        "representation": cfg.representation,
    }
    if args.mesh:
        # the ledger's execution-shape key; each K builds its own model
        out["mesh"] = args.mesh.replace(",", "x")
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


def ingest(args) -> int:
    """Run `ingest` (JAX `cmd_ingest`): compile a SNAP edge list into a
    binary shard cache out of core, or with --delta append an edge file to
    an existing cache by rebuilding only the touched shards. A host stage:
    it touches no device. Prints one JSON line with the JAX entry's keys
    (the IngestProfile's stages, counts and RSS included)."""
    tel = open_telemetry(args, "ingest")
    try:
        return _ingest(args, tel)
    finally:
        close_telemetry(tel)


def _ingest(args, tel) -> int:
    from bigclam_tpu_torch.graph.store import (
        GraphStore,
        compile_graph_cache,
        is_cache_dir,
    )
    from bigclam_tpu_torch.utils.profiling import IngestProfile

    if args.delta:
        if not is_cache_dir(args.cache_dir):
            print(f"error: --delta needs an existing compiled cache at "
                  f"{args.cache_dir} (run a full ingest first)",
                  file=sys.stderr)
            return 1
        store = GraphStore.open(args.cache_dir)
        prof = IngestProfile()
        try:
            info = store.apply_delta(args.delta,
                                     seed_rebake=not args.no_seed_bake,
                                     profile=prof)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        out = {
            "cache_dir": args.cache_dir,
            "delta": info["delta_path"],
            "delta_seq": info["delta_seq"],
            "edges_added": info["edges_added"],
            "edges": info["num_directed_edges"] // 2,
            "touched_shards": info["touched_shards"],
            "touched_rows": int(info["touched_rows"].size),
            "touched_frac": info["touched_frac"],
            "phi_rebaked_shards": info["phi_rebaked_shards"],
            "files_read": list(info["files_read"]),
            "seconds": info["seconds"],
            **prof.report(),
        }
    else:
        if not args.graph:
            print("error: a full ingest needs --graph (pass --delta to "
                  "append to an existing cache instead)", file=sys.stderr)
            return 1
        if is_cache_dir(args.cache_dir) and not args.overwrite:
            print(f"{args.cache_dir}: already compiled (use --overwrite to "
                  "rebuild, or --delta to append an edge file)",
                  file=sys.stderr)
            return 1
        if args.balance:
            # imported before the profile's RSS baseline, so the reported
            # delta measures the streaming build, not the import
            import bigclam_tpu_torch.parallel.balance  # noqa: F401
        prof = IngestProfile()
        store = compile_graph_cache(
            args.graph, args.cache_dir, num_shards=args.shards,
            chunk_bytes=args.chunk_bytes, workers=args.workers,
            balance=args.balance, overwrite=args.overwrite, profile=prof,
            seed_bake=not args.no_seed_bake, seed_cap=args.seed_cap,
            seed=args.seed, closure_bake=not args.no_closure_bake,
            closure_cap=max(args.closure_cap or 0, 0),
        )
        out = {
            "cache_dir": args.cache_dir,
            "n": store.num_nodes,
            "edges": store.num_directed_edges // 2,
            "shards": store.num_shards,
            "balanced": store.balanced,
            # from the manifest, not the flag: the work guard can skip an
            # uncapped bake on hub-heavy graphs
            "seed_baked": store.manifest.get("seed_scores", {}).get(
                "baked", False),
            "closure_baked": store.manifest.get("closure", {}).get(
                "baked", False),
            "chunk_bytes": args.chunk_bytes,
            **prof.report(),
        }
    if tel is not None:
        tel.set_final(out)
    print(json.dumps(out))
    return 0


def profile(args) -> dict:
    """Run `profile`: N steps under a torch.profiler capture, each in a
    step annotation and a span, their timings into the telemetry and the
    metrics like a fit's. Returns the JSON-ready result dict (the JAX keys
    plus `top_kernels`, the captured device kernels by time)."""
    if args.steps < 1:
        raise SystemExit("error: profile --steps must be >= 1")
    tel = open_telemetry(args, "profile")
    try:
        return _profile(args, tel)
    finally:
        close_telemetry(tel)


def _profile(args, tel) -> dict:
    import statistics

    import torch

    from bigclam_tpu_torch.obs import trace as obs_trace
    from bigclam_tpu_torch.utils.metrics import MetricsLogger
    from bigclam_tpu_torch.utils.profiling import StageProfile, trace

    if tel is None:
        print(
            "warning: profile without --telemetry-dir captures step "
            "annotations only — span names need a telemetry run to "
            "attach to, and no per-step timings land anywhere",
            file=sys.stderr,
        )
    cfg = config_from_args(args).replace(max_iters=args.steps, conv_tol=0.0)
    prof = StageProfile()
    with prof.stage("graph_load"):
        g = load_graph(args)
    with prof.stage("model_build"):
        model = build_model(g, cfg, args)
    with prof.stage("seeding"):
        F0 = init_F(g, cfg, args.init, args.seed_backend, args.device,
                    store=args._store, quiet=args.quiet)
    pdir = args.profile_dir or (
        os.path.join(args.telemetry_dir, "profile")
        if args.telemetry_dir else "bigclam_profile"
    )
    mesh = getattr(model, "mesh", None)
    state = model.init_state(F0)

    def sync():
        if model.device.type == "cuda":
            torch.cuda.synchronize()

    with prof.stage("warmup"):
        for _ in range(max(args.warmup, 0)):
            state = model._step(state)
        sync()
    times = []
    with MetricsLogger(args.metrics, echo=not args.quiet) as ml:
        cb = ml.step_callback(
            g.num_directed_edges, chips=mesh.size if mesh is not None else 1,
            path=model.engaged_path, num_nodes=g.num_nodes,
        )
        with prof.stage("profiled_steps"), trace(pdir) as cap:
            for i in range(args.steps):
                t0 = time.perf_counter()
                with obs_trace.step_annotation(i), obs_trace.span(
                    "step", emit=False
                ):
                    state = model._step(state)
                    sync()
                times.append(time.perf_counter() - t0)
                cb(i, float(state.llh))
    out = {
        "steps": args.steps,
        "warmup": args.warmup,
        "sec_per_step_p50": round(statistics.median(times), 6),
        "sec_per_step_min": round(min(times), 6),
        "profile_dir": pdir,
        "path": model.engaged_path,
        "kernel_path": model.engaged_path,
        "n": g.num_nodes,
        "edges": g.num_edges,
        "k": cfg.num_communities,
        "representation": cfg.representation,
        "partition": cfg.partition,
    }
    if mesh is not None:
        out["mesh"] = mesh.label()
    stamp_partition(out, cfg, model)
    stamp_models(out, model)
    out["top_kernels"] = cap.kernels[:PROFILE_TOP]
    out["device_kind"] = _device_kind(model)
    if tel is not None:
        tel.set_final({k: v for k, v in out.items() if k != "top_kernels"})
    return out


def _device_kind(model) -> str:
    from bigclam_tpu_torch.utils.device import device_kind

    return device_kind(model.device)


def perf(args) -> int:
    """Perf-ledger tooling (obs.ledger): `record` appends a record built
    from a finished telemetry dir, `diff` gates the latest run against its
    matched baseline (exit 2 on regression, 1 on missing data), `show`
    lists recent records."""
    from bigclam_tpu_torch.obs import ledger as L

    if args.action == "record":
        try:
            rec = L.record_from_dir(args.telemetry_dir, note=args.note)
        except (OSError, ValueError) as e:
            print(f"perf record: {e}", file=sys.stderr)
            return 1
        errors = L.validate_record(rec)
        if errors:
            print(f"invalid record: {errors}", file=sys.stderr)
            return 1
        L.PerfLedger(args.ledger).append(rec)
        print(json.dumps(rec, sort_keys=True))
        return 0

    led = L.PerfLedger(args.ledger)
    recs = led.load()
    if led.load_errors:
        print(f"note: {led.load_errors} unparsable ledger line(s) skipped",
              file=sys.stderr)
    if args.action == "show":
        for rec in recs[-args.n:]:
            print(json.dumps(rec, sort_keys=True))
        if not recs:
            print(f"{args.ledger}: no records", file=sys.stderr)
        return 0
    if not recs:
        print(f"{args.ledger}: no records to diff", file=sys.stderr)
        return 1
    new = led.latest(recs, run=args.run)
    if new is None:
        print(f"run {args.run!r} not found in {args.ledger}", file=sys.stderr)
        return 1
    base = led.baseline_for(new, recs)
    if base is None:
        print(
            f"no matched baseline for run {new.get('run')} "
            f"(entry={new.get('entry')}, cfg={new.get('cfg_digest')}, "
            f"backend={new.get('backend')}, host={new.get('host')})",
            file=sys.stderr,
        )
        return 1
    d = L.diff_records(base, new, tolerance=args.tolerance)
    print(L.render_diff(d))
    return 2 if d["regression"] else 0


def report(args) -> int:
    """Render a telemetry directory (obs.report); --json for the
    machine-readable merge, --fleet for a fleet root. Exit 1 when
    artifacts are missing or invalid."""
    from bigclam_tpu_torch.obs import report as R

    if args.fleet:
        if args.json:
            obj, errors = R.render_fleet_json(args.dir)
            print(json.dumps(obj, sort_keys=True))
            return 1 if errors else 0
        text, errors = R.render_fleet(args.dir)
    elif args.json:
        obj, errors = R.render_json(args.dir)
        print(json.dumps(obj, sort_keys=True))
        return 1 if errors else 0
    else:
        text, errors = R.render(args.dir)
    print(text)
    if errors:
        print(f"\n{errors} problem(s) found", file=sys.stderr)
    return 1 if errors else 0


def watch(args) -> int:
    """Live-tail a telemetry directory (obs.watch), or a fleet root."""
    from bigclam_tpu_torch.obs import watch as W

    fn = W.watch_fleet if args.fleet else W.watch
    return fn(args.dir, interval=args.interval, once=args.once,
              width=args.width)


def preflight(args) -> int:
    """Capacity preflight (obs.memory.preflight) from workload numbers,
    without a card. Exit 0 fits, 2 does not fit, 1 bad input or a
    configuration the port does not run (named as the JAX preflight names
    it)."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.obs import memory as M

    from bigclam_tpu_torch.graph.store import GraphStore, is_cache_dir

    if args.store_native and not args.mesh:
        print("error: not ported yet: --store-native: the store trainers run "
              "on a mesh (pass --mesh DP,1)", file=sys.stderr)
        return 1
    notes = []
    shard_counts = None
    closure_pairs = None
    cache_shards = 0
    if args.graph and is_cache_dir(args.graph):
        # the exact numbers of the cache's manifest, no blob read
        w = GraphStore.open(args.graph).workload()
        n = args.nodes or w["n"]
        directed = 2 * args.edges if args.edges else w["directed_edges"]
        shard_counts = w["shard_edge_counts"]
        cache_shards = w["num_shards"]
        # baked closure pair counts: exact 2D closure pricing
        cl = w.get("closure") or {}
        if cl.get("baked"):
            closure_pairs = cl.get("pair_counts")
    elif args.graph:
        if not os.path.isfile(args.graph):
            print(f"error: --graph {args.graph}: no such file or cache dir",
                  file=sys.stderr)
            return 1
        if not args.nodes:
            print("error: a text --graph carries no manifest — pass --nodes "
                  "(and ideally --edges), or `cli ingest` it first and "
                  "preflight the cache", file=sys.stderr)
            return 1
        n = args.nodes
        if args.edges:
            directed = 2 * args.edges
        else:
            directed = 2 * max(os.path.getsize(args.graph) // 13, 1)
            notes.append("edge count estimated from file size (~13 B/line); "
                         "pass --edges or preflight a compiled cache for "
                         "exact numbers")
    elif args.nodes and args.edges:
        n = args.nodes
        directed = 2 * args.edges
    else:
        print("error: pass --nodes and --edges (or a text --graph with "
              "--nodes, or a cache dir)", file=sys.stderr)
        return 1
    if args.serve:
        return serve_preflight(args, n, directed, notes)
    if args.mesh:
        dp, tp = parse_mesh(args.mesh)
    else:
        dp, tp = max(args.devices, 1), 1
    if closure_pairs is not None and len(closure_pairs) != dp:
        # pair counts are per cache shard: exact only when the shard grid
        # is the trainer's (the 2D trainers require that)
        closure_pairs = None
    if shard_counts:
        # the cache's per-shard counts summed into the trainer's dp groups
        # of contiguous shards (dp = 1: one device holds every shard)
        if len(shard_counts) % dp == 0:
            per = len(shard_counts) // dp
            shard_counts = [sum(shard_counts[i * per:(i + 1) * per])
                            for i in range(dp)]
        else:
            notes.append(
                f"cache has {len(shard_counts)} shards, not divisible by "
                f"dp={dp}: per-shard counts estimated (recompile with "
                f"--shards {dp} for exact geometry)")
            shard_counts = None
    if args.store_native and cache_shards != dp:
        notes.append(f"--store-native trains from a cache of exactly dp={dp} "
                     f"shards (`cli ingest --shards {dp}`)")
    hbm = 0.0
    if args.hbm_bytes:
        hbm = float(args.hbm_bytes)
    elif args.hbm_gb:
        hbm = float(args.hbm_gb) * (1 << 30)
    elif args.device_kind:
        try:
            hbm = float(M.device_hbm_bytes(args.device_kind))
        except KeyError:
            print(
                f"error: --device-kind {args.device_kind!r} is not in the "
                f"port's table ({sorted(M.DEVICE_HBM_BYTES)}); pass --hbm-gb "
                "or --hbm-bytes",
                file=sys.stderr,
            )
            return 1
    host_ram = float(args.host_ram_gb) * (1 << 30) if args.host_ram_gb else 0.0
    try:
        p = M.preflight(
            n, directed, args.k, dp=dp, tp=tp,
            itemsize=8 if args.dtype == "float64" else 4,
            num_candidates=args.max_backtracks + 1,
            representation=args.representation, sparse_m=args.sparse_m,
            support_every=args.support_every, schedule=args.schedule,
            health_every=max(args.health_every or 0, 0),
            edge_chunk=args.edge_chunk or BigClamConfig.edge_chunk,
            device_hbm_bytes=hbm, host_ram_bytes=host_ram,
            processes=max(args.processes, 1), chunk_bytes=args.chunk_bytes,
            shard_edge_counts=shard_counts, store_native=args.store_native,
            partition=args.partition,
            replica_cols=max(args.replica_cols or 1, 1),
            closure_pair_counts=closure_pairs,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    p["notes"] = notes + p["notes"]
    if args.json:
        print(json.dumps(p, sort_keys=True))
    else:
        print(M.render_preflight(p))
    return 0 if p["fits"] else 2


def parse_query_spec(spec: str) -> dict:
    """--query shorthand: 'communities_of:12', 'members_of:3',
    'suggest_for:12' — or a raw JSON object for anything richer
    (explicit-neighbour suggests). The JAX CLI's `_parse_query_spec`."""
    spec = spec.strip()
    if spec.startswith("{"):
        try:
            return json.loads(spec)
        except ValueError as e:
            raise SystemExit(f"error: --query {spec!r}: not JSON ({e})")
    fam, _, arg = spec.partition(":")
    keys = {"communities_of": "u", "members_of": "c", "suggest_for": "u"}
    if fam not in keys:
        raise SystemExit(
            f"error: --query {spec!r}: family must be one of "
            "communities_of/members_of/suggest_for (or pass a JSON object)"
        )
    try:
        return {"family": fam, keys[fam]: int(arg)}
    except ValueError:
        raise SystemExit(
            f"error: --query {spec!r}: {keys[fam]!r} must be an integer "
            f"(got {arg!r})"
        )


def serve(args) -> int:
    """Run `serve` for parsed arguments (exit 1 when any query errored)."""
    tel = open_telemetry(args, "serve")
    try:
        return _serve(args, tel)
    finally:
        close_telemetry(tel)


def _serve(args, tel=None) -> int:
    """Membership serving (JAX `cmd_serve`): answer the three query
    families from a published snapshot through the request batcher, the
    suggest family's fold-in on --device, and print the serving stats
    JSON (p50/p99 latency, QPS, cache hit rate), stamped into the
    telemetry final so `cli perf diff` verdicts serve p99."""
    from bigclam_tpu_torch.graph.store import GraphStore, is_cache_dir
    from bigclam_tpu_torch.serve.server import MembershipServer
    from bigclam_tpu_torch.serve.snapshot import SnapshotError
    from bigclam_tpu_torch.utils.device import resolve_device
    from bigclam_tpu_torch.utils.profiling import StageProfile

    if bool(args.snapshots) == bool(args.fleet):
        print(
            "error: serve needs exactly one of --snapshots (single-"
            "process) or --fleet (shard-replica mode)",
            file=sys.stderr,
        )
        return 1
    if args.fleet:
        return serve_fleet_replica(args, tel)
    # no card raises DeviceUnavailableError here, before anything loads
    device = resolve_device(args.device)
    prof = StageProfile()
    store = graph = None
    if args.graph:
        with prof.stage("graph_load"):
            if is_cache_dir(args.graph):
                # ALWAYS read-only: with the delta pipeline mutating the
                # cache live, a crc mismatch here is usually a half-applied
                # delta seen through a stale manifest, and a "heal" would
                # rebuild the PRE-delta blobs over the writer's work
                store = GraphStore.open(args.graph, self_heal=False)
            else:
                from bigclam_tpu_torch.graph import build_graph

                graph = build_graph(args.graph)
    queries = [parse_query_spec(q) for q in (args.query or [])]
    if args.queries:
        with open(args.queries) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    queries.append(json.loads(line))
                except ValueError as e:
                    print(f"error: {args.queries}:{lineno}: not JSON ({e})",
                          file=sys.stderr)
                    return 1
    if not queries:
        print("error: nothing to serve — pass --query and/or --queries",
              file=sys.stderr)
        return 1
    try:
        with prof.stage("snapshot_load"):
            server = MembershipServer(
                args.snapshots,
                store=store,
                graph=graph,
                max_batch=args.max_batch,
                budget_s=args.latency_budget_ms / 1e3,
                cache_slots=args.cache_slots,
                foldin_max_iters=args.foldin_max_iters,
                foldin_conv_tol=args.foldin_conv_tol,
                foldin_max_deg=args.foldin_max_deg,
                watch_interval_s=args.watch_snapshots,
                max_queue_depth=args.max_queue_depth,
                shed_wait_s=args.shed_wait_ms / 1e3,
                device=device,
            )
    except SnapshotError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    try:
        with prof.stage("serve"):
            results = []
            for _ in range(max(args.repeat, 1)):
                results = server.run_queries(queries)
        out = server.stats()
        out["snapshots"] = args.snapshots
        if args.results:
            with open(args.results, "w") as f:
                for r in results:
                    f.write(json.dumps(r) + "\n")
            out["results"] = args.results
        elif not args.quiet and len(queries) <= 16:
            # one-shot interactive use: the answers ARE the output
            for r in results:
                print(json.dumps(r))
    finally:
        server.close()
    if tel is not None:
        tel.set_final(out)
    print(json.dumps(out))
    return 1 if out.get("serve_errors") else 0


def serve_fleet_replica(args, tel=None) -> int:
    """One shard replica of a serving fleet (JAX
    `_cmd_serve_fleet_replica`): load this shard's rows of the latest
    fleet generation (`cli fit --publish-shards`) and answer the
    line-framed JSON sub-query protocol over TCP until a `stop` op or
    Ctrl-C; the suggest family folds in on --device.

        cli serve --fleet snaps/ --fleet-shard 0 --listen 127.0.0.1:0 \\
            --graph g.cache --max-queue-depth 256 --shed-wait-ms 50

    `cli route` is the client; N replicas of the same shard bind
    different ports and the router dispatches to the least loaded.
    --watch-snapshots polls for newer fleet generations (the replica
    holds the two newest; the router flips fleet-wide, barrier-free)."""
    from bigclam_tpu_torch.graph.store import GraphStore, is_cache_dir
    from bigclam_tpu_torch.resilience.faults import maybe_fire
    from bigclam_tpu_torch.serve.fleet import ReplicaServer, ShardReplica
    from bigclam_tpu_torch.serve.snapshot import SnapshotError

    if not args.listen:
        print("error: --fleet needs --listen HOST:PORT", file=sys.stderr)
        return 1
    # supervisor-tagged member id + the crash-loop fault site: firing
    # BEFORE the snapshot load means an injected kill here costs the
    # chaos drill milliseconds per respawn, not a full shard load
    member = os.environ.get("BIGCLAM_FLEET_MEMBER", "")
    maybe_fire("replica.start", member=member, shard=int(args.fleet_shard))
    host, _, port_s = args.listen.rpartition(":")
    try:
        port = int(port_s)
    except ValueError:
        print(f"error: --listen {args.listen!r}: port must be an integer",
              file=sys.stderr)
        return 1
    store = None
    if args.graph:
        if not is_cache_dir(args.graph):
            print(
                "error: --fleet replicas need a compiled cache --graph "
                "(suggest_for reads the shard's adjacency range from "
                "the store; text graphs have no ranges)",
                file=sys.stderr,
            )
            return 1
        # read-only, like every serving path
        store = GraphStore.open(args.graph, self_heal=False)
    try:
        # no card raises DeviceUnavailableError here, before the load
        replica = ShardReplica(
            args.fleet,
            args.fleet_shard,
            store=store,
            cache_slots=args.cache_slots,
            foldin_max_iters=args.foldin_max_iters,
            foldin_conv_tol=args.foldin_conv_tol,
            foldin_max_deg=args.foldin_max_deg,
            watch_interval_s=args.watch_snapshots,
            device=args.device,
        )
    except (SnapshotError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    server = ReplicaServer(
        replica,
        host=host or "127.0.0.1",
        port=port,
        max_batch=args.max_batch,
        budget_s=args.latency_budget_ms / 1e3,
        max_queue_depth=args.max_queue_depth,
        shed_wait_s=args.shed_wait_ms / 1e3,
    )
    # the bound endpoint, printed BEFORE serving starts: the launcher
    # reads this line to learn the port when --listen ended in :0
    print(json.dumps({
        "listening": f"{server.host}:{server.port}",
        "shard": args.fleet_shard,
        "generations": replica.generations,
        "device": replica.device.type,
    }), flush=True)
    try:
        server.serve_until_stopped()
    except KeyboardInterrupt:
        pass
    out = replica.status()
    out["shed"] = server._batcher.shed
    out["depth_peak"] = server._batcher.depth_peak
    server.close()
    replica.close()
    if tel is not None:
        tel.set_final(out)
    print(json.dumps(out))
    return 1 if out.get("errors") else 0


def parse_endpoints(spec: str, timeout_s: float):
    """--endpoints 'host:port,host:port,...' -> TcpReplica transports."""
    from bigclam_tpu_torch.serve.router import TcpReplica

    out = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        host, _, port_s = item.rpartition(":")
        try:
            port = int(port_s)
        except ValueError:
            raise SystemExit(f"error: --endpoints {item!r}: expected HOST:PORT")
        out.append(TcpReplica(host or "127.0.0.1", port, timeout_s=timeout_s))
    if not out:
        raise SystemExit("error: --endpoints named no endpoints")
    return out


def route(args) -> int:
    """Run `route` for parsed arguments."""
    tel = open_telemetry(args, "route")
    try:
        return _route(args, tel)
    finally:
        close_telemetry(tel)


def _route(args, tel=None) -> int:
    """The fleet query router (JAX `_cmd_route`): route the three query
    families over a sharded replica fleet.

        cli route --fleet snaps/ \\
            --endpoints 127.0.0.1:7001,127.0.0.1:7002 \\
            --queries load.jsonl --results answers.jsonl

    communities_of / suggest_for go to their node's shard (least-loaded
    healthy replica); members_of scatter-gathers every shard and merges
    under the sorted-by-raw-id contract. Every query is pinned to the
    fleet-wide serving generation, so a mid-stream publication flips the
    whole fleet at once. Stats carry the `cli serve` serve_* keys plus
    per-shard latency tables. --stop sends a stop op to every endpoint
    instead (fleet teardown); --members follows a supervisor's
    membership file; --daemon serves route() itself over the replica
    wire; --deadline-s / --retry-rounds / --hedge are the per-query
    failure budget."""
    from bigclam_tpu_torch.serve.router import FleetRouter, RouterError

    members = args.members
    endpoints = []
    if args.endpoints:
        endpoints = parse_endpoints(args.endpoints, args.request_timeout_s)
    elif not members:
        print("error: route needs --endpoints and/or --members",
              file=sys.stderr)
        return 1
    if args.stop:
        # teardown is idempotent: an endpoint that is ALREADY gone is a
        # success for the operator's goal — note it, keep tearing down
        # the survivors, exit 0
        stopped = already_down = 0
        for t in endpoints:
            try:
                t.request({"family": "stop"})
                stopped += 1
            except Exception as e:   # noqa: BLE001 — best-effort stop
                already_down += 1
                print(f"note: {t.host}:{t.port}: already down ({e})",
                      file=sys.stderr)
            t.close()
        print(json.dumps({"stopped": stopped, "already_down": already_down,
                          "of": len(endpoints)}))
        return 0
    queries = [parse_query_spec(q) for q in (args.query or [])]
    if args.queries:
        with open(args.queries) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    queries.append(json.loads(line))
                except ValueError as e:
                    print(f"error: {args.queries}:{lineno}: not JSON ({e})",
                          file=sys.stderr)
                    return 1
    if not queries and not args.daemon:
        print(
            "error: nothing to route — pass --query and/or --queries "
            "(or --daemon, or --stop)",
            file=sys.stderr,
        )
        return 1

    def make_router():
        return FleetRouter(
            args.fleet,
            endpoints,
            max_workers=args.max_workers,
            health_interval_s=args.health_interval_s,
            request_timeout_s=args.request_timeout_s,
            deadline_s=args.deadline_s,
            retry_rounds=args.retry_rounds,
            hedge=args.hedge,
            hedge_delay_s=args.hedge_delay_s,
            hedge_min_samples=args.hedge_min_samples,
            members_file=members,
        )

    router = None
    wait_deadline = time.monotonic() + max(args.wait_fleet_s, 0.0)
    while router is None:
        try:
            router = make_router()
        except RouterError as e:
            # with a membership file the fleet may still be COMING UP
            # (supervisor spawning replicas): bounded patience instead of
            # a start-order race
            if members and time.monotonic() < wait_deadline:
                time.sleep(0.25)
                continue
            print(f"error: {e}", file=sys.stderr)
            for t in endpoints:
                t.close()
            return 1
    if tel is not None:
        # the stall heartbeat runs ON the router process: stall events
        # carry the in-flight trace registry, so a wedged replica hop is
        # attributable from the stall line alone
        tel.open_traces = router.open_trace_count
        tel.oldest_inflight_s = router.oldest_inflight_s
    if args.daemon:
        from bigclam_tpu_torch.serve.router import RouterServer

        lhost, _, lport_s = (args.listen or "127.0.0.1:0").rpartition(":")
        try:
            lport = int(lport_s)
        except ValueError:
            print(f"error: --listen {args.listen!r}: port must be an integer",
                  file=sys.stderr)
            router.close()
            return 1
        server = RouterServer(router, host=lhost or "127.0.0.1", port=lport)
        # the bound endpoint, printed BEFORE serving (the replica hello
        # line's contract: launchers read it for a :0 port)
        print(json.dumps({"routing": f"{server.host}:{server.port}",
                          "fleet": args.fleet}), flush=True)
        try:
            server.serve_until_stopped()
        except KeyboardInterrupt:
            server.close()
        out = router.stats()
        out["fleet"] = args.fleet
        if tel is not None:
            tel.set_final(out)
        print(json.dumps(out))
        return 0
    try:
        results = []
        for _ in range(max(args.repeat, 1)):
            results = router.run_queries(queries)
        out = router.stats()
        out["fleet"] = args.fleet
        if args.results:
            with open(args.results, "w") as f:
                for r in results:
                    f.write(json.dumps(r) + "\n")
            out["results"] = args.results
        elif not args.quiet and len(queries) <= 16:
            for r in results:
                print(json.dumps(r))
    finally:
        router.close()
    if tel is not None:
        tel.set_final(out)
    print(json.dumps(out))
    return 1 if out.get("serve_errors") else 0


def fleet(args) -> int:
    """Run `fleet` for parsed arguments."""
    tel = open_telemetry(args, "fleet")
    try:
        return _fleet(args, tel)
    finally:
        close_telemetry(tel)


def _fleet(args, tel=None) -> int:
    """The self-healing fleet supervisor (JAX `_cmd_fleet`): own the
    replica processes of a serving fleet — restart-on-exit with
    RetryPolicy backoff, crash-loop quarantine, elastic membership
    published to a watched members file the router reconciles. Each
    replica is `bigclam_tpu_torch.cli serve --fleet` on --device.

        cli fleet up --fleet snaps/ --shards 2 --replicas 2 \\
            --members members.json
        cli fleet status --control 127.0.0.1:4444
        cli fleet add-replica --control ... --shard 0
        cli fleet drain --control ... --member s0r1
        cli fleet down --control ...

    `up` prints a hello line with the control endpoint + members path,
    then parks until a `down` op (or Ctrl-C)."""
    from bigclam_tpu_torch.resilience.retry import RetryPolicy
    from bigclam_tpu_torch.serve.supervise import FleetSupervisor, control_op

    if args.action == "up":
        if not args.fleet:
            print("error: fleet up needs --fleet DIR", file=sys.stderr)
            return 1
        members = args.members or os.path.join(args.fleet, "members.json")
        replica_args = []
        if args.replica_args:
            import shlex

            replica_args = shlex.split(args.replica_args)
        sup = FleetSupervisor(
            args.fleet,
            members,
            shards=args.shards,
            replicas=args.replicas,
            host=args.host,
            control_port=args.control_port,
            policy=RetryPolicy(
                base_s=args.restart_base_s,
                max_s=args.restart_max_s,
                seed=args.seed,
            ),
            quarantine_after=args.quarantine_after,
            stable_s=args.stable_s,
            drain_grace_s=args.drain_grace_s,
            replica_args=replica_args,
            graph=args.graph,
            watch_snapshots_s=args.watch_snapshots,
            log_dir=args.log_dir,
            seed=args.seed,
            device=args.device,
        )
        sup.up()
        all_up = sup.wait_all_up(timeout=args.up_timeout_s)
        st = sup.status()
        # the launcher contract (like the replica hello line): control
        # endpoint + members path on stdout BEFORE parking
        print(json.dumps({
            "control": st["control"],
            "members": members,
            "all_up": all_up,
            "fleet_members": [m["id"] for m in st["members"]],
        }), flush=True)
        try:
            sup.wait_down()
        except KeyboardInterrupt:
            sup.down()
        st = sup.status()
        out = {
            "replica_restarts": st["replica_restarts"],
            "quarantined": st["quarantined"],
            "fleet_members": {
                m["id"]: {"state": m["state"], "shard": m["shard"],
                          "restarts": m["restarts"]}
                for m in st["members"]
            },
        }
        if tel is not None:
            tel.set_final(out)
        print(json.dumps(out))
        return 0
    if args.action == "status" and not args.control and args.members:
        # offline roster: read the membership file directly (works even
        # with the supervisor gone)
        try:
            with open(args.members) as f:
                print(json.dumps(json.load(f)))
        except (OSError, ValueError) as e:
            print(f"error: {args.members}: {e}", file=sys.stderr)
            return 1
        return 0
    if not args.control:
        print(f"error: fleet {args.action} needs --control HOST:PORT "
              "(printed by `fleet up`)", file=sys.stderr)
        return 1
    op = {"op": args.action.replace("-", "_")}
    if args.action == "add-replica":
        op["shard"] = int(args.shard)
    if args.action == "drain":
        if not args.member:
            print("error: fleet drain needs --member ID", file=sys.stderr)
            return 1
        op["member"] = args.member
    try:
        res = control_op(args.control, op)
    except (OSError, ValueError, ConnectionError) as e:
        print(f"error: control {args.control}: {e}", file=sys.stderr)
        return 1
    print(json.dumps(res))
    if args.action == "drain" and not res.get("ok"):
        return 1
    return 0


def refit(args) -> int:
    """Run `refit` for parsed arguments."""
    tel = open_telemetry(args, "refit")
    try:
        return _refit(args, tel)
    finally:
        close_telemetry(tel)


def _refit(args, tel=None) -> int:
    """Warm-start incremental refit (JAX `cmd_refit`): start from the
    previous PUBLISHED F, re-optimize only the rows a delta touched (plus a
    halo of their neighbours) by batched fold-in on --device, and publish
    the result as the next snapshot generation. The health detectors watch
    the restricted objective; divergence or plateau escalates to a full
    fit (`--escalate never` publishes the refit F regardless)."""
    from bigclam_tpu_torch.models.refit import (
        touched_rows_from_delta,
        warm_start_refit,
    )
    from bigclam_tpu_torch.serve.snapshot import publish_snapshot
    from bigclam_tpu_torch.utils.checkpoint import CheckpointManager
    from bigclam_tpu_torch.utils.profiling import StageProfile

    if args.mesh or getattr(args, "distributed", False) or args.store_native:
        raise SystemExit(
            "error: refit is single-device for now — drop --mesh/"
            "--distributed/--store-native"
        )
    prof = StageProfile()
    with prof.stage("snapshot_load"):
        # the archive alone: the refit needs F, not the serving index that
        # ServingSnapshot.load builds (the same fallback past corrupt ones)
        got = CheckpointManager(args.snapshots).load_published()
    if got is None:
        print(f"error: {args.snapshots}: no published snapshot (fit with "
              "--publish-dir, or publish_snapshot())", file=sys.stderr)
        return 1
    step, arrays, meta = got
    sparse_snap = meta.get("representation", "dense") == "sparse"
    snap_k = int(meta.get("k") or (0 if sparse_snap else arrays["F"].shape[1]))
    snap_n = int(meta.get("n") or (arrays["ids"] if sparse_snap
                                   else arrays["F"]).shape[0])
    k = args.k or snap_k
    if k != snap_k:
        raise SystemExit(
            f"error: --k {k} does not match the published snapshot's "
            f"k={snap_k} (a refit continues the same model)"
        )
    args.k = k
    cfg = config_from_args(args)
    with prof.stage("graph_load"):
        g = load_graph(args)
    if g.num_nodes != snap_n:
        raise SystemExit(
            f"error: graph has {g.num_nodes} nodes but the snapshot was "
            f"published for {snap_n} — wrong graph/snapshot pair (deltas "
            "never grow N; re-ingest + full fit for new nodes)"
        )
    with prof.stage("model_build"):
        model = make_model(g, cfg, args.device)
    if sparse_snap:
        from bigclam_tpu_torch.ops.sparse_members import to_dense

        F_prev = to_dense(arrays["ids"], arrays["w"], snap_n, snap_k)
    else:
        F_prev = np.asarray(arrays["F"][:snap_n, :snap_k], np.float64)
    del arrays
    with prof.stage("touched"):
        touched = touched_rows_from_delta(g.raw_ids, args.delta)
    with prof.stage("refit"):
        res = warm_start_refit(
            model, F_prev, touched,
            halo=args.halo,
            max_rounds=args.refit_rounds,
            batch=args.refit_batch,
            foldin_max_iters=args.foldin_max_iters,
            conv_tol=cfg.conv_tol,
        )
    F_final = res.F
    total_wall = res.wall_s
    full_llh = None
    escalated_full = False
    if res.escalated and args.escalate == "full":
        print(
            f"[bigclam] refit escalated "
            f"({[a['check'] for a in res.anomalies]}): running a full fit "
            "warm-started from the refit F",
            file=sys.stderr,
        )
        t0 = time.perf_counter()
        with prof.stage("full_fit"):
            full = model.fit(res.F)
        total_wall = round(total_wall + time.perf_counter() - t0, 4)
        F_final = full.F
        full_llh = full.llh
        escalated_full = True
    base_wall = meta.get("fit_wall_s")
    ratio = (
        round(total_wall / float(base_wall), 6)
        if isinstance(base_wall, (int, float)) and base_wall
        and not isinstance(base_wall, bool)
        else None
    )
    out = {
        "n": g.num_nodes,
        "edges": g.num_edges,
        "k": k,
        "representation": cfg.representation,
        "from_generation": int(step),
        "touched": res.touched,
        "refit_nodes": res.refit_nodes,
        "touched_frac": res.touched_frac,
        "halo": res.halo,
        "rounds": res.rounds,
        "foldin_iters": res.foldin_iters,
        "converged": res.converged,
        "escalated": res.escalated,
        "escalated_full_fit": escalated_full,
        "refit_wall_s": total_wall,
        "baseline_fit_wall_s": base_wall,
        "refit_cost_ratio": ratio,
        "restricted_llh": res.llh,
        "kernel_path": model.engaged_path,
        "kernel_path_reason": model.path_reason,
    }
    if full_llh is not None:
        out["llh"] = full_llh
    if not args.no_publish:
        from bigclam_tpu_torch.utils.checkpoint import published_step_of

        with prof.stage("publish"):
            path = publish_snapshot(
                args.snapshots, step=None, F=F_final,
                raw_ids=g.raw_ids, num_edges=g.num_edges, cfg=cfg,
                meta={
                    "refit": True,
                    "seed": cfg.seed,
                    # the from-scratch cost baseline propagates through
                    # refit generations, so cost ratios keep meaning "vs a
                    # full fit", not "vs the last refit"
                    "fit_wall_s": base_wall,
                    "touched_frac": res.touched_frac,
                    "refit_rounds": res.rounds,
                    **({"llh": full_llh} if full_llh is not None else {}),
                },
            )
        out["published"] = path
        out["generation"] = published_step_of(path) if path else None
    if tel is not None:
        tel.set_final(out)
    print(json.dumps(out))
    return 0


def serve_preflight(args, n: int, directed: int, notes: list) -> int:
    """`preflight --serve` (the JAX CLI's branch): per-replica RSS
    (sparse-aware snapshot, inverted index, hot cache, adjacency slice) and
    fleet QPS capacity against --qps-target, priced on the host."""
    from bigclam_tpu_torch.obs import memory as M

    host_ram = float(args.host_ram_gb) * (1 << 30) if args.host_ram_gb else 0.0
    try:
        p = M.serve_preflight(
            n, directed, args.k,
            shards=args.serve_shards,
            replicas=args.serve_replicas,
            representation=args.representation,
            sparse_m=args.sparse_m,
            itemsize=8 if args.dtype == "float64" else 4,
            cache_slots=args.serve_cache_slots,
            avg_memberships=args.avg_memberships,
            qps_target=args.qps_target,
            qps_per_replica=args.qps_per_replica,
            host_ram_bytes=host_ram,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    p["notes"] = notes + p["notes"]
    if args.json:
        print(json.dumps(p, sort_keys=True))
    else:
        print(M.render_serve_preflight(p))
    return 0 if p["fits"] else 2


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command in ("perf", "report", "watch", "preflight", "ingest",
                        "serve", "route", "fleet", "refit"):
        return {"perf": perf, "report": report, "watch": watch,
                "preflight": preflight, "ingest": ingest, "serve": serve,
                "route": route, "fleet": fleet,
                "refit": refit}[args.command](args)
    from bigclam_tpu_torch.utils.profiling import NoDeviceKernelsError

    try:
        if args.command == "fit":
            out, _, _ = fit(args)
        elif args.command == "sweep":
            out = sweep(args)
        elif args.command == "profile":
            out = profile(args)
        else:
            out = evaluate(args)
    except NoDeviceKernelsError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        if getattr(args, "distributed", False):
            from bigclam_tpu_torch.parallel.multihost import shutdown_distributed

            shutdown_distributed()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
