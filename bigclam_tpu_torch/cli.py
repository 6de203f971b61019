"""Command line of the PyTorch port: `fit`.

Port of the dense single-device `fit` of bigclam_tpu/cli.py: load a text
edge list, seed F by conductance (or a {0,1} random / row-keyed init),
train to convergence on the chosen device and kernel path, extract the
communities by the delta threshold, and print one JSON line with the
same keys as the JAX `fit` (`llh`, `iters`, `n`, `edges`, `k`,
`representation`, `kernel_path`, `kernel_path_reason`, `partition`) plus
`sec_per_iter`, `device_kind` and the LLH history.

    python -m bigclam_tpu_torch.cli fit --graph g.txt --k 100
    python -m bigclam_tpu_torch.cli fit --graph g.txt --k 100 --device cpu
    python -m bigclam_tpu_torch.cli fit --graph g.txt --k 3000   # csr_fused_kb
    python -m bigclam_tpu_torch.cli fit --graph g.txt --k 1000 \
        --representation sparse --sparse-m 64                  # sparse_merge_pallas

It runs on `cuda` unless `--device cpu` is given, and refuses to start
when no card is present. Above K = 1024 the model takes the K-blocked
path by itself (`kernel_path` in the JSON says which). `--representation
sparse` trains the top-M member lists of models.sparse instead of a dense
F, with the member-lookup CUDA kernel on the card (`sparse_xla`, the plain
lookup, on the CPU); its JSON adds `sparse_m`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bigclam_tpu_torch.cli",
        description="BigCLAM overlapping community detection (PyTorch/CUDA)",
    )
    sub = p.add_subparsers(dest="command", required=True)
    f = sub.add_parser("fit", help="train at a fixed K and extract communities")
    f.add_argument("--graph", required=True, help="SNAP edge-list path")
    f.add_argument("--k", type=int, required=True, help="number of communities")
    f.add_argument("--max-iters", type=int, default=1000)
    f.add_argument("--conv-tol", type=float, default=1e-4)
    f.add_argument("--seed", type=int, default=0)
    f.add_argument(
        "--init", default="conductance",
        choices=["conductance", "random", "rowkeyed"],
        help="F initialization: conductance seeding (the reference "
             "default), a {0,1} Bernoulli(0.5) random init, or the "
             "row-keyed counter init",
    )
    f.add_argument(
        "--csr-kernels", default="auto", choices=["auto", "on", "off"],
        help="CSR edge kernels (auto: on for cuda; on: require — on cpu "
             "their plain versions run; off: the plain torch `xla` path)",
    )
    f.add_argument(
        "--csr-fused", default="auto", choices=["auto", "off"],
        help="fused schedule (auto: wherever the CSR kernels engage — "
             "`csr_fused`, or `csr_fused_kb` above K=1024; off: the split "
             "schedule — `csr`, or `csr_grouped_kb` above K=1024)",
    )
    f.add_argument(
        "--representation", default="dense", choices=["dense", "sparse"],
        help="affiliation-state representation: dense (N, K) F (default) "
             "or sparse per-node top-M member lists (models/sparse.py) — "
             "device memory and bytes per edge scale with --sparse-m, not K",
    )
    f.add_argument(
        "--sparse-m", type=int, default=64,
        help="member slots per node on --representation sparse (M; "
             "clamped to K — M >= K reproduces the dense trajectory)",
    )
    f.add_argument(
        "--support-every", type=int, default=1,
        help="iterations between sparse support updates (candidate-"
             "community admission from neighbour lists; 1 = every step, "
             "required for dense parity)",
    )
    f.add_argument(
        "--dtype", default="float32", choices=["float32", "float64"],
        help="F dtype (float64 runs on cpu only)",
    )
    f.add_argument("--out", default=None, help="write communities (SNAP cmty)")
    f.add_argument(
        "--device", default="cuda", choices=["cuda", "cpu"],
        help="device to train on (default cuda; there is no silent CPU "
             "fallback)",
    )
    return p


def config_from_args(args):
    from bigclam_tpu_torch.config import BigClamConfig

    return BigClamConfig(
        num_communities=args.k,
        dtype=args.dtype,
        max_iters=args.max_iters,
        conv_tol=args.conv_tol,
        seed=args.seed,
        use_pallas_csr={"auto": None, "on": True, "off": False}[args.csr_kernels],
        csr_fused={"auto": None, "off": False}[args.csr_fused],
        representation=args.representation,
        sparse_m=args.sparse_m,
        support_every=args.support_every,
    )


def make_model(g, cfg, device):
    """The trainer of cfg.representation on `device`."""
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


def init_F(g, cfg, init: str) -> Optional[np.ndarray]:
    """Host F0 for `--init`; None for rowkeyed (the model generates it)."""
    from bigclam_tpu_torch.models.bigclam import random_init_F
    from bigclam_tpu_torch.ops import seeding

    if init == "rowkeyed":
        return None
    if init == "conductance":
        return seeding.init_F(g, seeding.conductance_seeds(g, cfg), cfg)
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
    model = make_model(g, cfg, args.device)
    stage("model_build")
    F0 = init_F(g, cfg, args.init)
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
    if args.out:
        com = extraction.extract_communities(res.F, g)
        extraction.save_communities(args.out, com)
        out["communities"] = len(com)
        out["out"] = args.out
        stage("extract")
    out["stage_seconds"] = stages
    return out, res, state


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "fit":
        out, _, _ = fit(args)
        print(json.dumps(out))
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
