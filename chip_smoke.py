#!/usr/bin/env python3
"""Drive the PyTorch port of BigCLAM (bigclam_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON line; any failure raises, so the script
exits non-zero:

  card      the card's name and power limit (nvidia-smi), torch and CUDA
  build     nvcc builds every kernel source under bigclam_tpu_torch/csrc/
            for sm_90a, one process per source, all started together,
            and links them into one library
  odd       each kernel against its plain PyTorch version on a small odd
            case (K=37, isolated nodes)
  graph     AGM planted N=300,000, K=1,000, p_in=0.1, numpy rng seed 1,
            written as a SNAP edge list to a temporary directory
  main      the port's `cli fit` entry on the CUDA device at full width on
            that file (`--graph`, text ingest included), conductance init,
            5 iterations; path `csr_fused`, launches counted from 0 around
            the fit
  split     the same graph and init with --csr-fused off (path `csr`),
            2 steps, launches counted from 0 around the fit
  full      each kernel against its plain version at the main path's
            shapes (the main fit's final F), and both timed with CUDA
            events: the median of 10 runs, taken as two rounds of 5
            after a warm-up each, in the order plain, kernel, kernel,
            plain
  parity    planted N=2,400, K=100: 5 steps on the card (f32 kernels)
            against the port's CPU `xla` path in float64

Then one `kernels` line (per kernel: launches on its path, error against
the plain version, kernel / plain time, the card's lower bound for the
same work) and, last, {"ok": true, "device": {...}}.

Tolerances: F_new, grad, node_llh and the candidate LLH at
rtol = atol = 3e-5 (relative errors are reported as |got - want| /
(|want| + 3e-5)) (the float32 band the JAX package holds its fused,
split and XLA paths to); the 0/1 acceptance mask must be equal except
where |cand - threshold| <= 1e-5 * max(1, |threshold|) (a near-tie that
another summation order may flip); F_new is compared on every row with the
plain selection and projection applied to the kernel's own mask. LLH
histories agree at rtol 1e-4.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM data sheet peaks: HBM3 bytes/s and float32 (non-tensor) FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
RTOL = ATOL = 3e-5
TIE = 1e-5
LLH_RTOL = 1e-4

DEVICE = "cuda"
FULL = dict(n=300_000, k=1000, p_in=0.1, seed=1)
ODD = dict(n=400, k=37, blocks=20, p_in=0.3, isolated=5, seed=3)
PARITY = dict(n=2400, k=100, p_in=0.3, seed=0)

KERNELS = {
    "fused_superstep": dict(
        source="bigclam_tpu_torch/csrc/fused_superstep.cu",
        replaces="bigclam_tpu/ops/pallas_fused.py:287",
        tpu_kernel="fused_superstep_csr",
    ),
    "grad_llh_csr": dict(
        source="bigclam_tpu_torch/csrc/grad_llh.cu",
        replaces="bigclam_tpu/ops/pallas_csr.py:333",
        tpu_kernel="grad_llh_csr",
    ),
    "candidates_csr": dict(
        source="bigclam_tpu_torch/csrc/candidates.cu",
        replaces="bigclam_tpu/ops/pallas_csr.py:409",
        tpu_kernel="candidates_csr",
    ),
}
NO_LIBRARY = (
    "no single PyTorch call computes this function (gather, clipped "
    "log-survival edge terms and per-node sums, and for the candidate "
    "kernels the 16-step Armijo ladder)"
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Check:
    """Accumulates the kernel-vs-plain comparison of one kernel."""

    def __init__(self, name: str):
        self.name = name
        self.max_abs = 0.0
        self.max_rel = 0.0
        self.parts = {}

    def close(self, what, got, want):
        got, want = got.double(), want.double()
        if got.numel() == 0:
            return
        err = (got - want).abs()
        excess = float((err - (ATOL + RTOL * want.abs())).max())
        abs_err = float(err.max())
        rel = float((err / (want.abs() + ATOL)).max())
        self.max_abs = max(self.max_abs, abs_err)
        self.max_rel = max(self.max_rel, rel)
        self.parts[what] = {"max_abs_err": abs_err, "max_rel_err": rel}
        if not (excess <= 0.0 and torch.isfinite(got).all()):
            raise AssertionError(
                f"{self.name}: {what} disagrees with the plain version "
                f"(max abs err {abs_err}, beyond tolerance by {excess})"
            )

    def ok_mask(self, ok_k, ok_p, cand, thr):
        """Acceptance masks equal except at near-ties."""
        diff = ok_k != ok_p
        tie = (cand - thr).abs() <= TIE * thr.abs().clamp_min(1.0)
        bad = int((diff & ~tie).sum())
        self.parts["ok"] = {"flips": int(diff.sum()), "flips_outside_ties": bad}
        if bad:
            raise AssertionError(
                f"{self.name}: {bad} acceptance decisions differ away from "
                "a near-tie"
            )


def compare_kernels(F, csr, cfg):
    """Run each kernel and its plain version on the same inputs and hold
    them to the tolerances. Returns {name: Check}."""
    from bigclam_tpu_torch.ops import csr_kernels as ck
    from bigclam_tpu_torch.ops import fused

    sumF = F.sum(dim=0)
    checks = {n: Check(n) for n in KERNELS}
    grad_p, llh_p, cand_p, thr_p = fused.acceptance_inputs_plain(F, sumF, csr, cfg)

    c = checks["grad_llh_csr"]
    grad_k, llh_k = ck.grad_llh_csr(F, sumF, csr, cfg)
    torch.cuda.synchronize()
    c.close("grad", grad_k, grad_p)
    c.close("node_llh", llh_k, llh_p)

    c = checks["candidates_csr"]
    cand_k = ck.candidates_csr(F, grad_p, sumF, csr, cfg)
    torch.cuda.synchronize()
    c.close("cand", cand_k, cand_p)

    c = checks["fused_superstep"]
    Fn_k, g_k, l_k, ok_k = fused.fused_superstep(F, sumF, csr, cfg)
    torch.cuda.synchronize()
    c.close("grad", g_k, grad_p)
    c.close("node_llh", l_k, llh_p)
    c.ok_mask(ok_k, cand_p >= thr_p, cand_p, thr_p)
    # every row: the plain selection and projection on the kernel's mask
    c.close("F_new", Fn_k, fused.project_accepted(F, grad_p, ok_k, cfg))
    return checks


def time_ms(fn, reps: int = 5) -> list:
    """CUDA-event times (ms) of `reps` runs of fn() after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def bounds(n: int, e: int, k: int, s: int) -> dict:
    """Least time the card could take for each kernel's work at these
    inputs: max(bytes moved once / HBM rate, float32 operations / FP32
    peak), counting what the function needs, not what a kernel recomputes.
    Counts use the live K columns. Per directed edge: the dot and the
    gradient accumulation are 4K operations (+3 for expm1, log and the
    division), and each candidate's dot nf_s . F_v is 2K (+2); nf_s =
    clip(F_u + eta_s g_u) depends on u alone. Per node: fold + tail 6K,
    building nf_s and its tail 6K per candidate, selection 6K."""
    f4 = 4.0 * n * k
    csr_bytes = 8.0 * (n + 1) + 4.0 * e + 4.0 * k
    grad_ops = e * (4.0 * k + 3) + n * 6.0 * k
    cand_ops = e * s * (2.0 * k + 2) + n * s * 6.0 * k
    work = {
        "grad_llh_csr": (f4 + csr_bytes + f4 + 4.0 * n, grad_ops),
        "candidates_csr": (2 * f4 + csr_bytes + 4.0 * s * n, cand_ops),
        "fused_superstep": (
            f4 + csr_bytes + 2 * f4 + 4.0 * n + 1.0 * s * n,
            grad_ops + cand_ops + n * 6.0 * k,
        ),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        tb, to = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
        out[name] = {
            "bound_ms": max(tb, to) * 1e3,
            "bound_by": "bytes" if tb >= to else "operations",
            "bytes": nbytes,
            "ops": ops,
        }
    return out


def phase_card() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    return {
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }


def phase_build() -> dict:
    from bigclam_tpu_torch.ops import build

    res = build.build()
    regs = {
        name: [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "properties for" in ln
        ]
        for name, log in res["logs"].items()
    }
    return {"build_s": res["seconds"], "cached": res["cached"], "ptxas": regs}


def odd_case():
    """Planted blocks plus isolated nodes at K=37 (not a multiple of 32),
    with an all-zero F row."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.graph.ingest import graph_from_edges
    from bigclam_tpu_torch.models.agm import sample_planted_graph

    o = ODD
    g0, _ = sample_planted_graph(
        o["n"], o["blocks"], p_in=o["p_in"], rng=np.random.default_rng(o["seed"])
    )
    pairs = np.stack([g0.src, g0.dst], axis=1)
    g = graph_from_edges(pairs, num_nodes=o["n"] + o["isolated"])
    F = np.random.default_rng(o["seed"] + 1).uniform(0.0, 1.0, (g.num_nodes, o["k"]))
    F[7] = 0.0
    cfg = BigClamConfig(num_communities=o["k"])
    dev = torch.device(DEVICE)
    return torch.as_tensor(F, dtype=torch.float32, device=dev), g.to_device(dev), cfg


def phase_odd() -> dict:
    F, csr, cfg = odd_case()
    checks = compare_kernels(F, csr, cfg)
    return {
        "n": int(F.shape[0]), "k": int(F.shape[1]),
        "kernels": {n: c.parts for n, c in checks.items()},
    }


def fit_args(extra):
    from bigclam_tpu_torch import cli

    return cli.build_parser().parse_args(["fit", *extra])


def planted_file(cfg, path):
    """Sample an AGM planted graph and write it to `path` as a SNAP edge
    list (each undirected edge once); returns the sampled Graph."""
    from bigclam_tpu_torch.models.agm import sample_planted_graph

    g, _ = sample_planted_graph(
        cfg["n"], cfg["k"], p_in=cfg["p_in"],
        rng=np.random.default_rng(cfg["seed"]),
    )
    np.savetxt(path, np.stack([g.src, g.dst], axis=1)[g.src < g.dst], fmt="%d")
    return g


def run_path(g, path, extra, tmp):
    """`cli fit --graph path` (g is the graph written there) with launch
    counters zeroed just before it and read just after."""
    from bigclam_tpu_torch import cli
    from bigclam_tpu_torch.ops import fused

    args = fit_args([
        "--graph", path, "--k", str(FULL["k"]), "--init", "conductance",
        "--conv-tol", "0", "--device", DEVICE,
        "--out", os.path.join(tmp, "communities.txt"), *extra,
    ])
    fused.reset_launch_counts()
    out, res = cli.fit(args)
    counts = fused.launch_counts()
    if (out["n"], out["edges"]) != (g.num_nodes, g.num_edges):
        raise AssertionError(
            f"ingest read {out['n']} nodes / {out['edges']} edges, the file "
            f"holds {g.num_nodes} / {g.num_edges}"
        )
    hist = out["llh_history"]
    if not all(math.isfinite(v) for v in hist):
        raise AssertionError(f"non-finite LLH in {hist}")
    if res.F.shape != (g.num_nodes, FULL["k"]) or not np.isfinite(res.F).all():
        raise AssertionError("fit returned a malformed F")
    return out, res, counts


def phase_main(g, path, tmp):
    out, res, counts = run_path(g, path, ["--max-iters", "5"], tmp)
    hist = out["llh_history"]
    if out["kernel_path"] != "csr_fused":
        raise AssertionError(f"main path ran {out['kernel_path']}")
    if counts["fused_superstep"] != out["steps"] or counts["fused_superstep"] < 1:
        raise AssertionError(f"fused kernel launches {counts} vs {out['steps']} steps")
    if not hist[-1] > hist[0]:
        raise AssertionError(f"LLH did not increase: {hist}")
    e = g.num_directed_edges
    return out, res, counts, {
        "kernel_path": out["kernel_path"],
        "llh_history": hist,
        "steps": out["steps"],
        "iters": out["iters"],
        "sec_per_iter": out["sec_per_iter"],
        "directed_edges_per_s": e / out["sec_per_iter"],
        "stage_seconds": out["stage_seconds"],
        "communities": out["communities"],
        "launches": counts,
        "n": g.num_nodes, "directed_edges": e, "k": FULL["k"],
        "max_degree": int(g.degrees.max()),
    }


def phase_split(g, path, tmp, main_hist):
    out, _, counts = run_path(
        g, path, ["--max-iters", "1", "--csr-fused", "off"], tmp
    )
    hist = out["llh_history"]
    if out["kernel_path"] != "csr":
        raise AssertionError(f"split path ran {out['kernel_path']}")
    if counts["grad_llh_csr"] < 2 or counts["candidates_csr"] < 2:
        raise AssertionError(f"split kernel launches {counts}")
    for a, b in zip(hist[:2], main_hist[:2]):
        if abs(a - b) > LLH_RTOL * abs(b):
            raise AssertionError(f"split LLH {hist} vs fused {main_hist}")
    return counts, {
        "kernel_path": out["kernel_path"], "llh_history": hist,
        "steps": out["steps"], "sec_per_iter": out["sec_per_iter"],
        "stage_seconds": out["stage_seconds"], "launches": counts,
    }


def phase_full(g, F_host):
    """Kernels vs plain at the main path's shapes, then timed."""
    from bigclam_tpu_torch.config import BigClamConfig
    from bigclam_tpu_torch.models.bigclam import BigClamModel
    from bigclam_tpu_torch.ops import csr_kernels as ck
    from bigclam_tpu_torch.ops import fused

    cfg = BigClamConfig(num_communities=FULL["k"])
    model = BigClamModel(g, cfg, device=DEVICE)
    F = model.init_state(F_host).F
    csr = model.csr
    checks = compare_kernels(F, csr, cfg)
    sumF = F.sum(dim=0)
    grad, _ = ck.grad_llh_csr_plain(F, sumF, csr, cfg)
    calls = {
        "fused_superstep": (
            lambda: fused.fused_superstep(F, sumF, csr, cfg),
            lambda: fused.fused_superstep_plain(F, sumF, csr, cfg),
        ),
        "grad_llh_csr": (
            lambda: ck.grad_llh_csr(F, sumF, csr, cfg),
            lambda: ck.grad_llh_csr_plain(F, sumF, csr, cfg),
        ),
        "candidates_csr": (
            lambda: ck.candidates_csr(F, grad, sumF, csr, cfg),
            lambda: ck.candidates_csr_plain(F, grad, sumF, csr, cfg),
        ),
    }
    times = {}
    for name, (kern, plain) in calls.items():
        # plain, kernel, kernel, plain: drift on the card hits both alike
        p = time_ms(plain)
        k = time_ms(kern) + time_ms(kern)
        p += time_ms(plain)
        times[name] = {"ms": statistics.median(k), "plain_ms": statistics.median(p),
                       "ms_runs": k, "plain_ms_runs": p}
    bnd = bounds(g.num_nodes, g.num_directed_edges, FULL["k"],
                 len(cfg.step_candidates))
    return checks, times, bnd, {
        "kernels": {
            n: {**checks[n].parts, **times[n], **bnd[n]} for n in KERNELS
        },
        "k_pad": int(F.shape[1]),
    }


def phase_parity(tmp) -> dict:
    from bigclam_tpu_torch import cli

    path = os.path.join(tmp, "parity_graph.txt")
    planted_file(PARITY, path)
    base = ["--graph", path, "--k", str(PARITY["k"]), "--max-iters", "4",
            "--conv-tol", "0"]
    gpu, _ = cli.fit(fit_args(base + ["--device", DEVICE]))
    cpu, _ = cli.fit(fit_args(base + ["--device", "cpu", "--dtype", "float64"]))
    if gpu["kernel_path"] != "csr_fused" or cpu["kernel_path"] != "xla":
        raise AssertionError((gpu["kernel_path"], cpu["kernel_path"]))
    a, b = gpu["llh_history"], cpu["llh_history"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    if len(a) != len(b) or rel > LLH_RTOL:
        raise AssertionError(f"card LLH {a} vs cpu float64 {b}")
    return {"gpu_llh": a, "cpu_f64_llh": b, "max_rel": rel,
            "n": gpu["n"], "edges": gpu["edges"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("error: no CUDA device is available", file=sys.stderr)
        return 1
    import bigclam_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_all = time.perf_counter()

    def run(name, fn, *a):
        t0 = time.perf_counter()
        res = fn(*a)
        body = res[-1] if isinstance(res, tuple) else res
        emit({"phase": name, "seconds": time.perf_counter() - t0, **body})
        return res

    run("card", phase_card)
    run("build", phase_build)
    run("odd", phase_odd)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = os.path.join(tmp, "full_graph.txt")
        g = planted_file(FULL, path)
        emit({"phase": "graph", "seconds": time.perf_counter() - t0,
              "n": g.num_nodes, "directed_edges": g.num_directed_edges})
        _, res, main_counts, _ = run("main", phase_main, g, path, tmp)
        split_counts, _ = run("split", phase_split, g, path, tmp,
                              list(res.llh_history))
        checks, times, bnd, _ = run("full", phase_full, g, res.F)
        del g, res
        run("parity", phase_parity, tmp)
    launches = {
        "fused_superstep": main_counts["fused_superstep"],
        "grad_llh_csr": split_counts["grad_llh_csr"],
        "candidates_csr": split_counts["candidates_csr"],
    }
    emit({"kernels": [
        {
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": launches[name],
            "max_abs_err": checks[name].max_abs,
            "max_rel_err": checks[name].max_rel,
            "ms": times[name]["ms"], "kernel_ms": times[name]["ms"],
            "plain_ms": times[name]["plain_ms"],
            "bound_ms": bnd[name]["bound_ms"],
            "bound_by": bnd[name]["bound_by"],
            "library_ms": None, "library_note": NO_LIBRARY,
        }
        for name in KERNELS
    ], "total_seconds": time.perf_counter() - t_all})
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
