"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

Set-up loads the program's kernel library first, in a step of its own
(`library_s` in the log: a checkout's first run builds it there, and
set-up counts that build, as it counts any compilation), then makes the
graph from the seed (generate.py), hands the pairs to the
program (`graph_from_edges`, then `conductance_seeds` on the host), builds
the model, makes the seeded state on the device and runs the first fit's
first iterations through the window's own call (`fit_state`, which runs
`run_fit_loop`), keeping what the comparison reads. The window then runs
fits back to back, each from a device copy of the seeded state to the
configuration's tolerance; the callback stamps each iteration when its LLH
reaches the host and ends the window at the deadline. After the window
the peak memory is read, the program's state freed, and the reference
recomputes the graph, the seeds and the same iterations from the same
pairs in float64 on the device.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import statistics
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.ingest import graph_from_edges
from bigclam_tpu_torch.ops import build
from bigclam_tpu_torch.ops.seeding import conductance_seeds
from clambench import compare, generate, registry, timeline
from clambench.reference import graph as rgraph
from clambench.reference import seeding as rseeding

# iterations of the first fit that the reference follows (run_fit_loop's
# max_iters: it evaluates FIRST_STEPS + 1 LLHs and updates)
FIRST_STEPS = 3
SAMPLE_ROWS = 1 << 16
FORBIDDEN = ("jax", "jaxlib", "flax", "bigclam_tpu")
CSRC = registry.REPO / "bigclam_tpu_torch" / "csrc"


class StopWindow(Exception):
    """The callback's way out of run_fit_loop at the window's deadline."""


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN)


def bigclam_config(config: dict, device: torch.device) -> BigClamConfig:
    cfg = BigClamConfig(**config["bigclam"])
    if device.type == "cpu" and config["bigclam"]["dtype"] == "float32":
        # the kernels' plain versions, on the path the card takes
        cfg = cfg.replace(use_pallas_csr=True, sparse_pallas_merge=True)
    return cfg


def sample_rows(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng([int(seed), 7])
    return np.sort(rng.choice(n, size=min(n, SAMPLE_ROWS), replace=False))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(config: dict, mix: dict, seed: int, device, step_fault=None):
    """Everything before the window. `step_fault` (tests and the limit
    readings only) wraps the program's train step."""
    times, tick = {}, time.perf_counter()

    def lap(name):
        nonlocal tick
        sync(device)
        now = time.perf_counter()
        times[name], tick = now - tick, now

    cfg = bigclam_config(config, device)
    if device.type == "cuda":
        # the kernel library: built by a checkout's first run, loaded after
        times["library_built"] = not build.library_path().exists()
        build.load_library()
        lap("library_s")
    n = int(config["graph"]["nodes"])
    pairs = generate.make_pairs(config, mix, seed)
    lap("generate_s")
    g = graph_from_edges(pairs, num_nodes=n)
    lap("graph_s")
    seeds = conductance_seeds(g, cfg, backend="numpy")
    lap("seeding_s")
    trainer = registry.trainer(cfg.representation).Trainer(g, cfg, device)
    state0 = trainer.seeded(seeds)
    lap("model_s")
    if step_fault is not None:
        trainer.model._step = step_fault(trainer.model._step)
    prog = first_steps(trainer, state0, cfg, sample_rows(n, seed))
    prog.update(seeds=np.asarray(seeds[:cfg.num_communities]),
                edges=g.num_directed_edges)
    lap("first_steps_s")
    return SimpleNamespace(cfg=cfg, pairs=pairs, g=g, trainer=trainer, state0=state0,
                           prog=prog, times=times)


def first_steps(trainer, state0, cfg: BigClamConfig, rows: np.ndarray) -> dict:
    """The first fit's first iterations through fit_state, with
    max_iters = FIRST_STEPS (a host-only field: the step is the window's):
    the LLH of each, the accepted-step histogram of each update, and the
    capture of the state it ends on. Padding rows (no edges, all zero)
    take no step: they are taken out of the histograms' last slot."""
    model, hists = trainer.model, []

    def cb(it, llh, extras):
        hists.append(np.asarray(extras["accept_hist"], np.int64))

    model.cfg = cfg.replace(max_iters=FIRST_STEPS)
    try:
        state, _, _, hist = model.fit_state(trainer.fresh(state0), cb, checkpoints=None)
    finally:
        model.cfg = cfg
    for h in hists:
        h[-1] -= trainer.padding_rows()
    cap = trainer.capture(state, state0, rows)
    return {"llh": [float(v) for v in hist], "hists": hists, "state": cap}


def window(trainer, state0, seconds: float, device, tracing: bool) -> dict:
    """Fits back to back for `seconds`: each iteration's end (its LLH on the
    host) stamped on the host clock; fits started and fits that ended on a
    non-finite LLH."""
    model = trainer.model
    stamps, fits, failed = [], 0, 0

    def mark():
        if tracing:
            with torch.profiler.record_function(timeline.MARK):
                pass

    def cb(it, llh):
        now = time.perf_counter()
        stamps.append(now)
        mark()
        if now >= deadline:
            raise StopWindow

    sync(device)
    stamps.append(time.perf_counter())
    mark()
    deadline = stamps[0] + seconds
    try:
        while True:
            fits += 1
            try:
                model.fit_state(trainer.fresh(state0), cb, checkpoints=None)
            except FloatingPointError:
                failed += 1
                if time.perf_counter() >= deadline:
                    break
    except StopWindow:
        pass
    sync(device)
    return {"stamps": stamps, "fits": fits, "failed": failed}


def reference_outputs(rep: str, pairs: np.ndarray, config: dict, rows: np.ndarray,
                      steps: int, dtype, device) -> dict:
    """The reference's seeds, graph size, and its own first iterations from
    its own seeded state: `steps` + 1 LLHs and histograms, and the capture
    after `steps` iterations (reference/<representation>.py `follow`)."""
    n, k = int(config["graph"]["nodes"]), int(config["bigclam"]["num_communities"])
    g = rgraph.build(pairs, n, device)
    seeds = rseeding.seeds(g)
    out = registry.reference(rep).follow(
        g, seeds, config["bigclam"], torch.as_tensor(rows, device=device), steps, dtype)
    out.update(seeds=seeds[:k].cpu().numpy(), edges=g.num_directed_edges)
    return out


def e2e_metrics(win: dict, edges: int, peak: int, setup_s: float) -> dict:
    st = win["stamps"]
    ms = [(b - a) * 1e3 for a, b in zip(st, st[1:])]
    secs = st[-1] - st[0]
    p90 = statistics.quantiles(ms, n=10, method="inclusive")[-1] if len(ms) > 1 else (
        ms[0] if ms else math.inf)
    return {"edges_per_s": len(ms) * edges / secs if secs > 0 else 0.0,
            "iter_ms_p90": p90, "peak_gb": peak / 1e9, "setup_s": setup_s}


def number(v: float) -> float:
    """A JSON number: infinity (a reading with nothing to compare) as 1e300."""
    return v if math.isfinite(v) else 1e300


def run(bench: dict, cell: dict, config: dict, mix: dict, limits: dict, seed: int,
        seconds: float, trace: bool, t0: float, device=None,
        step_fault=None) -> tuple:
    """One run of `cell` with its configuration, mix and limits: (the
    result line's object, its `checks` last; a log of the run's stages for
    standard error)."""
    device = torch.device(device or "cuda")
    cell_name = cell["name"]
    started = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    cuda_init = time.perf_counter()
    s = setup(config, mix, seed, device, step_fault)
    prof = None
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    setup_s = time.perf_counter() - t0
    try:
        win = window(s.trainer, s.state0, seconds, device, trace)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    cfg, g = s.cfg, s.g
    facts = SimpleNamespace(
        representation=cfg.representation, n=g.num_nodes, e=g.num_directed_edges,
        k=cfg.num_communities, m=getattr(s.trainer.model, "m", 0),
        s=len(cfg.step_candidates), edge_chunk=int(s.trainer.model.edges.chunk))
    prog, pairs, times = s.prog, s.pairs, s.times
    del s
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = reference_outputs(cfg.representation, pairs, config,
                            sample_rows(facts.n, seed), len(prog["llh"]) - 1,
                            torch.float64, device)
    values = compare.readings(cfg.representation, prog, ref, facts.k, facts.n)
    correct, checks = compare.judge(values, limits)
    log = dict(start_s=started - t0, cuda_init_s=cuda_init - started, **times,
               setup_s=setup_s, reference_s=time.perf_counter() - t_ref,
               iterations=len(win["stamps"]) - 1, fits=win["fits"])

    result = {"correct": bool(correct and win["failed"] == 0),
              "attempted": win["fits"], "failed": win["failed"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if trace:
        t_tr = time.perf_counter()
        tr = timeline.collect(prof)
        record = SimpleNamespace(
            facts=facts, setup=times, trace=tr,
            window={"seconds": tr.window_s, "iterations": len(tr.marks) - 1},
            is_port=timeline.port_kernel_matcher(timeline.port_kernel_names(CSRC)))
        metrics = {}
        for entry in registry.per_layer_for(bench, cell_name):
            value = registry.metric(entry["name"]).read(record)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": units[entry["name"]]}
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result.update(metrics=metrics, device=dev, breakdown=timeline.breakdown(tr))
        log["trace_read_s"] = time.perf_counter() - t_tr
    else:
        e2e = e2e_metrics(win, facts.e, peak, setup_s)
        result.update(metrics={name: {"value": v, "unit": units[name]}
                               for name, v in e2e.items()}, device=dev)
    result["checks"] = {name: {"value": number(v), "limit": number(lim)}
                        for name, v, lim in checks}
    return result, log


def main(argv: list, t0: float) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = registry.load_benchmark()
    chips = int(registry.workload(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"clambench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "available", file=sys.stderr)
        return 2
    cell = registry.workload(bench, args.workload)
    result, log = run(bench, cell, registry.config(bench, cell["config"]),
                      registry.mix(cell["traffic"]), registry.limits(cell["name"]),
                      args.seed, args.seconds, bool(args.trace), t0)
    bad = forbidden_modules()
    if bad:
        print("clambench: JAX or the JAX package was loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    print("clambench: " + json.dumps(log), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
