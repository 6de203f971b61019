"""The readings that set each comparison limit (not a benchmark run):

    python3 clambench/readings.py --workload <cell> --seeds 1,2,3 \
        [--control] [--faults frozen,half_rows,altered] [--detail] [--out FILE]

For every seed, in one process: the program's first iterations against
the reference (the lower readings), the reference in bfloat16 put in the
program's place (`--control`: the upper readings) and the program with
each planted fault (faults.py). One JSON line a seed and side.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from clambench import compare, faults, harness, registry  # noqa: E402


def detail(rep: str, prog: dict, ref: dict, k: int) -> dict:
    """Where the sampled rows differ most: the rows whose members of
    weight > 0 differ, and the row of the largest gap with both lists."""
    import numpy as np

    P, R = prog["state"], ref["state"]
    if rep != "sparse":
        gap = np.linalg.norm(P["rows"] - R["rows"], axis=1)
        i = int(np.argmax(gap))
        return {"worst_row_gap": float(gap[i]), "rows_gap_gt_1e-3": int((gap > 1e-3).sum())}
    rows_p = compare.densify(P["ids"], P["w"], k)
    rows_r = compare.densify(R["ids"], R["w"], k)
    gap = np.linalg.norm(rows_p - rows_r, axis=1)
    i = int(np.argmax(gap))
    held = lambda ids, w: [frozenset(int(c) for c, x in zip(a, b) if c < k and x > 0)
                           for a, b in zip(ids, w)]
    differ = sum(a != b for a, b in zip(held(P["ids"], P["w"]), held(R["ids"], R["w"])))
    pair = lambda ids, w: [[int(c), float(x)] for c, x in zip(ids[i], w[i]) if c < k]
    return {"rows_weighted_members_differ": int(differ), "worst_row_gap": float(gap[i]),
            "worst_row_prog": pair(P["ids"], P["w"]), "worst_row_ref": pair(R["ids"], R["w"])}


def side_readings(config: dict, mix: dict, seed: int, device, fault=None,
                  want_detail: bool = False) -> dict:
    cfg = harness.bigclam_config(config, device)
    s = harness.setup(config, mix, seed, device, fault)
    prog, pairs, n = s.prog, s.pairs, s.g.num_nodes
    del s
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = harness.reference_outputs(cfg.representation, pairs, config,
                                    harness.sample_rows(n, seed), len(prog["llh"]) - 1,
                                    torch.float64, device)
    vals = compare.readings(cfg.representation, prog, ref, cfg.num_communities, n)
    if want_detail:
        vals["detail"] = detail(cfg.representation, prog, ref, cfg.num_communities)
    return vals


def control_readings(config: dict, mix: dict, seed: int, device,
                     dtype=torch.bfloat16) -> dict:
    """The reference computed in `dtype` in the program's place."""
    from clambench import generate

    rep = config["bigclam"]["representation"]
    n, k = int(config["graph"]["nodes"]), int(config["bigclam"]["num_communities"])
    pairs = generate.make_pairs(config, mix, seed)
    rows = harness.sample_rows(n, seed)
    ref = harness.reference_outputs(rep, pairs, config, rows, harness.FIRST_STEPS,
                                    torch.float64, device)
    low = harness.reference_outputs(rep, pairs, config, rows, harness.FIRST_STEPS,
                                    dtype, device)
    return compare.readings(rep, low, ref, k, n)


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="")
    ap.add_argument("--sound", type=int, default=1)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--detail", action="store_true")
    args = ap.parse_args(argv)
    bench = registry.load_benchmark()
    cell = registry.workload(bench, args.workload)
    config = registry.config(bench, cell["config"])
    mix = registry.mix(cell["traffic"])
    device = torch.device(args.device)
    out = open(args.out, "a") if args.out else sys.stdout
    for seed in (int(s) for s in args.seeds.split(",")):
        sides = [("program", None)] if args.sound else []
        sides += [(name, faults.FAULTS[name]) for name in args.faults.split(",") if name]
        for name, fault in sides:
            t = time.perf_counter()
            vals = side_readings(config, mix, seed, device, fault, args.detail)
            print(json.dumps({"cell": cell["name"], "seed": seed, "side": name,
                              "seconds": time.perf_counter() - t, **vals}),
                  file=out, flush=True)
        if args.control:
            t = time.perf_counter()
            vals = control_readings(config, mix, seed, device)
            print(json.dumps({"cell": cell["name"], "seed": seed, "side": "control",
                              "seconds": time.perf_counter() - t, **vals}),
                  file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
