"""fused_superstep_roofline: the fused superstep kernel's share, in %, of
its roofline: the least time of one launch over the whole graph
(counts.py, `fused_superstep`) over the mean device time of its launches
in the traced window (`ops/fused.py` -> csrc/fused_superstep.cu)."""

from clambench import counts

MOVES = "edges_per_s"
KERNEL = "fused_superstep_kernel"


def read(record):
    times = [b - a for name, a, b in record.trace.device_ops if KERNEL in name]
    if not times:
        return None
    f = record.facts
    bound = counts.fused_superstep_bound(f.n, f.e, f.k, f.s)["bound_ms"]
    return 100.0 * bound / (sum(times) / len(times) / 1e6)
