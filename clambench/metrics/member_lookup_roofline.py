"""member_lookup_roofline: the member-lookup kernels' share, in %, of
their roofline (`ops/sparse_members.py` -> csrc/member_lookup.cu): the
least time of a sweep over every directed edge (counts.py `member_bound`)
times the sweeps the traced window ran (launches over the program's edge
chunks a sweep), over the device time of those launches."""

import math

from clambench import counts

MOVES = "edges_per_s"
KERNEL = "member_lookup_"


def read(record):
    times = [b - a for name, a, b in record.trace.device_ops if KERNEL in name]
    f = record.facts
    if not times or f.m <= 0:
        return None
    sweeps = len(times) / math.ceil(f.e / f.edge_chunk)
    bound = counts.member_bound(f.n, f.e, f.m)["bound_ms"]
    return 100.0 * sweeps * bound / (sum(times) / 1e6)
