"""step_mfu: the whole iteration's share, in %, of what the card could do:
the least time of one iteration's work (counts.py `dense_step` or
`sparse_step`: the larger of its float32 operations over the peak rate and
its bytes over the HBM rate) over the device's busy time an iteration in
the traced window (every device operation of the window, the fits' state
copies with them, over its iterations). It counts the same work whatever
implements it; the idle time between operations is device.idle_share's."""

from clambench import counts

MOVES = "edges_per_s"


def read(record):
    f, w, busy = record.facts, record.window, record.trace.busy_s
    if w["iterations"] <= 0 or busy <= 0:
        return None
    if f.representation == "sparse":
        least = counts.sparse_step(f.n, f.e, f.m, f.k, f.s)
    else:
        least = counts.dense_step(f.n, f.e, f.k, f.s)
    return 100.0 * least["bound_ms"] / (1e3 * busy / w["iterations"])
