"""step.idle_share: the share, in %, of the traced window in which the card
idled while the host was inside the step's enqueue: the device-idle
stretches within the host ranges of the span `fit_loop/dispatch`
(`models/bigclam.py` `run_fit_loop`, a record_function under the capture),
over the window. The host blocks there where the step itself reads the
card (the sparse support update's syncs, `nonzero`, `index`), or is slower
to launch than the card to run."""

MOVES = "edges_per_s"
DISPATCH = "fit_loop/dispatch"


def read(record):
    tr = record.trace
    if not tr.device_ops or tr.window_s <= 0:
        return None
    t0, t1 = tr.window
    ranges = sorted((max(a, t0), min(b, t1)) for name, a, b in tr.host_ops
                    if name.endswith(DISPATCH) and b > t0 and a < t1)
    if not ranges:
        return None
    idle, j, total = tr.idle(), 0, 0
    for a, b in ranges:
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < b:
            total += min(b, idle[k][1]) - max(a, idle[k][0])
            k += 1
    return 100.0 * total / (t1 - t0)
