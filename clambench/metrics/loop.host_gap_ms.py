"""loop.host_gap_ms: the mean device-idle gap at an iteration's end, in
ms: the idle stretch that holds the moment the LLH reached the host (or,
where the device was still busy then, the first one after it, before the
next iteration's end), from the profiler timeline. It is what the loop
(`models/bigclam.py` `run_fit_loop`: the LLH read, the convergence test,
the next step's launch in Python) costs between iterations."""

import bisect

MOVES = "edges_per_s"


def read(record):
    tr = record.trace
    if not tr.device_ops or len(tr.marks) < 3:
        return None
    gaps = tr.idle()
    starts = [a for a, _ in gaps]
    total, count = 0, 0
    for mark, nxt in zip(tr.marks[1:-1], tr.marks[2:]):
        i = bisect.bisect_right(starts, mark) - 1
        if i >= 0 and gaps[i][1] >= mark:
            a, b = gaps[i]
        elif i + 1 < len(gaps) and gaps[i + 1][0] < nxt:
            a, b = gaps[i + 1]
        else:
            a = b = 0
        total += b - a
        count += 1
    return total / count / 1e6
