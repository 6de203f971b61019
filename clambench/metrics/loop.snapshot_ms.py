"""loop.snapshot_ms: device milliseconds an iteration of the fit loop's
rollback snapshot: the span `fit_loop/snapshot` (`models/bigclam.py`
`run_fit_loop`: the clone of a fit's first verified state, then a refresh
in place every `rollback_snapshot_every` iterations; timed with CUDA
events on the state's stream) over the iterations of the traced window.
The other device-to-device copies of the window are the harness's fresh
state for each fit."""

from clambench import spans

MOVES = "edges_per_s"


def read(record):
    if not record.trace.device_ops:
        return None
    return spans.device_ms_per_iteration("fit_loop/snapshot")
