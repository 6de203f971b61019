"""What the per-layer readers read of the program's own spans and counters:
the table of `bigclam_tpu_torch/obs/trace.py` (`totals()`), which holds the
spans and counters closed while the traced window's capture was live (the
program records them under any profiler capture; set-up runs before the
capture and leaves none). Each function returns None where it finds
nothing to read: a program without the table, or a table without the span
or counter."""

from __future__ import annotations

SYNC = "fit_loop/sync"


def table():
    """The program's table, read (it synchronizes the card once), or None."""
    try:
        from bigclam_tpu_torch.obs import trace
    except ImportError:
        return None
    totals = getattr(trace, "totals", None)
    return totals() if totals is not None else None


def rows(t: dict, name: str) -> list:
    """The table's rows of every path whose last names are `name`."""
    return [row for path, row in t["spans"].items()
            if path == name or path.endswith("/" + name)]


def iterations(t: dict) -> int:
    """The loop's iterations: closes of `fit_loop/sync`, one an LLH read
    (`models/bigclam.py` `run_fit_loop`)."""
    return sum(row["count"] for row in rows(t, SYNC))


def device_ms_per_iteration(name: str):
    """Device milliseconds of the spans named `name`, over the iterations."""
    t = table()
    if t is None:
        return None
    timed = [row["device_ms"] for row in rows(t, name) if row["device_ms"] is not None]
    its = iterations(t)
    if not timed or its <= 0:
        return None
    return sum(timed) / its


def counter(name: str):
    t = table()
    return None if t is None else t["counters"].get(name)
