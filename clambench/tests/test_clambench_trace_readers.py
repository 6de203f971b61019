"""The readers of the program's spans and counters (clambench/spans.py and
the seven metrics that read it) on a synthetic record: a Trace with host
ranges and device operations, and a filled table; None where the table or
the spans are missing."""

from types import SimpleNamespace

import pytest

from clambench import registry
from clambench.timeline import Trace

from bigclam_tpu_torch.obs import trace as ptrace

MS = 1_000_000           # ns

# a 100 ms window, two iterations; dispatch ranges 0-20 and 50-70 ms; the
# device busy 10-40 and 60-95 ms: idle 0-10, 40-60 and 95-100, of which
# 0-10 and 50-60 lie inside a dispatch
TRACE = Trace(
    device_ops=[("k", 10 * MS, 40 * MS), ("k", 60 * MS, 95 * MS)],
    host_ops=[("fit_loop/dispatch", 0, 20 * MS), ("fit_loop/sync", 20 * MS, 45 * MS),
              ("fit_loop/dispatch", 50 * MS, 70 * MS), ("aten::add", 55 * MS, 56 * MS)],
    marks=[0, 45 * MS, 100 * MS])

TABLE = {
    "spans": {
        "fit_loop/dispatch": {"host_s": 0.04, "device_ms": None, "count": 4},
        "fit_loop/sync": {"host_s": 0.05, "device_ms": None, "count": 4},
        "fit_loop/snapshot": {"host_s": 0.001, "device_ms": 6.0, "count": 2},
        "fit_loop/dispatch/support": {"host_s": 0.01, "device_ms": 8.0, "count": 4},
        "fit_loop/dispatch/sums": {"host_s": 0.01, "device_ms": 2.0, "count": 8},
        "fit_loop/dispatch/grad_sweep": {"host_s": 0.01, "device_ms": 12.0, "count": 4},
        "fit_loop/dispatch/cand_sweep": {"host_s": 0.01, "device_ms": 60.0, "count": 4},
        "fit_loop/dispatch/armijo": {"host_s": 0.01, "device_ms": 10.0, "count": 4},
    },
    "counters": {"step/rows": 4000, "step/rows_accepted": 1000},
    "orphans": 0,
}

WANT = {"step.idle_share": 20.0, "step.accept_share": 25.0, "loop.snapshot_ms": 1.5,
        "step.support_ms": 2.0, "step.grad_sweep_ms": 3.0, "step.cand_sweep_ms": 15.0,
        "step.armijo_ms": 2.5}


def _record(tr=TRACE):
    return SimpleNamespace(trace=tr, facts=None, setup={}, window=None,
                           is_port=lambda name: False)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_filled_table(monkeypatch, name, bench):
    assert name in {m["name"] for m in bench["per_layer"]}
    monkeypatch.setattr(ptrace, "totals", lambda: TABLE)
    assert registry.metric(name).read(_record()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("missing", ["no_table", "empty_table", "no_device_ops"])
@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_finds_nothing_to_read(monkeypatch, name, missing):
    """A program without the table (the parent of this reader), a window
    in which nothing recorded, and a capture without the card."""
    tr = TRACE
    if missing == "no_table":
        monkeypatch.delattr(ptrace, "totals")
        tr = tr._replace(host_ops=[op for op in tr.host_ops if op[0].startswith("aten")])
    elif missing == "empty_table":
        monkeypatch.setattr(ptrace, "totals",
                            lambda: {"spans": {}, "counters": {}, "orphans": 0})
        tr = tr._replace(host_ops=[])
    else:
        monkeypatch.setattr(ptrace, "totals", lambda: TABLE)
        tr = tr._replace(device_ops=[])
    value = registry.metric(name).read(_record(tr))
    if missing == "no_device_ops" and name == "step.accept_share":
        assert value == WANT[name]       # a count, not a device reading
    else:
        assert value is None


def test_the_part_metrics_are_the_sparse_cells():
    bench = registry.load_benchmark()
    parts = {"step.support_ms", "step.grad_sweep_ms", "step.cand_sweep_ms",
             "step.armijo_ms"}
    for cell in ("yt_k1000.seeded", "yt_k8385_sparse.seeded"):
        names = {m["name"] for m in registry.per_layer_for(bench, cell)}
        assert {"step.idle_share", "step.accept_share", "loop.snapshot_ms"} <= names
        sparse = cell == "yt_k8385_sparse.seeded"
        assert parts <= names if sparse else not parts & names
