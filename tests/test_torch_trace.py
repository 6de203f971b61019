"""The port's one span system (bigclam_tpu_torch/obs/trace.py): when spans
record (a telemetry, a profiler capture or a `recording()` scope, and
nothing else), the table of per-path totals and named counters, the parts
of the step and the mesh steps (utils.profiling.part/step_split), the
fit loop's spans, and that recording leaves a fit's numbers bit for bit
as they were. On the card: the device clock's events."""

import contextlib

import numpy as np
import pytest
import torch

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.models.agm import sample_planted_graph
from bigclam_tpu_torch.models.bigclam import BigClamModel
from bigclam_tpu_torch.models.sparse import SparseBigClamModel
from bigclam_tpu_torch.obs import trace
from bigclam_tpu_torch.parallel import SparseShardedBigClamModel, make_mesh
from bigclam_tpu_torch.utils import profiling

SPARSE_PARTS = ("support", "sums", "grad_sweep", "cand_sweep", "armijo")


@pytest.fixture(autouse=True)
def empty_table():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(scope="module")
def planted():
    g, _ = sample_planted_graph(300, 6, p_in=0.3, rng=np.random.default_rng(3))
    return g


def _model(g, rep: str, **kw):
    cfg = BigClamConfig(num_communities=6, max_iters=5, conv_tol=0.0, **kw)
    if rep == "sparse":
        return SparseBigClamModel(g, cfg.replace(representation="sparse", sparse_m=4),
                                  device="cpu")
    return BigClamModel(g, cfg, device="cpu")


def _leaf(spans: dict, name: str) -> list:
    return [row for path, row in spans.items()
            if path == name or path.endswith("/" + name)]


@pytest.mark.parametrize("scope", ["off", "profiler", "recording"])
def test_spans_record_only_in_a_scope(scope):
    if scope == "off":
        assert not trace.enabled()
        assert trace.span("outer") is trace.NULL_SPAN
        assert trace.span("part", emit=False, device=torch.device("cpu")) is trace.NULL_SPAN
        trace.add_span("measured", 0.5)
        assert trace.totals() == {"spans": {}, "counters": {}, "orphans": 0}
        return
    if scope == "profiler":
        ctx = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    else:
        ctx = trace.recording()
    with ctx as prof:
        assert trace.enabled()
        with trace.span("outer") as s:
            with trace.span("inner", emit=False, device=torch.device("cpu")) as i:
                assert i.path == "outer/inner"
                torch.ones(4).sum()
            assert (s._ann is not None) == (scope == "profiler")
    assert not trace.enabled()
    spans = trace.totals()["spans"]
    assert set(spans) == {"outer", "outer/inner"}
    assert spans["outer"]["count"] == spans["outer/inner"]["count"] == 1
    assert spans["outer"]["device_ms"] is None
    # a device-timed span on the CPU reads its wall time
    assert spans["outer/inner"]["device_ms"] == pytest.approx(
        1e3 * spans["outer/inner"]["host_s"])
    if scope == "profiler":
        names = {e.name for e in prof.events()}
        assert {"outer", "outer/inner"} <= names


@pytest.mark.parametrize("values", [[3, 4], [torch.tensor(5), 2, torch.tensor([1, 2]).sum()],
                                    [2, torch.tensor(7, dtype=torch.int64)]])
def test_counters_sum_ints_and_tensors(values):
    t0 = values[0] if isinstance(values[0], torch.Tensor) else None
    before = int(t0) if t0 is not None else None
    for v in values:
        trace.count("c", v)
    assert trace.totals()["counters"] == {"c": sum(int(v) for v in values)}
    if t0 is not None:          # the caller's tensor is never written
        assert int(t0) == before
    trace.reset()
    assert trace.totals()["counters"] == {}


@pytest.mark.parametrize("mesh", [False, True])
def test_step_split_returns_the_part_names(planted, mesh):
    cfg = BigClamConfig(num_communities=6, representation="sparse", sparse_m=4)
    if mesh:
        m = SparseShardedBigClamModel(planted, cfg,
                                      make_mesh((2, 1), [torch.device("cpu")] * 2))
        want = {"gathers", "support", "allreduces", "grad_sweep", "cand_sweep", "armijo"}
    else:
        m = SparseBigClamModel(planted, cfg, device="cpu")
        want = set(SPARSE_PARTS)
    st = m.init_state()
    with profiling.step_split() as split:
        m._step(st)
    assert set(split) == want
    assert all(ms > 0 for ms in split.values())
    assert not trace.enabled()


@pytest.mark.parametrize("rep", ["dense", "sparse"])
def test_recording_leaves_a_fit_bit_for_bit(planted, rep):
    m = _model(planted, rep)
    runs = []
    for on in (False, True):
        state0 = m.init_state()
        ctx = trace.recording() if on else contextlib.nullcontext()
        with ctx:
            runs.append(m.fit_state(state0))
    (s0, l0, n0, h0), (s1, l1, n1, h1) = runs
    assert h0 == h1 and l0 == l1 and n0 == n1
    assert torch.equal(s0.F, s1.F) and torch.equal(s0.sumF, s1.sumF)
    if rep == "sparse":
        assert torch.equal(s0.ids, s1.ids)
    spans = trace.totals()["spans"]
    assert sum(r["count"] for r in _leaf(spans, "fit_loop/sync")) == len(h1)


def test_sparse_parts_once_an_iteration(planted):
    m = _model(planted, "sparse")
    with trace.recording():
        _, _, _, hist = m.fit_state(m.init_state())
    spans = trace.totals()["spans"]
    iters = spans["fit_loop/sync"]["count"]
    assert iters == len(hist) and iters > 1
    for name in SPARSE_PARTS:
        rows = _leaf(spans, name)
        assert [r["count"] for r in rows] == [iters * (2 if name == "sums" else 1)], name
        assert rows[0]["device_ms"] > 0
    # the rollback snapshot, timed on the state's device
    assert spans["fit_loop/snapshot"]["device_ms"] is not None


@pytest.mark.parametrize("rep", ["dense", "sparse"])
def test_row_counters_equal_the_callback_histograms(planted, rep):
    m = _model(planted, rep)
    hists = []

    def cb(it, llh, extras):
        hists.append(np.asarray(extras["accept_hist"], np.int64))

    with trace.recording():
        m.fit_state(m.init_state(), cb)
    pad = m.n_pad - planted.num_nodes
    assert rep == "dense" or pad > 0
    counters = trace.totals()["counters"]
    assert counters["step/rows"] == sum(int(h.sum()) - pad for h in hists)
    assert counters["step/rows_accepted"] == sum(int(h[:-1].sum()) for h in hists)
    assert 0 < counters["step/rows_accepted"] <= counters["step/rows"]


# --- on the card ---------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_spans_take_the_device_clock_without_a_sync():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the device clock is CUDA events)")
    dev = torch.device("cuda")
    x = torch.randn(4096, 4096, device=dev)
    with trace.recording():
        for _ in range(3):
            with trace.span("fit_loop/dispatch", emit=False):
                with trace.span("mm", emit=False, device=dev):
                    y = x @ x
            assert len(trace._PENDING) > 0
            float(y.sum())              # the LLH read drains the stream
            trace.settle()
            assert not trace._PENDING
    spans = trace.totals()["spans"]
    row = spans["fit_loop/dispatch/mm"]
    assert row["count"] == 3 and row["device_ms"] > 0
    # the events went back to the pool and were reused
    assert sum(len(p) for p in trace._POOL.values()) == 2
