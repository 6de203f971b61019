"""The port's comms model (bigclam_tpu_torch/obs/comms.py) against the
bytes its collective helpers pass: `comms_measured` runs one step under
the counter and must equal the baked model exactly, on both schedules at
dp = 2, 3 and 4, on the plain and the kernel paths. The copied jax-free
parts (balance statistics, the report-time skew detector) are held
against the JAX module on the same inputs, and the port's sites carry the
JAX site names and payloads with the port's own wire conventions."""

import json

import numpy as np
import pytest
import torch

from bigclam_tpu.obs import comms as jcomms

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.models.agm import sample_planted_graph
from bigclam_tpu_torch.obs import RunTelemetry
from bigclam_tpu_torch.obs import comms as pcomms
from bigclam_tpu_torch.parallel import (
    RingBigClamModel,
    ShardedBigClamModel,
    make_mesh,
)
from bigclam_tpu_torch.parallel.sharded import all_gather, psum

CPU = torch.device("cpu")
SCHEDULES = {"allgather": ShardedBigClamModel, "ring": RingBigClamModel}


@pytest.fixture(scope="module")
def graph():
    g, _ = sample_planted_graph(230, 7, p_in=0.3, rng=np.random.default_rng(11))
    return g


def _model(g, schedule, dp, kernels, **cfg):
    c = BigClamConfig(num_communities=21, use_pallas_csr=kernels, **cfg)
    return SCHEDULES[schedule](g, c, make_mesh((dp, 1), [CPU] * dp))


@pytest.mark.parametrize("kernels", [False, True], ids=["xla", "csr"])
@pytest.mark.parametrize("dp", [2, 3, 4])
@pytest.mark.parametrize("schedule", ["allgather", "ring"])
def test_comms_measured_equals_the_model(graph, schedule, dp, kernels):
    m = _model(graph, schedule, dp, kernels)
    state = m.init_state(np.random.default_rng(dp).random((graph.num_nodes, 21)))
    for _ in range(2):           # from the initial and a stepped state
        measured = m.comms_measured(state)
        assert measured.site_bytes() == m.comms.site_bytes()
        assert measured.bytes_per_step() == pytest.approx(
            m.comms.bytes_per_step(), rel=0, abs=1e-6)
        assert m.comms.bytes_per_step() > 0
        state = m._step(state)


def test_counter_is_off_outside_counting(graph):
    """The helpers count nothing unless a counter is installed, and
    nesting restores the outer counter."""
    assert not pcomms.counting_on()
    parts = [torch.ones(3), torch.ones(3) * 2]
    with pcomms.counting() as outer:
        psum(parts, [CPU, CPU], "s")
        with pcomms.counting() as inner:
            all_gather(parts, [CPU, CPU], "g")
        all_gather(parts, [CPU, CPU], "g")
    psum(parts, [CPU, CPU], "s")
    assert not pcomms.counting_on()
    # psum: one 12-byte partial in, the 12-byte total back out
    assert outer.bytes == {"s": 24.0, "g": 24.0}
    assert inner.bytes == {"g": 24.0}


@pytest.mark.parametrize("dp", [2, 3, 4])
def test_port_sites_carry_the_jax_sites_with_port_wire_conventions(dp):
    """Same site names and payloads as the JAX tp = 1 models (health off);
    the wire bytes follow the port's collectives: psum = 2 s (p - 1),
    all_gather = p (p - 1) s, a ring step 2 (p - 1) hops of p s."""
    n_pad, k_pad, isz, s = 120 * dp, 64, 4, 16
    for port, jax_fn in (
        (pcomms.sharded_step_model(n_pad, k_pad, dp, isz, s),
         jcomms.sharded_step_model),
        (pcomms.ring_step_model(n_pad, k_pad, dp, isz, s),
         jcomms.ring_step_model),
    ):
        ref = jax_fn(n_pad, k_pad, dp, 1, isz, s)
        assert [x.site for x in port.sites] == [x.site for x in ref.sites]
        assert [x.payload_bytes for x in port.sites] == [
            x.payload_bytes for x in ref.sites]
        for site in port.sites:
            p, b = site.participants, site.payload_bytes
            want = {"psum": 2 * b * (p - 1), "all_gather": p * (p - 1) * b,
                    "ppermute": p * b}[site.op] * site.count
            assert site.bytes_per_step == want
    ring = pcomms.ring_step_model(n_pad, k_pad, dp, isz, s)
    ag = pcomms.sharded_step_model(n_pad, k_pad, dp, isz, s)
    shard = n_pad // dp * k_pad * isz
    assert ring.site_bytes()["ring/ppermute_F_rot"] == 2 * (dp - 1) * dp * shard
    assert ag.site_bytes()["sharded/all_gather_F"] == dp * (dp - 1) * shard
    assert pcomms.wire_bytes("psum", 100, 1) == 0.0


def test_copied_functions_equal_the_jax_ones():
    rng = np.random.default_rng(0)
    for counts in (rng.integers(0, 1000, 7).tolist(), [5.0], [], [0, 0, 9]):
        assert pcomms.balance_stats(counts) == jcomms.balance_stats(counts)
    for args in ((3, 8, 2), (0, 4, 1), (7, 8, 4)):
        assert pcomms.owner_pid(*args) == jcomms.owner_pid(*args)
    reports = [
        {"pid": p, "fingerprint": {"host": f"h{p}"},
         "spans": {"seconds": {"fit": 2.0 + p, "fit/fit_loop/sync": s,
                               "fit/fit_loop/dispatch": 0.5}}}
        for p, s in enumerate([1.5, 0.1, 1.4])
    ]
    for r in reports:
        assert pcomms.sync_seconds(r) == jcomms.sync_seconds(r)
        assert pcomms.loop_overhead_seconds(r) == jcomms.loop_overhead_seconds(r)
    assert pcomms.detect_host_skew(reports) == jcomms.detect_host_skew(reports)
    assert pcomms.detect_host_skew(reports)[0]["pid"] == 1
    assert pcomms.IMBALANCE_FACTOR == jcomms.IMBALANCE_FACTOR
    assert pcomms.DEFAULTS == jcomms.DEFAULTS


def test_mesh_build_emits_comms_and_balance_events(tmp_path, graph):
    with RunTelemetry(str(tmp_path / "t"), entry="fit") as tel:
        m = _model(graph, "ring", 3, False)
        rep = tel.report()
    assert rep["comms"]["sites"] == m.comms.site_bytes()
    assert rep["comms"]["bytes_per_step"] == round(m.comms.bytes_per_step(), 1)
    events = [json.loads(x) for x in open(tmp_path / "t" / "events.jsonl")]
    comms = [e for e in events if e["kind"] == "comms"]
    assert [e["reset_model"] for e in comms] == [1, 0, 0]
    assert any(e["kind"] == "balance" and e["what"] == "shard_edges"
               for e in events)


def test_single_device_models_bake_no_comms(graph):
    from bigclam_tpu_torch.models.bigclam import BigClamModel

    m = BigClamModel(graph, BigClamConfig(num_communities=5), device="cpu")
    assert m.comms is None and m.memory is not None
    one = _model(Graph(graph.indptr, graph.indices, graph.raw_ids),
                 "allgather", 1, False)
    assert one.comms.bytes_per_step() == 0.0


@pytest.mark.parametrize("rows,cols,gx,gcap", [
    (4, 1, "closure", 0), (2, 2, "closure", 40), (2, 2, "dense", 0),
    (1, 4, "closure", 60), (2, 4, "closure", 0), (3, 2, "dense", 0),
])
def test_twod_sites_carry_the_jax_sites(rows, cols, gx, gcap):
    """The port's 2D model carries JAX twod_step_model's site names,
    payloads and participants (health off); a site over one axis runs once
    per group of the other, so its count is JAX's times the groups, and
    the port's total is p times the JAX per-device figure."""
    p = rows * cols
    n_pad, k_pad, isz, s, cap = 120 * p, 64, 4, 16, 50
    ours = pcomms.twod_step_model(n_pad, k_pad, rows, cols, isz, s,
                                  closure_cap=cap, grad_exchange=gx,
                                  grad_cap=gcap, fused=True)
    ref = jcomms.twod_step_model(n_pad, k_pad, rows, cols, isz, s,
                                 closure_cap=cap, grad_exchange=gx,
                                 grad_cap=gcap, fused=True)
    assert [x.site for x in ours.sites] == [x.site for x in ref.sites]
    for o, r in zip(ours.sites, ref.sites):
        assert (o.op, o.payload_bytes, o.participants) == (
            r.op, r.payload_bytes, r.participants)
        assert o.count == r.count * p // r.participants
    assert ours.bytes_per_step() == pytest.approx(p * ref.bytes_per_step(),
                                                  rel=1e-12)
    assert pcomms.wire_bytes("all_to_all", 100, 4) == 300.0
    assert pcomms.wire_bytes("psum_scatter", 100, 1) == 0.0