"""The port's memory model (bigclam_tpu_torch/obs/memory.py): the model's
state + graph bytes reconcile with drift 0 against the storage bytes of
the live tensors on every family and kernel path, a planted extra tensor
fires `memory_drift`, the copied host model and renderers equal the JAX
ones, and `cli preflight` prices the survey's com-youtube configuration
and refuses what the port does not run."""

import json

import numpy as np
import pytest
import torch

from bigclam_tpu.obs import memory as jmem

from bigclam_tpu_torch import cli
from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.models import bigclam as pbig
from bigclam_tpu_torch.models.agm import sample_planted_graph
from bigclam_tpu_torch.models.sparse import SparseBigClamModel
from bigclam_tpu_torch.obs import RunTelemetry
from bigclam_tpu_torch.obs import comms as pcomms
from bigclam_tpu_torch.obs import memory as pmem
from bigclam_tpu_torch.ops import csr_kernels, diagnostics
from bigclam_tpu_torch.parallel import (
    RingBigClamModel,
    ShardedBigClamModel,
    make_mesh,
)

CPU = torch.device("cpu")
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def graph():
    g, _ = sample_planted_graph(240, 8, p_in=0.3, rng=np.random.default_rng(5))
    return g


DENSE = {
    "csr_fused": dict(use_pallas_csr=True),
    "csr": dict(use_pallas_csr=True, csr_fused=False),
    "csr_fused_kb": dict(use_pallas_csr=True, csr_k_block=32),
    "csr_grouped_kb": dict(use_pallas_csr=True, csr_k_block=32, csr_fused=False),
    "pallas_vmem": dict(use_pallas=True),
    "xla": dict(),
}


def _build(graph, family, **extra):
    k = 40
    if family in DENSE:
        cfg = BigClamConfig(num_communities=k, **DENSE[family], **extra)
        m = pbig.BigClamModel(graph, cfg, device="cpu")
        assert m.engaged_path == family
        return m
    if family == "sparse":
        return SparseBigClamModel(
            graph, BigClamConfig(num_communities=k, representation="sparse",
                                 sparse_m=6, **extra), device="cpu")
    schedule, dp = family.split("_dp")
    cls = RingBigClamModel if schedule == "ring" else ShardedBigClamModel
    dp = int(dp)
    return cls(graph, BigClamConfig(num_communities=k, **extra),
               make_mesh((dp, 1), [CPU] * dp))


FAMILIES = list(DENSE) + ["sparse", "sharded_dp2", "sharded_dp4",
                          "ring_dp3", "ring_dp4"]


@pytest.mark.parametrize("family", FAMILIES)
def test_memory_reconcile_is_exact(graph, family):
    m = _build(graph, family)
    state = m.init_state(np.random.default_rng(1).random((graph.num_nodes, 40)))
    for _ in range(3):
        recon = m.memory_reconcile(state)
        assert recon["drift_frac"] == 0.0 and recon["ok"], recon
        assert recon["modeled_bytes"] == m.memory.addressable_bytes()
        assert recon["hbm_modeled_bytes"] > recon["modeled_bytes"]
        state = m._step(state)
    cats = m.memory.category_bytes()
    assert set(cats) <= set(pmem.CATEGORIES)
    assert cats["scratch"] > 0           # the rollback snapshot (default on)


def test_planted_tensor_fires_memory_drift(tmp_path, graph):
    with RunTelemetry(str(tmp_path / "t"), entry="fit") as tel:
        m = _build(graph, "csr_fused")
        state = m.init_state()
        assert m.memory_reconcile(state)["ok"]
        leak = torch.zeros(4096, dtype=torch.float32)
        recon = m.memory_reconcile(state, extra=[leak])
        rep = tel.report()
    assert not recon["ok"] and recon["drift_frac"] > 0
    assert recon["measured_bytes"] - recon["modeled_bytes"] == 4096 * 4
    assert rep["health"]["anomalies"] == {"memory_drift": 1}
    modeled = rep["memory"]["modeled"]
    assert modeled["hbm_bytes_per_device"] == round(m.memory.hbm_bytes(), 1)
    assert modeled["addressable_bytes"] == m.memory.addressable_bytes()
    events = [json.loads(x) for x in open(tmp_path / "t" / "events.jsonl")]
    drift = [e for e in events if e.get("check") == "memory_drift"]
    assert len(drift) == 1 and drift[0]["iter"] == -1


def test_views_and_shared_storage_count_once():
    t = torch.zeros(10, 4)
    assert pmem.measured_device_bytes([t, t[2:5], t.view(-1), None]) == 160
    assert pmem.measured_device_bytes([(t, [t]), {"a": torch.ones(3)}]) == 172


@pytest.mark.parametrize("kwargs", [
    dict(n=1000, directed_edges=8000, k=50, itemsize=4),
    dict(n=1000, directed_edges=8000, k=50, itemsize=8, n_pad=1024,
         k_pad=64, processes=2, num_shards=4, chunk_bytes=1 << 20),
    dict(n=300, directed_edges=900, k=30, itemsize=4, representation="sparse",
         sparse_m=8, store_native=True, processes=3),
    dict(n=300, directed_edges=900, k=30, itemsize=4, rowkeyed_f0=True),
])
def test_host_rss_model_equals_the_jax_one(kwargs):
    port = pmem.host_rss_model(**kwargs).to_dict()
    assert port == jmem.host_rss_model(**kwargs).to_dict()


def test_copied_classes_equal_the_jax_ones():
    spec = [("state/F", 400.0, "state", 1.0, ""), ("graph/e", 120.0, "graph", 1.0, ""),
            ("transient/x", 50.0, "transient", 2.0, "n")]
    pm = pmem.MemoryModel("dense", "M", tuple(pmem.Buffer(*b) for b in spec), {})
    jm = jmem.MemoryModel("dense", "M", tuple(jmem.Buffer(*b) for b in spec), {})
    assert pm.to_dict() == jm.to_dict()
    for measured in (520.0, 600.0, 400.0):
        assert pm.reconcile(measured) == jm.reconcile(measured)
    assert pmem.HEALTH_LEN == diagnostics.HEALTH_LEN == jmem.HEALTH_LEN
    assert pmem.MAX_K == csr_kernels.MAX_K
    assert pmem.CSR_K_MULTIPLE == pbig.CSR_K_MULTIPLE
    for k, kb in ((37, 0), (1024, 0), (1100, 0), (3000, 0), (8385, 0), (100, 32)):
        assert pmem.k_block_plan(k, kb) == pbig.k_block_plan(k, kb)


def test_render_preflight_is_the_jax_renderer():
    p = pmem.preflight(5000, 40000, 200, dp=2, device_hbm_bytes=1 << 30)
    assert pmem.render_preflight(p) == jmem.render_preflight(p)


def _preflight(capsys, *args):
    rc = cli.main(["preflight", *args])
    return rc, capsys.readouterr()


YOUTUBE = ["--nodes", "1134890", "--edges", "2987624", "--k", "8385"]


def test_preflight_com_youtube_dense_names_sparse(capsys):
    """The survey's v3 configuration: com-youtube at K = 8,385 (SNAP's
    node and edge counts, no data file): a dense F of about 38 GB, which
    with its gradient, F_new and the snapshot does not fit one card, and
    `--representation sparse` as the knob."""
    rc, out = _preflight(capsys, *YOUTUBE, "--device-kind", H100, "--json")
    p = json.loads(out.out)
    assert rc == 2 and p["fits"] is False and p["binding"] == "hbm"
    buffers = {b["buffer"]: b["bytes"] for b in p["device"]["buffers"]}
    assert 37e9 < buffers["state/F"] < 40e9
    assert p["workload"]["kernel_path"] == "csr_fused_kb"
    assert p["hbm_budget_bytes"] == round(
        pmem.DEVICE_HBM_BYTES[H100] * (1 - pmem.HBM_HEADROOM_FRAC), 1)
    assert any(k.startswith("--representation sparse") for k in p["knobs"])
    rc, out = _preflight(capsys, *YOUTUBE, "--device-kind", H100,
                         "--representation", "sparse", "--sparse-m", "64")
    assert rc == 0 and "verdict: FITS" in out.out


# refused before the 2D trainer landed; now priced (a (4, 1) grid of cards)
PRICED = (["--partition", "2d", "--devices", "4"],)


@pytest.mark.parametrize("flags", [
    ["--device-kind", "v5e"],
    ["--partition", "2d", "--devices", "4"],
    ["--store-native"],
    ["--device-kind", "NVIDIA A100-SXM4-80GB"],
    ["--mesh", "1,2", "--representation", "sparse"],
    ["--mesh", "2,1", "--representation", "sparse", "--schedule", "ring"],
    ["--mesh", "2,2", "--partition", "2d"],
])
def test_preflight_refuses_what_the_port_does_not_run(capsys, flags):
    """What no port trainer runs exits 1 naming why; the 2D partition on
    four cards (PRICED), refused before its trainer landed, gets a verdict,
    and on a K-sharded mesh is refused in the JAX preflight's words."""
    rc, out = _preflight(capsys, "--nodes", "1000", "--edges", "5000",
                         "--k", "64", *flags)
    if flags in PRICED:
        assert rc == 0 and "partition 2d(cols=1) csr_fused_2d" in out.out
        return
    assert rc == 1 and out.out == ""
    assert "error:" in out.err
    if "2d" in flags:
        assert "partition=2d requires tp == 1" in out.err


@pytest.mark.parametrize("flags,path,k_pad", [
    (["--mesh", "2,2"], "csr_fused", 64),
    (["--mesh", "2,2", "--schedule", "ring"], "csr_ring_fused", 64),
    (["--mesh", "4,1", "--k", "3000"], "csr_fused_kb", 3072),
    (["--mesh", "2,2", "--k", "3000"], "csr_fused_kb", 3072),
    (["--mesh", "4,1", "--k", "3000", "--schedule", "ring"],
     "csr_ring_fused_kb", 3072),
])
def test_preflight_prices_k_blocked_and_tp_meshes(capsys, flags, path, k_pad):
    """K-blocked meshes and tp > 1 are priced, not refused: K pads to a
    multiple of 32 tp and K_loc takes its own K blocks (3 of 1,024 at
    tp = 1, 2 of 768 at tp = 2 for K = 3,000); the state is a K_loc block
    of a shard's rows, and at tp > 1 the psums over k are comms sites and
    the torch tails' two block temporaries are priced."""
    rc, out = _preflight(capsys, "--nodes", "1000", "--edges", "5000",
                         "--k", "64", *flags, "--json")
    assert rc == 0
    p = json.loads(out.out)
    dp, tp = (int(x) for x in flags[1].split(","))
    assert p["workload"]["kernel_path"] == path
    assert p["workload"]["k_pad"] == k_pad and p["workload"]["mesh"] == f"{dp}x{tp}"
    buffers = {b["buffer"]: b["bytes"] for b in p["device"]["buffers"]}
    assert buffers["state/F"] == (1000 // dp) * (k_pad // tp) * 4
    assert buffers.get("transient/tp_tails", 0) == (
        2 * buffers["state/F"] if tp > 1 else 0)
    ring = "--schedule" in flags
    cm = (pcomms.ring_step_model if ring else pcomms.sharded_step_model)(
        1000, k_pad, dp, 4, 16, tp=tp, edges=10000)
    assert p["comms_bytes_per_step"] == round(cm.bytes_per_step(), 1)
    assert any(s.site.endswith("psum_k_x") for s in cm.sites) == (tp > 1)


@pytest.mark.parametrize("kw", [
    {},
    {"representation": "sparse", "sparse_m": 32, "shards": 4, "replicas": 2,
     "qps_target": 50000.0, "host_ram_bytes": 2e8},
    {"itemsize": 8, "cache_slots": 256, "avg_memberships": 3.5,
     "host_ram_bytes": 1e6},
])
def test_serve_preflight_is_the_jax_pricing(kw):
    """`preflight --serve`'s host pricing (obs.memory.serve_preflight) and
    its rendering are the JAX package's on the same inputs."""
    args = (300_000, 8_512_796, 1000)
    ours = pmem.serve_preflight(*args, **kw)
    assert ours == jmem.serve_preflight(*args, **kw)
    assert pmem.render_serve_preflight(ours) == jmem.render_serve_preflight(
        ours)


def test_preflight_serve_prices_a_fleet(capsys):
    rc, out = _preflight(capsys, "--nodes", "300000", "--edges", "4256398",
                         "--k", "1000", "--serve", "--serve-shards", "2",
                         "--json")
    p = json.loads(out.out)
    assert rc == 0 and p["fits"] and p["workload"]["serve_shards"] == 2
    assert p == jmem.serve_preflight(300_000, 8_512_796, 1000, shards=2)
    rc, out = _preflight(capsys, "--nodes", "300000", "--edges", "4256398",
                         "--k", "1000", "--serve", "--qps-target", "1e6")
    assert rc == 2 and "DOES NOT FIT (binding: qps)" in out.out


def test_preflight_mesh_schedules(capsys):
    rc, out = _preflight(capsys, "--nodes", "300000", "--edges", "4256398",
                         "--k", "1000", "--mesh", "4,1", "--json")
    ag = json.loads(out.out)
    rc2, out = _preflight(capsys, "--nodes", "300000", "--edges", "4256398",
                          "--k", "1000", "--mesh", "4,1", "--schedule", "ring",
                          "--json")
    ring = json.loads(out.out)
    assert rc == rc2 == 0
    shard = 75000 * 1024 * 4
    # the same psums; the ring rotates 2 (dp - 1) dp shards where the
    # all-gather moves dp (dp - 1)
    assert ring["comms_bytes_per_step"] - ag["comms_bytes_per_step"] == 12 * shard
    assert ring["hbm_bytes_per_device"] < ag["hbm_bytes_per_device"]


def test_cli_fit_stamps_the_models(tmp_path, capsys, graph):
    path = tmp_path / "g.txt"
    with open(path, "w") as f:
        for u, v in zip(graph.src, graph.dst):
            if u < v:
                f.write(f"{u}\t{v}\n")
    common = ["fit", "--graph", str(path), "--k", "6", "--device", "cpu",
              "--max-iters", "2", "--quiet"]
    assert cli.main(common) == 0
    single = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert single["hbm_modeled_bytes"] > 0 and "comms_bytes_per_step" not in single
    assert cli.main(common + ["--mesh", "2,1", "--schedule", "ring"]) == 0
    mesh = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert mesh["comms_bytes_per_step"] > 0 and mesh["hbm_modeled_bytes"] > 0


@pytest.mark.parametrize("rows,cols,gx,gcap", [
    (4, 1, "dense", 0), (2, 2, "closure", 40), (2, 2, "dense", 0),
    (1, 4, "closure", 60),
])
def test_twod_memory_model_carries_the_jax_buffers(rows, cols, gx, gcap):
    """At one position a card the port's 2D model prices JAX's 2D buffers
    at JAX's bytes (the row-group gather, the closure table, the row-group
    gradient, the state's F); the touched-rows exchange prices one phase's
    staging (JAX's formula prices a send and a receive buffer) and adds
    the (n_row, K) result; the port's later phases (candidate sweep,
    tails) ride `transient/later_phase_excess`."""
    n_pad, k_pad, isz, s, cap = 960, 64, 4, 16, 50
    args = (n_pad, k_pad, rows, cols, isz, s, {"graph/x": 100.0})
    ours = pmem.twod_memory_model(*args, closure_cap=cap, grad_exchange=gx,
                                  grad_cap=gcap, path="csr_fused_2d")
    ref = jmem.twod_memory_model(*args, closure_cap=cap, grad_exchange=gx,
                                 grad_cap=gcap, fused=True)
    mine, theirs = ours.buffer_bytes(), ref.buffer_bytes()
    names = ["state/F", "transient/closure_recv"] + (
        ["transient/F_rowgather", "transient/grad_row"] if cols > 1 else [])
    for name in names:
        assert mine[name] == theirs[name], name
    if gx == "closure":
        n_row = cols * n_pad // (rows * cols)
        assert (mine["transient/grad_closure_exchange"]
                == theirs["transient/grad_closure_exchange"]
                + (n_row - cols * gcap) * k_pad * isz)
    assert ours.params["grad_exchange"] == ref.params["grad_exchange"] == gx