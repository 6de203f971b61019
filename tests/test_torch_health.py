"""The port's model health (ops.diagnostics, obs.health, the steps'
health packs) against the JAX package: health_pack matches the JAX pack on
the same F_old, F_new, grad and histogram at 1e-10 (on inputs whose float32
sums are exact, so summation order cannot differ; the two square roots to
one float32 ulp, as XLA's CPU sqrt rounds them; at float32 rounding on
random ones), the sparse latch included; the monitor emits the same
`health` and `anomaly` events for the same LLH series; health off leaves
the trajectory bit for bit as it was; every trainer emits health events."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigclam_tpu.config import BigClamConfig as JaxConfig
from bigclam_tpu.obs.health import HealthMonitor as JaxMonitor
from bigclam_tpu.ops import diagnostics as jdx

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.models.agm import sample_planted_graph
from bigclam_tpu_torch.models.bigclam import BigClamModel
from bigclam_tpu_torch.models.sparse import SparseBigClamModel
from bigclam_tpu_torch.obs import RunTelemetry, install, uninstall
from bigclam_tpu_torch.obs.health import HealthMonitor, run_detectors
from bigclam_tpu_torch.obs.telemetry import EVENTS_NAME
from bigclam_tpu_torch.ops import diagnostics as dx
from bigclam_tpu_torch.parallel import RingBigClamModel, ShardedBigClamModel, make_mesh

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _cfg(**kw):
    base = dict(num_communities=8, dtype="float64", health_every=2, beta=0.5)
    base.update(kw)
    jc = JaxConfig(**base)
    return jc, BigClamConfig(**dataclasses.asdict(jc))


def _dyadic_inputs(seed=0, n=64, k=8, s=16):
    """F in multiples of 1/8, grad in multiples of 1/4: every float32 sum
    and square of the pack is exact."""
    rng = np.random.default_rng(seed)
    F_old = rng.integers(0, 32, (n, k)) / 8.0
    F_new = np.clip(F_old + rng.integers(-4, 5, (n, k)) / 8.0, 0.0, None)
    F_new[:, -1] = 0.0                      # a dead column
    grad = rng.integers(-32, 33, (n, k)) / 4.0
    hist = rng.multinomial(n, np.ones(s + 1) / (s + 1)).astype(np.int32)
    return F_old, F_new, grad, hist


def _jax_pack(jc, it, F_old, F_new, grad, hist, extras=None, skip_carry=None):
    return np.asarray(jdx.health_pack(
        jc, jnp.asarray(it, jnp.int32), jnp.asarray(F_old), jnp.asarray(F_new),
        jnp.asarray(F_new.sum(axis=0)), jnp.asarray(hist),
        grad=jnp.asarray(grad), extras=extras, skip_carry=skip_carry))


def _port_pack(cfg, it, F_old, F_new, grad, hist, extras=None, skip_carry=None):
    t = torch.from_numpy
    out = dx.health_pack(cfg, it, t(F_old), t(F_new), t(F_new.sum(axis=0)),
                         t(hist), grad=t(grad), extras=extras,
                         skip_carry=skip_carry)
    return None if out is None else out.numpy()


# the two norms end in a square root, which XLA's CPU backend computes
# to within one float32 ulp rather than correctly rounded: those two slots
# are held to one ulp, every other slot at 1e-10
SQRT_SLOTS = [dx.HEALTH_INDEX["grad_norm"], dx.HEALTH_INDEX["update_norm"]]


def _assert_pack_equal(a, b):
    rest = [i for i in range(dx.HEALTH_LEN) if i not in SQRT_SLOTS]
    np.testing.assert_allclose(a[rest], b[rest], rtol=1e-10, atol=0.0,
                               equal_nan=True)
    np.testing.assert_allclose(a[SQRT_SLOTS], b[SQRT_SLOTS],
                               rtol=np.finfo(np.float32).eps, atol=0.0)


def test_field_order_and_sentinel_equal_jax():
    assert dx.HEALTH_FIELDS == jdx.HEALTH_FIELDS
    assert dx.HEALTH_INDEX == jdx.HEALTH_INDEX
    assert dx.HEALTH_LEN == jdx.HEALTH_LEN and dx.NA == jdx.NA
    assert dx.ACTIVE_EPS == jdx.ACTIVE_EPS


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_health_pack_matches_jax_at_1e10(seed):
    jc, cfg = _cfg()
    F_old, F_new, grad, hist = _dyadic_inputs(seed)
    a = _port_pack(cfg, 4, F_old, F_new, grad, hist)
    b = _jax_pack(jc, 4, F_old, F_new, grad, hist)
    assert a.dtype == b.dtype == np.float32
    _assert_pack_equal(a, b)
    assert a[dx.HEALTH_INDEX["active_comms"]] == 7
    assert np.isnan(a[dx.HEALTH_INDEX["llh"]])


def test_health_pack_matches_jax_on_random_inputs_at_float32_rounding():
    jc, cfg = _cfg(beta=0.1)
    rng = np.random.default_rng(9)
    F_old = rng.uniform(0, 2, (200, 12))
    F_new = np.clip(F_old + rng.normal(0, 0.1, F_old.shape), 0, None)
    grad = rng.normal(0, 3, F_old.shape)
    hist = rng.multinomial(200, np.ones(17) / 17).astype(np.int32)
    jc, cfg = jc.replace(num_communities=12), cfg.replace(num_communities=12)
    a = _port_pack(cfg, 6, F_old, F_new, grad, hist)
    b = _jax_pack(jc, 6, F_old, F_new, grad, hist)
    np.testing.assert_allclose(a, b, rtol=2e-6, equal_nan=True)


def test_off_cadence_and_off_compute_nothing():
    _, cfg = _cfg()
    F_old, F_new, grad, hist = _dyadic_inputs()
    assert _port_pack(cfg, 3, F_old, F_new, grad, hist) is None
    assert _port_pack(cfg.replace(health_every=0), 4, F_old, F_new, grad, hist) is None


def test_grad_max_propagates_nan():
    g = torch.ones(4, 3)
    g[2, 1] = float("nan")
    assert torch.isnan(dx.grad_stats(g)[1])
    assert np.isnan(float(jdx.grad_stats(jnp.asarray(g.numpy()))[1]))


def test_sparse_latch_and_extras_match_jax():
    jc, cfg = _cfg()
    F_old, F_new, grad, hist = _dyadic_inputs(4)
    jprev, pprev = None, None
    packs = {}
    for it, churn in ((1, 0.25), (3, 0.125), (4, 0.0625), (5, 0.5)):
        jex, jcarry = jdx.latch_extras(
            jprev, {"support_churn": jnp.float32(churn)})
        pex, pcarry = dx.latch_extras(
            pprev, {"support_churn": torch.tensor(churn, dtype=torch.float32)})
        np.testing.assert_array_equal(pcarry.numpy(), np.asarray(jcarry))
        b = _jax_pack(jc, it, F_old, F_new, grad, hist, extras=jex,
                      skip_carry=jcarry)
        a = _port_pack(cfg, it, F_old, F_new, grad, hist, extras=pex,
                       skip_carry=pcarry)
        if a[0] >= 0:
            _assert_pack_equal(a, b)
        else:
            np.testing.assert_array_equal(a, b)
        jprev, pprev = jnp.asarray(b), torch.from_numpy(a)
        packs[it] = a
    churn = dx.HEALTH_INDEX["support_churn"]
    # the sample at 4 holds the max since the start (0.25); it re-arms the
    # latch, so the carry after it holds 5's churn alone
    assert packs[4][churn] == 0.25 and packs[4][0] == 4
    assert packs[5][churn] == 0.5 and packs[5][0] == -1.0


def test_top_community_signatures_match_jax():
    F = np.random.default_rng(0).uniform(0, 1, (30, 6))
    F[4] = 0.0
    a = dx.dense_top_community(torch.from_numpy(F)).numpy()
    b = np.asarray(jdx.dense_top_community(jnp.asarray(F)))
    np.testing.assert_array_equal(a, b)
    assert a[4] == -1
    # a tuple of row shards gives the concatenated signature
    shards = tuple(torch.from_numpy(F[i:i + 10]) for i in range(0, 30, 10))
    np.testing.assert_array_equal(dx.dense_top_community(shards).numpy(), a)
    ids = np.sort(np.random.default_rng(1).integers(0, 20, (30, 4)), axis=1)
    w = np.random.default_rng(2).uniform(0, 1, (30, 4))
    w[7] = 0.0
    a = dx.sparse_top_community(torch.from_numpy(ids), torch.from_numpy(w)).numpy()
    b = np.asarray(jdx.sparse_top_community(jnp.asarray(ids), jnp.asarray(w)))
    np.testing.assert_array_equal(a, b)
    assert int(dx.sig_changed(torch.from_numpy(a), torch.from_numpy(b))) == 0


class _Sink:
    def __init__(self):
        self.events = []

    def event(self, kind, **fields):
        self.events.append((kind, fields))


def _series():
    """A healthy climb, then a plateau, then a divergence."""
    llh = [-1000.0 + 80.0 * i for i in range(6)]
    llh += [llh[-1] * (1 + 1e-9 * i) for i in range(1, 10)]
    llh += [llh[-1] * (1.05 + 0.05 * i) for i in range(5)]
    return llh


def test_monitor_emits_the_same_events_as_jax():
    jc, cfg = _cfg(health_every=1, conv_tol=1e-6)
    F_old, F_new, grad, hist = _dyadic_inputs(5)
    vec = _jax_pack(jc, 0, F_old, F_new, grad, hist).astype(np.float64)
    js, ps = _Sink(), _Sink()
    jm, pm = JaxMonitor(jc, js), HealthMonitor(cfg, ps)
    for it, llh in enumerate(_series()):
        v = vec.copy()
        v[0] = it
        jm.observe(it, llh, v, None)
        pm.observe(it, llh, v, None)
    assert ps.events == js.events
    checks = [f["check"] for kind, f in ps.events if kind == "anomaly"]
    assert "plateau" in checks and "divergence" in checks


def test_detectors_equal_jax_on_a_window():
    from bigclam_tpu.obs.health import run_detectors as jax_run_detectors

    samples = [{"iter": i, "llh": v, "dead_frac": 0.8 if i > 10 else 0.0}
               for i, v in enumerate(_series())]
    for end in range(2, len(samples) + 1):
        assert run_detectors(samples[:end], None, 1e-6) == jax_run_detectors(
            samples[:end], None, 1e-6)


# --------------------------------------------------------------------------
# the trainers
# --------------------------------------------------------------------------


def _planted():
    g, _ = sample_planted_graph(240, 6, p_in=0.3, rng=np.random.default_rng(0))
    F0 = np.random.default_rng(1).uniform(0, 1, (g.num_nodes, 6))
    return g, F0


def _trainers(g, cfg):
    mesh = make_mesh((4, 1), [CPU] * 4)
    f32 = cfg.replace(dtype="float32")
    return {
        "xla": BigClamModel(g, cfg, device="cpu"),
        "csr_fused": BigClamModel(g, f32.replace(use_pallas_csr=True), device="cpu"),
        "csr_fused_kb": BigClamModel(g, f32.replace(use_pallas_csr=True,
                                                    csr_k_block=32), device="cpu"),
        "pallas_vmem": BigClamModel(g, f32.replace(use_pallas=True), device="cpu"),
        "sparse_xla": SparseBigClamModel(
            g, cfg.replace(representation="sparse", sparse_m=3), device="cpu"),
        "sharded": ShardedBigClamModel(g, cfg, mesh),
        "ring": RingBigClamModel(g, cfg, mesh, balance=False),
    }


@pytest.mark.parametrize("name", ["xla", "csr_fused", "csr_fused_kb",
                                  "pallas_vmem", "sparse_xla", "sharded", "ring"])
def test_health_off_leaves_the_trajectory_bit_for_bit(name):
    g, F0 = _planted()
    cfg = BigClamConfig(num_communities=6, dtype="float64", max_iters=5,
                        conv_tol=0.0)
    off = _trainers(g, cfg)[name].fit(F0)
    on = _trainers(g, cfg.replace(health_every=2))[name].fit(F0)
    np.testing.assert_array_equal(on.F, off.F)
    assert on.llh_history == off.llh_history


def _events(directory):
    with open(os.path.join(directory, EVENTS_NAME)) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.mark.parametrize("name", ["xla", "csr_fused_kb", "sparse_xla", "ring"])
def test_trainers_emit_health_events(tmp_path, name):
    g, F0 = _planted()
    cfg = BigClamConfig(num_communities=6, dtype="float64", max_iters=6,
                        conv_tol=0.0, health_every=2)
    model = _trainers(g, cfg)[name]
    tel = install(RunTelemetry(str(tmp_path), entry="test"))
    try:
        model.fit(F0)
    finally:
        tel.finalize()
        uninstall(tel)
    health = [e for e in _events(tmp_path) if e["kind"] == "health"]
    assert [e["iter"] for e in health] == [0, 2, 4, 6]
    for e in health:
        assert e["grad_norm"] > 0 and 0 < e["active_comms"] <= 6
        assert ("support_churn" in e) == (name == "sparse_xla")
        assert "cap_occupancy" not in e
    assert "churn" in health[-1]
    assert tel.report()["health"]["samples"] == 4


def test_sharded_pack_equals_single_device_pack():
    g, F0 = _planted()
    cfg = BigClamConfig(num_communities=6, dtype="float64", health_every=1)
    one = BigClamModel(g, cfg, device="cpu")
    four = ShardedBigClamModel(g, cfg, make_mesh((4, 1), [CPU] * 4))
    a = one._step(one.init_state(F0)).health.numpy()
    b = four._step(four.init_state(F0)).health.numpy()
    np.testing.assert_allclose(b, a, rtol=1e-6, equal_nan=True)
