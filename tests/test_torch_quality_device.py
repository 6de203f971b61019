"""The port's device-resident quality schedule (bigclam_tpu_torch/models/
quality.py `fit_quality_device`) held against the JAX package's, in
float64 on the CPU, with the port's noise source fed the values JAX's
threefry draws (`jax.random.uniform(fold_in(base_key, tag), shape, 0, eps)`
over JAX's padded shape, its live block sliced, and placed at the port's
internal rows where a mesh balances); the transfer contract (one upload,
at most rounds + 1 fetches, model.fit never called); repair-round resume;
padding inert on the dense layout (K padded to 32) and on meshes; the
scatter edits; and the default generator, deterministic for a seed and
different for another key_salt."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigclam_tpu.config import BigClamConfig as JaxConfig
from bigclam_tpu.models import BigClamModel as JaxModel
from bigclam_tpu.models import quality as jq

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.models import quality as tq
from bigclam_tpu_torch.models.agm import sample_planted_graph
from bigclam_tpu_torch.models.bigclam import BigClamModel
from bigclam_tpu_torch.ops import seeding
from bigclam_tpu_torch.parallel import (
    RingBigClamModel,
    ShardedBigClamModel,
    make_mesh,
)
from bigclam_tpu_torch.utils.checkpoint import CheckpointManager
# the refit tests' row-relative F band
from test_torch_refit import assert_rows_close

torch.set_num_threads(2)

RTOL = 1e-10


def jax_noise(jmodel, F0, seed, key_salt=0, perm=None):
    """A noise source for fit_quality_device that returns JAX's draws: the
    uniform over JAX's padded F shape from fold_in(base_key, tag), its live
    block, at the port's internal rows (`perm`: a balanced mesh's)."""
    shape = jmodel.init_state(F0).F.shape
    base = jax.random.fold_in(
        jax.random.key((seed ^ 0x5EED) & 0xFFFFFFFF), key_salt)

    def noise(tag, live, eps, dtype, device):
        u = jax.random.uniform(jax.random.fold_in(base, tag), shape,
                               jnp.float64, 0.0, eps)
        blk = np.asarray(u)[: live[0], : live[1]]
        if perm is not None:
            out = np.empty_like(blk)
            out[perm] = blk
            blk = out
        return torch.from_numpy(np.ascontiguousarray(blk)).to(device, dtype)

    return noise


CASES = {
    # annealing, then an accepted atomize round
    "planted": (2400, 12, 0.15),
    # accepted merge/split (polish kicks from the tags POLISH_TAG + ...)
    # and atomize rounds
    "repairs": (1200, 50, 0.3),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    """(name, graph, cfg, F0, the JAX model, its fit_quality_device)."""
    n, k, p_in = CASES[name]
    g, truth = sample_planted_graph(n, k, p_in=p_in,
                                    rng=np.random.default_rng(7))
    base = dict(num_communities=k, quality_mode=True, restart_cycles=4,
                dtype="float64")
    cfg = BigClamConfig(**base)
    jcfg = JaxConfig(use_pallas=False, use_pallas_csr=False, **base)
    F0 = seeding.init_F(g, seeding.conductance_seeds(g, cfg), cfg,
                        np.random.default_rng(0))
    jmodel = JaxModel(g, jcfg)
    ref = jq.fit_quality_device(jmodel, F0)
    return name, g, cfg, F0, jmodel, ref


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return _case(request.param)


def _assert_device_equal(ours, ref):
    assert (ours.num_cycles, ours.total_iters, ours.num_repairs) == (
        ref.num_cycles, ref.total_iters, ref.num_repairs)
    np.testing.assert_allclose(ours.cycles_llh, ref.cycles_llh, rtol=RTOL)
    np.testing.assert_allclose(ours.fit.llh, ref.fit.llh, rtol=RTOL)
    assert ours.fit.num_iters == ref.fit.num_iters
    assert ours.stages["counts"] == ref.stages["counts"]


def test_fit_quality_device_matches_jax(case):
    name, g, cfg, F0, jmodel, ref = case
    ours = tq.fit_quality_device(BigClamModel(g, cfg, device="cpu"), F0,
                                 noise=jax_noise(jmodel, F0, cfg.seed))
    _assert_device_equal(ours, ref)
    assert_rows_close(ours.fit.F, ref.fit.F)
    assert ours.num_repairs >= 1
    if name == "repairs":
        assert ours.stages["counts"].get("repair_accepted", 0) >= 1


@pytest.mark.parametrize("balance", [False, True])
def test_fit_quality_device_on_a_mesh_matches_jax(balance):
    """The all-gather trainer at dp = 7 (n_pad past N: padding rows), with
    JAX's draws placed at its internal rows. Balanced, the atoms are
    planned in the relabeled ids, so the columns come out in another order
    (the same in JAX): the LLHs and counts still agree."""
    _, g, cfg, F0, jmodel, ref = _case("planted")
    model = ShardedBigClamModel(g, cfg, make_mesh((7, 1), [torch.device("cpu")] * 7),
                                balance=balance)
    assert model.n_pad > g.num_nodes
    ours = tq.fit_quality_device(model, F0, noise=jax_noise(
        jmodel, F0, cfg.seed, perm=model._perm))
    _assert_device_equal(ours, ref)
    if not balance:
        assert_rows_close(ours.fit.F, ref.fit.F)


# ------------------------------------------------------------ contract
@pytest.fixture(scope="module")
def small():
    g, truth = sample_planted_graph(600, 25, p_in=0.3,
                                    rng=np.random.default_rng(7))
    k = len(truth)
    cfg = BigClamConfig(num_communities=k, quality_mode=True,
                        restart_cycles=2, restart_tol=0.0)
    F0 = seeding.init_F(g, seeding.conductance_seeds(g, cfg), cfg,
                        np.random.default_rng(0))
    return g, cfg, F0


def test_device_quality_transfer_contract(small):
    g, cfg, F0 = small
    model = BigClamModel(g, cfg, device="cpu")
    fetches, uploads = [], []
    orig_extract, orig_init = model.extract_F, model.init_state
    model.extract_F = lambda st: fetches.append(1) or orig_extract(st)
    model.init_state = lambda F: uploads.append(1) or orig_init(F)

    def no_fit(*a, **kw):
        raise AssertionError("the device schedule must not call model.fit")

    model.fit = no_fit
    qres = tq.fit_quality_device(model, F0)
    counts = qres.stages["counts"]
    rounds = counts.get("repair_rounds", 0)
    assert rounds >= 1
    assert len(fetches) <= rounds + 1
    assert counts["f_device_fetches"] == len(fetches)
    assert counts["f_host_uploads"] == len(uploads) == 1
    assert {"anneal", "repair_detect", "final_fetch"} <= set(
        qres.stages["seconds"])


def test_device_repair_checkpoint_resume(small, tmp_path):
    g, cfg, F0 = small
    model = BigClamModel(g, cfg, device="cpu")
    cm = CheckpointManager(str(tmp_path / "q"))
    r1 = tq.fit_quality_device(model, F0, checkpoints=cm)
    calls = []
    orig = model.fit_state
    model.fit_state = lambda st, **kw: calls.append(1) or orig(st, **kw)
    r2 = tq.fit_quality_device(model, F0, checkpoints=cm)
    assert len(calls) == r2.num_cycles        # the repair stage restored
    assert (r2.fit.llh, r2.num_repairs) == (r1.fit.llh, r1.num_repairs)
    np.testing.assert_array_equal(r2.fit.F, r1.fit.F)
    meta = CheckpointManager(str(tmp_path / "q" / "repair")).restore()[2]
    assert meta["rng"] == "device" and meta["done"]
    calls.clear()
    r3 = tq.fit_quality_device(model, F0, checkpoints=cm, resume=False)
    assert len(calls) > r3.num_cycles         # a cold stage refits again
    assert r3.fit.llh == r1.fit.llh


@pytest.mark.parametrize("cls,dp,balance", [
    (ShardedBigClamModel, 7, True), (RingBigClamModel, 7, False),
])
def test_device_quality_sharded_padding_inert(small, cls, dp, balance):
    g, cfg, _ = small
    k = cfg.num_communities
    k0 = k - 4
    model = cls(g, cfg, make_mesh((dp, 1), [torch.device("cpu")] * dp),
                balance=balance)
    assert model.n_pad > g.num_nodes
    qres = tq.fit_quality_device(model, np.zeros((g.num_nodes, k)),
                                 kick_cols=k0)
    F = qres.fit.F
    assert np.all(F[:, k0:] == 0.0) and np.any(F[:, :k0] > 0.0)


def test_kick_and_edits_keep_padding_zero(small):
    """The kick, the scatter edits and clear_col touch only the live
    block: K padded to 32 on csr_fused, rows padded on a dp = 7 mesh, and
    on a (2, 2) K-sharded mesh with the kernels (k_pad 64 > K = 25: two
    column blocks of 32, the second holding padding columns past K) the
    kick block by block, each edit and clear in the block owning its
    column."""
    from bigclam_tpu_torch.parallel.mesh import row_shards

    g, cfg, _ = small
    n = g.num_nodes
    noise = tq.DeviceNoise(cfg.seed, 5)
    dense = BigClamModel(g, cfg.replace(use_pallas_csr=True), device="cpu")
    mesh = ShardedBigClamModel(g, cfg, make_mesh((7, 1), [torch.device("cpu")] * 7),
                               balance=True)
    tp2 = ShardedBigClamModel(g, cfg.replace(num_communities=40, use_pallas_csr=True),
                              make_mesh((2, 2), [torch.device("cpu")] * 4))
    assert tp2.tp == 2 and tp2.k_pad == 64
    for model in (dense, mesh, tp2):
        k = model.cfg.num_communities
        kc = k - 3
        st = model.init_state(np.ones((n, k)))
        F = tq.kick_F(st.F, noise(0, (n, kc), 0.01, torch.float32, "cpu"),
                      n, kc, 0.0, 1000.0)
        full = torch.cat(row_shards(F)).numpy()
        assert full.shape == (model.n_pad, model.k_pad)
        assert (model.n_pad, model.k_pad) != (n, k)
        assert np.all(full[n:] == 0) and np.all(full[:, k:] == 0)
        assert np.all(full[:n, kc:k] == 1.0)          # beyond kick_cols
        assert np.all((full[:n, :kc] >= 1.0) & (full[:n, :kc] < 1.01))
        assert np.all(torch.cat(row_shards(st.F)).numpy()[:n, :k] == 1.0)
        parts = tq._map_parts(torch.clone, tq._parts(F))
        rows = np.array([0, n - 1, model.n_pad + 7, 3, 5])
        # k - 5 and k - 4: in the second column block at tp = 2 (K = 40)
        tq.scatter_set_(parts, rows, np.array([1, 2, 1, model.k_pad, k - 5]), 9.0)
        tq.clear_col_(parts, 4)
        tq.clear_col_(parts, k - 4)
        out = torch.cat(row_shards(tq._as_layout(F, parts))).numpy()
        assert out[0, 1] == 9.0 and out[n - 1, 2] == 9.0 and out[5, k - 5] == 9.0
        assert np.all(out[n:] == 0) and np.all(out[:, k:] == 0)
        assert np.all(out[:, 4] == 0) and np.all(out[:, k - 4] == 0)
        assert np.count_nonzero(out == 9.0) == 3      # out of range dropped
        keep = np.setdiff1d(np.arange(k), [1, 2, 4, k - 5, k - 4])
        assert np.array_equal(out[6:n, keep], full[6:n, keep])


def test_default_noise_deterministic_per_seed_and_salt(small):
    g, cfg, F0 = small
    n = g.num_nodes
    a = tq.DeviceNoise(3, 0)(7, (n, 5), 0.5, torch.float64, "cpu")
    b = tq.DeviceNoise(3, 0)(7, (n, 5), 0.5, torch.float64, "cpu")
    assert torch.equal(a, b)
    assert float(a.min()) >= 0.0 and float(a.max()) < 0.5
    for other in (tq.DeviceNoise(3, 1), tq.DeviceNoise(4, 0)):
        assert not torch.equal(a, other(7, (n, 5), 0.5, torch.float64, "cpu"))
    assert not torch.equal(a, tq.DeviceNoise(3, 0)(8, (n, 5), 0.5,
                                                   torch.float64, "cpu"))
    model = BigClamModel(g, cfg, device="cpu")
    r1 = tq.fit_quality_device(model, F0)
    r2 = tq.fit_quality_device(model, F0)
    r3 = tq.fit_quality_device(model, F0, key_salt=1)
    np.testing.assert_array_equal(r1.fit.F, r2.fit.F)
    assert r1.cycles_llh == r2.cycles_llh
    assert r3.cycles_llh != r1.cycles_llh
