"""The port's trainer against the JAX package's `BigClamModel`, step for
step on each kernel path: `csr_fused` and `csr` on the kernels' plain
versions in float32 (JAX: the Pallas kernels in interpret mode, block 8,
tile 8) at rtol = atol = 3e-5, and `xla` in float64 at 1e-10. Also the
convergence rule, a JAX state carried across, path resolution and the
device policy."""

import dataclasses

import numpy as np
import pytest
import torch

from bigclam_tpu.config import BigClamConfig as JaxConfig
from bigclam_tpu.graph.ingest import graph_from_edges as jax_graph_from_edges
from bigclam_tpu.models.bigclam import BigClamModel as JaxModel

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.models.bigclam import (
    BigClamModel,
    state_from_jax_arrays,
)
from bigclam_tpu_torch.ops import fused
from bigclam_tpu_torch.ops.csr_kernels import KernelKLimitError
from bigclam_tpu_torch.utils.device import DeviceUnavailableError

torch.set_num_threads(2)

TIE = 1e-5


def _random_graph(seed, n=57, p=0.12):
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < p
    edges = [(i, j) for i in range(n) for j in range(i + 1, n) if a[i, j]]
    edges.append((0, n - 1))
    return jax_graph_from_edges(edges, num_nodes=n)


def _port_graph(g):
    return Graph(indptr=g.indptr, indices=g.indices, raw_ids=g.raw_ids)


def _jcfg(**kw):
    base = dict(
        num_communities=6, dtype="float32", edge_chunk=64,
        use_pallas_csr=True, pallas_interpret=True,
        csr_block_b=8, csr_tile_t=8,
    )
    base.update(kw)
    return JaxConfig(**base)


def _port_model(g, jcfg):
    cfg = BigClamConfig(**dataclasses.asdict(jcfg))
    return BigClamModel(_port_graph(g), cfg, device="cpu")


def _near_ties(model, state):
    """(S, N) near-tie mask of the port's acceptance test at `state`."""
    _, _, cand, thr = fused.acceptance_inputs_plain(
        state.F, state.sumF, model.csr, model.cfg
    )
    return ((cand - thr).abs() <= TIE * thr.abs().clamp_min(1.0)).numpy()


@pytest.mark.parametrize(
    "path,jkw",
    [("csr_fused", {}), ("csr", {"csr_fused": False})],
)
def test_three_f32_steps_match_jax_on_csr_paths(path, jkw):
    g = _random_graph(0)
    n, k = g.num_nodes, 6
    F0 = np.random.default_rng(1).uniform(0.0, 1.0, (n, k))
    jm = JaxModel(g, _jcfg(**jkw))
    pm = _port_model(g, _jcfg(**jkw))
    assert jm.engaged_path == pm.engaged_path == path
    sj, sp = jm.init_state(F0), pm.init_state(F0)
    for _ in range(3):
        ties = _near_ties(pm, sp)
        sj, sp = jm._step(sj), pm._step(sp)
        np.testing.assert_allclose(
            sp.F[:n, :k].numpy(), np.asarray(sj.F)[:n, :k], rtol=3e-5, atol=3e-5
        )
        np.testing.assert_allclose(float(sp.llh), float(sj.llh), rtol=3e-5)
        hist_diff = np.abs(sp.accept_hist.numpy() - np.asarray(sj.accept_hist))
        # equal, or moved only by acceptance flips at near-ties
        assert hist_diff.sum() <= 2 * ties.any(axis=0).sum()
    assert sp.it == int(sj.it) == 3


def test_three_f64_xla_steps_match_jax():
    g = _random_graph(2, n=41)
    n, k = g.num_nodes, 5
    F0 = np.random.default_rng(3).uniform(0.0, 1.0, (n, k))
    jcfg = JaxConfig(num_communities=k, dtype="float64", edge_chunk=16,
                     use_pallas_csr=False)
    jm, pm = JaxModel(g, jcfg), _port_model(g, jcfg)
    assert jm.engaged_path == pm.engaged_path == "xla"
    sj, sp = jm.init_state(F0), pm.init_state(F0)
    for _ in range(3):
        sj, sp = jm._step(sj), pm._step(sp)
        np.testing.assert_allclose(sp.F.numpy(), np.asarray(sj.F), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(float(sp.llh), float(sj.llh), rtol=1e-10)
        np.testing.assert_array_equal(sp.accept_hist.numpy(), np.asarray(sj.accept_hist))


def test_fit_converges_in_the_same_iterations_as_jax(toy_graphs):
    g = toy_graphs["two_cliques"]
    jcfg = JaxConfig(num_communities=4, dtype="float64", conv_tol=1e-4,
                     max_iters=200, use_pallas_csr=False)
    F0 = np.random.default_rng(5).uniform(0.1, 1.0, (g.num_nodes, 4))
    rj = JaxModel(g, jcfg).fit(F0)
    rp = _port_model(g, jcfg).fit(F0)
    assert rp.num_iters == rj.num_iters
    assert len(rp.llh_history) == len(rj.llh_history)
    np.testing.assert_allclose(rp.llh_history, rj.llh_history, rtol=1e-10)
    np.testing.assert_allclose(rp.F, rj.F, rtol=1e-9, atol=1e-12)


def test_max_iters_stops_after_evaluating_the_last_iteration(toy_graphs):
    g = toy_graphs["two_cliques"]
    jcfg = JaxConfig(num_communities=4, dtype="float64", conv_tol=0.0,
                     max_iters=3, use_pallas_csr=False)
    F0 = np.random.default_rng(6).uniform(0.1, 1.0, (g.num_nodes, 4))
    rj = JaxModel(g, jcfg).fit(F0)
    rp = _port_model(g, jcfg).fit(F0)
    assert rp.num_iters == rj.num_iters == 3
    assert len(rp.llh_history) == len(rj.llh_history) == 4
    np.testing.assert_allclose(rp.llh_history, rj.llh_history, rtol=1e-10)


def test_jax_state_carried_across_gives_the_same_next_step():
    """Two JAX fused steps, the state moved into the port's layout
    (the JAX rows past n and columns past K stripped, K re-padded to the
    port's 32-multiple), then one more step in each package."""
    g = _random_graph(4)
    n, k = g.num_nodes, 6
    F0 = np.random.default_rng(7).uniform(0.0, 1.0, (n, k))
    jm = JaxModel(g, _jcfg())
    pm = _port_model(g, _jcfg())
    sj = jm._step(jm._step(jm.init_state(F0)))
    assert np.asarray(sj.F).shape != (n, pm.k_pad)   # different layouts
    sp = pm.state_from_jax(np.asarray(sj.F), llh=float(sj.llh), it=int(sj.it))
    assert tuple(sp.F.shape) == (n, pm.k_pad) and sp.it == 2
    np.testing.assert_allclose(
        sp.sumF[:k].numpy(), np.asarray(sj.F)[:n, :k].sum(0), rtol=1e-6
    )
    sj2, sp2 = jm._step(sj), pm._step(sp)
    np.testing.assert_allclose(
        sp2.F[:n, :k].numpy(), np.asarray(sj2.F)[:n, :k], rtol=3e-5, atol=3e-5
    )
    np.testing.assert_allclose(float(sp2.llh), float(sj2.llh), rtol=3e-5)
    same = state_from_jax_arrays(
        np.asarray(sj.F), n, k, pm.k_pad, torch.float32, torch.device("cpu")
    )
    assert torch.equal(same.F, sp.F)


def test_auto_path_on_cpu_is_xla_and_on_means_plain_kernels(toy_graphs):
    g = _port_graph(toy_graphs["two_cliques"])
    m = BigClamModel(g, BigClamConfig(num_communities=4), device="cpu")
    assert m.engaged_path == "xla" and "not cuda" in m.path_reason
    assert m.k_pad == 4
    m = BigClamModel(g, BigClamConfig(num_communities=4, use_pallas_csr=True),
                     device="cpu")
    assert m.engaged_path == "csr_fused" and m.k_pad == 32
    m = BigClamModel(
        g, BigClamConfig(num_communities=4, use_pallas_csr=True, csr_fused=False),
        device="cpu",
    )
    assert m.engaged_path == "csr"
    with pytest.raises(ValueError, match="float32"):
        BigClamModel(
            g, BigClamConfig(num_communities=4, use_pallas_csr=True,
                             dtype="float64"), device="cpu",
        )
    with pytest.raises(ValueError, match="min_f"):
        BigClamModel(
            g, BigClamConfig(num_communities=4, use_pallas_csr=True, min_f=0.1),
            device="cpu",
        )


def test_no_device_and_no_card_raises(toy_graphs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    g = _port_graph(toy_graphs["triangle"])
    with pytest.raises(DeviceUnavailableError):
        BigClamModel(g, BigClamConfig(num_communities=2))
    with pytest.raises(DeviceUnavailableError):
        BigClamModel(g, BigClamConfig(num_communities=2), device="cuda")


def test_float64_is_a_cpu_dtype_and_k_bound_is_named():
    from bigclam_tpu_torch.utils.device import resolve_dtype

    assert resolve_dtype("float64", torch.device("cpu")) == torch.float64
    with pytest.raises(ValueError, match="CPU parity"):
        resolve_dtype("float64", torch.device("cuda"))
    assert issubclass(KernelKLimitError, ValueError)
