"""The port's plain torch objective and line search against the JAX
package (bigclam_tpu.ops.objective / ops.linesearch) and the float64 NumPy
spec interpreter, at the tolerances tests/test_jax_core.py holds the JAX
core to (rtol 1e-12, float64)."""

import numpy as np
import pytest
import torch

from bigclam_tpu.config import BigClamConfig as JaxConfig
from bigclam_tpu.models.bigclam import prepare_graph
from bigclam_tpu.ops import linesearch as jls
from bigclam_tpu.ops import objective as jobj
from bigclam_tpu.spec import interpreter as spec

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.ops import linesearch as ls
from bigclam_tpu_torch.ops import objective as obj

torch.set_num_threads(2)

JCFG = JaxConfig(num_communities=4, dtype="float64", edge_chunk=8)


def _port_cfg(jcfg):
    import dataclasses

    return BigClamConfig(**dataclasses.asdict(jcfg))


def _rand_F(seed, n, k):
    return np.random.default_rng(seed).uniform(0.1, 1.0, size=(n, k))


def _port_graph(g):
    return Graph(indptr=g.indptr, indices=g.indices, raw_ids=g.raw_ids)


def _edges(g, chunk=8):
    return obj.EdgeChunks(
        torch.as_tensor(g.src.astype(np.int64)),
        torch.as_tensor(g.dst.astype(np.int64)),
        chunk,
    )


def _jax_inputs(g, F):
    import jax.numpy as jnp

    edges, n_pad = prepare_graph(g, JCFG, dtype=jnp.float64)
    assert n_pad == g.num_nodes
    Fd = jnp.asarray(F)
    return edges, Fd, Fd.sum(axis=0)


def test_config_carries_over_by_asdict():
    import dataclasses

    j = JaxConfig(num_communities=7, csr_fused=False, step_scale=0.5)
    p = _port_cfg(j)
    assert dataclasses.asdict(p) == dataclasses.asdict(j)
    assert p.step_candidates == j.step_candidates


def test_edge_terms_match_jax():
    x = np.random.default_rng(0).uniform(0.0, 8.0, 200)
    x[:3] = [0.0, 1e-9, 40.0]
    omp_j, ell_j = jobj.edge_terms(x, JCFG)
    omp_p, ell_p = obj.edge_terms(torch.as_tensor(x), _port_cfg(JCFG))
    np.testing.assert_allclose(omp_p.numpy(), np.asarray(omp_j), rtol=1e-12)
    np.testing.assert_allclose(ell_p.numpy(), np.asarray(ell_j), rtol=1e-12)


def test_grad_llh_matches_jax_and_spec(toy_graphs):
    cfg = _port_cfg(JCFG)
    for name, g in toy_graphs.items():
        F = _rand_F(0, g.num_nodes, 4)
        Ft = torch.as_tensor(F)
        grad_p, llh_p = obj.grad_llh(Ft, Ft.sum(0), _edges(g), cfg)
        edges, Fd, sumFd = _jax_inputs(g, F)
        grad_j, llh_j = jobj.grad_llh(Fd, sumFd, edges, JCFG)
        grad_s, llh_s = spec.grad_llh(F, F.sum(0), g, JCFG)
        np.testing.assert_allclose(grad_p.numpy(), np.asarray(grad_j), rtol=1e-12, err_msg=name)
        np.testing.assert_allclose(llh_p.numpy(), np.asarray(llh_j), rtol=1e-12, err_msg=name)
        np.testing.assert_allclose(grad_p.numpy(), grad_s, rtol=1e-12, err_msg=name)
        np.testing.assert_allclose(llh_p.numpy(), llh_s, rtol=1e-12, err_msg=name)


def test_loglikelihood_matches_jax_and_spec(toy_graphs):
    g = toy_graphs["two_cliques"]
    F = _rand_F(1, g.num_nodes, 4)
    Ft = torch.as_tensor(F)
    llh_p = float(obj.loglikelihood(Ft, Ft.sum(0), _edges(g, chunk=5), _port_cfg(JCFG)))
    edges, Fd, sumFd = _jax_inputs(g, F)
    assert np.isclose(llh_p, float(jobj.loglikelihood(Fd, sumFd, edges, JCFG)), rtol=1e-12)
    assert np.isclose(llh_p, spec.loglikelihood(F, F.sum(0), g, JCFG), rtol=1e-12)


def test_candidates_and_update_match_jax_and_spec(toy_graphs):
    cfg = _port_cfg(JCFG)
    for name, g in toy_graphs.items():
        F = _rand_F(2, g.num_nodes, 4)
        Ft = torch.as_tensor(F)
        sumF = Ft.sum(0)
        e = _edges(g)
        grad, llh = obj.grad_llh(Ft, sumF, e, cfg)
        cand_p = ls.candidates_pass(Ft, grad, e, cfg)
        F1_p, sumF1_p, hist_p = ls.armijo_update(
            Ft, sumF, grad, llh, cand_p, cfg, with_stats=True
        )
        edges, Fd, sumFd = _jax_inputs(g, F)
        grad_j, llh_j = jobj.grad_llh(Fd, sumFd, edges, JCFG)
        cand_j = jls.candidates_pass(Fd, grad_j, edges, JCFG)
        F1_j, sumF1_j, hist_j = jls.armijo_update(
            Fd, sumFd, grad_j, llh_j, cand_j, JCFG, with_stats=True
        )
        F1_s, sumF1_s, _ = spec.line_search_step(F, F.sum(0), g, JCFG)
        np.testing.assert_allclose(cand_p.numpy(), np.asarray(cand_j), rtol=1e-12, err_msg=name)
        np.testing.assert_allclose(F1_p.numpy(), np.asarray(F1_j), rtol=1e-12, err_msg=name)
        np.testing.assert_allclose(F1_p.numpy(), F1_s, rtol=1e-12, err_msg=name)
        np.testing.assert_allclose(sumF1_p.numpy(), sumF1_s, rtol=1e-12)
        np.testing.assert_array_equal(hist_p.numpy(), np.asarray(hist_j))


def test_armijo_select_matches_jax(toy_graphs):
    g = toy_graphs["two_cliques"]
    cfg = _port_cfg(JCFG)
    F = _rand_F(3, g.num_nodes, 4)
    Ft = torch.as_tensor(F)
    e = _edges(g)
    grad, llh = obj.grad_llh(Ft, Ft.sum(0), e, cfg)
    cand = ls.candidates_pass(Ft, grad, e, cfg) + ls.armijo_tails(Ft, Ft.sum(0), grad, cfg)
    F1_p, _ = ls.armijo_select(Ft, grad, llh, cand, cfg)
    F1_j, _ = jls.armijo_select(
        F, grad.numpy(), llh.numpy(), cand.numpy(), JCFG
    )
    np.testing.assert_allclose(F1_p.numpy(), np.asarray(F1_j), rtol=1e-12)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accept_stats_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ok = rng.random((16, 40)) < 0.2
    ok[:, :3] = False                          # some rows accept nothing
    ok[0, 3] = True
    np.testing.assert_array_equal(
        ls.accept_stats(torch.as_tensor(ok)).numpy(),
        np.asarray(jls.accept_stats(ok)),
    )


def test_edge_terms_stable_below_f32_floor():
    """The -expm1 form of 1-p keeps full f32 relative precision for tiny
    edge dots, where 1 - exp(-x) collapses to 0 (the JAX core's floor
    case, tests/test_jax_core.py)."""
    cfg = BigClamConfig(num_communities=4, max_p=1.0 - 1e-12)
    for x in (1e-10, 1e-8, 1e-5):
        omp, ell = obj.edge_terms(torch.tensor(x, dtype=torch.float32), cfg)
        np.testing.assert_allclose(float(omp), x, rtol=1e-5)
        np.testing.assert_allclose(float(ell), np.log(x) + x, rtol=1e-5)
    omp_clip, _ = obj.edge_terms(torch.tensor(1e-14, dtype=torch.float32), cfg)
    np.testing.assert_allclose(float(omp_clip), 1e-12, rtol=1e-4)
    omp64, _ = obj.edge_terms(torch.tensor(0.3, dtype=torch.float64), _port_cfg(JCFG))
    np.testing.assert_allclose(float(omp64), 1.0 - np.exp(-0.3), rtol=1e-14)


def test_edge_chunks_cover_every_edge_once(toy_graphs):
    g = toy_graphs["two_cliques"]
    e = _edges(g, chunk=7)
    got = torch.cat([s for s, _ in e.slices()]).numpy()
    np.testing.assert_array_equal(got, g.src)
    assert obj.edge_chunk_bound(BigClamConfig(edge_chunk=1 << 20), 1024) == 262144
