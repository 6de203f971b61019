"""The plain versions of the port's three CUDA kernels against the JAX
package's Pallas kernels in interpret mode (as tests/test_fused.py runs
them: block 8, tile 8, float32), and — on a card only — each CUDA kernel
against its plain version run in float64.

Tolerances: F_new, grad and node_llh at rtol = atol = 3e-5 (the float32
band tests/test_fused.py holds fused vs split vs xla to). The 0/1
acceptance mask must be equal except where
|cand - threshold| <= 1e-5 * max(1, |threshold|): a near-tie that another
summation order may flip. F_new rows are compared wherever the chosen
(largest accepted) step agrees, which includes every row whose whole
mask agrees.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigclam_tpu.config import BigClamConfig as JaxConfig
from bigclam_tpu.graph.ingest import graph_from_edges as jax_graph_from_edges
from bigclam_tpu.ops.csr_tiles import build_block_tiles
from bigclam_tpu.ops.pallas_csr import candidates_csr as jax_candidates_csr
from bigclam_tpu.ops.pallas_csr import device_tiles
from bigclam_tpu.ops.pallas_csr import grad_llh_csr as jax_grad_llh_csr
from bigclam_tpu.ops.pallas_fused import fused_superstep_csr

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.ops import csr_kernels as ck
from bigclam_tpu_torch.ops import fused

torch.set_num_threads(2)

RTOL = ATOL = 3e-5
TIE = 1e-5


def _random_graph(seed, n=57, p=0.12, isolated=()):
    """tests/test_fused.py's random graph, optionally with isolated nodes
    (their edges removed; node count unchanged)."""
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < p
    edges = [(i, j) for i in range(n) for j in range(i + 1, n) if a[i, j]]
    edges.append((0, n - 1))
    edges = [e for e in edges if e[0] not in isolated and e[1] not in isolated]
    return jax_graph_from_edges(edges, num_nodes=n)


def _hub_graph(isolated, n=760, degrees=(100, 700), p=0.005, seed=5):
    """A sparse random graph plus hubs: node i gets `degrees[i]` random
    neighbours, so its edges fill many 32-neighbour tiles of the CUDA
    kernels' candidate pass (and the isolated nodes lose their edges)."""
    rng = np.random.default_rng(seed)
    a = np.triu(rng.random((n, n)) < p, 1)
    for hub, deg in enumerate(degrees):
        others = np.setdiff1d(np.arange(n), [hub, *isolated])
        a[hub, rng.choice(others, deg, replace=False)] = True
    a = a | a.T
    a[list(isolated), :] = False
    a[:, list(isolated)] = False
    i, j = np.nonzero(np.triu(a, 1))
    return jax_graph_from_edges(list(zip(i.tolist(), j.tolist())), num_nodes=n)


# the hub graphs by name: _hub_graph's arguments. "hub_tiles": a small
# graph whose hubs (degrees 96 and 76) fill three 32-row ladder tiles each,
# the last one whole or of 12 rows
HUBS = {
    "hub": dict(n=760, degrees=(100, 700), p=0.005, seed=5),
    "hub_tiles": dict(n=240, degrees=(96, 75), p=0.01, seed=8),
}

# (graph seed or hub name, K, isolated nodes, all-zero F row, Armijo ladder
# length)
CASES = {
    "fused_test_graph": (0, 6, (), None, 16),
    "isolated_nodes": (1, 5, (3, 20), None, 16),
    "k_not_multiple_of_pad": (2, 37, (), 11, 16),
    "short_ladder": (3, 12, (), None, 8),
    "hub_k37": ("hub", 37, (3, 20), 11, 16),
    "hub_k100": ("hub", 100, (3, 20), 11, 16),
    "hub_tiles_k37": ("hub_tiles", 37, (4, 30), 12, 16),
}


def _case(name):
    seed, k, isolated, zero_row, num_s = CASES[name]
    if seed in HUBS:
        hub = HUBS[seed]
        g, seed = _hub_graph(isolated, **hub), hub["seed"]
        assert all(g.degrees[i] >= d for i, d in enumerate(hub["degrees"]))
    else:
        g = _random_graph(seed, isolated=isolated)
    assert all(g.degrees[u] == 0 for u in isolated)
    F = np.random.default_rng(seed + 10).uniform(0.0, 1.0, (g.num_nodes, k))
    if zero_row is not None:
        F[zero_row] = 0.0
    cfg = JaxConfig(num_communities=k, max_backtracks=num_s - 1)
    return g, F.astype(np.float32), cfg


def _jax_tiles(g, with_seq):
    return device_tiles(build_block_tiles(g, 8, 8), jnp.float32, with_seq=with_seq)


def _jax_F(F, n_pad):
    Fp = np.zeros((n_pad, F.shape[1]), np.float32)
    Fp[: F.shape[0]] = F
    return jnp.asarray(Fp)


def _port(g, F, jcfg):
    cfg = BigClamConfig(**dataclasses.asdict(jcfg))
    csr = Graph(g.indptr, g.indices, g.raw_ids).to_device(torch.device("cpu"))
    Ft = torch.as_tensor(F)
    return Ft, Ft.sum(dim=0), csr, cfg


def _same_step_rows(ok_a, ok_b):
    """Nodes whose chosen step (first accepted candidate, or none) agrees."""
    ok_a, ok_b = np.asarray(ok_a, bool), np.asarray(ok_b, bool)
    first = lambda ok: np.where(ok.any(axis=0), ok.argmax(axis=0), -1)  # noqa: E731
    return first(ok_a) == first(ok_b)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_grad_plain_matches_pallas_grad_llh_csr(case):
    g, F, jcfg = _case(case)
    n = g.num_nodes
    Ft, sumF, csr, cfg = _port(g, F, jcfg)
    grad_p, llh_p = ck.grad_llh_csr(Ft, sumF, csr, cfg)        # cpu: plain
    tiles = _jax_tiles(g, with_seq=False)
    Fj = _jax_F(F, tiles.n_pad)
    grad_j, llh_j = jax_grad_llh_csr(Fj, Fj.sum(axis=0), tiles, jcfg, interpret=True)
    _close(grad_p.numpy(), np.asarray(grad_j)[:n])
    _close(llh_p.numpy(), np.asarray(llh_j)[:n])


@pytest.mark.parametrize("case", sorted(CASES))
def test_candidates_plain_matches_pallas_candidates_csr(case):
    g, F, jcfg = _case(case)
    n = g.num_nodes
    Ft, sumF, csr, cfg = _port(g, F, jcfg)
    grad, _ = ck.grad_llh_csr(Ft, sumF, csr, cfg)
    cand_p = ck.candidates_csr(Ft, grad, sumF, csr, cfg)
    tiles = _jax_tiles(g, with_seq=False)
    Fj = _jax_F(F, tiles.n_pad)
    gj = _jax_F(grad.numpy(), tiles.n_pad)
    cand_j = jax_candidates_csr(Fj, gj, Fj.sum(axis=0), tiles, jcfg, interpret=True)
    assert cand_p.shape == (len(cfg.step_candidates), n)
    _close(cand_p.numpy(), np.asarray(cand_j)[:, :n])


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_plain_matches_pallas_fused_superstep(case):
    g, F, jcfg = _case(case)
    n = g.num_nodes
    Ft, sumF, csr, cfg = _port(g, F, jcfg)
    Fn_p, grad_p, llh_p, ok_p = fused.fused_superstep(Ft, sumF, csr, cfg)
    _, _, cand, thr = fused.acceptance_inputs_plain(Ft, sumF, csr, cfg)
    tiles = _jax_tiles(g, with_seq=True)
    Fj = _jax_F(F, tiles.n_pad)
    Fn_j, grad_j, llh_j, ok_j = fused_superstep_csr(
        Fj, Fj.sum(axis=0), tiles, jcfg, interpret=True
    )
    _close(grad_p.numpy(), np.asarray(grad_j)[:n])
    _close(llh_p.numpy(), np.asarray(llh_j)[:n])
    ok_j = np.asarray(ok_j)[:, :n] > 0
    diff = ok_p.numpy() != ok_j
    tie = np.abs((cand - thr).numpy()) <= TIE * np.maximum(1.0, np.abs(thr.numpy()))
    assert not (diff & ~tie).any(), "acceptance differs away from a near-tie"
    rows = _same_step_rows(ok_p.numpy(), ok_j)
    assert rows.sum() > n // 2
    _close(Fn_p.numpy()[rows], np.asarray(Fn_j)[:n][rows])


def test_zero_isolated_row_stays_put():
    """An all-zero isolated row is inert (grad = -sumF <= 0 clips back to
    zero, as padding rows are); an isolated node gets only its tail
    terms."""
    g, F, jcfg = _case("isolated_nodes")
    F[20] = 0.0                                     # isolated, all zero
    Ft, sumF, csr, cfg = _port(g, F, jcfg)
    Fn, grad, llh, ok = fused.fused_superstep(Ft, sumF, csr, cfg)
    assert torch.all(Fn[20] == 0) and not ok[:, 20].any()
    u = 3                                           # isolated
    tail = float(-(Ft[u] @ sumF) + (Ft[u] * Ft[u]).sum())
    np.testing.assert_allclose(float(llh[u]), tail, rtol=1e-6)
    np.testing.assert_allclose(grad[u].numpy(), (Ft[u] - sumF).numpy(), rtol=1e-6)


def test_cuda_input_checks_name_the_k_limit():
    """The CUDA wrappers' input checks run before any launch: K above the
    single-pass bound raises the named error pointing at csr_fused_kb."""
    g, F, jcfg = _case("fused_test_graph")
    Ft, sumF, csr, cfg = _port(g, F, jcfg)
    wide = torch.zeros((g.num_nodes, ck.MAX_K + 1))
    with pytest.raises(ck.KernelKLimitError, match="csr_fused_kb"):
        ck.check_cuda_inputs(wide, csr, torch.zeros(ck.MAX_K + 1))
    with pytest.raises(TypeError, match="float32"):
        ck.check_cuda_inputs(Ft.double(), csr, sumF.double())
    with pytest.raises(ValueError, match="shape"):
        ck.check_cuda_inputs(Ft, csr, sumF[:-1])
    ck.check_cuda_inputs(Ft, csr, sumF, rows=(Ft,))        # well-formed


def test_kernel_constants_are_float32_rounded():
    c = ck.kernel_constants(BigClamConfig())
    assert c["num_s"] == 16 and c["etas"].dtype == np.float32
    assert c["coefs"][3] == np.float32(0.05 * BigClamConfig().step_candidates[3])
    assert c["omp_lo"] == float(np.float32(1.0 - 0.9999))
    with pytest.raises(ValueError, match="16 step candidates"):
        ck.kernel_constants(BigClamConfig(max_backtracks=16))


# the ladder kernels with a per-bucket plan (#14's takes any K)
LADDER_KERNELS = ("fused_superstep", "candidates_csr", "ring_cand_phase", "cand_dots_kb")


def _header_constant(name):
    """A `constexpr int` of csrc/edge_common.cuh, by name."""
    import pathlib
    import re

    text = (pathlib.Path(ck.__file__).parent.parent / "csrc" / "edge_common.cuh").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("k", [1, 37, 1000, 1024])
@pytest.mark.parametrize("kernel", LADDER_KERNELS)
def test_ladder_launch_plan_fits_one_block(kernel, k):
    """The launch plan the wrappers pass and the C entries check: the
    block's shared memory within Hopper's 227 KB, the opt-in above 48 KB,
    and the sizes of csrc/edge_common.cuh (`fused_smem_bytes`,
    `candidates_smem_bytes`, `ring_cand_smem_bytes`,
    `cand_dots_smem_bytes`)."""
    plan = ck.ladder_launch_plan(kernel, k)
    assert plan["smem_bytes"] <= 227 * 1024       # an H100 block's most
    assert plan["opt_in"] == (plan["smem_bytes"] > 48 * 1024)
    kpl = plan["kpl"]
    assert kpl == ck.kpl_bucket(k) and k <= 32 * kpl and (kpl == 1 or 16 * kpl < k)
    assert (plan["rows"], plan["chunk"]) == (
        _header_constant("kLadderRows"), _header_constant("kLadderChunk"))
    assert plan["warps_per_block"] == _header_constant("kWarpsPerBlock")
    ladder = 2 * plan["rows"] * (plan["chunk"] + 4) + 4 * (4 * plan["chunk"] + 4)
    extra = {"fused_superstep": 32 * kpl + 16, "candidates_csr": 16}
    per_warp = ladder + extra.get(kernel, 0)
    assert plan["smem_bytes"] == 4 * plan["warps_per_block"] * per_warp


@pytest.mark.parametrize("kernel", LADDER_KERNELS)
def test_ladder_launch_plan_refuses_k_outside_the_single_pass_range(kernel):
    # cand_dots_kb's k is a K block's width: its message names that range
    match = "1..1024" if kernel == "cand_dots_kb" else "csr_fused_kb"
    for k in (0, ck.MAX_K + 1, 3000):
        with pytest.raises(ck.KernelKLimitError, match=match):
            ck.ladder_launch_plan(kernel, k)


# --- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernels_match_plain(case, cuda_device):
    g, F, jcfg = _case(case)
    Ft, sumF, csr, cfg = _port(g, F, jcfg)
    Ft, sumF = Ft.to(cuda_device), sumF.to(cuda_device)
    csr = Graph(g.indptr, g.indices, g.raw_ids).to_device(cuda_device)
    # the plain versions on float64 copies of the same inputs: in float32
    # their own rounding and index_add_'s run-to-run atomic order can flip
    # a decision outside the near-tie band on the hub cases
    F64, sumF64 = Ft.double(), sumF.double()
    grad_p, llh_p, cand_p, thr_p = fused.acceptance_inputs_plain(F64, sumF64, csr, cfg)
    grad_in = grad_p.float()
    before = fused.launch_counts()
    grad_k, llh_k = ck.grad_llh_csr(Ft, sumF, csr, cfg)
    cand_k = ck.candidates_csr(Ft, grad_in, sumF, csr, cfg)
    Fn_k, g_k, l_k, ok_k = fused.fused_superstep(Ft, sumF, csr, cfg)
    Fn_p, _, _, ok_p = fused.fused_superstep_plain(F64, sumF64, csr, cfg)
    torch.cuda.synchronize()
    after = fused.launch_counts()
    assert all(after[k] == before[k] + 1 for k in after)
    cand_in = ck.candidates_csr_plain(F64, grad_in.double(), sumF64, csr, cfg)
    for a, b in ((grad_k, grad_p), (llh_k, llh_p), (cand_k, cand_in),
                 (g_k, grad_p), (l_k, llh_p)):
        _close(a.cpu().numpy(), b.cpu().numpy())
    diff = (ok_k != ok_p).cpu().numpy()
    tie = ((cand_p - thr_p).abs() <= TIE * thr_p.abs().clamp_min(1.0)).cpu().numpy()
    assert not (diff & ~tie).any()
    rows = _same_step_rows(ok_k.cpu().numpy(), ok_p.cpu().numpy())
    _close(Fn_k.cpu().numpy()[rows], Fn_p.cpu().numpy()[rows])


def _planted_hub_graph():
    """chip_smoke.py's hub graph: 40 planted blocks of 20 nodes (p_in 0.3),
    node i joined to 100 and 700 random nodes (degrees 105 and 700 with
    their block edges), and 5 isolated nodes."""
    from bigclam_tpu_torch.graph.ingest import graph_from_edges
    from bigclam_tpu_torch.models.agm import sample_planted_graph

    rng = np.random.default_rng(5)
    g0, _ = sample_planted_graph(800, 40, p_in=0.3, rng=rng)
    pairs = [np.stack([g0.src, g0.dst], axis=1)]
    for hub, deg in enumerate((100, 700)):
        nbrs = rng.choice(np.setdiff1d(np.arange(800), [hub]), deg, replace=False)
        pairs.append(np.stack([np.full(deg, hub), nbrs], axis=1))
    return graph_from_edges(np.concatenate(pairs), num_nodes=805)


def _grad_case(g, k, device, seed=7):
    F = np.random.default_rng(seed).uniform(0.0, 1.0, (g.num_nodes, k))
    F[11] = 0.0
    Ft = torch.as_tensor(F, dtype=torch.float32, device=device)
    return Ft, Ft.sum(dim=0), BigClamConfig(num_communities=k)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [37, 1000, 1024])
def test_cuda_grad_llh_on_the_hub_graph(k, cuda_device):
    """Kernel B (staged rows; 4-byte copies at K=37) against its plain
    version in float64 at rtol = atol = 3e-5 on a graph with hubs of degree
    105 and 700 and isolated nodes."""
    g = _planted_hub_graph()
    assert [int(d) for d in g.degrees[:2]] == [105, 700]
    Ft, sumF, cfg = _grad_case(g, k, cuda_device)
    csr = g.to_device(cuda_device)
    before = ck.grad_llh_csr.launches
    grad_k, llh_k = ck.grad_llh_csr(Ft, sumF, csr, cfg)
    torch.cuda.synchronize()
    assert ck.grad_llh_csr.launches == before + 1
    grad_p, llh_p = ck.grad_llh_csr_plain(Ft.double(), sumF.double(), csr, cfg)
    _close(grad_k.double().cpu().numpy(), grad_p.cpu().numpy())
    _close(llh_k.double().cpu().numpy(), llh_p.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [37, 1000])
def test_cuda_grad_llh_reads_neighbour_rows_of_a_gathered_f(k, cuda_device):
    """The all-gather form: the rows [lo, hi) of the hub graph (the
    degree-700 hub among them), their CSR indexing the gathered F (more
    rows than the local F). It equals its plain version and, bit for bit,
    kernel B's rows [lo, hi) on the whole graph."""
    from bigclam_tpu_torch.parallel.sharded import device_csr

    g = _planted_hub_graph()
    Ft, sumF, cfg = _grad_case(g, k, cuda_device)
    lo, hi = 1, 600
    indptr = np.asarray(g.indptr[lo : hi + 1], np.int64)
    csr = device_csr(indptr - indptr[0], g.indices[indptr[0] : indptr[-1]], cuda_device)
    F_loc = Ft[lo:hi].contiguous()
    grad_k, llh_k = ck.grad_llh_csr(F_loc, sumF, csr, cfg, F_dst=Ft)
    whole_grad, whole_llh = ck.grad_llh_csr(Ft, sumF, g.to_device(cuda_device), cfg)
    torch.cuda.synchronize()
    grad_p, llh_p = ck.grad_llh_csr_plain(F_loc.double(), sumF.double(), csr, cfg,
                                          Ft.double())
    _close(grad_k.double().cpu().numpy(), grad_p.cpu().numpy())
    _close(llh_k.double().cpu().numpy(), llh_p.cpu().numpy())
    assert torch.equal(grad_k, whole_grad[lo:hi])
    assert torch.equal(llh_k, whole_llh[lo:hi])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [37, 1024])
def test_cuda_grad_llh_of_an_isolated_node_is_f_minus_sumf(k, cuda_device):
    """A node without an edge runs no staged row but still gets its fold:
    grad = F_u - sumF exactly, node_llh = its tail."""
    g = _planted_hub_graph()
    iso = np.flatnonzero(g.degrees == 0)
    assert iso.tolist() == [800, 801, 802, 803, 804]
    Ft, sumF, cfg = _grad_case(g, k, cuda_device)
    grad_k, llh_k = ck.grad_llh_csr(Ft, sumF, g.to_device(cuda_device), cfg)
    torch.cuda.synchronize()
    rows = torch.as_tensor(iso, device=cuda_device)
    assert torch.equal(grad_k[rows], Ft[rows] - sumF)
    F64, s64 = Ft[rows].double(), sumF.double()
    _close(llh_k[rows].double().cpu().numpy(),
           (-(F64 * s64).sum(1) + (F64 * F64).sum(1)).cpu().numpy())


@pytest.mark.cuda
def test_cuda_entry_refuses_another_launch_plan(cuda_device):
    """The C entry of kernel A checks the wrapper's shared-memory bytes."""
    from bigclam_tpu_torch.ops import build

    g, F, jcfg = _case("fused_test_graph")
    _, _, _, cfg = _port(g, F, jcfg)
    Ft = torch.as_tensor(F, device=cuda_device)
    sumF = Ft.sum(0)
    csr = Graph(g.indptr, g.indices, g.raw_ids).to_device(cuda_device)
    c = ck.kernel_constants(cfg)
    n, k = Ft.shape
    out = [torch.empty_like(Ft), torch.empty_like(Ft), torch.empty(n, device=cuda_device),
           torch.empty((c["num_s"], n), dtype=torch.bool, device=cuda_device)]
    wrong = ck.ladder_launch_plan("fused_superstep", k)["smem_bytes"] + 16
    with pytest.raises(build.KernelLaunchError):
        build.launch(
            Ft.device, "bigclam_fused_superstep", Ft.data_ptr(), Ft.data_ptr(),
            sumF.data_ptr(), csr.indptr.data_ptr(), csr.indices.data_ptr(), n, k,
            c["etas"].ctypes.data, c["coefs"].ctypes.data, c["num_s"], c["omp_lo"],
            c["omp_hi"], c["min_f"], c["max_f"], *(t.data_ptr() for t in out), wrong,
        )


@pytest.mark.cuda
def test_cuda_wrapper_raises_above_k_bound(cuda_device):
    g, _, _ = _case("fused_test_graph")
    csr = Graph(g.indptr, g.indices, g.raw_ids).to_device(cuda_device)
    F = torch.zeros((g.num_nodes, ck.MAX_K + 32), device=cuda_device)
    with pytest.raises(ck.KernelKLimitError):
        fused.fused_superstep(F, F.sum(0), csr, BigClamConfig())
