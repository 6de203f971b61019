"""The non-CSR step `pallas_vmem` of the port against the JAX package: the
plain version of the candidate edge-terms kernel against the Pallas
kernel `candidate_edge_terms` in interpret mode (float64 at rtol 1e-12,
float32 at rtol = atol = 3e-5, the band tests/test_fused.py holds the f32
paths to), the candidate pass against `candidates_pass_pallas`, the
float64 trajectory against the JAX `BigClamModel` with the Pallas kernel
engaged (1e-10), the path engagement, and — on a card only — the CUDA
kernel against its plain version."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bigclam_tpu.ops.pallas_kernels as jpk
from bigclam_tpu.config import BigClamConfig as JaxConfig
from bigclam_tpu.models.agm import planted_partition_F, sample_graph
from bigclam_tpu.models.bigclam import BigClamModel as JaxModel
from bigclam_tpu.ops import objective as jobj

from bigclam_tpu_torch import cli
from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.models.bigclam import BigClamModel, pick_candidates_impl
from bigclam_tpu_torch.ops import edge_kernels as ek
from bigclam_tpu_torch.ops import linesearch as ls
from bigclam_tpu_torch.ops.objective import EdgeChunks, grad_llh

torch.set_num_threads(2)

RTOL32 = ATOL32 = 3e-5
CUDA = torch.device("cuda")


def _port_graph(g):
    return Graph(indptr=g.indptr, indices=g.indices, raw_ids=g.raw_ids)


def _rows(seed, m, k, k_pad, dtype):
    """Gathered-row stand-ins (fs, gs, fd) of m edges at K live columns
    zero-padded to k_pad, and the (m,) all-ones mask."""
    rng = np.random.default_rng(seed)
    fs = np.zeros((m, k_pad))
    gs = np.zeros((m, k_pad))
    fd = np.zeros((m, k_pad))
    fs[:, :k] = rng.uniform(0.0, 1.0, (m, k))
    gs[:, :k] = rng.normal(0.0, 1.0, (m, k))
    fd[:, :k] = rng.uniform(0.0, 1.0, (m, k))
    fs[3] = 0.0                     # an all-zero source row
    return [a.astype(dtype) for a in (fs, gs, fd)] + [np.ones(m, dtype)]


# (edges m, live K, padded K, masked tail): K=4 in 128 lanes as
# tests/test_pallas.py pads it, K=37 unpadded (interpret mode takes it),
# and a 2,048-edge chunk (two 1,024-edge blocks) whose last 300 edges are
# padding
TERM_CASES = {
    "k4_lanes128": (600, 4, 128, 0),
    "k37": (333, 37, 37, 0),
    "two_blocks_masked_tail": (2048, 37, 128, 300),
}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(TERM_CASES))
def test_plain_terms_match_pallas_interpret(case, dtype):
    m, k, k_pad, tail = TERM_CASES[case]
    fs, gs, fd, mask = _rows(len(case) + m, m, k, k_pad, np.dtype(dtype))
    if tail:
        mask[-tail:] = 0.0
        fs[-tail:] = gs[-tail:] = fd[-tail:] = 0.0
    jcfg = JaxConfig(num_communities=k, dtype=dtype)
    want = np.asarray(jpk.candidate_edge_terms(
        jnp.asarray(fs), jnp.asarray(gs), jnp.asarray(fd), jnp.asarray(mask),
        jcfg, interpret=True,
    ))
    got = ek.candidate_edge_terms_plain(
        *(torch.as_tensor(a) for a in (fs, gs, fd, mask)),
        BigClamConfig(**dataclasses.asdict(jcfg)),
    ).numpy()
    assert got.shape == want.shape == (16, m)
    if tail:
        assert not got[:, -tail:].any()
    if dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=1e-12)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL32, atol=ATOL32)


def test_unmasked_terms_are_the_candidate_pass_body():
    fs, gs, fd, mask = _rows(0, 50, 6, 6, np.float64)
    cfg = BigClamConfig(num_communities=6)
    t = [torch.as_tensor(a) for a in (fs, gs, fd)]
    assert torch.equal(
        ek.candidate_edge_terms_plain(*t, None, cfg),
        ek.candidate_edge_terms_plain(*t, torch.as_tensor(mask), cfg),
    )
    assert torch.equal(
        ek.candidate_edge_terms_plain(*t, None, cfg),
        ls.candidate_edge_terms_body(*t, cfg),
    )


@pytest.fixture(scope="module")
def planted():
    """tests/test_pallas.py's trajectory graph: its edge chunk reaches the
    TPU kernel's 1,024-edge tile."""
    Fp, _ = planted_partition_F(120, 4, strength=1.5)
    g = sample_graph(Fp, rng=np.random.default_rng(2))
    assert g.num_directed_edges >= 1024
    return g


def test_candidates_pass_kernel_matches_pallas_interpret(planted):
    g = planted
    jcfg = JaxConfig(num_communities=4, dtype="float64")
    jm = JaxModel(g, jcfg, k_multiple=128)
    F0 = np.random.default_rng(0).uniform(0.1, 1.0, (g.num_nodes, 4))
    st = jm.init_state(F0)
    grad_j, _ = jobj.grad_llh(st.F, st.sumF, jm.edges, jcfg)
    want = np.asarray(jpk.candidates_pass_pallas(
        st.F, grad_j, jm.edges, jcfg, interpret=True
    ))[:, : g.num_nodes]

    cfg = BigClamConfig(**dataclasses.asdict(jcfg))
    F = torch.as_tensor(F0)
    csr = _port_graph(g).to_device("cpu")
    edges = EdgeChunks(csr.src, csr.dst, 700)           # ragged last chunk
    grad, _ = grad_llh(F, F.sum(0), edges, cfg)
    got = ek.candidates_pass_kernel(F, grad, edges, cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    # on the CPU the kernel's pass is the plain pass, bit for bit
    assert torch.equal(got, ls.candidates_pass(F, grad, edges, cfg))


def test_pallas_vmem_trajectory_matches_jax(planted, monkeypatch):
    g = planted
    F0 = np.random.default_rng(1).uniform(0.1, 1.0, (g.num_nodes, 4))
    jcfg = JaxConfig(
        num_communities=4, dtype="float64", max_iters=4, conv_tol=0.0,
        use_pallas=True,
    )
    orig = jpk.candidates_pass_pallas

    def interp(F, grad, edges, cfg, interpret=False):
        return orig(F, grad, edges, cfg, interpret=True)

    monkeypatch.setattr(jpk, "candidates_pass_pallas", interp)
    jm = JaxModel(g, jcfg, k_multiple=128)
    assert jm.engaged_path == "pallas_vmem"
    want = jm.fit(F0)

    pm = BigClamModel(_port_graph(g), BigClamConfig(**dataclasses.asdict(jcfg)),
                      device="cpu")
    assert pm.engaged_path == "pallas_vmem"
    ek.reset_launch_counts()
    got = pm.fit(F0)
    assert ek.launch_counts() == {"candidate_edge_terms": 0}   # plain on cpu
    assert got.num_iters == want.num_iters == 4
    np.testing.assert_allclose(got.F, np.asarray(want.F)[: g.num_nodes, :4], rtol=1e-10)
    np.testing.assert_allclose(got.llh_history, want.llh_history, rtol=1e-10)


# --- engagement ------------------------------------------------------------


@pytest.mark.parametrize(
    "device,kw,want",
    [
        ("cuda", {}, ("pallas_vmem", "")),
        ("cpu", {}, ("xla", "auto: device 'cpu' is not cuda")),
        ("cuda", {"use_pallas": False}, ("xla", "use_pallas=False")),
        ("cpu", {"use_pallas": False}, ("xla", "use_pallas=False")),
        ("cpu", {"use_pallas": True}, ("pallas_vmem", "")),
    ],
)
def test_pick_candidates_impl(device, kw, want):
    cfg = BigClamConfig(**kw)
    assert pick_candidates_impl(cfg, torch.device(device), torch.float32) == want


def test_cpu_plain_version_runs_in_float64():
    cfg = BigClamConfig(use_pallas=True, dtype="float64")
    assert pick_candidates_impl(cfg, torch.device("cpu"), torch.float64) == (
        "pallas_vmem", ""
    )


@pytest.mark.parametrize(
    "kw,dtype",
    [({}, torch.float64), ({"accum_dtype": "float64"}, torch.float32),
     ({"max_backtracks": 16}, torch.float32)],
)
def test_cuda_kernel_limits_refuse_in_auto_and_explicit_mode(kw, dtype):
    # no plain step on the card unless use_pallas=False asks for it
    cfg = BigClamConfig(**kw)
    for use_pallas in (None, True):
        with pytest.raises(ek.CandidateKernelError,
                           match=f"use_pallas={use_pallas}: .*use_pallas=False"):
            pick_candidates_impl(cfg.replace(use_pallas=use_pallas), CUDA, dtype)
    assert pick_candidates_impl(cfg.replace(use_pallas=False), CUDA, dtype) == (
        "xla", "use_pallas=False"
    )


@pytest.mark.parametrize(
    "kw", [{"accum_dtype": "float64"}, {"max_backtracks": 16}]
)
def test_csr_engagement_shares_the_kernel_limits(planted, kw):
    g = _port_graph(planted)
    cfg = BigClamConfig(num_communities=4, use_pallas_csr=True, **kw)
    with pytest.raises(ValueError, match="use_pallas_csr=True: the CSR kernels"):
        BigClamModel(g, cfg, device="cpu")


def test_model_reports_path_and_reason_on_cpu(planted):
    g = _port_graph(planted)
    m = BigClamModel(g, BigClamConfig(num_communities=4, use_pallas_csr=False,
                                      use_pallas=True), device="cpu")
    assert (m.engaged_path, m.path_reason) == ("pallas_vmem", "use_pallas_csr=False")
    assert m.k_pad == 4
    m = BigClamModel(g, BigClamConfig(num_communities=4), device="cpu")
    assert (m.engaged_path, m.path_reason) == ("xla", "auto: device 'cpu' is not cuda")


def test_cli_fit_csr_kernels_off_on_cpu_is_xla(planted, tmp_path, capsys):
    path = tmp_path / "g.txt"
    np.savetxt(path, np.stack([planted.src, planted.dst], 1)[planted.src < planted.dst],
               fmt="%d")
    assert cli.main(["fit", "--graph", str(path), "--k", "4", "--max-iters", "2",
                     "--csr-kernels", "off", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["kernel_path"] == "xla"
    with pytest.raises(SystemExit):
        cli.main(["fit", "--help"])
    assert "`pallas_vmem` on cuda, `xla` on cpu" in " ".join(capsys.readouterr().out.split())


def test_cuda_input_checks():
    F = torch.zeros((5, 3))
    idx = torch.zeros(4, dtype=torch.int64)
    ek._check_cuda(F, F, idx, idx)                          # well-formed
    with pytest.raises(TypeError):
        ek._check_cuda(F.double(), F.double(), idx, idx)
    with pytest.raises(ValueError):
        ek._check_cuda(F, F[:, :2].contiguous(), idx, idx)
    with pytest.raises(ValueError):
        ek._check_cuda(F, F, idx.int(), idx)
    with pytest.raises(ValueError):
        ek._check_cuda(F, F, idx, idx[:3])


# --- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return CUDA


@pytest.mark.cuda
@pytest.mark.parametrize("k,e", [(37, 333), (4, 1000), (1100, 2050)])
def test_cuda_kernel_matches_plain(k, e, cuda_device):
    rng = np.random.default_rng(k)
    n = 200
    F = torch.as_tensor(rng.uniform(0.0, 1.0, (n, k)), dtype=torch.float32)
    F[7] = 0.0
    grad = torch.as_tensor(rng.normal(0.0, 1.0, (n, k)), dtype=torch.float32)
    src = torch.as_tensor(np.sort(rng.integers(0, n, e)))
    dst = torch.as_tensor(rng.integers(0, n, e))
    cfg = BigClamConfig(num_communities=k)
    want = ek.candidate_edge_terms(F, grad, src, dst, cfg)
    before = ek.candidate_edge_terms.launches
    got = ek.candidate_edge_terms(*(t.to(cuda_device) for t in (F, grad, src, dst)), cfg)
    torch.cuda.synchronize()
    assert ek.candidate_edge_terms.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=RTOL32, atol=ATOL32)
    # the runs given as a model caches them, and the same edges shuffled
    # (runs of about one edge): each edge's terms are its own
    runs = ek.edge_runs(src.to(cuda_device))
    again = ek.candidate_edge_terms(
        *(t.to(cuda_device) for t in (F, grad, src, dst)), cfg, runs)
    assert torch.equal(again, got)
    perm = torch.as_tensor(rng.permutation(e))
    shuffled = ek.candidate_edge_terms(
        *(t.to(cuda_device) for t in (F, grad, src[perm], dst[perm])), cfg)
    torch.cuda.synchronize()
    np.testing.assert_allclose(shuffled.cpu().numpy(), want[:, perm].numpy(),
                               rtol=RTOL32, atol=ATOL32)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_float64(cuda_device):
    F = torch.zeros((4, 3), dtype=torch.float64, device=cuda_device)
    idx = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError):
        ek.candidate_edge_terms(F, F, idx, idx, BigClamConfig())
