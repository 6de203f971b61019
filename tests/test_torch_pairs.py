"""The pair structure behind the port's K-blocked edge dots (ops.kblocked):
the reverse-edge index `reverse_edges` (for each CSR position of (u, v),
the position of (v, u)), which lets the CUDA kernel compute each undirected
pair once and write both of its positions, and the in-place gradient the
K-blocked pass writes window by window.

On the CPU: `rev` is an involution that swaps every edge's ends on planted,
hub and random graphs with isolated nodes; a CSR that is not symmetric (a
ring bucket's, a directed one) or holds a self-loop is refused by name; the
plain dots are symmetric bit for bit (x == x[rev]), which is what the
kernel relies on; BigClamModel caches `rev` on the K-blocked paths only;
the gradient written in place into the step's (n, K_pad) matrix equals the
window-by-window one bit for bit, folded in the kernel or in torch. On a
card only: both kernels against their plain versions at rtol = atol = 3e-5
on the hub graph at K=1,100 and in kc=3 windows (the 4-byte copies), x
symmetric bit for bit, a node count that ends inside a block, and the
wrapper's refusal of a ring bucket's CSR.
"""

import numpy as np
import pytest
import torch

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.ingest import graph_from_edges
from bigclam_tpu_torch.models.agm import sample_planted_graph
from bigclam_tpu_torch.models.bigclam import BigClamModel, k_block_plan
from bigclam_tpu_torch.ops import kblocked as kb
from bigclam_tpu_torch.parallel.ring import ring_shard_edges
from bigclam_tpu_torch.parallel.sharded import device_csr

torch.set_num_threads(2)

CPU = torch.device("cpu")
RTOL = ATOL = 3e-5


def _planted(n=400, blocks=20, isolated=5, seed=3):
    """chip_smoke.py's odd graph: planted blocks plus isolated nodes."""
    g0, _ = sample_planted_graph(n, blocks, p_in=0.3, rng=np.random.default_rng(seed))
    return graph_from_edges(np.stack([g0.src, g0.dst], axis=1), num_nodes=n + isolated)


def _hub(n=800, blocks=40, degrees=(100, 700), isolated=5, seed=5):
    """chip_smoke.py's hub graph: planted blocks, two hubs, isolated nodes."""
    rng = np.random.default_rng(seed)
    g0, _ = sample_planted_graph(n, blocks, p_in=0.3, rng=rng)
    pairs = [np.stack([g0.src, g0.dst], axis=1)]
    for hub, deg in enumerate(degrees):
        nbrs = rng.choice(np.setdiff1d(np.arange(n), [hub]), deg, replace=False)
        pairs.append(np.stack([np.full(deg, hub), nbrs], axis=1))
    return graph_from_edges(np.concatenate(pairs), num_nodes=n + isolated)


def _random(n=57, p=0.12, isolated=(3, 20), seed=1):
    """A random graph whose isolated nodes lose their edges."""
    rng = np.random.default_rng(seed)
    a = np.triu(rng.random((n, n)) < p, 1)
    a[list(isolated), :] = False
    a[:, list(isolated)] = False
    i, j = np.nonzero(a)
    return graph_from_edges(np.stack([i, j], axis=1), num_nodes=n)


def _tail(n=13):
    """A complete graph on n - 1 nodes plus an isolated one: the kernels'
    last block of 4 warps (one node each) holds a single node."""
    i, j = np.triu_indices(n - 1, 1)
    return graph_from_edges(np.stack([i, j], axis=1), num_nodes=n)


GRAPHS = {"planted": _planted, "hub": _hub, "random": _random, "tail": _tail}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graph(request):
    g = GRAPHS[request.param]()
    assert (g.degrees == 0).any()          # isolated nodes in every case
    return g


def _F(g, k, k_pad, seed=4):
    F = np.zeros((g.num_nodes, k_pad), np.float32)
    F[:, :k] = np.random.default_rng(seed).uniform(0.0, 1.0, (g.num_nodes, k))
    F[min(7, g.num_nodes - 1)] = 0.0       # an all-zero row
    return F


# --- the reverse-edge index ----------------------------------------------------


def test_rev_swaps_every_edge(graph):
    csr = graph.to_device(CPU)
    rev = kb.reverse_edges(csr)
    assert rev.dtype == torch.int32 and tuple(rev.shape) == (graph.num_directed_edges,)
    r = rev.long()
    assert torch.equal(r[r], torch.arange(graph.num_directed_edges))
    assert torch.equal(csr.src[r], csr.dst)
    assert torch.equal(csr.dst[r], csr.src)
    # against a plain search of each edge's reverse key
    key = csr.src * graph.num_nodes + csr.dst
    want = np.searchsorted(key.numpy(), (csr.dst * graph.num_nodes + csr.src).numpy())
    np.testing.assert_array_equal(rev.numpy(), want)


def test_with_rev_caches_once(graph):
    csr = kb.with_rev(graph.to_device(CPU))
    assert torch.equal(csr.rev, kb.reverse_edges(csr))
    assert kb.with_rev(csr) is csr


def test_a_ring_bucket_csr_is_refused():
    g = _planted()
    # shard 0's phase-1 bucket of 2 shards of 205 rows: its edges lead to
    # shard 1's rows, renumbered from 0
    bucket = device_csr(*ring_shard_edges(g, 2, 410)[0][1], CPU)
    assert bucket.num_directed_edges > 0
    with pytest.raises(kb.AsymmetricCSRError, match="symmetric"):
        kb.reverse_edges(bucket)


def test_a_directed_csr_and_a_self_loop_are_refused():
    csr = _random().to_device(CPU)
    keep = csr.src < csr.dst                 # one direction of every pair
    indptr = torch.zeros(csr.num_nodes + 1, dtype=torch.int64)
    indptr[1:] = torch.cumsum(torch.bincount(csr.src[keep], minlength=csr.num_nodes), 0)
    one_way = device_csr(indptr.numpy(), csr.dst[keep].numpy(), CPU)
    with pytest.raises(kb.AsymmetricCSRError, match="symmetric"):
        kb.reverse_edges(one_way)
    loop = device_csr(np.array([0, 1, 2, 3]), np.array([0, 2, 1]), CPU)
    with pytest.raises(kb.AsymmetricCSRError, match="self-loops"):
        kb.reverse_edges(loop)
    assert issubclass(kb.AsymmetricCSRError, ValueError)


def test_plain_dots_are_symmetric_bit_for_bit(graph):
    """x[(u, v)] == x[(v, u)] exactly over every window, the property that
    lets the kernel compute a pair once and write it twice."""
    k, kc = 37, 16
    _, k_pad = k_block_plan(k, kc)
    F = torch.as_tensor(_F(graph, k, k_pad))
    csr = kb.with_rev(graph.to_device(CPU))
    x = torch.zeros(graph.num_directed_edges)
    for col0 in range(0, k_pad, kc):
        kb.edge_dots_kb(F, csr, col0, kc, x)
    assert torch.equal(x[csr.rev.long()], x)
    want = (F.double()[csr.src] * F.double()[csr.dst]).sum(dim=1)
    np.testing.assert_allclose(x.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "csr_fused,path", [(None, "csr_fused_kb"), (False, "csr_grouped_kb"),
                       (None, "csr_fused")],
)
def test_model_caches_rev_on_the_kb_paths_only(csr_fused, path):
    g = _planted()
    k_block = 0 if path == "csr_fused" else 16
    cfg = BigClamConfig(num_communities=37, use_pallas_csr=True,
                        csr_fused=csr_fused, csr_k_block=k_block)
    m = BigClamModel(g, cfg, device="cpu")
    assert m.engaged_path == path
    if path == "csr_fused":
        assert m.csr.rev is None
    else:
        assert torch.equal(m.csr.rev, kb.reverse_edges(m.csr))


# --- the gradient in place -------------------------------------------------------


@pytest.mark.parametrize("fold", [True, False], ids=["fused_kb", "grouped_kb"])
def test_train_pass_writes_the_gradient_in_place(fold):
    """The K-blocked pass's (n, K_pad) gradient, each window written into
    its columns (and folded there in torch without `fold`), equals the
    windows computed one by one and joined, bit for bit."""
    g = _hub()
    k, kc = 40, 20
    _, k_pad = k_block_plan(k, kc)
    F = torch.as_tensor(_F(g, k, k_pad))
    sumF = F.sum(dim=0)
    cfg = BigClamConfig(num_communities=k)
    csr = kb.with_rev(g.to_device(CPU))
    grad, llh, _ = kb.train_pass_kblocked(F, sumF, csr, cfg, kc, fold=fold)
    assert tuple(grad.shape) == (g.num_nodes, k_pad) and grad.is_contiguous()
    x = torch.zeros(g.num_directed_edges)
    for col0 in range(0, k_pad, kc):
        kb.edge_dots_kb(F, csr, col0, kc, x)
    parts = []
    for col0 in range(0, k_pad, kc):
        g_kb, ln = kb.grad_from_x_kb(x, F, sumF, csr, col0, kc, cfg, fold)
        if not fold:
            g_kb = g_kb - sumF[None, col0 : col0 + kc] + F[:, col0 : col0 + kc]
        parts.append(g_kb)
        if col0 == 0:
            assert torch.equal(ln, llh)
    assert torch.equal(grad, torch.cat(parts, dim=1))


def test_grad_from_x_writes_only_its_window():
    g = _random()
    k, kc = 37, 16
    _, k_pad = k_block_plan(k, kc)
    F = torch.as_tensor(_F(g, k, k_pad))
    sumF = F.sum(dim=0)
    cfg = BigClamConfig(num_communities=k)
    csr = g.to_device(CPU)
    x = (F[csr.src] * F[csr.dst]).sum(dim=1)
    out = torch.full((g.num_nodes, k_pad), 7.0)
    got, _ = kb.grad_from_x_kb(x, F, sumF, csr, kc, kc, cfg, True, out=out[:, kc : 2 * kc])
    want, _ = kb.grad_from_x_kb(x, F, sumF, csr, kc, kc, cfg, True)
    assert got.data_ptr() == out[:, kc:].data_ptr()
    assert torch.equal(out[:, kc : 2 * kc], want)
    assert torch.all(out[:, :kc] == 7.0) and torch.all(out[:, 2 * kc :] == 7.0)


def test_window_rows_check():
    good = torch.zeros((5, 12))
    assert kb.check_window_rows("g", good[:, 4:8], 5, 4, CPU) == 12
    assert kb.check_window_rows("g", good[:, 3:4], 5, 1, CPU) == 12
    with pytest.raises(ValueError, match="contiguous rows"):
        kb.check_window_rows("g", good.t()[:4], 4, 5, CPU)
    with pytest.raises(ValueError, match="shape"):
        kb.check_window_rows("g", good, 5, 4, CPU)
    with pytest.raises(TypeError, match="float32"):
        kb.check_window_rows("g", good.double()[:, :4], 5, 4, CPU)


# --- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(a, b):
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("k,k_block", [(1100, 0), (37, 3)], ids=["k1100", "k37_kc3"])
def test_cuda_pair_kernels_match_plain(name, k, k_block, cuda_device):
    """edge_dots_kb and grad_from_x against their plain versions (fold on,
    into the step's gradient; fold off, into a matrix of its own), x
    symmetric bit for bit."""
    g = GRAPHS[name]()
    kc, k_pad = k_block_plan(k, k_block)
    F = torch.as_tensor(_F(g, k, k_pad), device=cuda_device)
    sumF = F.sum(dim=0)
    cfg = BigClamConfig(num_communities=k)
    csr = g.to_device(cuda_device)
    e = g.num_directed_edges
    x, x_p = torch.zeros(e, device=cuda_device), torch.zeros(e, device=cuda_device)
    for col0 in range(0, k_pad, kc):
        kb.edge_dots_kb(F, csr, col0, kc, x)       # rev built by the wrapper
        kb.edge_dots_kb_plain(F, csr, col0, kc, x_p)
    torch.cuda.synchronize()
    _close(x, x_p)
    assert torch.equal(x[kb.reverse_edges(csr).long()], x)
    grad = torch.full((g.num_nodes, k_pad), float("nan"), device=cuda_device)
    for col0 in range(0, k_pad, kc):
        win = grad[:, col0 : col0 + kc]
        _, ln = kb.grad_from_x_kb(x_p, F, sumF, csr, col0, kc, cfg, True, out=win)
        g_p, ln_p = kb.grad_from_x_kb_plain(x_p, F, sumF, csr, col0, kc, cfg, True)
        torch.cuda.synchronize()
        _close(win, g_p)
        if col0 == 0:
            _close(ln, ln_p)
        g_n, _ = kb.grad_from_x_kb(x_p, F, sumF, csr, col0, kc, cfg, False)
        g_np, _ = kb.grad_from_x_kb_plain(x_p, F, sumF, csr, col0, kc, cfg, False)
        torch.cuda.synchronize()
        _close(g_n, g_np)
    assert torch.isfinite(grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("fold", [True, False])
def test_cuda_in_place_gradient_is_bit_equal(fold, cuda_device):
    """The kernels write the same bits into a window of the step's
    gradient as into a matrix of their own; cand_dots_kb reads either."""
    g = _hub()
    k, kc = 1100, 576
    _, k_pad = k_block_plan(k, 0)
    F = torch.as_tensor(_F(g, k, k_pad), device=cuda_device)
    sumF = F.sum(dim=0)
    cfg = BigClamConfig(num_communities=k)
    csr = kb.with_rev(g.to_device(cuda_device))
    x = (F[csr.src] * F[csr.dst]).sum(dim=1)
    grad = torch.empty_like(F)
    s, e = len(cfg.step_candidates), g.num_directed_edges
    xc_a = torch.zeros((s, e), device=cuda_device)
    xc_b = torch.zeros((s, e), device=cuda_device)
    for col0 in range(0, k_pad, kc):
        win = grad[:, col0 : col0 + kc]
        kb.grad_from_x_kb(x, F, sumF, csr, col0, kc, cfg, fold, out=win)
        own, _ = kb.grad_from_x_kb(x, F, sumF, csr, col0, kc, cfg, fold)
        torch.cuda.synchronize()
        assert torch.equal(win, own)
        kb.cand_dots_kb(F, win, csr, col0, kc, cfg, xc_a)
        kb.cand_dots_kb(F, own, csr, col0, kc, cfg, xc_b)
    torch.cuda.synchronize()
    assert torch.equal(xc_a, xc_b)


@pytest.mark.cuda
def test_cuda_edge_dots_refuses_a_ring_bucket(cuda_device):
    g = _planted()
    bucket = device_csr(*ring_shard_edges(g, 2, 410)[0][1], cuda_device)
    F = torch.zeros((205, 64), device=cuda_device)
    # the pair mode refuses it; asked for no mode, the dots walk its
    # directed edges (tests/test_torch_kbmesh.py holds that mode)
    with pytest.raises(kb.AsymmetricCSRError):
        kb.edge_dots_kb(F, bucket, 0, 64, torch.zeros(bucket.num_directed_edges,
                                                      device=cuda_device),
                        directed=False)
