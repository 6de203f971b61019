"""The port's node pass (ops.kblocked `cand_select_from_x`) and its epilogue
form (ops.linesearch `armijo_update_kernel` / `armijo_tail_select`) against
the JAX package.

On the CPU the wrappers run their plain versions, which are held in
float64 at rtol 1e-12 against what the JAX package computes in their
place: `cand_nbr_from_x_csr` in interpret mode (block 8, tile 8), the node
tail, then `armijo_update` (F_new, node_llh, sumF_new and the accepted-step
histogram; atol 1e-12 besides, for sums that cancel to near 0). The inputs come from numpy: a planted graph plus isolated
nodes, an all-zero F row, K = 37 (one K block of 37 in windows of 16) and
K = 1,100 (k_pad 1,152 in two blocks of 576), the folded gradient, the
neighbour LLH and the full candidate dots of that F.

On a card only, each CUDA entry against its plain version at rtol = atol =
3e-5 (the float32 band tests/test_fused.py holds the JAX paths to), with
acceptance flips only at near-ties (|cand - thr| <= 1e-5 max(1, |thr|));
F_new on every row against the plain projection on the kernel's own mask;
the refusals; and steps that must never reach the torch tails.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigclam_tpu.config import BigClamConfig as JaxConfig
from bigclam_tpu.graph.ingest import graph_from_edges as jax_graph_from_edges
from bigclam_tpu.models.agm import sample_planted_graph
from bigclam_tpu.ops.csr_tiles import build_block_tiles
from bigclam_tpu.ops.linesearch import accept_stats as jax_accept_stats
from bigclam_tpu.ops.linesearch import armijo_update as jax_armijo_update
from bigclam_tpu.ops.objective import node_tail as jax_node_tail
from bigclam_tpu.ops.pallas_csr import cand_nbr_from_x_csr, device_tiles

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.models.bigclam import k_block_plan
from bigclam_tpu_torch.ops import kblocked as kb
from bigclam_tpu_torch.ops import linesearch as ls
from bigclam_tpu_torch.ops.fused import project_accepted

torch.set_num_threads(2)

RTOL_F64 = 1e-12
RTOL = ATOL = 3e-5
TIE = 1e-5
BLOCK = TILE = 8


def _planted(n=64, blocks=4, isolated=5, seed=11):
    """A planted graph of `blocks` communities plus `isolated` nodes past
    its last one (empty CSR slices)."""
    g, _ = sample_planted_graph(n, blocks, p_in=0.4, rng=np.random.default_rng(seed))
    pairs = [(int(u), int(v)) for u, v in zip(g.src, g.indices) if u < v]
    return jax_graph_from_edges(pairs, num_nodes=n + isolated)


def _hub(n=760, degree=700, seed=5):
    """A sparse random graph plus node 0 joined to `degree` others, and two
    isolated nodes."""
    rng = np.random.default_rng(seed)
    a = np.triu(rng.random((n, n)) < 0.004, 1)
    a[0, rng.choice(np.arange(1, n - 2), degree, replace=False)] = True
    a[:, n - 2 :] = False
    a[n - 2 :, :] = False
    i, j = np.nonzero(a)
    return jax_graph_from_edges(list(zip(i.tolist(), j.tolist())), num_nodes=n)


def _inputs(g, k, k_pad, cfg, seed, zero_rows):
    """float64 numpy (F, sumF, grad, llh_nbr, xc) of one K-blocked step at
    a random F on g: the folded gradient, the neighbour LLH and the full
    candidate dots clip(F_u + eta g_u).F_v per step and CSR position. F is
    uniform on [0, 0.05), small enough that the nodes choose among several
    steps; the rows `zero_rows` are 0 (an isolated zero row accepts no
    step)."""
    rng = np.random.default_rng(seed)
    n = g.num_nodes
    F = np.zeros((n, k_pad))
    F[:, :k] = rng.uniform(0.0, 0.05, (n, k))
    F[list(zero_rows)] = 0.0
    src, dst = g.src.astype(np.int64), g.indices.astype(np.int64)
    sumF = F.sum(axis=0)
    x = (F[src] * F[dst]).sum(axis=1)
    omp = np.clip(-np.expm1(-x), 1.0 - cfg.max_p, 1.0 - cfg.min_p)
    grad = np.zeros_like(F)
    np.add.at(grad, src, F[dst] / omp[:, None])
    grad = grad - sumF[None, :] + F
    llh_nbr = np.zeros(n)
    np.add.at(llh_nbr, src, np.log(omp) + x)
    etas = np.asarray(cfg.step_candidates)
    xc = np.stack([
        (np.clip(F[src] + eta * grad[src], cfg.min_f, cfg.max_f) * F[dst]).sum(axis=1)
        for eta in etas
    ])
    return F, sumF, grad, llh_nbr, xc


def _slots(g, bt):
    """CSR position of every tile slot (-1 where masked) and the valid mask
    (tests/test_torch_kblocked.py's mapping)."""
    n = g.num_nodes
    src = bt.block_id[:, None].astype(np.int64) * bt.block_b + bt.src_local
    valid = bt.mask > 0
    key_csr = g.src.astype(np.int64) * n + g.indices
    pos = np.searchsorted(key_csr, src * n + bt.dst)
    pos = np.where(valid, np.minimum(pos, len(key_csr) - 1), -1)
    assert np.array_equal(np.sort(pos[valid]), np.arange(g.num_directed_edges))
    return pos, valid


# (K, csr_k_block): K = 37 in windows of 16 (k_pad 48), K = 1,100 in the
# model's own blocks (2 x 576)
CASES = {"planted_k37": (37, 16), "planted_k1100": (1100, 0)}


class Case:
    def __init__(self, name, dtype="float64"):
        k, csr_k_block = CASES[name]
        self.g = g = _planted()
        self.n, self.k = g.num_nodes, k
        self.kc, self.k_pad = k_block_plan(k, csr_k_block)
        self.jcfg = JaxConfig(num_communities=k, dtype=dtype)
        self.cfg = BigClamConfig(**dataclasses.asdict(self.jcfg))
        # a zero row with neighbours and an isolated one
        self.np = _inputs(g, k, self.k_pad, self.cfg, seed=k, zero_rows=(3, self.n - 1))
        self.csr = Graph(g.indptr, g.indices, g.raw_ids).to_device(torch.device("cpu"))

    def torch(self):
        return [torch.as_tensor(a) for a in self.np]

    def jax_cand_nbr(self):
        """JAX cand_nbr_from_x_csr in interpret mode, in float64."""
        bt = build_block_tiles(self.g, BLOCK, TILE)
        pos, valid = _slots(self.g, bt)
        xc = self.np[4]
        tiles_xc = np.where(valid, xc[..., np.maximum(pos, 0)], 0.0)
        tiles_xc = jnp.asarray(np.moveaxis(tiles_xc, -2, 0))
        out = cand_nbr_from_x_csr(tiles_xc, device_tiles(bt, jnp.float64), self.jcfg,
                                  interpret=True)
        return np.asarray(out)[:, : self.n]

    def jax_step(self, cand_nbr):
        """JAX node tail and armijo_update: (F_new, sumF_new, hist,
        node_llh)."""
        F, sumF, grad, llh_nbr, _ = (jnp.asarray(a) for a in self.np)
        node_llh = llh_nbr + jax_node_tail(F, sumF)
        F_new, sumF_new, hist = jax_armijo_update(
            F, sumF, grad, node_llh, jnp.asarray(cand_nbr), self.jcfg, with_stats=True
        )
        return (np.asarray(F_new), np.asarray(sumF_new), np.asarray(hist),
                np.asarray(node_llh))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return Case(request.param)


def _close64(a, b):
    # atol for sums of log-survival terms that cancel to near 0 (one ulp of
    # a term is about 1e-16)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL_F64,
                               atol=RTOL_F64)


# --- the plain routes against the JAX package (float64) -----------------------


def test_case_exercises_the_edges_it_names(case):
    """Isolated nodes (empty slices), a zero row, accepted and rejected
    rows, more than one accepted step."""
    c = case
    assert (c.g.degrees[-5:] == 0).all() and c.g.degrees[3] > 0
    assert (c.np[0][[3, -1]] == 0).all()
    *_, hist, _ = c.jax_step(c.jax_cand_nbr())
    assert hist[-1] > 0 and hist[:-1].sum() > 0
    assert (hist[:-1] > 0).sum() >= 2


def test_cand_select_from_x_plain_matches_jax(case):
    c = case
    xc, F, sumF, grad, llh = (torch.as_tensor(c.np[i]) for i in (4, 0, 1, 2, 3))
    F_new, node_llh, ok = kb.cand_select_from_x(xc, F, sumF, grad, llh, c.csr, c.cfg)
    assert F_new.dtype == torch.float64 and ok.dtype == torch.bool
    assert tuple(ok.shape) == (len(c.cfg.step_candidates), c.n)
    F_j, sumF_j, hist_j, llh_j = c.jax_step(c.jax_cand_nbr())
    _close64(F_new.numpy(), F_j)
    _close64(node_llh.numpy(), llh_j)
    _close64(F_new.sum(dim=0).numpy(), sumF_j)
    np.testing.assert_array_equal(ls.accept_stats(ok).numpy(), hist_j)


def test_neighbour_sums_plain_match_jax(case):
    """The neighbour-only entry (the JAX function) in float64."""
    c = case
    out = kb.cand_nbr_from_x(torch.as_tensor(c.np[4]), c.csr, c.cfg)
    _close64(out.numpy(), c.jax_cand_nbr())


def test_armijo_update_kernel_plain_matches_jax(case):
    """The epilogue from given neighbour sums: armijo_update_kernel on CPU
    tensors against JAX armijo_update."""
    c = case
    cand_nbr = c.jax_cand_nbr()
    F_j, sumF_j, hist_j, llh_j = c.jax_step(cand_nbr)
    F, sumF, grad, _, _ = c.torch()
    F_new, sumF_new, hist = ls.armijo_update_kernel(
        F, sumF, grad, torch.as_tensor(llh_j), torch.as_tensor(cand_nbr), c.cfg,
        with_stats=True,
    )
    _close64(F_new.numpy(), F_j)
    _close64(sumF_new.numpy(), sumF_j)
    np.testing.assert_array_equal(hist.numpy(), hist_j)
    F_new2, sumF_new2 = ls.armijo_update_kernel(
        F, sumF, grad, torch.as_tensor(llh_j), torch.as_tensor(cand_nbr), c.cfg)
    assert torch.equal(F_new2, F_new) and torch.equal(sumF_new2, sumF_new)


def test_accept_stats_of_the_kernel_mask_match_jax(case):
    """The (S, n) 0/1 mask as the kernels write it (armijo_tail_select's
    plain route, as bytes) gives the JAX histogram."""
    c = case
    cand_nbr = c.jax_cand_nbr()
    *_, hist_j, llh_j = c.jax_step(cand_nbr)
    F, sumF, grad, _, _ = c.torch()
    _, ok = ls.armijo_tail_select(F, sumF, grad, torch.as_tensor(llh_j),
                                  torch.as_tensor(cand_nbr), c.cfg)
    as_bytes = ok.to(torch.uint8)
    np.testing.assert_array_equal(ls.accept_stats(as_bytes).numpy(), hist_j)
    np.testing.assert_array_equal(np.asarray(jax_accept_stats(jnp.asarray(ok.numpy()))),
                                  hist_j)


def test_kblocked_terms_feed_the_node_pass(case):
    """kblocked_terms + cand_select_from_x is the old pass + torch
    epilogue: train_pass_kblocked's neighbour sums through armijo_update
    give the same F_new, node_llh and histogram bit for bit."""
    c = case
    F, sumF = (torch.as_tensor(c.np[i]) for i in (0, 1))
    grad, llh_nbr, xc = kb.kblocked_terms(F, sumF, c.csr, c.cfg, c.kc)
    F_new, node_llh, ok = kb.cand_select_from_x(xc, F, sumF, grad, llh_nbr, c.csr, c.cfg)
    g2, l2, cand_nbr = kb.train_pass_kblocked(F, sumF, c.csr, c.cfg, c.kc)
    assert torch.equal(g2, grad) and torch.equal(l2, llh_nbr)
    want_llh = llh_nbr + (-(F @ sumF) + (F * F).sum(dim=1))
    F_w, _, hist_w = ls.armijo_update(F, sumF, grad, want_llh, cand_nbr, c.cfg,
                                      with_stats=True)
    assert torch.equal(F_new, F_w) and torch.equal(node_llh, want_llh)
    assert torch.equal(ls.accept_stats(ok), hist_w)


# --- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _flips_at_ties(ok_k, cand, thr):
    diff = ok_k.cpu() != (cand >= thr)
    tie = (cand - thr).abs() <= TIE * thr.abs().clamp_min(1.0)
    assert not bool((diff & ~tie).any()), "acceptance flips away from a near-tie"


def _close(got, want):
    np.testing.assert_allclose(got.double().cpu().numpy(), want.double().cpu().numpy(),
                               rtol=RTOL, atol=ATOL)


# (graph, K, csr_k_block): k_pad 1,056 in kc = 3 windows (a block a node,
# rows of 264 float4), a degree-700 hub at K = 1,100, a graph of 5 nodes
# (smaller than one block of 8 warps), and the planted graph's empty slices
# at K = 37 (rows of 48 floats) and K = 37 in kc = 3 windows (k_pad 39:
# rows off 16 bytes, the 4-byte path)
CARD_CASES = {
    "kpad1056_kc3": ("planted", 1050, 3),
    "hub700_k1100": ("hub", 1100, 0),
    "five_nodes_k37": ("five", 37, 16),
    "empty_slices_k37": ("planted", 37, 16),
    "empty_slices_kpad39": ("planted", 37, 3),
}


def _card_graph(which):
    if which == "hub":
        return _hub()
    if which == "five":
        return jax_graph_from_edges([(0, 1), (1, 2), (0, 2), (2, 3)], num_nodes=5)
    return _planted()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_CASES))
def test_cuda_node_pass_matches_plain(name, cuda_device):
    which, k, csr_k_block = CARD_CASES[name]
    g = _card_graph(which)
    kc, k_pad = k_block_plan(k, csr_k_block)
    cfg = BigClamConfig(num_communities=k)
    arrs = _inputs(g, k, k_pad, cfg, seed=k, zero_rows=(1, g.num_nodes - 1))
    F, sumF, grad, llh_nbr, xc = (torch.as_tensor(a, dtype=torch.float32, device=cuda_device)
                                  for a in arrs)
    csr = Graph(g.indptr, g.indices, g.raw_ids).to_device(cuda_device)
    kb.reset_launch_counts()
    F_new, node_llh, ok = kb.cand_select_from_x(xc, F, sumF, grad, llh_nbr, csr, cfg)
    torch.cuda.synchronize()
    assert kb.launch_counts()["cand_select_from_x"] == 1
    # the plain version on float64 copies of the same float32 inputs
    F64, sumF64, grad64, llh64, xc64 = (t.double() for t in (F, sumF, grad, llh_nbr, xc))
    cand_nbr = kb.cand_nbr_from_x_plain(xc64, csr, cfg)
    node_llh_p = llh64 + (-(F64 @ sumF64) + (F64 * F64).sum(dim=1))
    _close(node_llh, node_llh_p)
    cand = cand_nbr + ls.armijo_tails(F64, sumF64, grad64, cfg)
    coefs = torch.tensor([cfg.alpha * e for e in cfg.step_candidates],
                         dtype=torch.float32).double().to(cuda_device)
    thr = node_llh_p[None, :] + coefs[:, None] * (grad64 * grad64).sum(dim=1)[None, :]
    _flips_at_ties(ok, cand.cpu(), thr.cpu())
    _close(F_new, project_accepted(F64, grad64, ok, cfg))
    # the neighbour-only entry
    _close(kb.cand_nbr_from_x(xc, csr, cfg), cand_nbr)
    # the epilogue from given sums
    F_e, ok_e = ls.armijo_tail_select(F, sumF, grad, node_llh_p.float(),
                                      cand_nbr.float(), cfg)
    torch.cuda.synchronize()
    _flips_at_ties(ok_e, cand.cpu(), thr.cpu())
    _close(F_e, project_accepted(F64, grad64, ok_e, cfg))


@pytest.mark.cuda
def test_cuda_entries_refuse_by_name(cuda_device):
    c = Case("planted_k37", dtype="float32")
    F, sumF, grad, llh, xc = (t.float().to(cuda_device) for t in c.torch())
    csr = Graph(c.g.indptr, c.g.indices, c.g.raw_ids).to_device(cuda_device)
    node_llh = llh.clone()
    cand_nbr = torch.zeros((len(c.cfg.step_candidates), c.n), device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        kb.cand_select_from_x(xc.double(), F, sumF, grad, llh, csr, c.cfg)
    with pytest.raises(TypeError, match="float32"):
        ls.armijo_tail_select(F.double(), sumF, grad, node_llh, cand_nbr, c.cfg)
    seventeen = c.cfg.replace(max_backtracks=16)
    assert len(seventeen.step_candidates) == 17
    with pytest.raises(ValueError, match="at most 16"):
        kb.cand_select_from_x(xc, F, sumF, grad, llh, csr, seventeen)
    with pytest.raises(ValueError, match="at most 16"):
        ls.armijo_update_kernel(F, sumF, grad, node_llh, cand_nbr, seventeen)
    strided = torch.zeros((c.n, 2 * c.k_pad), device=cuda_device)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        kb.cand_select_from_x(xc, strided, sumF, grad, llh, csr, c.cfg)
    with pytest.raises(ValueError, match="contiguous"):
        ls.armijo_tail_select(F, sumF, strided, node_llh, cand_nbr, c.cfg)


@pytest.mark.cuda
def test_cuda_steps_never_run_the_torch_tails(cuda_device, monkeypatch):
    """csr_fused_kb, csr_grouped_kb, pallas_vmem, csr_ring_fused and
    csr_ring steps on the card with ops.linesearch.armijo_tails made to
    raise: the kernels carry the tails."""
    from bigclam_tpu_torch.models.bigclam import BigClamModel
    from bigclam_tpu_torch.parallel import RingBigClamModel, make_mesh

    def refuse(*a, **kw):
        raise AssertionError("armijo_tails ran on the card")

    monkeypatch.setattr(ls, "armijo_tails", refuse)
    g = _planted()
    pg = Graph(g.indptr, g.indices, g.raw_ids)
    F0 = np.random.default_rng(0).uniform(0.0, 1.0, (g.num_nodes, 37))
    base = BigClamConfig(num_communities=37, max_iters=2, conv_tol=0.0)
    kb.reset_launch_counts()
    ls.armijo_tail_select.launches = 0
    for fused, want in ((None, "csr_fused_kb"), (False, "csr_grouped_kb")):
        m = BigClamModel(pg, base.replace(csr_k_block=16, csr_fused=fused),
                         device=cuda_device)
        assert m.engaged_path == want
        assert len(m.fit(F0).llh_history) == 3
    assert kb.launch_counts()["cand_select_from_x"] == 6
    m = BigClamModel(pg, base.replace(use_pallas_csr=False), device=cuda_device)
    assert m.engaged_path == "pallas_vmem"
    m.fit(F0)
    assert ls.armijo_tail_select.launches == 3
    mesh = make_mesh((2, 1), [cuda_device] * 2)
    for fused, want in ((None, "csr_ring_fused"), (False, "csr_ring")):
        m = RingBigClamModel(pg, base.replace(csr_fused=fused), mesh, balance=False)
        assert m.engaged_path == want
        ls.armijo_tail_select.launches = 0
        m.fit(F0)
        assert ls.armijo_tail_select.launches == 2 * 3
