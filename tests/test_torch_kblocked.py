"""The port's K-blocked kernels (ops.kblocked; paths `csr_fused_kb` and
`csr_grouped_kb`) against the JAX package: each plain version against the
Pallas kernels it replaces in interpret mode (block 8, tile 8, float32, as
tests/test_fused.py runs them), the whole K-blocked pass against
`train_pass_csr_kblocked_fused` / `train_pass_csr_grouped_kblocked`, and
three steps of the port's `BigClamModel` against the JAX one on both paths.
On a card only, each CUDA kernel against its plain version.

The JAX kernels keep per-edge values in tile slots; the port keeps them by
CSR position. `_slots` maps one to the other through the (src, dst) key of
every valid (mask 1) slot.

Tolerances: rtol = atol = 3e-5 (the float32 band tests/test_fused.py holds
its fused, split and xla paths to); the LLH of a step at rtol 1e-5, as
tests/test_fused.py holds the JAX K-blocked path to XLA.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigclam_tpu.config import BigClamConfig as JaxConfig
from bigclam_tpu.graph.ingest import graph_from_edges as jax_graph_from_edges
from bigclam_tpu.models.bigclam import BigClamModel as JaxModel
from bigclam_tpu.ops.csr_tiles import build_block_tiles, group_tiles
from bigclam_tpu.ops.pallas_csr import (
    cand_dots_csr,
    cand_nbr_from_x_csr,
    device_grouped_tiles,
    device_tiles,
    edge_dots_csr,
    grad_nbr_from_x_csr,
    train_pass_csr_grouped_kblocked,
)
from bigclam_tpu.ops.pallas_fused import (
    cand_dots_fused,
    edge_dots_fused,
    grad_nbr_from_x_fused,
    train_pass_csr_kblocked_fused,
)

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.models.bigclam import (
    BigClamModel,
    check_k_block,
    k_block_plan,
)
from bigclam_tpu_torch.ops import csr_kernels as ck
from bigclam_tpu_torch.ops import kblocked as kb

torch.set_num_threads(2)

RTOL = ATOL = 3e-5
BLOCK = TILE = 8


def _random_graph(seed, n=57, p=0.12, isolated=()):
    """tests/test_fused.py's random graph, optionally with isolated nodes."""
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < p
    edges = [(i, j) for i in range(n) for j in range(i + 1, n) if a[i, j]]
    edges.append((0, n - 1))
    edges = [e for e in edges if e[0] not in isolated and e[1] not in isolated]
    return jax_graph_from_edges(edges, num_nodes=n)


def _hub_graph(isolated, n=240, degrees=(96, 75), p=0.01, seed=8):
    """A sparse random graph plus hubs: node i gets `degrees[i]` random
    neighbours (three 32-row tiles of the CUDA kernels' candidate ladder),
    and the isolated nodes lose their edges."""
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


# (graph seed or "hub", K, kc, isolated nodes, all-zero F row, Armijo ladder
# length). kc = 3 windows start off 16 bytes (the kernel's 4-byte copies);
# the hub's kc = 20 windows start on them (its 16-byte copies)
CASES = {
    "fused_test_graph_k6_kc3": (0, 6, 3, (), None, 16),
    "k37_kc16_isolated_zero_row": (1, 37, 16, (3, 20), 11, 16),
    "short_ladder_k12_kc8": (2, 12, 8, (), None, 8),
    "hub_k40_kc20": ("hub", 40, 20, (4, 30), 12, 16),
}


class Case:
    """One case's inputs in both packages' layouts."""

    def __init__(self, name):
        seed, k, kc, isolated, zero_row, num_s = CASES[name]
        if seed == "hub":
            g, seed = _hub_graph(isolated), 8
            assert g.degrees[0] >= 96 and g.degrees[1] >= 75
        else:
            g = _random_graph(seed, isolated=isolated)
        assert all(g.degrees[u] == 0 for u in isolated)
        self.g, self.k, self.kc = g, k, kc
        self.n, self.e = g.num_nodes, g.num_directed_edges
        _, self.k_pad = k_block_plan(k, kc)
        rng = np.random.default_rng(seed + 10)
        F = np.zeros((self.n, self.k_pad), np.float32)
        F[:, :k] = rng.uniform(0.0, 1.0, (self.n, k))
        if zero_row is not None:
            F[zero_row] = 0.0
        self.F = F
        # a gradient-like input with both signs, so the projection clips
        self.G = rng.uniform(-1.5, 1.5, (self.n, self.k_pad)).astype(np.float32)
        self.G[:, k:] = 0.0
        self.jcfg = JaxConfig(num_communities=k, max_backtracks=num_s - 1)
        self.cfg = BigClamConfig(**dataclasses.asdict(self.jcfg))
        self.csr = Graph(g.indptr, g.indices, g.raw_ids).to_device(torch.device("cpu"))
        self.bt = build_block_tiles(g, BLOCK, TILE)
        self.pos, self.valid = _slots(g, self.bt)
        self.n_pad = self.bt.n_pad

    @property
    def num_s(self):
        return len(self.cfg.step_candidates)

    def windows(self):
        """The first K block, the second and the last (past K: zeros)."""
        n_kb = self.k_pad // self.kc
        return sorted({0, 1, n_kb - 1})

    def jax_rows(self, M):
        """(n_pad, cols) float32 jax array: M's rows, zero padding rows."""
        out = np.zeros((self.n_pad, M.shape[1]), np.float32)
        out[: self.n] = M
        return jnp.asarray(out)

    def tiles(self, kc=0):
        return device_tiles(self.bt, jnp.float32, with_seq=False, kc=kc)

    def fd(self, col0):
        """The dst-row gather of one window, as the grouped K-blocked pass
        takes it (`fd_of` in train_pass_csr_grouped_kblocked)."""
        cols = self.jax_rows(self.F)[:, col0 : col0 + self.kc]
        return jnp.take(cols, self.tiles().dst, axis=0)

    def to_tiles(self, v):
        """(..., E) per-CSR-position values -> (n_tiles, ..., T) slots."""
        v = np.asarray(v)
        out = np.where(self.valid, v[..., np.maximum(self.pos, 0)], 0.0)
        return jnp.asarray(np.moveaxis(out, -2, 0).astype(np.float32))

    def from_tiles(self, t):
        """(n_tiles, R, T) slot values -> (R, E) per CSR position."""
        t = np.asarray(t)
        out = np.zeros((t.shape[1], self.e), t.dtype)
        for r in range(t.shape[1]):
            out[r, self.pos[self.valid]] = t[:, r, :][self.valid]
        return out


def _slots(g, bt):
    """CSR position of every tile slot (-1 where masked) and the valid
    mask; every directed edge sits in exactly one valid slot."""
    n = g.num_nodes
    src = bt.block_id[:, None].astype(np.int64) * bt.block_b + bt.src_local
    valid = bt.mask > 0
    key_csr = g.src.astype(np.int64) * n + g.indices
    key = src * n + bt.dst
    pos = np.searchsorted(key_csr, key)
    pos = np.where(valid, np.minimum(pos, len(key_csr) - 1), -1)
    assert (key_csr[pos[valid]] == key[valid]).all()
    assert np.array_equal(np.sort(pos[valid]), np.arange(g.num_directed_edges))
    return pos, valid


def _full_dots(c):
    F = c.F.astype(np.float64)
    return (F[c.g.src] * F[c.g.indices]).sum(axis=1).astype(np.float32)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return Case(request.param)


# --- each kernel's plain version against the Pallas kernels ------------------


@pytest.mark.parametrize("route", ["fused", "csr"])
def test_edge_dots_plain_matches_pallas(case, route):
    c = case
    Ft = torch.as_tensor(c.F)
    Fj = c.jax_rows(c.F)
    for kbi in c.windows():
        col0 = kbi * c.kc
        x = torch.zeros(c.e)
        assert kb.edge_dots_kb(Ft, c.csr, col0, c.kc, x) is x          # cpu: plain
        if route == "fused":
            xj = edge_dots_fused(Fj, c.tiles(c.kc), Fj, kbi, c.kc, interpret=True)
        else:
            xj = edge_dots_csr(Fj[:, col0 : col0 + c.kc], c.tiles(), c.fd(col0),
                               interpret=True)
        _close(x.numpy(), c.from_tiles(xj)[0])


@pytest.mark.parametrize("route", ["fused", "csr"])
def test_grad_from_x_plain_matches_pallas(case, route):
    """Fused: the -sumF + F fold in the kernel; csr: neighbour sums only."""
    c = case
    fold = route == "fused"
    Ft = torch.as_tensor(c.F)
    sumF = Ft.sum(dim=0)
    x = _full_dots(c)
    Fj = c.jax_rows(c.F)
    for kbi in c.windows():
        col0 = kbi * c.kc
        g_p, llh_p = kb.grad_from_x_kb(torch.as_tensor(x), Ft, sumF, c.csr, col0,
                                       c.kc, c.cfg, fold)
        assert g_p.shape == (c.n, c.kc)
        if fold:
            g_j, llh_j = grad_nbr_from_x_fused(
                c.to_tiles(x[None]), c.tiles(c.kc), Fj, kbi, c.kc, c.jcfg,
                interpret=True, F=Fj, sumF=Fj.sum(axis=0),
            )
        else:
            g_j, llh_j = grad_nbr_from_x_csr(
                c.to_tiles(x[None]), c.tiles(), c.fd(col0), c.jcfg, interpret=True
            )
        _close(g_p.numpy(), np.asarray(g_j)[: c.n])
        if col0 == 0:
            _close(llh_p.numpy(), np.asarray(llh_j)[: c.n])
        else:
            assert llh_p is None                     # written on block 0 only


@pytest.mark.parametrize("route", ["fused", "csr"])
def test_cand_dots_plain_matches_pallas(case, route):
    c = case
    Ft = torch.as_tensor(c.F)
    Fj = c.jax_rows(c.F)
    for kbi in c.windows():
        col0 = kbi * c.kc
        g_kb = np.ascontiguousarray(c.G[:, col0 : col0 + c.kc])
        xc = torch.zeros((c.num_s, c.e))
        kb.cand_dots_kb(Ft, torch.as_tensor(g_kb), c.csr, col0, c.kc, c.cfg, xc)
        if route == "fused":
            xj = cand_dots_fused(Fj, c.jax_rows(g_kb), c.tiles(c.kc), Fj, kbi,
                                 c.kc, c.jcfg, interpret=True)
        else:
            xj = cand_dots_csr(Fj[:, col0 : col0 + c.kc], c.jax_rows(g_kb),
                               c.tiles(), c.fd(col0), c.jcfg, interpret=True)
        _close(xc.numpy(), c.from_tiles(xj))


def test_cand_nbr_from_x_plain_matches_pallas(case):
    c = case
    rng = np.random.default_rng(7)
    xc = rng.uniform(0.0, 3.0, (c.num_s, c.e)).astype(np.float32)
    xc[:, ::5] = 0.0                                # the survival clip's floor
    out_p = kb.cand_nbr_from_x(torch.as_tensor(xc), c.csr, c.cfg)
    out_j = cand_nbr_from_x_csr(c.to_tiles(xc), c.tiles(), c.jcfg, interpret=True)
    assert out_p.shape == (c.num_s, c.n)
    _close(out_p.numpy(), np.asarray(out_j)[:, : c.n])


def test_edge_dots_over_every_window_are_the_full_dots(case):
    c = case
    x = torch.zeros(c.e)
    for col0 in range(0, c.k_pad, c.kc):
        kb.edge_dots_kb(torch.as_tensor(c.F), c.csr, col0, c.kc, x)
    _close(x.numpy(), _full_dots(c))


# --- the K-blocked pass and the trainer --------------------------------------


@pytest.mark.parametrize("fold", [True, False], ids=["fused_kb", "grouped_kb"])
def test_train_pass_matches_jax(case, fold):
    c = case
    Ft = torch.as_tensor(c.F)
    sumF = Ft.sum(dim=0)
    grad, llh_nbr, cand_nbr = kb.train_pass_kblocked(Ft, sumF, c.csr, c.cfg, c.kc,
                                                     fold=fold)
    Fj = c.jax_rows(c.F)
    if fold:
        out = train_pass_csr_kblocked_fused(Fj, Fj.sum(axis=0), c.tiles(c.kc), c.jcfg,
                                            interpret=True)
    else:
        gt = device_grouped_tiles(group_tiles(c.bt, 2), jnp.float32, kc=c.kc)
        Fg = np.zeros((gt.n_pad, c.k_pad), np.float32)
        Fg[: c.n] = c.F
        Fg = jnp.asarray(Fg)
        out = train_pass_csr_grouped_kblocked(Fg, Fg.sum(axis=0), gt, c.jcfg,
                                              interpret=True)
    grad_j, llh_j, cand_j = (np.asarray(a) for a in out)
    assert grad.shape == (c.n, c.k_pad)
    _close(grad.numpy(), grad_j[: c.n])
    _close(llh_nbr.numpy(), llh_j[: c.n])
    _close(cand_nbr.numpy(), cand_j[:, : c.n])


def _jcfg(**kw):
    base = dict(
        num_communities=6, dtype="float32", edge_chunk=64,
        use_pallas_csr=True, pallas_interpret=True,
        csr_block_b=8, csr_tile_t=8, csr_k_block=3,
    )
    base.update(kw)
    return JaxConfig(**base)


@pytest.mark.parametrize(
    "path,jkw",
    [("csr_fused_kb", {}), ("csr_grouped_kb", {"csr_fused": False})],
)
def test_three_f32_steps_match_jax_on_kb_paths(path, jkw, monkeypatch):
    """tests/test_fused.py's K-blocked case: the port starts from the JAX
    state (padded to K_pad 129) through state_from_jax_arrays. The JAX
    grouped layout gets tests/test_pallas_csr.py's small group budget
    (the default one pads this graph to a huge number of empty blocks)."""
    import bigclam_tpu.models.bigclam as mb

    monkeypatch.setattr(mb, "GROUP_FD_BUDGET", 40960)
    g = _random_graph(3, n=37)
    n, k = g.num_nodes, 6
    F0 = np.random.default_rng(0).uniform(0.0, 1.0, (n, k))
    jm = JaxModel(g, _jcfg(**jkw))
    pm = BigClamModel(Graph(g.indptr, g.indices, g.raw_ids),
                      BigClamConfig(**dataclasses.asdict(_jcfg(**jkw))), device="cpu")
    assert jm.engaged_path == pm.engaged_path == path
    assert (pm.kc, pm.k_pad) == (3, 33)
    sj = jm.init_state(F0)
    sp = pm.state_from_jax(np.asarray(sj.F))
    for _ in range(3):
        sj, sp = jm._step(sj), pm._step(sp)
        _close(sp.F[:, :k].numpy(), np.asarray(sj.F)[:n, :k])
        np.testing.assert_allclose(float(sp.llh), float(sj.llh), rtol=1e-5)
    assert sp.it == int(sj.it) == 3
    assert torch.all(sp.F[:, k:] == 0)                   # padding stays inert


def test_state_from_jax_strips_the_kb_padding():
    g = _random_graph(4, n=37)
    n, k = g.num_nodes, 6
    jm = JaxModel(g, _jcfg())
    pm = BigClamModel(Graph(g.indptr, g.indices, g.raw_ids),
                      BigClamConfig(**dataclasses.asdict(_jcfg())), device="cpu")
    F0 = np.random.default_rng(1).uniform(0.0, 1.0, (n, k))
    Fj = np.asarray(jm.init_state(F0).F)
    assert Fj.shape[1] == 129 and Fj.shape[0] > n          # round_up(128, 3)
    sp = pm.state_from_jax(Fj, llh=-5.0, it=2)
    assert tuple(sp.F.shape) == (n, 33) and sp.it == 2 and float(sp.llh) == -5.0
    np.testing.assert_array_equal(sp.F[:, :k].numpy(), Fj[:n, :k])
    assert torch.all(sp.F[:, k:] == 0)
    np.testing.assert_allclose(sp.sumF[:k].numpy(), Fj[:n, :k].sum(0), rtol=1e-6)


# --- the plan and the limits ---------------------------------------------------


@pytest.mark.parametrize(
    "k,csr_k_block,want",
    [(3000, 0, (1024, 3072)), (1100, 0, (576, 1152)), (1000, 0, (0, 1024)),
     (1024, 0, (0, 1024)), (1025, 0, (544, 1088)), (6, 3, (3, 33)),
     (37, 16, (16, 64)), (8385, 0, (960, 8640))],
)
def test_k_block_plan(k, csr_k_block, want):
    kc, k_pad = k_block_plan(k, csr_k_block)
    assert (kc, k_pad) == want
    assert k_pad >= k and (kc == 0 or k_pad % kc == 0)
    if csr_k_block == 0:
        assert kc <= ck.MAX_K and kc % 32 == 0


def test_model_takes_the_kb_paths_above_1024():
    g = _random_graph(5, n=20)
    pg = Graph(g.indptr, g.indices, g.raw_ids)
    m = BigClamModel(pg, BigClamConfig(num_communities=1100, use_pallas_csr=True),
                     device="cpu")
    assert (m.engaged_path, m.kc, m.k_pad) == ("csr_fused_kb", 576, 1152)
    m = BigClamModel(pg, BigClamConfig(num_communities=1100, use_pallas_csr=True,
                                       csr_fused=False), device="cpu")
    assert m.engaged_path == "csr_grouped_kb"
    m = BigClamModel(pg, BigClamConfig(num_communities=1000, use_pallas_csr=True),
                     device="cpu")
    assert (m.engaged_path, m.kc, m.k_pad) == ("csr_fused", 0, 1024)
    with pytest.raises(ValueError, match="min_f"):
        BigClamModel(pg, BigClamConfig(num_communities=1100, use_pallas_csr=True,
                                       min_f=0.1), device="cpu")


@pytest.mark.parametrize("csr_fused,want", [("auto", "csr_fused_kb"),
                                            ("off", "csr_grouped_kb")])
def test_cli_fit_above_1024_takes_the_kb_path(tmp_path, csr_fused, want):
    """`cli fit --k 1100` with the kernels on (their plain versions on the
    CPU): the K-blocked path by itself, K padded to 2 blocks of 576."""
    import contextlib
    import io
    import json

    from bigclam_tpu_torch import cli

    g = _random_graph(6, n=40, p=0.2)
    path = tmp_path / "g.txt"
    keep = g.src < g.indices
    np.savetxt(path, np.stack([g.src[keep], g.indices[keep]], axis=1), fmt="%d")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["fit", "--graph", str(path), "--k", "1100", "--init",
                       "random", "--max-iters", "2", "--conv-tol", "0",
                       "--csr-kernels", "on", "--csr-fused", csr_fused,
                       "--device", "cpu"])
    assert rc == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["kernel_path"] == want and out["k"] == 1100
    assert len(out["llh_history"]) == 3
    assert all(np.isfinite(out["llh_history"]))
    assert out["llh_history"][-1] > out["llh_history"][0]


def test_k_limit_messages_name_what_happens():
    # the model on a card: only an explicit csr_k_block above 1024 is refused
    check_k_block(1024, torch.device("cuda"))
    check_k_block(2048, torch.device("cpu"))               # plain versions: any
    with pytest.raises(ck.KernelKLimitError, match="leave csr_k_block at 0"):
        check_k_block(1056, torch.device("cuda"))
    # the single-pass wrappers still refuse K > 1024 and say where it goes
    c = Case("fused_test_graph_k6_kc3")
    wide = torch.zeros((c.n, ck.MAX_K + 1))
    with pytest.raises(ck.KernelKLimitError, match="single-pass.*csr_fused_kb"):
        ck.check_cuda_inputs(wide, c.csr, torch.zeros(ck.MAX_K + 1))
    # the K-blocked wrappers' window
    F = torch.zeros((c.n, 2048))
    kb.check_window(F, 1024, 1024)
    with pytest.raises(ck.KernelKLimitError, match="1..1024"):
        kb.check_window(F, 0, 1025)
    with pytest.raises(ValueError, match="outside"):
        kb.check_window(F, 1536, 1024)
    with pytest.raises(ValueError, match="divide"):
        kb.train_pass_kblocked(F, F.sum(0), c.csr, c.cfg, 1000)


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("fold", [True, False])
def test_cuda_kb_kernels_match_plain(name, fold, cuda_device):
    c = Case(name)
    dev = cuda_device
    F = torch.as_tensor(c.F, device=dev)
    sumF = F.sum(dim=0)
    csr = Graph(c.g.indptr, c.g.indices, c.g.raw_ids).to_device(dev)
    kb.reset_launch_counts()
    g_k, l_k, x_k = kb.train_pass_kblocked(F, sumF, csr, c.cfg, c.kc, fold=fold)
    torch.cuda.synchronize()
    n_kb = c.k_pad // c.kc
    assert kb.launch_counts() == {"edge_dots_kb": n_kb, "grad_from_x": n_kb,
                                  "cand_dots_kb": n_kb, "cand_from_x": 1,
                                  "cand_select_from_x": 0}
    x_p = torch.zeros(c.e, device=dev)
    for col0 in range(0, c.k_pad, c.kc):
        kb.edge_dots_kb_plain(F, csr, col0, c.kc, x_p)
    x = torch.zeros(c.e, device=dev)
    for col0 in range(0, c.k_pad, c.kc):
        kb.edge_dots_kb(F, csr, col0, c.kc, x)
    _close(x.cpu().numpy(), x_p.cpu().numpy())
    G = torch.as_tensor(c.G, device=dev)
    xc = torch.zeros((c.num_s, c.e), device=dev)
    xc_p = torch.zeros((c.num_s, c.e), device=dev)
    for col0 in range(0, c.k_pad, c.kc):
        g, ln = kb.grad_from_x_kb(x_p, F, sumF, csr, col0, c.kc, c.cfg, fold)
        g_p, ln_p = kb.grad_from_x_kb_plain(x_p, F, sumF, csr, col0, c.kc, c.cfg, fold)
        _close(g.cpu().numpy(), g_p.cpu().numpy())
        if col0 == 0:
            _close(ln.cpu().numpy(), ln_p.cpu().numpy())
        else:
            assert ln is None and ln_p is None
        g_kb = G[:, col0 : col0 + c.kc].contiguous()
        kb.cand_dots_kb(F, g_kb, csr, col0, c.kc, c.cfg, xc)
        kb.cand_dots_kb_plain(F, g_kb, csr, col0, c.kc, c.cfg, xc_p)
    _close(xc.cpu().numpy(), xc_p.cpu().numpy())
    _close(kb.cand_nbr_from_x(xc_p, csr, c.cfg).cpu().numpy(),
           kb.cand_nbr_from_x_plain(xc_p, csr, c.cfg).cpu().numpy())
    Fc, sumFc = F.cpu(), sumF.cpu()
    g_c, l_c, x_c = kb.train_pass_kblocked(Fc, sumFc, c.csr, c.cfg, c.kc, fold=fold)
    for a, b in ((g_k, g_c), (l_k, l_c), (x_k, x_c)):
        _close(a.cpu().numpy(), b.numpy())


@pytest.mark.cuda
def test_cuda_kb_wrappers_refuse_a_wide_window(cuda_device):
    c = Case("fused_test_graph_k6_kc3")
    csr = Graph(c.g.indptr, c.g.indices, c.g.raw_ids).to_device(cuda_device)
    F = torch.zeros((c.n, 2048), device=cuda_device)
    with pytest.raises(ck.KernelKLimitError):
        kb.edge_dots_kb(F, csr, 0, 2048, torch.zeros(c.e, device=cuda_device))
    with pytest.raises(ck.KernelKLimitError):
        BigClamModel(Graph(c.g.indptr, c.g.indices, c.g.raw_ids),
                     BigClamConfig(num_communities=2000, csr_k_block=2048),
                     device="cuda")
