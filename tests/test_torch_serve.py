"""The port's serving stack (bigclam_tpu_torch/ops/foldin.py and
serve/{snapshot,batcher,server}.py) held against the JAX package's in
float64: the fold-in ops at rtol 1e-12, the optimizer at 1e-10 with equal
iteration counts (and a stop test made before every step, as the
while_loop's), batched = sequential fold-in on the dense and sparse models,
the member-list densify with sentinels past k + 1, the FoldInEngine and the
MembershipServer of both packages on one snapshot, snapshots published by
either package served by the other (dense, and sparse at K = 37), and the
copies of snapshot.py and batcher.py pinned to their JAX sources."""

import ast
import pathlib
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bigclam_tpu.config import BigClamConfig as JaxConfig
from bigclam_tpu.models.agm import sample_planted_graph
from bigclam_tpu.ops import foldin as jfi
from bigclam_tpu.ops import sparse_members as jsm
from bigclam_tpu.serve import server as jserver
from bigclam_tpu.serve import snapshot as jsnap

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.models.bigclam import BigClamModel, random_init_F
from bigclam_tpu_torch.models.sparse import SparseBigClamModel
from bigclam_tpu_torch.ops import foldin as fi
from bigclam_tpu_torch.ops import sparse_members as sm
from bigclam_tpu_torch.serve import server as tserver
from bigclam_tpu_torch.serve import snapshot as tsnap
from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
K = 6
N = 120
K_ODD = 37
RTOL_OPS = 1e-12
RTOL_FIT = 1e-10


def _port_graph(g):
    return Graph(indptr=np.asarray(g.indptr), indices=np.asarray(g.indices),
                 raw_ids=np.asarray(g.raw_ids))


@pytest.fixture(scope="module")
def fitted():
    """The JAX serving tests' planted graph (N = 120, K = 6), fitted by the
    port on the CPU in float64 (the fold-in tests only need a realistic,
    converged F)."""
    g, _ = sample_planted_graph(N, K, p_in=0.8, rng=np.random.default_rng(3))
    pg = _port_graph(g)
    cfg = BigClamConfig(num_communities=K, max_iters=300, dtype="float64")
    model = BigClamModel(pg, cfg, device="cpu")
    res = model.fit(random_init_F(pg, cfg))
    return g, pg, cfg, model, res


def _jcfg(cfg):
    return JaxConfig(num_communities=cfg.num_communities, dtype="float64",
                     max_iters=cfg.max_iters, use_pallas_csr=False)


def _batch(g, F, nodes, k_cols):
    """The padded fold-in inputs of `nodes` on frozen F, in numpy."""
    nbr_ids, nbr_mask, _ = tsnap.pad_neighbor_batch(g.indptr, g.indices, nodes)
    Fp = np.zeros((F.shape[0], k_cols))
    Fp[:, : F.shape[1]] = F
    own = Fp[nodes]
    sumF_others = Fp.sum(axis=0)[None, :] - own
    return Fp, own, Fp[nbr_ids], nbr_mask.astype(np.float64), sumF_others


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------ fold-in ops
def test_foldin_ops_match_jax(fitted):
    g, _, cfg, _, res = fitted
    nodes = [0, 7, 33, 77, 119]
    _, own, nbr_rows, mask, sumF_others = _batch(g, res.F, nodes, K)
    jc = _jcfg(cfg)
    jg, jl = jfi.foldin_pass(jnp.asarray(own), jnp.asarray(nbr_rows),
                             jnp.asarray(mask), jnp.asarray(sumF_others), jc)
    tg, tl = fi.foldin_pass(_t(own), _t(nbr_rows), _t(mask), _t(sumF_others),
                            cfg)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=RTOL_OPS,
                               atol=1e-12)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL_OPS)
    jc_ = jfi.foldin_candidates(jnp.asarray(own), jg, jnp.asarray(nbr_rows),
                                jnp.asarray(mask), jnp.asarray(sumF_others), jc)
    tc = fi.foldin_candidates(_t(own), tg, _t(nbr_rows), _t(mask),
                              _t(sumF_others), cfg)
    assert tc.shape == (len(cfg.step_candidates), len(nodes))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc_), rtol=RTOL_OPS)
    np.testing.assert_allclose(
        fi.neighbor_mean_rows(_t(nbr_rows), _t(mask)).numpy(),
        np.asarray(jfi.neighbor_mean_rows(jnp.asarray(nbr_rows),
                                          jnp.asarray(mask))),
        rtol=RTOL_OPS)


def _jax_fit(cfg, rows0, nbr_rows, mask, sumF_others, **kw):
    fit = jfi.make_foldin_fit(_jcfg(cfg), **kw)
    rows, llh, iters = fit(jnp.array(rows0), jnp.asarray(nbr_rows),
                           jnp.asarray(mask), jnp.asarray(sumF_others))
    return np.asarray(rows), np.asarray(llh), np.asarray(iters)


@pytest.mark.parametrize("init", ["own", "mean"])
@pytest.mark.parametrize("tol", [None, 1e-8])
def test_foldin_fit_matches_jax(fitted, init, tol):
    g, _, cfg, _, res = fitted
    # an odd batch: node 0's row from a far-off start, padding rows of zeros
    nodes = [0, 2, 19, 45, 101, 118, 0]
    _, own, nbr_rows, mask, sumF_others = _batch(g, res.F, nodes, K)
    mask[-1] = 0.0
    if init == "mean":
        rows0 = np.array(jfi.neighbor_mean_rows(jnp.asarray(nbr_rows),
                                                jnp.asarray(mask)))
    else:
        rows0 = own.copy()
        rows0[0] *= 3.0
    rows0[-1] = 0.0
    kw = dict(max_iters=400, conv_tol=tol)
    jr, jl, ji = _jax_fit(cfg, rows0, nbr_rows, mask, sumF_others, **kw)
    r0 = _t(rows0.copy())
    tr, tl, ti = fi.make_foldin_fit(cfg, **kw)(r0, _t(nbr_rows), _t(mask),
                                               _t(sumF_others))
    assert torch.equal(r0, _t(rows0))           # rows0 is never written
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(tr.numpy(), jr, rtol=RTOL_FIT, atol=1e-12)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=RTOL_FIT)
    assert not tr[-1].any()                     # padding rows stay zero
    assert ti.dtype == torch.int32


@pytest.mark.parametrize("start,tol", [("mean", 1e-4), ("mean", 1e-8),
                                       ("own", 1e-4), ("own", 1e-8)])
def test_fit_stops_when_every_node_converged(fitted, monkeypatch, start, tol):
    """The loop tests any(active) before every step, as the JAX
    while_loop's cond does: it makes one pass beyond the last node's last
    active step and none after."""
    g, _, cfg, _, res = fitted
    nodes = list(range(0, N, 7))
    _, own, nbr_rows, mask, sumF_others = _batch(g, res.F, nodes, K)
    rows0 = (_t(own) if start == "own"
             else fi.neighbor_mean_rows(_t(nbr_rows), _t(mask)))
    passes = []
    orig = fi.foldin_pass

    def counted(*a, **kw):
        passes.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(fi, "foldin_pass", counted)
    _, _, iters = fi.make_foldin_fit(cfg, max_iters=300, conv_tol=tol)(
        rows0, _t(nbr_rows), _t(mask), _t(sumF_others))
    assert int(iters.max()) < 300
    assert len(passes) == int(iters.max()) + 1


def test_foldin_rows_recovers_trained_row_dense(fitted):
    g, _, cfg, model, res = fitted
    state = model.init_state(res.F)
    nodes = list(range(0, N, 11))
    rows, llh, iters = model.foldin_rows(state, nodes, conv_tol=1e-8,
                                         max_iters=500)
    np.testing.assert_allclose(rows, res.F[nodes], atol=1e-3)
    assert np.all(np.isfinite(llh))


def _sparse_fit(fitted):
    _, pg, cfg, _, _ = fitted
    import dataclasses

    scfg = dataclasses.replace(cfg, representation="sparse", sparse_m=K)
    smodel = SparseBigClamModel(pg, scfg, device="cpu")
    state, _, _, _ = smodel.fit_state(
        smodel.init_state(random_init_F(pg, scfg)))
    return smodel, state


def test_foldin_rows_recovers_trained_row_sparse(fitted):
    smodel, state = _sparse_fit(fitted)
    F_tr = smodel.extract_F(state)
    nodes = list(range(0, N, 13))
    rows, _, _ = smodel.foldin_rows(state, nodes, conv_tol=1e-8,
                                    max_iters=500)
    np.testing.assert_allclose(rows, F_tr[nodes], atol=5e-3)


@pytest.mark.parametrize("init", ["own", "mean"])
def test_batched_equals_sequential_dense(fitted, init):
    _, _, _, model, res = fitted
    state = model.init_state(res.F)
    nodes = [2, 19, 45, 101]
    rows_b, llh_b, it_b = model.foldin_rows(state, nodes, conv_tol=1e-8,
                                            max_iters=400, init=init)
    for i, u in enumerate(nodes):
        rows_1, llh_1, it_1 = model.foldin_rows(state, [u], conv_tol=1e-8,
                                                max_iters=400, init=init)
        np.testing.assert_allclose(rows_1[0], rows_b[i], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(llh_1[0], llh_b[i], rtol=1e-10)
        assert int(it_1[0]) == int(it_b[i])


def test_batched_equals_sequential_sparse(fitted):
    smodel, state = _sparse_fit(fitted)
    nodes = [5, 28, 61]
    rows_b, _, it_b = smodel.foldin_rows(state, nodes, conv_tol=1e-8,
                                         max_iters=400, init="mean")
    for i, u in enumerate(nodes):
        rows_1, _, it_1 = smodel.foldin_rows(state, [u], conv_tol=1e-8,
                                             max_iters=400, init="mean")
        np.testing.assert_allclose(rows_1[0], rows_b[i], rtol=1e-6, atol=1e-7)
        assert int(it_1[0]) == int(it_b[i])


@pytest.mark.parametrize("sentinel", [K_ODD, 64, 128])
def test_densify_maps_every_sentinel_to_the_discard_column(sentinel):
    """Member lists whose empty slots hold a sentinel at or past k + 1
    densify as JAX's out-of-range-dropping scatter does."""
    rng = np.random.default_rng(37)
    n, m = 40, 5
    F = rng.uniform(0, 1, (n, K_ODD)) * (rng.random((n, K_ODD)) < 0.08)
    ids, w, _ = jsm.from_dense(F, m, K_ODD, n)
    ids = np.where(ids >= K_ODD, sentinel, ids).astype(np.int32)
    nbr = rng.integers(0, n, (7, 9))
    jd = np.asarray(jfi.densify_member_rows(jnp.asarray(ids), jnp.asarray(w),
                                            jnp.asarray(nbr), K_ODD))
    td = fi.densify_member_rows(_t(ids), _t(w), _t(nbr), K_ODD)
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_array_equal(
        fi.densify_rows(_t(ids), _t(w), _t(nbr[0]), K_ODD).numpy(),
        np.asarray(jfi.densify_rows(jnp.asarray(ids), jnp.asarray(w),
                                    jnp.asarray(nbr[0]), K_ODD)))
    np.testing.assert_array_equal(td.numpy()[0],
                                  sm.to_dense(ids, w, n, K_ODD)[nbr[0]])


def test_apply_rows_matches_jax(fitted):
    _, _, _, _, res = fitted
    F = res.F.copy()
    nodes = np.asarray([3, 50, 99])
    rows = np.random.default_rng(1).uniform(0, 1, (3, K))
    jF, jsum = jfi.apply_rows(jnp.asarray(F), jnp.asarray(F.sum(0)),
                              jnp.asarray(nodes), jnp.asarray(rows))
    tF, tsum = fi.apply_rows(_t(F.copy()), _t(F.sum(0)), _t(nodes), _t(rows))
    np.testing.assert_array_equal(tF.numpy(), np.asarray(jF))
    np.testing.assert_allclose(tsum.numpy(), np.asarray(jsum), rtol=1e-14)


# --------------------------------------------- engines, servers, snapshots
def _suggest_items(g, snap, rng):
    """Existing nodes (own rows, one with its neighbours capped) and
    brand-new nodes given neighbour id lists."""
    items = []
    for u in (0, 17, 58, 119):
        lo, hi = int(g.indptr[u]), int(g.indptr[u + 1])
        items.append((np.asarray(g.indices[lo:hi], np.int64), u))
    for d in (3, 11):
        items.append((rng.choice(snap.n, size=d, replace=False), None))
    return items


def _assert_suggest_equal(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a["iters"] == b["iters"]
        np.testing.assert_allclose(a["llh"], b["llh"], rtol=RTOL_FIT)
        assert [c for c, _ in a["suggested"]] == [c for c, _ in b["suggested"]]
        np.testing.assert_allclose([v for _, v in a["suggested"]],
                                   [v for _, v in b["suggested"]],
                                   rtol=RTOL_FIT, atol=1e-12)


def _publish(pkg, d, fitted, sparse=False, k=K, F=None, sentinel=None):
    g, _, cfg, _, res = fitted
    F = res.F if F is None else F
    jc = JaxConfig(num_communities=k, dtype="float64")
    if not sparse:
        return pkg.publish_snapshot(d, step=None, F=F, raw_ids=g.raw_ids,
                                    num_edges=g.num_edges, cfg=jc)
    ids, w, _ = (jsm if pkg is jsnap else sm).from_dense(F, k, k, F.shape[0])
    if sentinel is not None:
        ids = np.where(ids >= k, sentinel, ids).astype(np.int32)
    return pkg.publish_snapshot(d, step=None, ids=ids, w=w, raw_ids=g.raw_ids,
                                num_edges=g.num_edges, cfg=jc)


def _odd_F(fitted):
    """An (N, 37) F: the fitted rows spread over 37 columns."""
    _, _, _, _, res = fitted
    rng = np.random.default_rng(11)
    F = np.zeros((N, K_ODD))
    cols = rng.permutation(K_ODD)[:K]
    F[:, cols] = res.F
    return F


@pytest.mark.parametrize("case", ["dense", "sparse_k37"])
@pytest.mark.parametrize("publisher", ["port", "jax"])
def test_snapshots_cross_packages(tmp_path, fitted, case, publisher):
    """A snapshot either package publishes loads in the other with the same
    index, reads and sumF, and both packages' engines fold it in alike
    (the sparse case with sentinels 37 from the port's from_dense and 128
    from a JAX model's k_pad)."""
    g = fitted[0]
    sparse = case != "dense"
    k = K_ODD if sparse else K
    F = _odd_F(fitted) if sparse else None
    d = str(tmp_path / "s")
    pub = tsnap if publisher == "port" else jsnap
    _publish(pub, d, fitted, sparse, k, F,
             sentinel=128 if (sparse and publisher == "jax") else None)
    ours = tsnap.ServingSnapshot.load(d)
    ref = jsnap.ServingSnapshot.load(d)
    assert ours.representation == ref.representation
    assert (ours.step, ours.n, ours.k, ours.delta) == (ref.step, ref.n, ref.k,
                                                     ref.delta)
    np.testing.assert_array_equal(ours.comm_indptr, ref.comm_indptr)
    np.testing.assert_array_equal(ours.comm_members, ref.comm_members)
    np.testing.assert_array_equal(ours.sumF, ref.sumF)
    for u in range(0, N, 9):
        for a, b in zip(ours.communities_of(u), ref.communities_of(u)):
            np.testing.assert_array_equal(a, b)
    items = _suggest_items(g, ours, np.random.default_rng(5))
    te = tserver.FoldInEngine(ours, device="cpu")
    je = jserver.FoldInEngine(ref)
    assert te.dtype == torch.float64
    _assert_suggest_equal(te.suggest_batch(items), je.suggest_batch(items))


def test_engine_rows_addressing_matches_id_addressing(tmp_path, fitted):
    g = fitted[0]
    d = str(tmp_path / "s")
    _publish(tsnap, d, fitted)
    snap = tsnap.ServingSnapshot.load(d)
    eng = tserver.FoldInEngine(snap, device="cpu")
    items = _suggest_items(g, snap, np.random.default_rng(6))
    by_rows = [(snap.F[nbr], None if row is None else snap.F[row])
               for nbr, row in items]
    _assert_suggest_equal(eng.suggest_batch_rows(by_rows),
                          eng.suggest_batch(items))
    _assert_suggest_equal(eng.suggest_batch_rows(by_rows),
                          jserver.FoldInEngine(
                              jsnap.ServingSnapshot.load(d)
                          ).suggest_batch_rows(by_rows))


def _queries(g, rng, n=60):
    out = []
    for i in range(n):
        r = i % 5
        if r in (0, 1):
            out.append({"family": "communities_of", "u": int(rng.integers(N))})
        elif r in (2, 3):
            out.append({"family": "members_of", "c": int(rng.integers(K))})
        elif i % 2:
            out.append({"family": "suggest_for", "u": int(rng.integers(N))})
        else:
            out.append({"family": "suggest_for",
                        "neighbors": rng.choice(N, 4, replace=False).tolist()})
    out.append({"family": "members_of", "c": K + 3})     # an error answer
    return out


@pytest.mark.parametrize("sparse", [False, True])
def test_server_matches_jax_server(tmp_path, fitted, sparse):
    g, pg = fitted[0], fitted[1]
    d = str(tmp_path / "s")
    _publish(tsnap, d, fitted, sparse=sparse)
    qs = _queries(g, np.random.default_rng(9))
    with tserver.MembershipServer(d, graph=pg, budget_s=0.002, max_batch=16,
                                  device="cpu") as ours, \
            jserver.MembershipServer(d, graph=g, budget_s=0.002,
                                     max_batch=16) as ref:
        got, want = ours.run_queries(qs), ref.run_queries(qs)
        so, sr = ours.stats(), ref.stats()
    assert so["serve_errors"] == sr["serve_errors"] == 1
    assert set(so) == set(sr)
    for q, a, b in zip(qs, got, want):
        if q["family"] != "suggest_for":
            a.pop("cached", None), b.pop("cached", None)
            assert a == b
        else:
            assert a.get("u") == b.get("u")
            _assert_suggest_equal([a], [b])


def test_hot_swap_drops_nothing_and_threads_close(tmp_path, fitted):
    g, pg = fitted[0], fitted[1]
    d = str(tmp_path / "s")
    _publish(tsnap, d, fitted)
    qs = _queries(g, np.random.default_rng(4), n=200)[:-1]
    before = {t.name for t in threading.enumerate()}
    server = tserver.MembershipServer(d, graph=pg, budget_s=0.001,
                                      max_batch=8, watch_interval_s=0.05,
                                      device="cpu")
    try:
        res = []
        stream = threading.Thread(target=lambda: res.extend(
            server.run_queries(qs * 3)))
        stream.start()
        _publish(tsnap, d, fitted)
        stream.join(timeout=120)
        assert not stream.is_alive()
        if server.generation == 1:              # the stream beat the poll
            server.maybe_reload()
        stats = server.stats()
    finally:
        server.close()
    assert server.generation == 2 and stats["snapshot_swaps"] == 1
    assert len(res) == 3 * len(qs) and stats["serve_errors"] == 0
    assert not any("error" in r for r in res)
    later = {t.name for t in threading.enumerate()} - before
    assert not any(n.startswith("bigclam") for n in later), later
    assert CheckpointManager(d).latest() == 2


def test_server_resolves_its_device_at_start(tmp_path, fitted):
    from bigclam_tpu_torch.utils.device import DeviceUnavailableError

    d = str(tmp_path / "s")
    _publish(tsnap, d, fitted)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(DeviceUnavailableError):
        tserver.MembershipServer(d)


def test_engine_dtype_follows_the_snapshot_on_the_cpu(tmp_path, fitted):
    d = str(tmp_path / "s")
    _publish(tsnap, d, fitted)
    snap = tsnap.ServingSnapshot.load(d)
    assert snap.sumF.dtype == np.float64
    assert tserver.FoldInEngine(snap, device="cpu").dtype == torch.float64
    assert tserver.FoldInEngine(snap, device="cpu",
                                dtype=torch.float32).dtype == torch.float32


@pytest.mark.cuda
def test_float64_snapshot_serves_on_the_card_in_float32(tmp_path, fitted):
    """A float64 archive (a CPU float64 fit's, or the JAX package's under
    x64) is served on the card in float32, as the JAX engine serves it
    without x64; asking for float64 there is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g, pg = fitted[0], fitted[1]
    d = str(tmp_path / "s")
    _publish(tsnap, d, fitted)
    snap = tsnap.ServingSnapshot.load(d)
    card = tserver.FoldInEngine(snap, device="cuda")
    assert card.dtype == torch.float32
    items = _suggest_items(g, snap, np.random.default_rng(6))
    got = card.suggest_batch(items)
    ref = tserver.FoldInEngine(snap, device="cpu").suggest_batch(items)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a["llh"], b["llh"], rtol=1e-4)
    with pytest.raises(ValueError):
        tserver.FoldInEngine(snap, device="cuda", dtype=torch.float64)
    qs = [q for q in _queries(g, np.random.default_rng(9))
          if q["family"] == "suggest_for"]
    with tserver.MembershipServer(d, graph=pg, device="cuda") as server:
        answers = server.run_queries(qs)
        assert server.stats()["serve_errors"] == 0
    assert all("suggested" in a for a in answers)


FLEET_NAMES = {"ShardReplica": "fleet", "ReplicaServer": "fleet",
               "LocalReplica": "fleet", "FleetRouter": "router",
               "TcpReplica": "router", "RouterError": "router"}


@pytest.mark.parametrize("name", sorted(FLEET_NAMES))
def test_fleet_names_are_exported(name):
    """The six fleet names of the JAX package's serve/ are the port's
    serve.fleet and serve.router classes, lazily exported."""
    import importlib

    import bigclam_tpu_torch.serve as serve

    mod = importlib.import_module(f"bigclam_tpu_torch.serve.{FLEET_NAMES[name]}")
    assert getattr(serve, name) is getattr(mod, name)
    assert name in serve.__all__ and not hasattr(serve, "FleetNotPortedError")


# ----------------------------------------------------------- copy pins
def _docless_tree(path: pathlib.Path, package: str) -> ast.Module:
    """The module's AST with every docstring dropped and the package name
    replaced by a placeholder."""
    tree = ast.parse(path.read_text().replace(package + ".", "PKG."))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return tree


def _docless_ast(path: pathlib.Path, package: str) -> str:
    return ast.dump(_docless_tree(path, package))


@pytest.mark.parametrize("name", ["snapshot", "batcher", "router"])
def test_serving_copies_are_their_jax_sources(name):
    ours = REPO / "bigclam_tpu_torch" / "serve" / f"{name}.py"
    ref = REPO / "bigclam_tpu" / "serve" / f"{name}.py"
    assert _docless_ast(ours, "bigclam_tpu_torch") == _docless_ast(
        ref, "bigclam_tpu")
    assert f"Copied from bigclam_tpu/serve/{name}.py" in ours.read_text()


def _defs(path: pathlib.Path, package: str) -> dict:
    """Docless AST of every module-level statement, keyed by a function's
    or class method's qualified name (other statements by position)."""
    out = {}
    for i, node in enumerate(_docless_tree(path, package).body):
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                out[f"{node.name}.{getattr(sub, 'name', i)}"] = ast.dump(sub)
            node.body = [b for b in node.body if not isinstance(
                b, (ast.FunctionDef, ast.AsyncFunctionDef))]
        out[getattr(node, "name", f"stmt{i}")] = ast.dump(node)
    return out


# what the port changes in its copies: the replica resolves a --device
# and builds the torch FoldInEngine there, reports it in its status, and
# the supervisor passes its --device to the children it spawns
FLEET_EDITS = {
    "fleet": {"ShardReplica.__init__", "ShardReplica._engine_for",
              "ShardReplica.status"},
    "supervise": {"FleetSupervisor.__init__", "FleetSupervisor._spawn"},
}


@pytest.mark.parametrize("name", sorted(FLEET_EDITS))
def test_fleet_copies_are_their_jax_sources_but_for_the_device(name):
    ours = _defs(REPO / "bigclam_tpu_torch" / "serve" / f"{name}.py",
                 "bigclam_tpu_torch")
    ref = _defs(REPO / "bigclam_tpu" / "serve" / f"{name}.py", "bigclam_tpu")
    assert set(ours) == set(ref)
    differ = {k for k in ref if ours[k] != ref[k]}
    assert differ == FLEET_EDITS[name]
    text = (REPO / "bigclam_tpu_torch" / "serve" / f"{name}.py").read_text()
    assert f"Copied from bigclam_tpu/serve/{name}.py" in text
