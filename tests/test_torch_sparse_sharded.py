"""The port's sparse sharded trainer (parallel/sparse_sharded.py) and its
sparse allreduce (parallel/sparse_collectives.py) against the JAX
package's, on the CPU in float64.

* The host copies are their JAX sources (AST, docstrings dropped);
  `presence` equals the JAX one.
* The port's sparse allreduce equals the JAX `sparse_allreduce_sum` under
  shard_map, counters included: the exact case, the overflow fallback,
  the static-psum form.
* `SparseShardedBigClamModel` at dp = 2, 4 and 8 against the JAX trainer
  on the planted fixture with a community-local init (LLH 1e-10, ids
  equal, weights within JAX's band, cap, mode, path and counters equal at
  every step), on both merge paths; the sharded fit equals the port's
  single-device sparse fit; the sparse and the psum exchange give the
  same bits, and so does a cap that overflows every step.
* The refusals carry the JAX messages; a resume is bit for bit; a
  checkpoint of another dp and a dense one are refused.
* Health extras, the comms model and the memory model; `cli fit`,
  `sweep` and `preflight` on a sparse mesh against the JAX CLI.
"""

import ast
import contextlib
import dataclasses
import io
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

from bigclam_tpu.cli import main as jax_main
from bigclam_tpu.config import BigClamConfig as JaxConfig
from bigclam_tpu.models.agm import sample_planted_graph
from bigclam_tpu.obs import comms as jcomms
from bigclam_tpu.ops import sparse_members as jsm
from bigclam_tpu.parallel import SparseShardedBigClamModel as JaxSharded
from bigclam_tpu.parallel import make_mesh as jax_make_mesh
from bigclam_tpu.parallel.sparse_collectives import (
    sparse_allreduce_sum as jax_sparse_allreduce_sum,
)
from bigclam_tpu.utils.compat import shard_map

from bigclam_tpu_torch import cli
from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.models.bigclam import BigClamModel, CheckpointMismatchError
from bigclam_tpu_torch.models.sparse import SparseBigClamModel
from bigclam_tpu_torch.obs import comms as pcomms
from bigclam_tpu_torch.obs.schema import validate_events_file
from bigclam_tpu_torch.ops import diagnostics as dx
from bigclam_tpu_torch.ops import sparse_members as sm
from bigclam_tpu_torch.parallel import SparseShardedBigClamModel, make_mesh
from bigclam_tpu_torch.parallel import sparse_collectives as sc
from bigclam_tpu_torch.parallel.sparse_sharded import shard_touched_counts
from bigclam_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _port_graph(g):
    return Graph(indptr=g.indptr, indices=g.indices, raw_ids=g.raw_ids)


def _local_init(g, truth, k, lo, hi):
    """A community-local F0: each node in its planted block(s) only, at a
    weight from uniform(lo, hi) (default_rng(19))."""
    rng = np.random.default_rng(19)
    F0 = np.zeros((g.num_nodes, k))
    for c, nodes in enumerate(truth):
        F0[nodes, c] = rng.uniform(lo, hi, len(nodes))
    return F0


@pytest.fixture(scope="module")
def planted():
    """tests/test_sparse.py's planted blocks (N = 1,024, K = 256, p_in
    0.6, default_rng(11)) with a community-local init at weights from
    uniform(0.05, 0.3): the first step moves every row (at weight 1 the
    blocks are a fixed point of the ascent, which would make any two paths
    agree trivially)."""
    g, truth = sample_planted_graph(
        1024, 256, p_in=0.6, rng=np.random.default_rng(11)
    )
    return g, _port_graph(g), _local_init(g, truth, 256, 0.05, 0.3)


@pytest.fixture(scope="module")
def moving():
    """Overlapping planted blocks (N = 1,024, K = 64, p_in 0.3, two nodes
    of each block also in the next): a community-local init whose LLH
    moves every step and whose support update admits the next block's
    community across shard boundaries. M = 4."""
    g, truth = sample_planted_graph(
        1024, 64, p_in=0.3, overlap=2, rng=np.random.default_rng(11)
    )
    return g, _port_graph(g), _local_init(g, truth, 64, 0.02, 0.2)


def _jcfg(k=256, m=16, **kw):
    base = dict(
        num_communities=k, representation="sparse", sparse_m=m,
        dtype="float64", max_iters=4, conv_tol=0.0,
        use_pallas=False, use_pallas_csr=False, sparse_pallas_merge=False,
    )
    base.update(kw)
    return JaxConfig(**base)


def _pcfg(jcfg):
    return BigClamConfig(**dataclasses.asdict(jcfg))


def _pmesh(dp):
    return make_mesh((dp, 1), [CPU] * dp)


def _pair(jg, pg, jcfg, dp):
    jm = JaxSharded(jg, jcfg, jax_make_mesh((dp, 1), jax.devices()[:dp]))
    pm = SparseShardedBigClamModel(pg, _pcfg(jcfg), _pmesh(dp))
    return jm, pm


def _ids(state):
    return torch.cat(list(state.ids)).numpy()


def _w(state):
    return torch.cat(list(state.F)).numpy()


# ----------------------------------------------------------- copy pins
def _docless_function_ast(path, package, name):
    tree = ast.parse(path.read_text().replace(package + ".", "PKG."))
    node = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    for sub in ast.walk(node):
        body = getattr(sub, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            sub.body = body[1:] or [ast.Pass()]
    return ast.dump(node)


@pytest.mark.parametrize("rel,name", [
    ("parallel/sparse_collectives.py", "_round_up"),
    ("parallel/sparse_collectives.py", "exchange_payload_bytes"),
    ("parallel/sparse_collectives.py", "auto_cap"),
    ("parallel/sparse_collectives.py", "static_mode"),
    ("parallel/sparse_sharded.py", "shard_touched_counts"),
])
def test_host_copies_are_their_jax_sources(rel, name):
    ours = _docless_function_ast(REPO / "bigclam_tpu_torch" / rel,
                                 "bigclam_tpu_torch", name)
    ref = _docless_function_ast(REPO / "bigclam_tpu" / rel, "bigclam_tpu", name)
    assert ours == ref


def test_presence_and_touched_counts_equal_jax():
    rng = np.random.default_rng(1)
    F = rng.uniform(0.0, 1.0, size=(40, 12))
    F[F < 0.6] = 0.0
    ids, _, _ = sm.from_dense(F, m=5, k_pad=12, n_pad=48)
    got = sm.presence(torch.from_numpy(ids), 12).numpy()
    np.testing.assert_array_equal(got, np.asarray(jsm.presence(jnp.asarray(ids), 12)))
    np.testing.assert_array_equal(got, (F > 0).any(axis=0) & np.isin(
        np.arange(12), ids[ids < 12]))
    for dp in (1, 2, 3, 4):
        assert shard_touched_counts(ids, dp, 12).tolist() == [
            int(np.unique(ids[i * (48 // dp):(i + 1) * (48 // dp)][
                ids[i * (48 // dp):(i + 1) * (48 // dp)] < 12]).size)
            for i in range(dp)]


# -------------------------------------------------------- sparse allreduce
def _jax_allreduce(vals, pres, cap, k_pad):
    dp = vals.shape[0]
    mesh = JaxMesh(np.asarray(jax.devices()[:dp]).reshape(dp, 1), ("nodes", "k"))

    def body(v, p):
        return jax_sparse_allreduce_sum(v[0], p[0], cap, "nodes", k_pad)

    f = shard_map(body, mesh=mesh, in_specs=(P("nodes", None), P("nodes", None)),
                  out_specs=(P(), P(), P()), check_vma=False)
    out, cnt, fb = jax.jit(f)(jnp.asarray(vals), jnp.asarray(pres))
    return np.asarray(out), int(cnt), int(fb)


def _port_allreduce(vals, pres, cap, k_pad, mode="sparse"):
    dp = vals.shape[0]
    v = [torch.from_numpy(vals[i]) for i in range(dp)]
    p = [torch.from_numpy(pres[i]) for i in range(dp)]
    with pcomms.counting() as ctr:
        if mode == "sparse":
            out, cnt, fb = sc.sparse_allreduce_sum(v, p, cap, k_pad, [CPU] * dp)
        else:
            out, cnt, fb = sc.psum_allreduce_sum(v, p, [CPU] * dp)
    assert all(o is out[0] for o in out)        # one device: one copy
    return out[0].numpy(), int(cnt), int(fb), ctr.bytes


@pytest.mark.parametrize("case", ["exact", "overflow", "psum"])
@pytest.mark.parametrize("dp", [3, 4])
def test_sparse_allreduce_equals_jax(case, dp):
    """Float values this time: the port sums in shard order, so its
    sparse exchange equals its psum bit for bit, and JAX's at 1e-15."""
    rng = np.random.default_rng(dp)
    k_pad, cap = 64, 24 if case != "overflow" else 8
    vals = np.zeros((dp, k_pad))
    pres = np.zeros((dp, k_pad), bool)
    for i in range(dp):
        touched = rng.choice(k_pad, size=10 + i, replace=False)
        pres[i, touched] = True
        vals[i, touched] = rng.uniform(0.5, 3.0, touched.size)
    out, cnt, fb, counted = _port_allreduce(
        vals, pres, cap, k_pad, "psum" if case == "psum" else "sparse")
    dense, _, _, _ = _port_allreduce(vals, pres, cap, k_pad, "psum")
    np.testing.assert_array_equal(out, dense)
    want = vals[0].copy()
    for i in range(1, dp):
        want = want + vals[i]
    np.testing.assert_array_equal(out, want)
    assert cnt == 10 + dp - 1
    if case == "psum":
        assert fb == 1 and set(counted) == {sc.SITE_SUMF, sc.SITE_COUNT}
        return
    ref, jcnt, jfb = _jax_allreduce(vals, pres, cap, k_pad)
    np.testing.assert_allclose(out, ref, rtol=1e-15, atol=0)
    assert (cnt, fb) == (jcnt, jfb) == (jcnt, int(case == "overflow"))
    pay = sc.exchange_payload_bytes(cap, 8)
    want_sites = {sc.SITE_COUNT: pcomms.wire_bytes("pmax", 4, dp)}
    if case == "exact":
        want_sites[sc.SITE_TOUCHED] = pcomms.wire_bytes("all_gather", pay, dp)
    else:
        want_sites[sc.SITE_SUMF] = pcomms.wire_bytes("psum", k_pad * 8, dp)
    assert counted == want_sites


def test_compact_touched_equals_jax_nonzero():
    rng = np.random.default_rng(7)
    vals = rng.uniform(size=40)
    pres = rng.random(40) < 0.3
    from bigclam_tpu.parallel.sparse_collectives import compact_touched as jct

    for cap in (4, 8, 40):
        got = sc.compact_touched(torch.from_numpy(vals), torch.from_numpy(pres),
                                 cap, 40)
        ref = jct(jnp.asarray(vals), jnp.asarray(pres), cap, 40)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------- the trainer
def _lockstep(jm, pm, F0, steps=4, check_ids=True):
    sj, sp = jm.init_state(F0), pm.init_state(F0)
    assert (pm.comm_cap, pm.comm_mode, pm.engaged_path, pm.n_pad, pm.block_b) == (
        jm.comm_cap, jm.comm_mode, jm.engaged_path, jm.n_pad, jm.block_b)
    for _ in range(steps):
        sj, sp = jm._step(sj), pm._step(sp)
        np.testing.assert_allclose(float(sp.llh), float(sj.llh), rtol=1e-10)
        assert pm.last_comm(sp) == jm.last_comm(sj)
        if check_ids:
            np.testing.assert_array_equal(_ids(sp), np.asarray(sj.ids))
            np.testing.assert_allclose(_w(sp), np.asarray(sj.F),
                                       rtol=1e-9, atol=1e-12)
    return sj, sp


@pytest.mark.parametrize("dp", [2, 4, 8])
@pytest.mark.parametrize("fixture,m", [("planted", 16), ("moving", 4)])
def test_trainer_matches_jax(request, fixture, m, dp):
    jg, pg, F0 = request.getfixturevalue(fixture)
    jm, pm = _pair(jg, pg, _jcfg(F0.shape[1], m), dp)
    _, sp = _lockstep(jm, pm, F0)
    assert pm.engaged_path == ("sparse_xla_spall" if dp == 8 else "sparse_xla_psum")
    assert pm.last_comm(sp)[1] == (dp != 8)            # psum mode: flag 1


def test_kernel_path_matches_jax_interpret():
    """sparse_pallas_merge=True: the member-lookup kernel's plain version
    on the CPU against the interpret-mode Pallas merge."""
    g, truth = sample_planted_graph(160, 40, p_in=0.6,
                                    rng=np.random.default_rng(3))
    F0 = np.zeros((g.num_nodes, 40))
    for c, nodes in enumerate(truth):
        F0[nodes, c] = np.random.default_rng(c).uniform(0.2, 1.5, len(nodes))
    jcfg = _jcfg(40, 6, sparse_pallas_merge=True, pallas_interpret=True,
                 max_iters=2)
    jm, pm = _pair(g, _port_graph(g), jcfg, 4)
    assert pm.engaged_path.startswith("sparse_merge_pallas_")
    _lockstep(jm, pm, F0, steps=2)


def test_sharded_equals_single_device(moving):
    _, pg, F0 = moving
    cfg = _pcfg(_jcfg(64, 4, max_iters=5))
    one = SparseBigClamModel(pg, cfg, device="cpu").fit(F0)
    for dp in (3, 8):
        res = SparseShardedBigClamModel(pg, cfg, _pmesh(dp)).fit(F0)
        np.testing.assert_allclose(res.llh_history, one.llh_history, rtol=1e-12)
        np.testing.assert_allclose(res.F, one.F, rtol=1e-9, atol=1e-12)
    assert len(set(one.llh_history)) > 1            # the ascent moved


def test_sparse_and_psum_exchange_give_the_same_bits(moving):
    """Forcing the psum (sparse_dense_fallback=0) or a cap that overflows
    every step (comm_dense 1) changes the wire pattern, not the bits."""
    _, pg, F0 = moving
    cfg = _pcfg(_jcfg(64, 4, max_iters=3))
    runs = {}
    for name, c in (("spall", cfg), ("psum", cfg.replace(sparse_dense_fallback=0.0)),
                    ("overflow", cfg.replace(sparse_comm_cap=8))):
        m = SparseShardedBigClamModel(pg, c, _pmesh(8))
        state = m.init_state(F0)
        for _ in range(3):
            state = m._step(state)
        runs[name] = (m.engaged_path, m.last_comm(state), _w(state), _ids(state),
                      float(state.llh))
    assert runs["spall"][0] == runs["overflow"][0] == "sparse_xla_spall"
    assert runs["psum"][0] == "sparse_xla_psum"
    assert runs["spall"][1][1] is False and runs["spall"][1][0] < 32
    assert runs["overflow"][1] == (runs["spall"][1][0], True)
    for name in ("psum", "overflow"):
        np.testing.assert_array_equal(runs[name][2], runs["spall"][2])
        np.testing.assert_array_equal(runs[name][3], runs["spall"][3])
        assert runs[name][4] == runs["spall"][4]


def test_hook_entry_equals_init_state(planted):
    """A community-local state built without a dense F0: the ids and
    weights through _on_init_sparsified and reset_state(*_place(...)),
    bit for bit init_state(one-hot F0)."""
    g, pg, _ = planted
    truth = sample_planted_graph(1024, 256, p_in=0.6,
                                 rng=np.random.default_rng(11))[1]
    cfg = _pcfg(_jcfg())
    a = SparseShardedBigClamModel(pg, cfg, _pmesh(8))
    b = SparseShardedBigClamModel(pg, cfg, _pmesh(8))
    F0 = np.zeros((g.num_nodes, 256))
    ids = np.full((a.n_pad, a.m), 256, np.int32)
    w = np.zeros((a.n_pad, a.m))
    for c, nodes in enumerate(truth):
        F0[nodes, c] = 1.0
        ids[nodes, 0] = c
        w[nodes, 0] = 1.0
    sa = a.init_state(F0)
    b._on_init_sparsified(ids)
    sb = b.reset_state(*b._place(ids, w))
    assert (a.comm_cap, a.comm_mode, a.engaged_path) == (
        b.comm_cap, b.comm_mode, b.engaged_path)
    for _ in range(2):
        for x, y in zip(sa, sb):
            xs = x if isinstance(x, tuple) else (x,)
            ys = y if isinstance(y, tuple) else (y,)
            assert len(xs) == len(ys)
            for u, v in zip(xs, ys):
                assert (torch.equal(u, v) if isinstance(u, torch.Tensor)
                        else u == v)
        sa, sb = a._step(sa), b._step(sb)


def test_refusals_carry_jax_messages(planted):
    _, pg, _ = planted
    cfg = _pcfg(_jcfg())
    with pytest.raises(ValueError, match="does not shard the K axis"):
        SparseShardedBigClamModel(pg, cfg, make_mesh((2, 2), [CPU] * 4))
    with pytest.raises(ValueError, match="balance=True is not supported"):
        SparseShardedBigClamModel(pg, cfg, _pmesh(2), balance=True)


# ------------------------------------------------------------ the CLI
def _cli_json(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def edge_file(tmp_path_factory):
    g, _ = sample_planted_graph(240, 12, p_in=0.4, rng=np.random.default_rng(2))
    path = tmp_path_factory.mktemp("g") / "g.txt"
    keep = g.src < g.dst
    np.savetxt(path, np.stack([g.src[keep], g.dst[keep]], axis=1), fmt="%d")
    return str(path)


def _jax_refusal(argv):
    try:
        jax_main(argv + ["--quiet"])
    except SystemExit as e:
        return str(e)
    except ValueError as e:
        return f"error: {e}"
    raise AssertionError("the JAX CLI ran")


@pytest.mark.parametrize("extra", [
    ["--mesh", "2,1", "--schedule", "ring"],
    ["--mesh", "2,2"],
    ["--mesh", "2,1", "--balance"],
    ["--mesh", "2,1", "--store-native"],
    ["--mesh", "2,1", "--quality"],
    ["--mesh", "2,1", "--partition", "2d"],
], ids=["ring", "tp2", "balance", "store_native", "quality", "2d"])
def test_cli_refusals_carry_jax_words(edge_file, extra):
    argv = ["fit", "--graph", edge_file, "--k", "6", "--max-iters", "2",
            "--representation", "sparse", "--sparse-m", "3"] + extra
    want = _jax_refusal(argv)
    with pytest.raises(SystemExit) as e:
        cli.main(argv + ["--device", "cpu"])
    assert str(e.value) == want


@pytest.mark.parametrize("mesh", ["2,1", "4,1"])
def test_cli_fit_sparse_mesh_matches_jax_cli(edge_file, tmp_path, mesh):
    argv = ["fit", "--graph", edge_file, "--k", "12", "--max-iters", "5",
            "--dtype", "float64", "--representation", "sparse",
            "--sparse-m", "4", "--mesh", mesh]
    out = _cli_json(cli.main, argv + ["--device", "cpu", "--telemetry-dir",
                                      str(tmp_path / "t"), "--metrics",
                                      str(tmp_path / "p.jsonl")])
    ref = _cli_json(jax_main, argv + ["--quiet", "--metrics",
                                      str(tmp_path / "j.jsonl")])
    assert out["kernel_path"] == ref["kernel_path"] == "sparse_xla_" + (
        "spall" if out["sparse_comm"] == "sparse" else "psum")
    for key in ("sparse_comm", "sparse_comm_cap", "sparse_m", "mesh", "iters",
                "representation"):
        assert out[key] == ref[key], key
    np.testing.assert_allclose(out["llh"], ref["llh"], rtol=1e-10)
    hist = [[json.loads(x)["llh"] for x in open(tmp_path / f"{w}.jsonl")]
            for w in "pj"]
    assert len(hist[0]) == len(hist[1]) == 6
    np.testing.assert_allclose(hist[0], hist[1], rtol=1e-10)
    np.testing.assert_allclose(hist[0], out["llh_history"], rtol=0)
    n_events, problems = validate_events_file(str(tmp_path / "t" / "events.jsonl"))
    assert n_events and not problems
    events = [json.loads(x) for x in open(tmp_path / "t" / "events.jsonl")]
    comm = [e for e in events if e["kind"] == "sparse_comm"]
    assert comm and comm[-1]["comm_cap"] == out["sparse_comm_cap"]
    assert comm[-1]["comm_mode"] == out["sparse_comm"]


def test_cli_sweep_sparse_mesh_chooses_jax_k(edge_file):
    argv = ["sweep", "--graph", edge_file, "--min-com", "4", "--max-com", "12",
            "--div-com", "3", "--max-iters", "4", "--dtype", "float64",
            "--representation", "sparse", "--sparse-m", "4", "--mesh", "2,1"]
    out = _cli_json(cli.main, argv + ["--device", "cpu"])
    ref = _cli_json(jax_main, argv + ["--quiet"])
    assert out["chosen_k"] == ref["chosen_k"] and out["kset"] == ref["kset"]
    for k, v in ref["llh_by_k"].items():
        np.testing.assert_allclose(out["llh_by_k"][k], v, rtol=1e-10)


def test_cli_preflight_prices_a_sparse_mesh(capsys, edge_file):
    """The old refusal case (`--mesh 2,1 --representation sparse`) is
    priced; the comms sites and payloads are the JAX preflight's."""
    argv = ["preflight", "--graph", edge_file, "--nodes", "1000", "--edges",
            "5000", "--k", "128",
            "--mesh", "2,1", "--representation", "sparse", "--sparse-m", "4",
            "--json", "--health-every", "0"]
    assert cli.main(argv) == 0
    p = json.loads(capsys.readouterr().out)
    assert jax_main(argv) == 0
    ref = json.loads(capsys.readouterr().out)
    for key in ("n", "directed_edges", "k", "representation", "sparse_m",
                "mesh", "schedule"):
        assert p["workload"][key] == ref["workload"][key], key
    assert p["workload"]["kernel_path"] == "sparse_merge_pallas_spall"
    assert p["device"]["model"] == "SparseShardedBigClamModel"
    n_pad = p["device"]["params"]["n_pad"]
    buffers = {b["buffer"]: b["bytes"] for b in p["device"]["buffers"]}
    assert buffers["transient/members_allgather"] == n_pad * 4 * 8
    jm = jcomms.sparse_step_model(n_pad, 4, 128, 2, 4, 16, 32, "sparse")
    pm = pcomms.sparse_step_model(n_pad, 4, 128, 2, 4, 16, 32, "sparse")
    assert p["comms_bytes_per_step"] == round(pm.bytes_per_step(), 1)
    assert [s.site for s in pm.sites] == [s.site for s in jm.sites]
    rc = cli.main(argv[:-2] + ["--schedule", "ring"])
    assert rc == 1 and "--schedule ring" in capsys.readouterr().err


# --------------------------------------------- checkpoints, health, models
def test_resume_is_bit_for_bit_and_refusals(planted, tmp_path):
    _, pg, F0 = planted
    cfg = _pcfg(_jcfg(max_iters=4, checkpoint_every=2))
    full = SparseShardedBigClamModel(pg, cfg, _pmesh(4)).fit(F0)
    ckpt = CheckpointManager(str(tmp_path / "a"))
    SparseShardedBigClamModel(pg, cfg.replace(max_iters=2), _pmesh(4)).fit(
        F0, checkpoints=ckpt)
    resumed = SparseShardedBigClamModel(pg, cfg, _pmesh(4)).fit(
        F0, checkpoints=ckpt)
    np.testing.assert_array_equal(resumed.F, full.F)
    assert resumed.llh_history == full.llh_history
    with pytest.raises(CheckpointMismatchError,
                       match="incompatible with this sparse run: node_shards=4"):
        SparseShardedBigClamModel(pg, cfg, _pmesh(2)).fit(F0, checkpoints=ckpt)
    dense = CheckpointManager(str(tmp_path / "d"))
    BigClamModel(pg, BigClamConfig(num_communities=256, max_iters=2,
                                   checkpoint_every=2), device="cpu").fit(
        F0, checkpoints=dense)
    with pytest.raises(ValueError, match="representation|member-id"):
        SparseShardedBigClamModel(pg, cfg, _pmesh(4)).fit(F0, checkpoints=dense)


@pytest.mark.parametrize("dp", [4, 8])
def test_health_extras_equal_jax(planted, dp):
    jg, pg, F0 = planted
    jm, pm = _pair(jg, pg, _jcfg(health_every=2), dp)
    sj, sp = jm.init_state(F0), pm.init_state(F0)
    idx = [dx.HEALTH_INDEX[k] for k in ("support_churn", "cap_occupancy",
                                       "dense_fallback", "exchanged_ids")]
    for _ in range(4):
        sj, sp = jm._step(sj), pm._step(sp)
        a, b = sp.health.numpy(), np.asarray(sj.health)
        np.testing.assert_array_equal(a[idx], b[idx])
        np.testing.assert_allclose(a, b, rtol=1e-5, equal_nan=True)
    assert (a[idx[1]] == dx.NA) == (dp == 4)           # NA in psum mode


@pytest.mark.parametrize("dp", [2, 3, 8])
def test_comms_model_sites_equal_jax_and_counted_bytes_reconcile(planted, dp):
    _, pg, F0 = planted
    m = SparseShardedBigClamModel(pg, _pcfg(_jcfg()), _pmesh(dp))
    state = m.init_state(F0)
    ref = jcomms.sparse_step_model(m.n_pad, m.m, m.k_pad, dp, 8, 16,
                                   m.comm_cap, m.comm_mode)
    assert [(s.site, s.op, s.payload_bytes, s.count) for s in m.comms.sites] == [
        (s.site, s.op, s.payload_bytes, s.count) for s in ref.sites]
    for _ in range(2):
        got = m.comms_measured(state)
        assert got["counted_sites"] == m.comms.site_bytes()
        jref = jcomms.sparse_measured(ref, state._replace(
            ids=jnp.asarray(_ids(state)), F=jnp.asarray(_w(state))))
        assert got["exchanged_ids"] == jref["exchanged_ids"]
        assert got["dense_fallback"] == jref["dense_fallback"]
        state = m._step(state)
    recon = m.memory_reconcile(state, emit=False)
    assert recon["drift_frac"] == 0.0


def test_foldin_on_the_mesh_equals_one_device(planted):
    _, pg, F0 = planted
    cfg = _pcfg(_jcfg(max_iters=2))
    one = SparseBigClamModel(pg, cfg, device="cpu")
    mesh = SparseShardedBigClamModel(pg, cfg, _pmesh(4))
    s1, _, _, _ = one.fit_state(one.init_state(F0))
    s4, _, _, _ = mesh.fit_state(mesh.init_state(F0))
    nodes = [0, 5, 300, 1023]
    for a, b in zip(one.foldin_rows(s1, nodes), mesh.foldin_rows(s4, nodes)):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)
    rows = np.random.default_rng(0).uniform(0, 1, (len(nodes), 256))
    c1, c4 = one.refit_commit(s1, nodes, rows), mesh.refit_commit(s4, nodes, rows)
    np.testing.assert_array_equal(one.extract_F(c1), mesh.extract_F(c4))
