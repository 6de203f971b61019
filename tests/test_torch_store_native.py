"""The port's cache-fed CLI and store-native trainers against the JAX
package: `cli ingest`, `fit` and `sweep` on a cache directory or with
--cache-dir, `--seed-backend baked`, `preflight` on a cache, and
StoreShardedBigClamModel / StoreRingBigClamModel on a 4-shard CPU mesh,
bit for bit the in-memory trainers on the same layout."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from bigclam_tpu.cli import main as jax_main
from bigclam_tpu_torch import cli
from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph import build_graph
from bigclam_tpu_torch.graph.store import GraphStore, compile_graph_cache
from bigclam_tpu_torch.models import agm
from bigclam_tpu_torch.models.bigclam import rowkeyed_init_F
from bigclam_tpu_torch.parallel import (
    RingBigClamModel,
    ShardedBigClamModel,
    StoreRingBigClamModel,
    StoreShardedBigClamModel,
    make_mesh,
)

DP = 4
CPU4 = ["cpu"] * DP


@pytest.fixture(scope="module")
def text(tmp_path_factory):
    """A planted graph as a SNAP edge list with sparse raw ids (so the
    cache's remap is exercised) and node count 181: not a multiple of 4,
    so the last shard is short."""
    g, _ = agm.sample_planted_graph(181, 6, p_in=0.3,
                                    rng=np.random.default_rng(15))
    keep = g.src < g.dst
    path = tmp_path_factory.mktemp("graph") / "g.txt"
    np.savetxt(path, np.stack([g.src[keep], g.dst[keep]], axis=1) * 3 + 7,
               fmt="%d", header="planted", comments="# ")
    return str(path)


@pytest.fixture(scope="module")
def caches(text, tmp_path_factory):
    """{balanced: a 4-shard cache of the text}."""
    root = tmp_path_factory.mktemp("caches")
    return {
        bal: compile_graph_cache(text, str(root / f"c{int(bal)}"),
                                 num_shards=DP, balance=bal)
        for bal in (False, True)
    }


def _run(main, argv):
    """(exit code, parsed last stdout JSON or None, stderr text)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            return e.code, None, err.getvalue()
    lines = out.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None, err.getvalue()


def _jax_history(err: str) -> list:
    """The JAX CLI logs one JSON line per iteration on stderr."""
    return [json.loads(ln)["llh"] for ln in err.splitlines()
            if ln.startswith("{") and '"iter"' in ln]


# ------------------------------------------------------------------ ingest
@pytest.mark.parametrize("flags", [[], ["--balance", "--seed-cap", "2"]],
                         ids=["plain", "balanced_capped"])
def test_ingest_prints_the_jax_keys(text, tmp_path, flags):
    argv = ["ingest", "--graph", text, "--shards", "3", *flags]
    rc, ours, _ = _run(cli.main, argv + ["--cache-dir", str(tmp_path / "p")])
    rcj, ref, _ = _run(jax_main, argv + ["--cache-dir", str(tmp_path / "j")])
    assert rc == rcj == 0
    assert set(ref) <= set(ours)
    for key in ("n", "edges", "shards", "balanced", "seed_baked",
                "closure_baked", "chunk_bytes"):
        assert ours[key] == ref[key], key
    assert set(ours["seconds"]) == {"scan", "scatter", "dedup", "shards",
                                    "seed_bake", "closure_bake"}
    # a second full ingest refuses without --overwrite, as the JAX one
    rc, _, err = _run(cli.main, argv + ["--cache-dir", str(tmp_path / "p")])
    assert rc == 1 and "already compiled" in err


def test_ingest_delta_prints_the_jax_keys(text, tmp_path):
    for d in ("p", "j"):
        compile_graph_cache(text, str(tmp_path / d), num_shards=DP)
    delta = tmp_path / "delta.txt"
    delta.write_text("7 163\n10 400\n13 31\n")      # existing raw ids
    rc, ours, _ = _run(cli.main, ["ingest", "--cache-dir", str(tmp_path / "p"),
                                  "--delta", str(delta)])
    rcj, ref, _ = _run(jax_main, ["ingest", "--cache-dir", str(tmp_path / "j"),
                                  "--delta", str(delta)])
    assert rc == rcj == 0 and set(ref) <= set(ours)
    for key in ("delta_seq", "edges_added", "edges", "touched_shards",
                "touched_rows", "touched_frac", "phi_rebaked_shards",
                "files_read"):
        assert ours[key] == ref[key], key
    rc, _, err = _run(cli.main, ["ingest", "--cache-dir", str(tmp_path / "x"),
                                 "--delta", str(delta)])
    assert rc == 1 and "needs an existing compiled cache" in err


# -------------------------------------------------------------- cache fits
FIT = ["fit", "--k", "5", "--max-iters", "3", "--dtype", "float64"]


@pytest.mark.parametrize("source", ["cache_as_graph", "cache_dir"])
def test_cache_fed_fit_matches_the_jax_cli(text, caches, tmp_path, source):
    if source == "cache_as_graph":
        ours_args = ref_args = ["--graph", caches[False].directory]
    else:
        ours_args = ["--graph", text, "--cache-dir", str(tmp_path / "p")]
        ref_args = ["--graph", text, "--cache-dir", str(tmp_path / "j")]
    rc, ours, err = _run(cli.main, FIT + ours_args + ["--device", "cpu"])
    rcj, ref, jerr = _run(jax_main, FIT + ref_args + ["--csr-kernels", "off"])
    assert rc == rcj == 0
    assert "using ingest-baked seed scores" in err
    assert "using ingest-baked seed scores" in jerr
    ref_hist = _jax_history(jerr)
    assert len(ours["llh_history"]) == len(ref_hist) == 4
    np.testing.assert_allclose(ours["llh_history"], ref_hist, rtol=1e-9)
    assert (ours["n"], ours["edges"]) == (ref["n"], ref["edges"])
    if source == "cache_dir":
        # compiled once, reloaded after: the same bytes as ingest, and the
        # same fit
        assert "compiling graph cache" in err
        rc, again, err = _run(cli.main, FIT + ours_args + ["--device", "cpu"])
        assert rc == 0 and "compiling" not in err
        assert again["llh_history"] == ours["llh_history"]


def test_cache_fit_equals_the_text_fit(text, caches):
    """The baked exact phi is the host conductance pass, and an unbalanced
    cache's graph is build_graph's: the same float64 history bit for bit."""
    _, on_cache, _ = _run(cli.main, FIT + ["--graph", caches[False].directory,
                                           "--device", "cpu"])
    _, on_text, _ = _run(cli.main, FIT + ["--graph", text, "--device", "cpu"])
    assert on_cache["llh_history"] == on_text["llh_history"]


def test_seed_backend_baked_match_mismatch_and_auto(text, tmp_path):
    capped = compile_graph_cache(text, str(tmp_path / "capped"),
                                 num_shards=2, seed_cap=2)
    base = FIT + ["--graph", capped.directory, "--device", "cpu"]
    # a match: the cap and seed the bake used
    rc, out, err = _run(cli.main, base + ["--seed-backend", "baked",
                                          "--seeding-degree-cap", "2"])
    assert rc == 0 and "using ingest-baked seed scores" in err
    # a mismatch under baked exits naming cap and seed, as the JAX CLI
    rc, _, err = _run(cli.main, base + ["--seed-backend", "baked"])
    rcj, _, jerr = _run(jax_main, [a for a in base if a not in ("--device", "cpu")]
                        + ["--seed-backend", "baked"])
    assert "cap=2" in str(rc) and "seed=0" in str(rc)
    assert str(rc) == str(rcj)
    # auto falls back to scoring the graph, with the note
    rc, auto, err = _run(cli.main, base)
    assert rc == 0 and "falling back to the streaming conductance pass" in err
    _, on_text, _ = _run(cli.main, FIT + ["--graph", text, "--device", "cpu"])
    assert auto["llh_history"] == on_text["llh_history"]
    # a cache baked without scores: baked exits with the re-ingest hint
    bare = compile_graph_cache(text, str(tmp_path / "bare"), num_shards=2,
                               seed_bake=False)
    rc, _, _ = _run(cli.main, FIT + ["--graph", bare.directory, "--device",
                                     "cpu", "--seed-backend", "baked"])
    assert "no baked seed scores" in str(rc)


def test_sweep_on_a_cache(text, caches):
    argv = ["sweep", "--min-com", "2", "--max-com", "4", "--div-com", "2",
            "--max-iters", "2", "--dtype", "float64", "--device", "cpu"]
    rc, on_cache, err = _run(cli.main, argv + ["--graph", caches[False].directory])
    assert rc == 0 and "using ingest-baked seed scores" in err
    _, on_text, _ = _run(cli.main, argv + ["--graph", text])
    assert on_cache == on_text


def test_preflight_on_a_cache(caches):
    store = caches[False]
    base = ["preflight", "--graph", store.directory, "--k", "16", "--json"]
    rc, one, _ = _run(cli.main, base)
    assert rc == 0
    assert one["workload"]["n"] == store.num_nodes
    assert one["workload"]["directed_edges"] == store.num_directed_edges
    assert one["workload"]["shard_counts_known"]
    rc, sn, _ = _run(cli.main, base + ["--mesh", "4,1", "--store-native",
                                       "--schedule", "ring"])
    assert rc == 0 and sn["workload"]["store_native"] is True
    stages = {s["stage"] for s in sn["host"]["stages"]}
    assert "shard_load" in stages and "graph_load" not in stages
    rc, ag, _ = _run(cli.main, base + ["--mesh", "4,1"])
    assert rc == 0 and ag["workload"]["store_native"] is False
    # the JAX preflight reads the same manifest numbers
    rcj, ref, _ = _run(jax_main, base)
    assert ref["workload"]["n"] == one["workload"]["n"]
    assert ref["workload"]["directed_edges"] == one["workload"]["directed_edges"]
    # the 2D partition, refused before its trainer landed, is priced from
    # the manifest's baked closure pair counts (no coupon-collector note)
    rc, tw, _ = _run(cli.main, base + ["--partition", "2d", "--mesh", "4,1"])
    assert rc == 0 and tw["workload"]["partition"] == "2d"
    assert not any("coupon-collector" in n for n in tw["notes"])
    rc, _, err = _run(cli.main, base + ["--store-native"])
    assert rc == 1 and "error:" in err
    # --serve prices a serving fleet on the manifest's numbers, as JAX's
    rc, sv, _ = _run(cli.main, base + ["--serve"])
    rcj, ref, _ = _run(jax_main, base + ["--serve"])
    assert rc == rcj == 0 and sv == ref
    assert sv["workload"]["directed_edges"] == store.num_directed_edges


# ------------------------------------------------------- store trainers
def _cfg(**kw):
    return BigClamConfig(num_communities=5, max_iters=4, conv_tol=0.0,
                         dtype="float64", seed=2, **kw)


@pytest.mark.parametrize("balanced", [False, True], ids=["plain", "balanced"])
@pytest.mark.parametrize("schedule", ["allgather", "ring"])
def test_store_trainers_bit_identical_to_in_memory(text, caches, schedule,
                                                   balanced):
    store = GraphStore.open(caches[balanced].directory)
    mesh = make_mesh((DP, 1), CPU4)
    mem_cls, store_cls = (
        (RingBigClamModel, StoreRingBigClamModel) if schedule == "ring"
        else (ShardedBigClamModel, StoreShardedBigClamModel))
    F0c = np.random.default_rng(3).random((store.num_nodes, 5))
    if balanced:
        # the in-memory build relabels the text graph by the same
        # permutation the cache baked: F0 maps to original ids
        perm = store.load_perm()
        mem = mem_cls(build_graph(text), _cfg(), mesh, balance=True)
        np.testing.assert_array_equal(mem._perm, perm)
        F0 = F0c[perm]
    else:
        mem = mem_cls(store.load_graph(), _cfg(), mesh, balance=False)
        F0 = F0c
    model = store_cls(store, _cfg(), mesh)
    a, b = mem.fit(F0), model.fit(F0c)
    assert a.llh_history == b.llh_history and len(a.llh_history) == 5
    np.testing.assert_array_equal(a.F, b.F[perm] if balanced else b.F)
    if schedule == "ring":
        for row_m, row_s in zip(mem.buckets, model.buckets):
            for bm, bs in zip(row_m, row_s):
                for x, y in zip(bm, bs):
                    assert (x is None and y is None) or torch.equal(x, y)


@pytest.mark.parametrize("schedule", ["allgather", "ring"])
def test_store_trainers_match_the_jax_store_trainers(caches, schedule):
    """At 1e-10 against the JAX package's StoreSharded/StoreRing models on
    the same cache (both float64 on the CPU)."""
    import jax

    from bigclam_tpu.config import BigClamConfig as JaxConfig
    from bigclam_tpu.graph.store import GraphStore as JaxStore
    from bigclam_tpu.parallel import (
        StoreRingBigClamModel as JaxStoreRing,
        StoreShardedBigClamModel as JaxStoreSharded,
        make_mesh as jax_make_mesh,
    )

    d = caches[False].directory
    F0 = np.random.default_rng(4).random((caches[False].num_nodes, 5))
    ours_cls = StoreRingBigClamModel if schedule == "ring" else StoreShardedBigClamModel
    ref_cls = JaxStoreRing if schedule == "ring" else JaxStoreSharded
    ours = ours_cls(GraphStore.open(d), _cfg(), make_mesh((DP, 1), CPU4)).fit(F0)
    ref = ref_cls(
        JaxStore.open(d),
        JaxConfig(num_communities=5, max_iters=4, conv_tol=0.0,
                  dtype="float64", seed=2, use_pallas_csr=False),
        jax_make_mesh((DP, 1), jax.devices()[:DP]),
    ).fit(F0)
    np.testing.assert_allclose(ours.llh_history, ref.llh_history, rtol=1e-10)
    np.testing.assert_allclose(ours.F, np.asarray(ref.F), rtol=1e-10,
                               atol=1e-12)


@pytest.mark.parametrize("cls", [StoreShardedBigClamModel, StoreRingBigClamModel])
def test_each_position_reads_only_its_shard(caches, cls):
    store = GraphStore.open(caches[True].directory)
    model = cls(store, _cfg(), make_mesh((DP, 1), CPU4))
    assert model.files_read == [
        (f"shard_{s:05d}.indptr.npy", f"shard_{s:05d}.indices.npy")
        for s in range(DP)
    ]
    with pytest.raises(AttributeError, match="no global CSR"):
        model.g.src
    assert model.g.num_nodes == store.num_nodes


def test_shard_count_refusal_matches_jax(caches):
    import jax

    from bigclam_tpu.config import BigClamConfig as JaxConfig
    from bigclam_tpu.graph.store import GraphStore as JaxStore
    from bigclam_tpu.parallel import StoreShardedBigClamModel as JaxStoreSharded
    from bigclam_tpu.parallel import make_mesh as jax_make_mesh

    d = caches[False].directory
    with pytest.raises(ValueError) as ours:
        StoreShardedBigClamModel(GraphStore.open(d), _cfg(),
                                 make_mesh((2, 1), ["cpu"] * 2))
    with pytest.raises(ValueError) as ref:
        JaxStoreSharded(JaxStore.open(d), JaxConfig(num_communities=5),
                        jax_make_mesh((2, 1), jax.devices()[:2]))
    assert str(ours.value) == str(ref.value)
    assert "--shards 2" in str(ours.value)


@pytest.mark.parametrize("cls", [StoreShardedBigClamModel, StoreRingBigClamModel])
def test_per_position_rowkeyed_init(caches, cls):
    store = GraphStore.open(caches[False].directory)
    cfg = _cfg()
    model = cls(store, cfg, make_mesh((DP, 1), CPU4))
    F = model.extract_F(model.init_state(None))
    np.testing.assert_array_equal(F, rowkeyed_init_F(model.g, cfg))
    mem = ShardedBigClamModel(store.load_graph(), cfg, make_mesh((DP, 1), CPU4))
    for x, y in zip(model.init_state(None).F, mem.init_state(None).F):
        assert torch.equal(x, y)


@pytest.mark.parametrize("schedule", ["allgather", "ring"])
def test_cli_store_native_equals_the_in_memory_mesh(caches, schedule):
    argv = FIT + ["--graph", caches[False].directory, "--device", "cpu",
                  "--mesh", "4,1", "--schedule", schedule]
    rc, native, _ = _run(cli.main, argv + ["--store-native"])
    rc2, mem, _ = _run(cli.main, argv)
    assert rc == rc2 == 0
    assert native["llh_history"] == mem["llh_history"]
    assert native["kernel_path"] == mem["kernel_path"] == "xla"


@pytest.mark.parametrize("case", ["balance", "no_mesh", "text", "sparse"])
def test_cli_store_native_refusals(text, caches, case):
    argv = FIT + ["--device", "cpu", "--store-native"]
    graph = ["--graph", caches[False].directory]
    argv += {
        "balance": graph + ["--mesh", "4,1", "--balance"],
        "no_mesh": graph,
        "text": ["--graph", text, "--mesh", "4,1"],
        "sparse": graph + ["--mesh", "4,1", "--representation", "sparse"],
    }[case]
    rc, _, _ = _run(cli.main, argv)
    assert str(rc).startswith("error: --store-native")
    if case == "balance":
        rcj, _, _ = _run(jax_main, [a for a in argv if a not in ("--device", "cpu")])
        assert str(rc) == str(rcj)
