"""The port's graph store (bigclam_tpu_torch/graph/stream.py and store.py)
held against the JAX package's: the streaming parse, caches that are byte
for byte the same from both packages (each opening the other's), the
refusals, self-heal, and edge deltas."""

import filecmp
import json
import os
import shutil
import warnings

import numpy as np
import pytest

from bigclam_tpu.graph import store as jstore
from bigclam_tpu.graph import stream as jstream
from bigclam_tpu.resilience import faults as jfaults
from bigclam_tpu_torch.graph import build_graph
from bigclam_tpu_torch.graph import store as tstore
from bigclam_tpu_torch.graph import stream as tstream
from bigclam_tpu_torch.resilience import faults as tfaults

def _write_edges(path, pairs, header=True):
    with open(path, "w") as f:
        if header:
            f.write("# synthetic\n# Nodes: ? Edges: ?\n\n")
        for u, v in np.asarray(pairs).tolist():
            f.write(f"{u} {v}\n")
    return str(path)


@pytest.fixture()
def messy_text(tmp_path):
    """Sparse raw ids, duplicate edges (both directions), self-loops (the
    fixture of tests/test_store.py)."""
    rng = np.random.default_rng(7)
    pairs = rng.integers(0, 300, size=(2000, 2)) * 11 + 5
    pairs = np.concatenate([pairs, pairs[:50, ::-1], pairs[:20]])
    loops = np.stack([pairs[:15, 0], pairs[:15, 0]], axis=1)
    pairs = np.concatenate([pairs, loops])
    return _write_edges(tmp_path / "g.txt", pairs)


def _assert_dirs_identical(a, b):
    """Every file of the two directories (subdirectories included) holds
    the same bytes."""
    def files(d):
        return sorted(
            os.path.relpath(os.path.join(r, f), d)
            for r, _, fs in os.walk(d) for f in fs
        )

    assert files(a) == files(b)
    for rel in files(a):
        assert filecmp.cmp(os.path.join(a, rel), os.path.join(b, rel),
                           shallow=False), rel


def _assert_graphs_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a.indptr), np.asarray(b.indptr))
    np.testing.assert_array_equal(np.asarray(a.indices), np.asarray(b.indices))
    np.testing.assert_array_equal(np.asarray(a.raw_ids), np.asarray(b.raw_ids))


def _port_msg(text: str) -> str:
    """A port message with the JAX CLI's module name, for comparison."""
    return text.replace("bigclam_tpu_torch.cli", "bigclam_tpu.cli")


# --------------------------------------------------------- streaming parse
@pytest.mark.parametrize("chunk", [17, 256, 4096, 1 << 20])
def test_byte_ranges_and_chunks_match_jax(messy_text, chunk):
    assert tstream.byte_ranges(messy_text, chunk) == jstream.byte_ranges(
        messy_text, chunk)
    ours = list(tstream.stream_edge_list(messy_text, chunk))
    ref = list(jstream.stream_edge_list(messy_text, chunk))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_parse_bytes_matches_jax(messy_text):
    data = open(messy_text, "rb").read()
    np.testing.assert_array_equal(tstream.parse_bytes(data),
                                  jstream.parse_bytes(data))
    assert tstream.parse_bytes(b"# only\n\n").shape == (0, 2)
    for bad in (b"1 2\n3\n", b"1 2 3\n"):
        with pytest.raises(ValueError) as ours:
            tstream.parse_bytes(bad, "x")
        with pytest.raises(ValueError) as ref:
            jstream.parse_bytes(bad, "x")
        assert str(ours.value) == str(ref.value)


def test_ingest_parses_with_the_stream_module():
    from bigclam_tpu_torch.graph import ingest

    assert ingest.parse_bytes is tstream.parse_bytes


def test_stream_workers_match_in_process_and_jax(messy_text):
    ref = jstream.load_edge_list_streaming(messy_text, chunk_bytes=300)
    np.testing.assert_array_equal(
        tstream.load_edge_list_streaming(messy_text, chunk_bytes=300), ref)
    np.testing.assert_array_equal(
        tstream.load_edge_list_streaming(messy_text, chunk_bytes=300,
                                         workers=2), ref)


def test_bounded_blob_cache_and_scan_edge_files(tmp_path):
    for i in range(3):
        np.save(tmp_path / f"b{i}.npy", np.arange(i + 1))
    cache = tstream.BoundedBlobCache(capacity=2)
    for i in (0, 1, 2, 0):
        np.testing.assert_array_equal(cache.get(str(tmp_path / f"b{i}.npy")),
                                      np.arange(i + 1))
    assert len(cache._cache) == 2
    for name in ("d2.txt", "d1.txt", ".hidden", "d3.txt.tmp", "d4.part"):
        (tmp_path / name).write_text("1 2\n")
    seen = [str(tmp_path / "d1.txt")]
    assert tstream.scan_edge_files(str(tmp_path), seen) == \
        jstream.scan_edge_files(str(tmp_path), seen)


# ------------------------------------------------- caches byte for byte
@pytest.mark.parametrize("closure", [True, False], ids=["closure", "noclosure"])
@pytest.mark.parametrize("seed_cap", [None, 2], ids=["exact", "cap2"])
@pytest.mark.parametrize("balance", [False, True], ids=["plain", "balanced"])
@pytest.mark.parametrize("chunk", [500, 1 << 20])
@pytest.mark.parametrize("shards", [1, 3, 8])
def test_both_packages_write_the_same_cache(messy_text, tmp_path, shards, chunk,
                                            balance, seed_cap, closure):
    kw = dict(num_shards=shards, chunk_bytes=chunk, balance=balance,
              seed_cap=seed_cap, seed=3, closure_bake=closure)
    a = tstore.compile_graph_cache(messy_text, str(tmp_path / "port"), **kw)
    b = jstore.compile_graph_cache(messy_text, str(tmp_path / "jax"), **kw)
    _assert_dirs_identical(a.directory, b.directory)
    # each package opens the other's cache to its own arrays
    for mine, other in ((tstore, b.directory), (jstore, a.directory)):
        own = a if mine is tstore else b
        got = mine.GraphStore.open(other)
        _assert_graphs_equal(got.load_graph(), own.load_graph())
        s1, s2 = got.load_seed_scores(), own.load_seed_scores()
        np.testing.assert_array_equal(s1.phi, s2.phi)
        assert (s1.cap, s1.seed) == (s2.cap, s2.seed) == (seed_cap, 3)
        if closure:
            c1, c2 = got.load_closure_lists(), own.load_closure_lists()
            assert c1.cap == c2.cap and sorted(c1.shards) == sorted(c2.shards)
            for s, sc in c1.shards.items():
                for x, y in zip(sc.out_ids + sc.in_ids,
                                c2.shards[s].out_ids + c2.shards[s].in_ids):
                    np.testing.assert_array_equal(x, y)
                assert sc.edge_counts == c2.shards[s].edge_counts
        if balance:
            np.testing.assert_array_equal(got.load_perm(), own.load_perm())
    if not balance:
        _assert_graphs_equal(build_graph(a.directory), build_graph(messy_text))


# ------------------------------------------------------------ refusals
def _corrupt(path):
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) - 3)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))


@pytest.mark.parametrize("case", ["overwrite", "stale", "checksum", "missing"])
def test_refusals_match_jax(messy_text, tmp_path, case):
    def attempt(mod, root):
        cache = str(tmp_path / root)
        if case == "missing":
            os.makedirs(cache)
            return lambda: mod.GraphStore.open(cache)
        store = mod.compile_graph_cache(messy_text, cache, num_shards=4)
        if case == "overwrite":
            return lambda: mod.compile_graph_cache(messy_text, cache,
                                                   num_shards=4)
        if case == "stale":
            mpath = os.path.join(cache, mod.MANIFEST_NAME)
            manifest = json.load(open(mpath))
            manifest["format_version"] = mod.MANIFEST_VERSION + 1
            json.dump(manifest, open(mpath, "w"))
            return lambda: mod.GraphStore.open(cache)
        _corrupt(store.shard_files(1)[1])
        return lambda: mod.GraphStore.open(cache).load_graph()

    errors = []
    for mod, root in ((tstore, "c"), (jstore, "c_jax")):
        fn = attempt(mod, root)
        with pytest.raises((ValueError, FileExistsError)) as e:
            fn()
        errors.append((type(e.value).__name__,
                       _port_msg(str(e.value)).replace("c_jax", "c")))
    assert errors[0] == errors[1]
    if case == "checksum":
        assert errors[0][0] == "ShardCorruption"


# ------------------------------------------------------------ self-heal
def _copies(tmp_path, text, n=2, **kw):
    base = jstore.compile_graph_cache(text, str(tmp_path / "base"), **kw)
    out = []
    for i in range(n):
        d = str(tmp_path / f"copy{i}")
        shutil.copytree(base.directory, d)
        out.append(d)
    return out


def test_self_heal_rebuild_matches_jax(messy_text, tmp_path):
    """corrupt_shard on shard 1 through each package's fault plan, then a
    self-healing load: the quarantined blob, the rebuilt blobs, the
    re-stamped manifest (phi and closure crcs kept) are the same bytes."""
    port_dir, jax_dir = _copies(tmp_path, messy_text, num_shards=4)
    spec = {"seed": 0, "faults": [{"kind": "corrupt_shard",
                                   "site": "store.load_shard", "shard": 1}]}
    before = json.load(open(os.path.join(port_dir, "manifest.json")))
    for mod, faults, d in ((tstore, tfaults, port_dir),
                           (jstore, jfaults, jax_dir)):
        faults.install_plan(faults.FaultPlan.from_spec(spec))
        try:
            g = mod.GraphStore.open(d, self_heal=True).load_graph()
        finally:
            faults.install_plan(None)
        _assert_graphs_equal(g, build_graph(messy_text))
    assert os.listdir(os.path.join(port_dir, "quarantine"))
    _assert_dirs_identical(port_dir, jax_dir)
    after = json.load(open(os.path.join(port_dir, "manifest.json")))
    for key in ("phi", "closure"):
        assert after["shards"][1]["crc32"][key] == \
            before["shards"][1]["crc32"][key]


def test_without_healing_a_corrupt_shard_raises(messy_text, tmp_path):
    (d,) = _copies(tmp_path, messy_text, n=1, num_shards=4)
    spec = {"seed": 0, "faults": [{"kind": "corrupt_shard",
                                   "site": "store.load_shard", "shard": 1}]}
    tfaults.install_plan(tfaults.FaultPlan.from_spec(spec))
    try:
        with pytest.raises(tstore.ShardCorruption, match="checksum") as e:
            tstore.GraphStore.open(d).load_graph()
    finally:
        tfaults.install_plan(None)
    assert e.value.shard == 1


def test_quarantine_and_rebuild_matches_jax(messy_text, tmp_path):
    port_dir, jax_dir = _copies(tmp_path, messy_text, num_shards=3,
                                balance=True)
    for mod, d in ((tstore, port_dir), (jstore, jax_dir)):
        _corrupt(os.path.join(d, "shard_00002.indices.npy"))
        mod.GraphStore.open(d).quarantine_and_rebuild(2, reason="test")
    _assert_dirs_identical(port_dir, jax_dir)
    tstore.GraphStore.open(port_dir).load_graph()   # crcs valid again


# ---------------------------------------------------------------- deltas
N = 200
SHARDS = 4


def _base_edges(n=N, extra=500, seed=0):
    """Ring (every id present => internal row == raw id) + random (the
    fixture of tests/test_delta.py)."""
    rng = np.random.default_rng(seed)
    edges = [(i, (i + 1) % n) for i in range(n)]
    edges += [(int(u), int(v)) for u, v in rng.integers(0, n, (extra, 2))
              if u != v]
    return edges


def _delta_edges(lo=0, hi=50, stride=2, shift=9):
    return [
        (i, lo + (i + shift - lo) % (hi - lo))
        for i in range(lo, hi, stride)
        if i != lo + (i + shift - lo) % (hi - lo)
    ]


@pytest.fixture()
def delta_world(tmp_path):
    text = _write_edges(tmp_path / "g.txt", _base_edges(), header=False)
    port_dir, jax_dir = _copies(tmp_path, text, num_shards=SHARDS)
    return text, port_dir, jax_dir


@pytest.mark.parametrize("edges", ["one_shard", "spread"])
def test_apply_delta_matches_jax(tmp_path, delta_world, edges):
    text, port_dir, jax_dir = delta_world
    pairs = _delta_edges() if edges == "one_shard" else \
        _delta_edges() + _delta_edges(lo=100, hi=190, stride=5, shift=31)
    delta = _write_edges(tmp_path / "delta.txt", pairs, header=False)
    ours = tstore.GraphStore.open(port_dir).apply_delta(delta)
    ref = jstore.GraphStore.open(jax_dir).apply_delta(delta)
    _assert_dirs_identical(port_dir, jax_dir)
    np.testing.assert_array_equal(ours.pop("touched_rows"),
                                  ref.pop("touched_rows"))
    ours.pop("seconds"), ref.pop("seconds")
    assert ours == ref
    # the delta cache equals a fresh ingest of text + delta
    combined = str(tmp_path / "combined.txt")
    with open(combined, "w") as f:
        f.write(open(text).read() + open(delta).read())
    _assert_graphs_equal(tstore.GraphStore.open(port_dir).load_graph(),
                         build_graph(combined))


def test_apply_delta_refuses_new_nodes(tmp_path, delta_world):
    _, port_dir, jax_dir = delta_world
    delta = _write_edges(tmp_path / "delta.txt", [(0, N + 7)], header=False)
    msgs = []
    for mod, d in ((tstore, port_dir), (jstore, jax_dir)):
        store = mod.GraphStore.open(d)
        with pytest.raises(ValueError, match="cannot grow N") as e:
            store.apply_delta(delta)
        assert store.delta_seq == 0
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_empty_delta_does_nothing(tmp_path, delta_world):
    _, port_dir, _ = delta_world
    delta = str(tmp_path / "empty.txt")
    open(delta, "w").write("# nothing\n3 3\n")
    before = open(os.path.join(port_dir, "manifest.json")).read()
    info = tstore.GraphStore.open(port_dir).apply_delta(delta)
    assert info["edges_added"] == 0 and info["delta_seq"] == 0
    assert info["touched_shards"] == []
    assert open(os.path.join(port_dir, "manifest.json")).read() == before


def test_changed_delta_is_refused_on_rebuild(tmp_path, delta_world):
    _, port_dir, _ = delta_world
    delta = _write_edges(tmp_path / "delta.txt", _delta_edges(), header=False)
    store = tstore.GraphStore.open(port_dir)
    store.apply_delta(delta)
    _write_edges(delta, _delta_edges() + [(3, 17)], header=False)
    with pytest.raises(tstore.ShardCorruption, match="delta file changed"):
        tstore.GraphStore.open(port_dir).rebuild_shard(0)


def test_quarantine_rebuild_replays_deltas(tmp_path, delta_world):
    _, port_dir, _ = delta_world
    delta = _write_edges(tmp_path / "delta.txt", _delta_edges(), header=False)
    tstore.GraphStore.open(port_dir).apply_delta(delta)
    good = tstore.GraphStore.open(port_dir).load_graph()
    _corrupt(os.path.join(port_dir, "shard_00000.indices.npy"))
    healed = tstore.GraphStore.open(port_dir, self_heal=True).load_graph()
    _assert_graphs_equal(healed, good)


# ------------------------------------------------------ the mmap upload
def test_mmap_cache_uploads_through_a_writable_copy(messy_text, tmp_path):
    store = tstore.compile_graph_cache(messy_text, str(tmp_path / "c"),
                                       num_shards=1)
    g = store.load_graph(mmap=True)
    assert not g.indices.flags.writeable        # the memmap itself
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        csr = g.to_device("cpu")
    assert np.shares_memory(csr.indices.numpy(), g.indices) is False
    np.testing.assert_array_equal(csr.indices.numpy(), g.indices)
