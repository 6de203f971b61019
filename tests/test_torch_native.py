"""The port's native host library (bigclam_tpu_torch/graph/native) against
the JAX package's (bigclam_tpu/graph/native) and against the port's numpy
paths: the parser on the grammar cases of tests/test_native.py, exact and
capped triangle counts and the covering walk on a planted graph with hub
nodes of degree 100 and 700; and two processes that build the library
into one empty directory at once. Skips only where no C++ compiler is
installed."""

import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from bigclam_tpu.graph import native as jnat
from bigclam_tpu.graph.ingest import graph_from_edges as jax_graph_from_edges
from bigclam_tpu.models.agm import sample_planted_graph as jax_planted

from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph import native
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.graph.ingest import parse_bytes
from bigclam_tpu_torch.ops import seeding

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def compiler():
    if not (os.environ.get("CXX") or shutil.which("g++")):
        pytest.skip("no C++ compiler: the native library cannot build here")


def hub_graph(n=800, blocks=40, degrees=(100, 700), isolated=5, seed=5):
    """(JAX graph, port graph): planted blocks plus hubs 0 and 1 joined to
    `degrees` random nodes, plus isolated nodes (chip_smoke.py's hub
    graph)."""
    rng = np.random.default_rng(seed)
    g0, _ = jax_planted(n, blocks, p_in=0.3, rng=rng)
    pairs = [np.stack([g0.src, g0.dst], axis=1)]
    for hub, deg in enumerate(degrees):
        nbrs = rng.choice(np.setdiff1d(np.arange(n), [hub]), deg, replace=False)
        pairs.append(np.stack([np.full(deg, hub), nbrs], axis=1))
    gj = jax_graph_from_edges(np.concatenate(pairs), num_nodes=n + isolated)
    return gj, Graph(gj.indptr, gj.indices, gj.raw_ids)


@pytest.fixture(scope="module")
def hub():
    return hub_graph()


def test_library_loads_and_says_so():
    st = native.status()
    assert st["loaded"], st
    assert st["reason"] is None
    assert Path(st["path"]).parent == native.BUILD_DIR
    assert Path(st["path"]) == native.library_path()


GRAMMAR = {
    "comments_tabs_blanks": "# header\n# another\n0 1\n1\t2\n  3   4\n\n5 6\n",
    "indented_comment_crlf": "10\t20\r\n  # note\r\n-3 +7\r\n",
    "comments_only": "# nothing\n",
    "empty": "",
}


@pytest.mark.parametrize("case", sorted(GRAMMAR))
def test_parser_matches_jax_native_and_parse_bytes(tmp_path, case):
    p = tmp_path / "g.txt"
    p.write_text(GRAMMAR[case])
    got = native.parse_edge_list(str(p))
    np.testing.assert_array_equal(got, jnat.parse_edge_list(str(p)))
    np.testing.assert_array_equal(got, parse_bytes(p.read_bytes()))
    assert got.dtype == np.int64 and got.shape[1] == 2


@pytest.mark.parametrize("text", ["0 1\n2\n", "0 1\n2 x\n", "0 1 # tail\n"])
def test_parser_refuses_malformed_as_both_paths_do(tmp_path, text):
    p = tmp_path / "bad.txt"
    p.write_text(text)
    with pytest.raises(ValueError, match="even number"):
        native.parse_edge_list(str(p))
    with pytest.raises(ValueError):
        jnat.parse_edge_list(str(p))
    with pytest.raises(ValueError):
        parse_bytes(p.read_bytes())


def test_parser_missing_file():
    with pytest.raises(OSError):
        native.parse_edge_list("/nonexistent/file.txt")


def test_exact_triangle_counts_bit_for_bit(hub):
    gj, gp = hub
    got = native.triangle_counts(gp)
    np.testing.assert_array_equal(got, jnat.triangle_counts(gj))
    np.testing.assert_array_equal(got, seeding.triangle_counts_numpy(gp))
    assert got.dtype == np.int64 and got[1] > 0


@pytest.mark.parametrize("cap", [16, 100, 1000])
def test_capped_counts_match_jax_native_and_numpy(hub, cap):
    """Bit for bit against the JAX library (the same C++); against the
    port's numpy estimator on the same sampled lists, bit for bit where
    the cap binds nowhere (every weight 1) and at rtol 1e-9 where it binds
    (the same hits, summed in another order)."""
    gj, gp = hub
    seed = 0x5EED + cap
    got = native.triangle_counts_capped(gp, cap, seed=seed)
    np.testing.assert_array_equal(got, jnat.triangle_counts_capped(gj, cap, seed=seed))
    rng_seed = int(np.random.default_rng(cap).integers(2**63))
    plain = seeding.triangle_counts_sampled(
        gp, cap, np.random.default_rng(cap), use_native=False
    )
    ours = native.triangle_counts_capped(gp, cap, seed=rng_seed)
    if cap >= int(gp.degrees.max()):
        np.testing.assert_array_equal(ours, plain)
        np.testing.assert_array_equal(ours, native.triangle_counts(gp).astype(float))
    else:
        np.testing.assert_allclose(ours, plain, rtol=1e-9, atol=1e-9)
        assert not np.array_equal(ours, native.triangle_counts(gp).astype(float))


@pytest.mark.parametrize("hops", [1, 2])
def test_covering_walk_matches_jax_native_and_numpy(hub, hops):
    gj, gp = hub
    cap = 16                                    # binds on both hubs
    cfg = BigClamConfig(num_communities=60, seeding_degree_cap=cap)
    phi = seeding.conductance(gp, backend="numpy")
    order = seeding.covering_order(gp, phi, cfg)
    got = native.select_seeds_covering(gp, order, 60, hops, cap)
    np.testing.assert_array_equal(got, jnat.select_seeds_covering(gj, order, 60, hops, cap))
    np.testing.assert_array_equal(
        got, seeding._covering_walk_numpy(gp, order, 60, hops, cap)
    )
    np.testing.assert_array_equal(
        got, seeding.select_seeds_covering(gp, phi, 60, cfg, hops=hops)
    )


def test_two_processes_build_into_one_empty_directory(tmp_path):
    """Both processes compile at once into an empty build directory; each
    loads a library that counts triangles right, and one library and no
    temporary file is left."""
    build = tmp_path / "_build"
    code = textwrap.dedent(
        """
        import sys
        from pathlib import Path
        import numpy as np
        from bigclam_tpu_torch.graph import native
        from bigclam_tpu_torch.graph.ingest import graph_from_edges
        native.BUILD_DIR = Path(sys.argv[1])
        g = graph_from_edges(np.array([[0, 1], [1, 2], [2, 0], [2, 3]]))
        print(native.status()["loaded"], native.triangle_counts(g).tolist())
        """
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen([sys.executable, "-c", code, str(build)], env=env,
                         cwd=str(REPO), stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for _ in range(2)
    ]
    for proc in procs:
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, err
        assert out.split("\n")[0] == "True [1, 1, 1, 0]", (out, err)
    left = sorted(p.name for p in build.iterdir())
    assert len(left) == 1 and left[0].startswith("libbigclam_native-"), left
