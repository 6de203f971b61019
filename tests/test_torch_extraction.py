"""The port's array extraction and writer (bigclam_tpu_torch/ops/extraction.py)
against the JAX package's `save_communities(extract_communities(...))`, byte
for byte: unpermuted and permuted raw ids, negative ids, tied row maxima,
all-zero rows, empty communities and an empty result. The device branch on
the CPU device against the JAX `extract_communities_device` (padded F,
small chunks) and on a balanced dp = 4 port mesh through
internal_row_to_node() (tests/test_extraction_eval.py:121-182); the
`cli fit --out` file against the JAX writer; and the device branch on the
card (skipped here)."""

import numpy as np
import pytest
import torch

from bigclam_tpu.graph.ingest import graph_from_edges as jax_graph_from_edges
from bigclam_tpu.ops import extraction as jext

from bigclam_tpu_torch import cli
from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.ops import extraction as pext
from bigclam_tpu_torch.parallel import ShardedBigClamModel, make_mesh

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _port(gj):
    return Graph(gj.indptr, gj.indices, gj.raw_ids)


def _graph(n, seed=3, offset=0):
    """A random graph on raw ids offset .. offset + n - 1 (negative ids for
    a negative offset)."""
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < 0.05
    edges = [(i + offset, j + offset) for i in range(n) for j in range(i + 1, n)
             if a[i, j]]
    edges.append((offset, offset + n - 1))
    gj = jax_graph_from_edges(edges)
    return gj, _port(gj)


def _F(g, k, seed=0, zero_row=True):
    """F with a row tied on its max below delta, a row tied above, column
    3 empty but for an all-zero row (which lands in every community) when
    zero_row."""
    rng = np.random.default_rng(seed)
    F = rng.uniform(0.0, 0.3, size=(g.num_nodes, k))
    F[:, 3] = 0.0
    F[rng.uniform(size=g.num_nodes) < 0.5, 3 + 1:] = 0.0
    F[:, 0] = np.maximum(F[:, 0], 1e-3)           # no other all-zero rows
    if zero_row:
        F[5] = 0.0
    F[11, :3] = 0.2
    F[11, 3:] = 0.0
    F[12, :2] = 2.0
    return F


def _write_both(tmp_path, F, gp, gj, name):
    arr = pext.extract_community_arrays(F, gp)
    pext.write_communities(str(tmp_path / f"{name}.port"), arr)
    jext.save_communities(str(tmp_path / f"{name}.jax"), jext.extract_communities(F, gj))
    return arr, (tmp_path / f"{name}.port").read_bytes(), (
        tmp_path / f"{name}.jax").read_bytes()


@pytest.mark.parametrize("offset", [0, -40, 10**12])
@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("zero_row", [False, True])
def test_writer_is_byte_identical_to_jax(tmp_path, offset, permuted, dtype,
                                         zero_row, monkeypatch):
    gj, gp = _graph(97, offset=offset)
    F = _F(gp, 7, zero_row=zero_row).astype(dtype)
    if permuted:
        perm = np.random.default_rng(1).permutation(gp.num_nodes)
        gj, gp = gj.permute(perm), gp.permute(perm)
        F = F[np.argsort(perm)]
        assert not np.all(np.diff(gp.raw_ids) > 0)
    monkeypatch.setattr(pext, "WRITE_CHUNK_PAIRS", 29)   # lines across chunks
    arr, port, jax = _write_both(tmp_path, F, gp, gj, "c")
    assert port == jax and port.endswith(b"\n")
    want = jext.extract_communities(F, gj)
    assert arr.to_dict() == want and len(arr) == len(want)
    # column 3: only the all-zero row's, else empty and left out
    assert (3 in want) == (3 in arr.ids) == zero_row
    assert all(len(v) > 0 for v in want.values())
    assert pext.extract_communities(F, gp) == want         # the plain version
    assert (offset < 0) == (b"-" in port)


def test_writer_of_an_empty_result_writes_an_empty_file(tmp_path):
    gj = jax_graph_from_edges(np.empty((0, 2), np.int64))
    gp = _port(gj)
    F = np.zeros((0, 4))
    arr, port, jax = _write_both(tmp_path, F, gp, gj, "e")
    assert port == jax == b"" and len(arr) == 0
    pext.write_communities(str(tmp_path / "direct"), pext.CommunityArrays.from_counts(
        np.zeros(3, np.int64), np.empty(0, np.int64), np.arange(5)))
    assert (tmp_path / "direct").read_bytes() == b""


@pytest.mark.parametrize("permuted", [False, True])
def test_device_branch_on_cpu_matches_jax_padded(permuted):
    import jax.numpy as jnp

    gj, gp = _graph(97)
    if permuted:
        perm = np.random.default_rng(2).permutation(gp.num_nodes)
        gj, gp = gj.permute(perm), gp.permute(perm)
    k = 7
    F = _F(gp, k)
    F_pad = np.zeros((128, 16))
    F_pad[: gp.num_nodes, :k] = F
    want = jext.extract_communities_device(jnp.asarray(F_pad), gj,
                                           num_communities=k, chunk_rows=13)
    got = pext.extract_communities_device(torch.as_tensor(F_pad), gp,
                                          num_communities=k, chunk_rows=13)
    assert got == want == jext.extract_communities(F, gj)
    arr = pext.extract_community_arrays_device(
        torch.as_tensor(F_pad, dtype=torch.float32), gp, num_communities=k,
        chunk_rows=13)
    host = pext.extract_community_arrays(F_pad[: gp.num_nodes, :k].astype(np.float32), gp)
    for a, b in ((arr.ids, host.ids), (arr.offsets, host.offsets),
                 (arr.nodes, host.nodes)):
        np.testing.assert_array_equal(a, b)


def test_device_branch_uniform_rows_below_delta():
    gj, gp = _graph(8)
    F = np.full((gp.num_nodes, 3), 0.5)
    got = pext.extract_communities_device(torch.as_tensor(F), gp, delta=2.0)
    assert got == jext.extract_communities(F, gj, delta=2.0)
    assert set(got) == {0, 1, 2}


@pytest.mark.parametrize("balance", [False, True])
def test_device_branch_on_a_dp4_mesh_matches_host(balance):
    gj, gp = _graph(96)
    k = 6
    cfg = BigClamConfig(num_communities=k, dtype="float64", max_iters=3,
                        use_pallas_csr=False)
    model = ShardedBigClamModel(gp, cfg, make_mesh((4, 1), [CPU] * 4),
                                balance=balance)
    assert (model._perm is not None) == balance
    F0 = np.random.default_rng(1).uniform(0.0, 1.0, (gp.num_nodes, k))
    final, _llh, _it, _h = model.fit_state(model.init_state(F0))
    host = pext.extract_communities(model.extract_F(final), gp)
    assert host == jext.extract_communities(model.extract_F(final), gj)
    via_trainer_graph = pext.extract_communities_device(
        final.F, model.g, num_communities=k, chunk_rows=17)
    via_row_map = pext.extract_communities_device(
        final.F, gp, num_communities=k, chunk_rows=17,
        row_to_node=model.internal_row_to_node())
    assert via_trainer_graph == host
    assert via_row_map == host
    if not balance:
        assert model.internal_row_to_node() is None


def test_cli_fit_out_is_byte_identical_to_the_jax_writer(tmp_path):
    gj, gp = _graph(150, offset=-20)
    path = tmp_path / "g.txt"
    keep = gj.src < gj.dst
    raw = gj.raw_ids
    np.savetxt(path, np.stack([raw[gj.src[keep]], raw[gj.dst[keep]]], axis=1), fmt="%d")
    args = cli.build_parser().parse_args([
        "fit", "--graph", str(path), "--k", "9", "--max-iters", "3",
        "--device", "cpu", "--out", str(tmp_path / "p.txt")])
    out, res, _ = cli.fit(args)
    jext.save_communities(str(tmp_path / "j.txt"), jext.extract_communities(res.F, gj))
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert out["communities"] == len(jext.extract_communities(res.F, gj))
    assert "extract" in out["stage_seconds"]


@pytest.mark.cuda
@pytest.mark.parametrize("permuted", [False, True])
def test_cuda_device_branch_matches_host(permuted):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gj, gp = _graph(300)
    if permuted:
        gp = gp.permute(np.random.default_rng(2).permutation(gp.num_nodes))
    F = _F(gp, 37).astype(np.float32)
    dev = pext.extract_community_arrays_device(
        torch.as_tensor(F, device="cuda"), gp, chunk_rows=64)
    host = pext.extract_community_arrays(F, gp)
    for a, b in ((dev.ids, host.ids), (dev.offsets, host.offsets),
                 (dev.nodes, host.nodes)):
        np.testing.assert_array_equal(a, b)
