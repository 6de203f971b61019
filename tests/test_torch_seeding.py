"""The port's seeding (bigclam_tpu_torch/ops/seeding.py) against the JAX
package's (bigclam_tpu/ops/seeding.py): the capped sampler bit for bit,
the capped estimator on the native and numpy paths, the dense and sampled
device backends on the CPU device, the `auto` rule, and the seeds of every
backend; `cli fit --seeding-degree-cap` against the JAX CLI in float64;
and the device backends on the card (skipped here)."""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from bigclam_tpu.cli import main as jax_main
from bigclam_tpu.config import BigClamConfig as JaxConfig
from bigclam_tpu.graph.ingest import graph_from_edges as jax_graph_from_edges
from bigclam_tpu.models.agm import sample_planted_graph as jax_planted
from bigclam_tpu.ops import seeding as jseed

from bigclam_tpu_torch import cli
from bigclam_tpu_torch.config import BigClamConfig
from bigclam_tpu_torch.graph import native
from bigclam_tpu_torch.graph.csr import Graph
from bigclam_tpu_torch.ops import seeding as pseed

torch.set_num_threads(2)

CPU = torch.device("cpu")
RTOL_NATIVE = 1e-9        # native vs numpy estimates: summation order only
RTOL_DEVICE = 2e-5        # float32 device estimate vs the float64 host one


def _port(gj):
    return Graph(gj.indptr, gj.indices, gj.raw_ids)


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
    return gj, _port(gj)


def random_graph(n=300, p=0.08, seed=3):
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < p
    gj = jax_graph_from_edges(
        [(i, j) for i in range(n) for j in range(i + 1, n) if a[i, j]], num_nodes=n
    )
    return gj, _port(gj)


@pytest.fixture(scope="module")
def hub():
    return hub_graph()


@pytest.fixture(scope="module")
def small():
    return random_graph()


def _ranks(g, phi, k=30):
    return pseed.rank_seeds(g, phi, BigClamConfig(num_communities=k))


def test_splitmix64_matches_jax():
    xs = [0, 1, 5, 2**63 - 1, 2**64 - 1, 0x9E3779B97F4A7C15]
    got = pseed._splitmix64(np.array(xs, dtype=np.uint64))
    assert [int(v) for v in got] == [jseed._splitmix64(x) for x in xs]


@pytest.mark.parametrize("cap", [4, 16, 100, 700, 1000])
def test_capped_csr_bit_for_bit(hub, cap):
    gj, gp = hub
    for seed in (0, 2**63 + 12345):
        want = jseed.capped_csr(gj, cap, seed)
        got = pseed.capped_csr(gp, cap, seed)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    # a shard-local call keys the stream by the global row id
    lo, hi = 100, 500
    want = jseed.capped_neighbor_lists(
        gj.indptr[lo : hi + 1] - gj.indptr[lo],
        gj.indices[gj.indptr[lo] : gj.indptr[hi]], cap, 7, row_offset=lo,
    )
    got = pseed.capped_neighbor_lists(
        gp.indptr[lo : hi + 1] - gp.indptr[lo],
        gp.indices[gp.indptr[lo] : gp.indptr[hi]], cap, 7, row_offset=lo,
    )
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cap", [4, 32])
@pytest.mark.parametrize("use_native", [True, False])
def test_sampled_estimator_matches_jax(hub, cap, use_native):
    gj, gp = hub
    kw = dict(use_native=use_native, chunk_entries=1 << 26 if use_native else 4096)
    got = pseed.triangle_counts_sampled(gp, cap, np.random.default_rng(7), **kw)
    want = jseed.triangle_counts_sampled(gj, cap, np.random.default_rng(7),
                                         use_native=use_native)
    np.testing.assert_allclose(got, want, rtol=RTOL_NATIVE, atol=RTOL_NATIVE)
    other = pseed.triangle_counts_sampled(
        gp, cap, np.random.default_rng(7), use_native=not use_native
    )
    np.testing.assert_allclose(got, other, rtol=RTOL_NATIVE, atol=RTOL_NATIVE)


def test_estimator_draws_one_seed_on_every_path(hub):
    _, gp = hub
    ends = []
    for use_native in (True, False):
        rng = np.random.default_rng(11)
        pseed.triangle_counts_sampled(gp, 8, rng, use_native=use_native)
        ends.append(int(rng.integers(2**63)))
    assert ends[0] == ends[1]


@pytest.mark.parametrize("cap", [4, 32])
def test_sampled_device_on_cpu_matches_jax(hub, cap):
    gj, gp = hub
    seed = int(np.random.default_rng(7).integers(2**63))
    got = pseed.triangle_counts_sampled_device(gp, cap, seed, device=CPU)
    want = jseed.triangle_counts_sampled_device(gj, cap, seed)
    np.testing.assert_allclose(got, want, rtol=RTOL_DEVICE, atol=RTOL_DEVICE)
    host = pseed.triangle_counts_sampled(gp, cap, np.random.default_rng(7))
    np.testing.assert_allclose(got, host, rtol=RTOL_DEVICE, atol=RTOL_DEVICE)
    # small chunks: a ragged last chunk of sentinel rows changes nothing
    chunked = pseed.triangle_counts_sampled_device(gp, cap, seed, chunk_nodes=37,
                                                   device=CPU)
    np.testing.assert_allclose(chunked, got, rtol=RTOL_DEVICE, atol=RTOL_DEVICE)


def test_dense_device_on_cpu_is_exact(hub, small):
    for gj, gp in (hub, small):
        got = pseed.triangle_counts_dense_device(gp, device=CPU)
        np.testing.assert_array_equal(got, jseed.triangle_counts_dense_device(gj))
        np.testing.assert_array_equal(got, pseed.triangle_counts(gp))
        assert got.dtype == np.int64


def test_dense_device_refuses_the_degree_bound():
    n = pseed.DENSE_DEVICE_MAX_DEGREE + 2
    gp = _port(jax_graph_from_edges([(0, i) for i in range(1, n)], num_nodes=n))
    with pytest.raises(ValueError, match="float32-exact bound"):
        pseed.triangle_counts_dense_device(gp, device=CPU)


def test_cap_at_max_degree_is_exact(small):
    gj, gp = small
    cap = int(gp.degrees.max())
    exact = pseed.triangle_counts(gp).astype(float)
    np.testing.assert_allclose(
        pseed.triangle_counts_sampled_device(gp, cap, 0, device=CPU), exact, atol=1e-6
    )
    for use_native in (True, False):
        np.testing.assert_allclose(
            pseed.triangle_counts_sampled(gp, cap, np.random.default_rng(1),
                                          use_native=use_native),
            exact, rtol=0, atol=1e-9,
        )


@pytest.mark.parametrize("backend", ["sampled", "sampled_device"])
def test_capped_phi_stays_non_negative(small, backend, monkeypatch):
    gj, gp = small
    for use_native in (True, False):
        if not use_native:
            def unavailable(*a, **kw):
                raise native.NativeUnavailableError("disabled in this test")

            monkeypatch.setattr(native, "triangle_counts_capped", unavailable)
        phi = pseed.conductance(gp, backend=backend, degree_cap=4,
                                rng=np.random.default_rng(4), device=CPU)
        assert (phi >= 0).all(), (use_native, phi.min())


def _record(monkeypatch, module, names, calls):
    for name in names:
        fn = getattr(module, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)


COUNTERS = ("triangle_counts", "triangle_counts_dense_device",
            "triangle_counts_sampled", "triangle_counts_sampled_device")


@pytest.mark.parametrize("case", ["cap_binds", "dense_fits", "cap_loose",
                                  "too_many_nodes", "degree_too_high"])
def test_auto_picks_the_jax_rules_backend(case, monkeypatch):
    if case == "too_many_nodes":
        n = pseed.DENSE_DEVICE_MAX_NODES + 1
        gj = jax_graph_from_edges([(i, i + 1) for i in range(0, n - 1, 2)],
                                  num_nodes=n)
    elif case == "degree_too_high":
        n = pseed.DENSE_DEVICE_MAX_DEGREE + 2
        gj = jax_graph_from_edges([(0, i) for i in range(1, n)], num_nodes=n)
    else:
        gj, _ = random_graph(n=120, p=0.1)
    gp = _port(gj)
    cap = {"cap_binds": 4, "cap_loose": 1000}.get(case)
    jcalls, pcalls = [], []
    _record(monkeypatch, jseed, COUNTERS, jcalls)
    _record(monkeypatch, pseed, COUNTERS, pcalls)
    want = jseed.conductance(gj, backend="auto", degree_cap=cap,
                             rng=np.random.default_rng(2))
    got = pseed.conductance(gp, backend="auto", degree_cap=cap,
                            rng=np.random.default_rng(2), device=CPU)
    assert pcalls[0] == jcalls[0], (pcalls, jcalls)
    assert pseed.auto_backend(gp, cap, CPU) == {
        "triangle_counts": "numpy", "triangle_counts_dense_device": "dense",
        "triangle_counts_sampled": "sampled",
    }[jcalls[0]]
    np.testing.assert_allclose(got, want, rtol=RTOL_NATIVE, atol=RTOL_NATIVE)
    # no device named: the exact host pass where the rule would run dense
    # (the same integers)
    pcalls.clear()
    np.testing.assert_array_equal(
        pseed.conductance(gp, backend="auto", degree_cap=cap,
                          rng=np.random.default_rng(2)), got,
    )
    assert pcalls[0] == ("triangle_counts" if jcalls[0].endswith("dense_device")
                         else jcalls[0])


@pytest.mark.parametrize("exclusion", [False, True])
def test_conductance_seeds_equal_on_every_backend(hub, exclusion):
    """One config, the same seeds as the JAX package on every backend:
    exactly for the exact counts, and for the capped estimates (identical
    rank orders from estimates within the bands)."""
    gj, gp = hub
    for cap in (None, 16):
        jc = JaxConfig(num_communities=40, seeding_degree_cap=cap,
                       seed_exclusion=exclusion, seed=3)
        pc = BigClamConfig(**dataclasses.asdict(jc))
        backends = (("numpy", "dense", "auto") if cap is None
                    else ("sampled", "sampled_device", "auto"))
        want = jseed.conductance_seeds(gj, jc, backend=backends[0])
        for b in backends:
            got = pseed.conductance_seeds(gp, pc, backend=b, device=CPU)
            np.testing.assert_array_equal(got, want, err_msg=f"{b} cap={cap}")
            np.testing.assert_array_equal(
                got, jseed.conductance_seeds(gj, jc, backend=b), err_msg=b
            )


def test_capped_phi_ranks_agree_across_backends(hub):
    _, gp = hub
    phis = {
        b: pseed.conductance(gp, backend=b, degree_cap=16,
                             rng=np.random.default_rng(9), device=CPU)
        for b in ("sampled", "sampled_device")
    }
    np.testing.assert_allclose(phis["sampled_device"], phis["sampled"],
                               rtol=RTOL_DEVICE, atol=RTOL_DEVICE)
    np.testing.assert_array_equal(_ranks(gp, phis["sampled"]),
                                  _ranks(gp, phis["sampled_device"]))


def test_unknown_backend_is_refused(small):
    with pytest.raises(ValueError, match="unknown conductance backend"):
        pseed.conductance(small[1], backend="gpu")


# --- the CLI ---------------------------------------------------------------


def _cli_json(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _capture_init(monkeypatch, module, into):
    real = module.init_F

    def spy(g, seeds, cfg, rng=None):
        F = real(g, seeds, cfg, rng)
        into.append((np.asarray(seeds).copy(), F.copy()))
        return F

    monkeypatch.setattr(module, "init_F", spy)


def test_cli_fit_with_degree_cap_matches_jax_cli(tmp_path, hub, monkeypatch):
    """Port and JAX `cli fit --seeding-degree-cap 4` on the hub graph, in
    float64 on the CPU: the same seeds and F0, the same communities file
    byte for byte, LLH histories at 1e-9."""
    gj, _ = hub
    path = tmp_path / "g.txt"
    keep = gj.src < gj.dst
    np.savetxt(path, np.stack([gj.src[keep], gj.dst[keep]], axis=1), fmt="%d")
    argv = ["fit", "--graph", str(path), "--k", "12", "--max-iters", "4",
            "--dtype", "float64", "--seeding-degree-cap", "4"]
    pinit, jinit = [], []
    _capture_init(monkeypatch, pseed, pinit)
    _capture_init(monkeypatch, jseed, jinit)
    out = _cli_json(cli.main, argv + ["--device", "cpu",
                                      "--out", str(tmp_path / "p.txt")])
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        ref = _cli_json(jax_main, argv + ["--csr-kernels", "off",
                                          "--out", str(tmp_path / "j.txt")])
    ref_hist = [json.loads(ln)["llh"] for ln in err.getvalue().splitlines()
                if ln.startswith("{") and '"iter"' in ln]
    (ps, pF), (js, jF) = pinit[0], jinit[0]
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pF, jF)
    assert len(out["llh_history"]) == len(ref_hist)
    np.testing.assert_allclose(out["llh_history"], ref_hist, rtol=1e-9)
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert out["communities"] == ref["communities"]


@pytest.mark.parametrize("command", ["fit", "sweep"])
def test_cli_seed_backend_baked_exits_with_the_jax_message(tmp_path, command):
    path = tmp_path / "g.txt"
    path.write_text("0 1\n1 2\n2 0\n")
    with pytest.raises(SystemExit) as jax_exit:
        jax_main(["fit", "--graph", str(path), "--k", "2", "--seed-backend",
                  "baked", "--max-iters", "1"])
    extra = ["--k", "2"] if command == "fit" else ["--min-com", "1", "--max-com", "2"]
    with pytest.raises(SystemExit) as port_exit:
        cli.main([command, "--graph", str(path), *extra, "--seed-backend",
                  "baked", "--device", "cpu", "--max-iters", "1"])
    assert str(port_exit.value.code) == str(jax_exit.value.code)
    assert "baked" in str(port_exit.value.code)


def test_cli_sweep_seeds_with_the_cap_from_the_config(tmp_path, monkeypatch):
    """`cli sweep --seeding-degree-cap` seeds once, at K_max, with the cap
    (the sampled backend, as the JAX sweep does under auto)."""
    gj, gp = random_graph(n=120, p=0.1)
    path = tmp_path / "g.txt"
    keep = gj.src < gj.dst
    np.savetxt(path, np.stack([gj.src[keep], gj.dst[keep]], axis=1), fmt="%d")
    seen = []
    real = pseed.conductance_seeds

    def spy(g, cfg=None, backend="auto", phi=None, device=None):
        seen.append((cfg.num_communities, cfg.seeding_degree_cap, backend))
        return real(g, cfg, backend=backend, phi=phi, device=device)

    monkeypatch.setattr(pseed, "conductance_seeds", spy)
    out = _cli_json(cli.main, ["sweep", "--graph", str(path), "--min-com", "3",
                               "--max-com", "6", "--div-com", "2",
                               "--max-iters", "2", "--device", "cpu",
                               "--seeding-degree-cap", "3"])
    assert seen == [(out["kset"][-1], 3, "auto")]


# --- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the device backends run there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_dense_backend_is_exact(hub, cuda_device):
    _, gp = hub
    np.testing.assert_array_equal(
        pseed.triangle_counts_dense_device(gp, device=cuda_device),
        pseed.triangle_counts(gp),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [16, 1000])
def test_cuda_sampled_device_matches_host(hub, cap, cuda_device):
    _, gp = hub
    seed = int(np.random.default_rng(7).integers(2**63))
    got = pseed.triangle_counts_sampled_device(gp, cap, seed, device=cuda_device)
    host = pseed.triangle_counts_sampled(gp, cap, np.random.default_rng(7))
    np.testing.assert_allclose(got, host, rtol=RTOL_DEVICE, atol=RTOL_DEVICE)
    np.testing.assert_array_equal(_ranks(gp, pseed.conductance(gp, tri=got)),
                                  _ranks(gp, pseed.conductance(gp, tri=host)))
