"""The port's CLI flags against the JAX CLI's: every subcommand the two
share has the same options, defaults and choices, but for the deliberate
differences ROADMAP.md queue 3 names (the JAX parser is built inside
`bigclam_tpu.cli.main`, so it is captured there by patching
`ArgumentParser.parse_args` for one call); and `sweep`'s flags of the JAX
`_add_common` with their effects: `--metrics` writes the JAX `{"k",
"llh"}` records, `--quiet` silences their stderr echo, `--health-every`
and `--heartbeat-s`/`--heartbeat-escalate` reach the config and the
telemetry, and `sweep`/`refit --init` parse and are ignored."""

import argparse
import contextlib
import io
import json
from unittest import mock

import numpy as np
import pytest

from bigclam_tpu_torch import cli
from bigclam_tpu_torch.models.agm import sample_planted_graph

SUBCOMMANDS = ("fit", "sweep", "eval", "ingest", "profile", "perf", "report",
               "watch", "preflight", "serve", "route", "fleet", "refit")

# environment variables the port reads that the JAX package does not, and
# what each does
DELIBERATE_ENV = {
    # the process group's backend for a cuda mesh: gloo in the place of
    # nccl, with cuda tensors staged through host memory (two ranks share
    # one card so)
    "BIGCLAM_DIST_BACKEND": "bigclam_tpu_torch/parallel/multihost.py",
}

# option -> what the port has in its place (None: the port lacks it)
DEVICE = ("cuda", ("cuda", "cpu"))
DELIBERATE = {
    "fit": {"--platform": None, "--device": DEVICE, "--csr-k-block": (0, None)},
    "sweep": {"--platform": None, "--device": DEVICE, "--csr-k-block": (0, None)},
    "profile": {"--platform": None, "--device": DEVICE, "--csr-k-block": (0, None),
                "--save-f": (None, None)},
    "refit": {"--platform": None, "--device": DEVICE, "--csr-k-block": (0, None),
              "--save-f": (None, None)},
    "serve": {"--device": DEVICE},
    "fleet": {"--device": DEVICE},
    # the port prices any card by name, not the TPU generations
    "preflight": {"--device-kind": (None, None)},
}


class _Captured(Exception):
    pass


def jax_parser() -> argparse.ArgumentParser:
    from bigclam_tpu import cli as jax_cli

    box = {}

    def grab(self, *args, **kwargs):
        box["parser"] = self
        raise _Captured

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        with pytest.raises(_Captured):
            jax_cli.main(["fit"])
    return box["parser"]


def _subparsers(p):
    (act,) = [a for a in p._actions if isinstance(a, argparse._SubParsersAction)]
    return act.choices


def _options(p) -> dict:
    """option string -> (default, choices) of every optional argument, and
    the positionals by name."""
    out = {}
    for a in p._actions:
        if isinstance(a, (argparse._HelpAction, argparse._SubParsersAction)):
            continue
        choices = tuple(a.choices) if a.choices is not None else None
        for key in a.option_strings or [a.dest]:
            out[key] = (a.default, choices)
    return out


@pytest.fixture(scope="module")
def parsers():
    return _subparsers(jax_parser()), _subparsers(cli.build_parser())


def test_both_clis_have_the_same_subcommands(parsers):
    jax, port = parsers
    assert set(jax) == set(port) == set(SUBCOMMANDS)


@pytest.mark.parametrize("name", SUBCOMMANDS)
def test_subcommand_options_match_the_jax_cli(parsers, name):
    jax, port = parsers
    ref, ours = _options(jax[name]), _options(port[name])
    allowed = DELIBERATE.get(name, {})
    for key in sorted(set(ref) | set(ours)):
        if key in allowed:
            assert ours.get(key) == allowed[key], (name, key, ours.get(key))
            continue
        assert ours.get(key) == ref.get(key), (name, key, ours.get(key), ref.get(key))
    if name == "perf":          # perf's own subcommands
        jsub, psub = _subparsers(jax[name]), _subparsers(port[name])
        assert set(jsub) == set(psub)
        for sub in jsub:
            assert _options(psub[sub]) == _options(jsub[sub]), sub


@pytest.mark.parametrize("name", ["fit", "sweep", "profile", "refit"])
def test_distributed_flag_matches_the_jax_cli(parsers, name):
    """`--distributed` is the JAX CLI's store_true flag wherever the JAX
    parser has it; fit and sweep run it (tests/test_torch_multihost.py),
    refit refuses it in the JAX CLI's words."""
    jax, port = parsers
    (ref,) = [a for a in jax[name]._actions if "--distributed" in a.option_strings]
    (ours,) = [a for a in port[name]._actions if "--distributed" in a.option_strings]
    assert isinstance(ours, argparse._StoreTrueAction)
    assert isinstance(ref, argparse._StoreTrueAction)
    assert (ours.default, ours.dest) == (ref.default, ref.dest)
    if name == "refit":
        with pytest.raises(SystemExit, match="--distributed"):
            cli.main(["refit", "--graph", "g", "--snapshots", "s", "--delta", "d",
                      "--distributed", "--device", "cpu"])


def test_deliberate_environment_is_the_ports_own():
    import pathlib

    repo = pathlib.Path(__file__).resolve().parent.parent
    jax_src = "".join(p.read_text() for p in (repo / "bigclam_tpu").rglob("*.py"))
    for name, path in DELIBERATE_ENV.items():
        assert name in (repo / path).read_text()
        assert name not in jax_src


def test_serve_fleet_shard_defaults_to_zero():
    args = cli.build_parser().parse_args(["serve", "--fleet", "d"])
    assert args.fleet_shard == 0 and args.listen is None


@pytest.mark.parametrize("sub", ["sweep", "refit"])
def test_sweep_and_refit_accept_init_and_ignore_it(sub):
    argv = {"sweep": ["sweep", "--graph", "g.txt"],
            "refit": ["refit", "--graph", "c", "--snapshots", "s", "--delta", "d"]}[sub]
    assert cli.build_parser().parse_args(argv + ["--init", "random"]).init == "random"
    assert cli.build_parser().parse_args(argv).init == "conductance"


@pytest.fixture(scope="module")
def edge_file(tmp_path_factory):
    g, _ = sample_planted_graph(200, 8, p_in=0.3, rng=np.random.default_rng(5))
    path = tmp_path_factory.mktemp("flags") / "g.txt"
    keep = g.src < g.dst
    np.savetxt(path, np.stack([g.src[keep], g.dst[keep]], 1), fmt="%d")
    return str(path)


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_sweep_metrics_and_quiet_write_the_jax_records(edge_file, tmp_path):
    from bigclam_tpu.cli import main as jax_main

    argv = ["sweep", "--graph", edge_file, "--min-com", "2", "--max-com", "8",
            "--div-com", "4", "--max-iters", "10", "--dtype", "float64",
            "--init", "random"]
    rc, _, err = _run(cli.main, argv + ["--device", "cpu", "--quiet", "--metrics",
                                        str(tmp_path / "p.jsonl")])
    assert rc == 0 and '"llh"' not in err
    rcj, _, _ = _run(jax_main, argv + ["--quiet", "--metrics", str(tmp_path / "j.jsonl")])
    assert rcj == 0
    ours = [json.loads(x) for x in open(tmp_path / "p.jsonl")]
    ref = [json.loads(x) for x in open(tmp_path / "j.jsonl")]
    assert [r["k"] for r in ours] == [r["k"] for r in ref]
    np.testing.assert_allclose([r["llh"] for r in ours], [r["llh"] for r in ref],
                               rtol=1e-10)
    assert [set(r) for r in ours] == [set(r) for r in ref]      # t, ts, load_s
    # without --quiet each record is echoed to stderr as well
    rc, _, err = _run(cli.main, argv + ["--device", "cpu"])
    echoed = [json.loads(x) for x in err.splitlines() if x.startswith("{")]
    assert rc == 0 and [r["k"] for r in echoed] == [r["k"] for r in ref]


def test_sweep_health_and_heartbeat_reach_config_and_telemetry(edge_file, tmp_path):
    """--health-every goes into the config (with --telemetry-dir, whose
    monitor reads the packs) and the heartbeat flags into the telemetry."""
    import bigclam_tpu_torch.models.model_selection as ms
    import bigclam_tpu_torch.obs as obs

    seen = {}
    orig_sweep, orig_tel = ms.sweep_k, obs.RunTelemetry

    def sweep_k(g, cfg, **kw):
        seen["health_every"] = cfg.health_every
        return orig_sweep(g, cfg, **kw)

    def telemetry(*a, **kw):
        seen.update(kw)
        return orig_tel(*a, **kw)

    argv = ["sweep", "--graph", edge_file, "--min-com", "2", "--max-com", "4",
            "--div-com", "2", "--max-iters", "3", "--device", "cpu", "--quiet",
            "--telemetry-dir", str(tmp_path / "tel"), "--health-every", "3",
            "--heartbeat-s", "7.5", "--heartbeat-escalate", "2"]
    with mock.patch.object(ms, "sweep_k", sweep_k), \
            mock.patch.object(obs, "RunTelemetry", telemetry):
        rc, _, _ = _run(cli.main, argv)
    assert rc == 0
    assert seen["health_every"] == 3
    assert (seen["heartbeat_s"], seen["heartbeat_escalate"], seen["quiet"]) == (
        7.5, 2, True)
    defaults = cli.build_parser().parse_args(["sweep", "--graph", edge_file])
    assert (defaults.health_every, defaults.heartbeat_s, defaults.heartbeat_escalate,
            defaults.metrics, defaults.quiet) == (10, 300.0, 3, None, False)
