"""The PyTorch port imports neither jax nor anything of the JAX package:
a fresh interpreter imports every module of bigclam_tpu_torch (the
non-CSR candidate kernel's ops.edge_kernels, the K sweep's
models.model_selection, the graph store's graph.stream and graph.store,
the serving stack's ops.foldin, serve.* and models.refit, the fleet's
serve.router, serve.fleet and serve.supervise, the GEXF export's
utils.viz, quality mode's ops.components and models.quality, the sparse sharded trainer's
parallel.sparse_collectives and parallel.sparse_sharded, the 2D
partition's parallel.twod, the multi-process meshes' parallel.multihost
and utils.dist, and the
observability and resilience modules among them) and runs every
subcommand's `--help`, then finds no jax and no bigclam_tpu module
loaded; a static scan finds no such import in any port file, in
chip_smoke.py or in the two-process tests' worker; and the graph stream's spawned parse workers load neither
either."""

import ast
import os
import pathlib
import re
import subprocess
import sys
import textwrap

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "bigclam_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "_torch_multihost_worker.py"
]


def _forbidden(module: str) -> bool:
    head = module.split(".")[0]
    return head in ("jax", "jaxlib", "bigclam_tpu")


def test_port_imports_no_jax_in_fresh_interpreter():
    code = textwrap.dedent(
        """
        import pkgutil, sys
        import bigclam_tpu_torch
        import bigclam_tpu_torch.cli as cli
        for m in pkgutil.walk_packages(
            bigclam_tpu_torch.__path__, "bigclam_tpu_torch."
        ):
            __import__(m.name)
        for sub in ("fit", "sweep", "eval", "ingest", "profile", "perf",
                    "report", "watch", "preflight", "serve", "route",
                    "fleet", "refit"):
            try:
                cli.main([sub, "--help"])
            except SystemExit as e:
                assert e.code == 0, e.code
        for name in ("ops.edge_kernels", "models.model_selection",
                     "obs.telemetry", "obs.trace", "obs.heartbeat",
                     "obs.health", "obs.schema", "ops.diagnostics",
                     "resilience.faults", "resilience.retry",
                     "resilience.supervisor", "utils.checkpoint",
                     "utils.metrics", "utils.profiling", "obs.comms",
                     "obs.memory", "obs.ledger", "obs.report", "obs.watch",
                     "graph.stream", "graph.store", "ops.foldin",
                     "serve.snapshot", "serve.batcher", "serve.server",
                     "models.refit", "ops.components", "models.quality",
                     "parallel.sparse_collectives",
                     "parallel.sparse_sharded", "parallel.twod",
                     "serve.router", "serve.fleet", "serve.supervise",
                     "utils.viz", "parallel.multihost", "utils.dist"):
            assert "bigclam_tpu_torch." + name in sys.modules, name
        bad = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "bigclam_tpu")
        )
        assert not bad, bad
        print("clean")
        """
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=str(REPO),
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert r.stdout.strip().splitlines()[-1] == "clean"
    assert "--csr-fused" in r.stdout        # the fit help was printed
    assert "--ksweep-tol" in r.stdout and "--no-nmi" in r.stdout
    assert "--watch-snapshots" in r.stdout and "--refit-batch" in r.stdout
    assert "--publish-shards" in r.stdout and "--follow-timeout" in r.stdout
    assert "--export-gexf" in r.stdout and "--fleet-shard" in r.stdout
    assert "--hedge-delay-s" in r.stdout and "--quarantine-after" in r.stdout
    assert "torch.distributed" in r.stdout      # the --distributed help


def test_static_scan_finds_no_jax_or_reference_import():
    assert len(PORT_FILES) > 10
    for name in ("stream.py", "store.py"):
        assert REPO / "bigclam_tpu_torch" / "graph" / name in PORT_FILES
    for rel in ("serve/__init__.py", "serve/snapshot.py", "serve/batcher.py",
                "serve/server.py", "ops/foldin.py", "models/refit.py",
                "serve/router.py", "serve/fleet.py", "serve/supervise.py",
                "utils/viz.py", "parallel/multihost.py", "utils/dist.py"):
        assert REPO / "bigclam_tpu_torch" / rel in PORT_FILES
    dynamic = re.compile(r"""(import_module|__import__)\(\s*["'](jax|bigclam_tpu)\b(?!_torch)""")
    for path in PORT_FILES:
        src = path.read_text()
        tree = ast.parse(src, filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path.relative_to(REPO)}:{node.lineno} imports {bad}"
        assert not dynamic.search(src), path


def test_scan_rule_tells_the_port_from_the_reference():
    assert _forbidden("bigclam_tpu.ops.objective")
    assert _forbidden("jax.numpy")
    assert not _forbidden("bigclam_tpu_torch.ops.objective")
    assert not _forbidden("torch")


def test_spawned_parse_workers_load_no_jax(tmp_path):
    """stream_edge_list(..., workers=2) in a fresh interpreter: neither the
    parent nor a spawned worker (which unpickles the port's parse_span and
    so imports its module) loads jax or the JAX package."""
    text = tmp_path / "g.txt"
    text.write_text("# edges\n" + "".join(f"{i} {(i * 7 + 3) % 97}\n"
                                           for i in range(400)))
    probe = tmp_path / "probe"
    probe.mkdir()
    script = tmp_path / "run_stream.py"
    script.write_text(textwrap.dedent(f"""
        import os, sys

        FORBIDDEN = ("jax", "jaxlib", "bigclam_tpu")
        PROBE = {str(probe)!r}

        def _mark(kind, name):
            with open(os.path.join(PROBE, f"{{kind}}.{{os.getpid()}}"), "a") as f:
                f.write(name + "\\n")

        class Probe:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in FORBIDDEN:
                    _mark("forbidden", name)
                if name == "bigclam_tpu_torch.graph.stream":
                    _mark("seen", name)
                return None

        if __name__ == "__mp_main__":
            # a spawned worker: watch every import from here on
            for m in list(sys.modules):
                if m.split(".")[0] in FORBIDDEN:
                    _mark("forbidden", m)
            sys.meta_path.insert(0, Probe())

        if __name__ == "__main__":
            from bigclam_tpu_torch.graph.stream import load_edge_list_streaming
            pairs = load_edge_list_streaming({str(text)!r}, chunk_bytes=300,
                                             workers=2)
            bad = sorted(m for m in sys.modules
                         if m.split(".")[0] in FORBIDDEN)
            assert not bad, bad
            print("clean", pairs.shape[0])
    """))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, str(script)], env=env, cwd=str(REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert r.stdout.split()[0] == "clean"
    names = os.listdir(probe)
    assert [n for n in names if n.startswith("seen.")], names
    assert not [n for n in names if n.startswith("forbidden.")], [
        open(probe / n).read() for n in names]
