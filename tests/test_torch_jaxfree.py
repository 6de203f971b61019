"""The PyTorch port imports neither jax nor anything of the JAX package:
a fresh interpreter imports every module of bigclam_tpu_torch (the
non-CSR candidate kernel's ops.edge_kernels, the K sweep's
models.model_selection, and the observability and resilience modules
among them) and runs every subcommand's `--help`,
then finds no jax and no bigclam_tpu module loaded; a
static scan finds no such import in any port file or in chip_smoke.py."""

import ast
import os
import pathlib
import re
import subprocess
import sys
import textwrap

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "bigclam_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"
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
        for sub in ("fit", "sweep", "eval", "profile", "perf", "report",
                    "watch", "preflight"):
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
                     "obs.memory", "obs.ledger", "obs.report", "obs.watch"):
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


def test_static_scan_finds_no_jax_or_reference_import():
    assert len(PORT_FILES) > 10
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
