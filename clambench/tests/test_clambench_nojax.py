"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names."""

import subprocess
import sys

from conftest import REPO
from clambench import harness

SCRIPT = r"""
import sys, time
sys.path.insert(0, {repo!r}); sys.path.insert(0, {tests!r})
from conftest import tiny_config, CELLS
from clambench import harness, registry
bench = registry.load_benchmark()
for name in CELLS:
    cell, config = tiny_config(bench, name)
    harness.run(bench, cell, config, registry.mix(cell["traffic"]),
                registry.limits(name), 5, 0.5, True, time.perf_counter(), device="cpu")
print("LOADED", ",".join(harness.forbidden_modules()))
"""


def test_a_run_loads_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(repo=str(REPO),
                                             tests=str(REPO / "clambench" / "tests"))],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "LOADED"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("jax", "jaxlib.xla_client", "flax.linen", "bigclam_tpu.models"):
        monkeypatch.setitem(sys.modules, name, object())
    monkeypatch.setitem(sys.modules, "bigclam_tpu_torch_like", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    got = [m for m in harness.forbidden_modules()
           if m in ("jax", "jaxlib.xla_client", "flax.linen", "bigclam_tpu.models",
                    "bigclam_tpu_torch_like", "jaxtyping")]
    assert got == ["bigclam_tpu.models", "flax.linen", "jax", "jaxlib.xla_client"]
