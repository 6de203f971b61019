"""Find everything a cell needs by its name in BENCHMARK.json.

* a configuration: the file its `configs` entry names;
* a traffic mix: `traffic/<mix>.json`, read by the one generator
  (generate.py);
* the limits of a cell's comparison: `limits/<cell>.json`;
* a per-layer metric: `metrics/<metric>.py`, a reader with `MOVES` (the
  end-to-end metric it moves) and `read(record)` (the value, or None
  where it finds nothing to read);
* the program's trainer and the plain reference of a representation:
  `trainers/<representation>.py`, `reference/<representation>.py`.

A later cell, mix or metric is a new file and a new entry; nothing here
names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def load_benchmark(repo: Path = REPO) -> dict:
    with open(repo / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _by_name(bench["workloads"], name, "workload")


def config(bench: dict, name: str, repo: Path = REPO) -> dict:
    with open(repo / _by_name(bench["configs"], name, "configuration")["file"]) as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def mix(name: str, root: Path = HERE) -> dict:
    return _json(root / "traffic" / f"{name}.json")


def limits(cell: str, root: Path = HERE) -> dict:
    return _json(root / "limits" / f"{cell}.json")


def metric(name: str, root: Path = HERE):
    """The reader module of per-layer metric `name`."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "clambench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def names(kind: str, root: Path = HERE) -> list:
    """The names a kind ('traffic', 'metrics', 'limits', 'configs') has
    files for."""
    suffix = ".py" if kind == "metrics" else ".json"
    return sorted(p.name[:-len(suffix)] for p in (root / kind).glob(f"*{suffix}"))


def trainer(representation: str):
    return importlib.import_module(f"clambench.trainers.{representation}")


def reference(representation: str):
    return importlib.import_module(f"clambench.reference.{representation}")


def per_layer_for(bench: dict, cell: str) -> list:
    """The per-layer entries a cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in e2e else [])]
