"""Shared helpers of the benchmark's CPU tests: the repository root on the
path, and tiny versions of the cells' configurations."""

import copy
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from clambench import registry  # noqa: E402

TINY_GRAPH = {"nodes": 2000, "edges": 12000, "communities": 40}


@pytest.fixture(scope="session")
def bench():
    return registry.load_benchmark()


def tiny_config(bench, cell_name: str, dtype: str = "") -> tuple:
    """(cell, configuration) with the cell's settings at 2,000 nodes: K 20
    dense, K 40 and M 8 sparse; `dtype`, where given, the program's."""
    cell = registry.workload(bench, cell_name)
    config = copy.deepcopy(registry.config(bench, cell["config"]))
    config["graph"] = dict(TINY_GRAPH)
    sparse = config["bigclam"]["representation"] == "sparse"
    config["bigclam"]["num_communities"] = 40 if sparse else 20
    config["bigclam"]["sparse_m"] = 8
    if dtype:
        config["bigclam"]["dtype"] = dtype
    return cell, config


CELLS = ["yt_k1000.seeded", "yt_k8385_sparse.seeded"]
