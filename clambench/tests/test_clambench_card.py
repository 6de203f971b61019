"""On the card (marker `cuda`; skips without one): a short run of each
cell's path at a tiny size through the program's CUDA kernels is correct."""

import time

import pytest
import torch

from conftest import CELLS, tiny_config
from clambench import harness, registry


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_tiny_run_on_the_card(bench, cell_name):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the program's kernels run only on the card")
    cell, config = tiny_config(bench, cell_name)
    result, _ = harness.run(bench, cell, config, registry.mix(cell["traffic"]),
                            registry.limits(cell_name), 9, 1.0, True,
                            time.perf_counter(), device="cuda")
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0
