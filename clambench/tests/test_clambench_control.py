"""The comparison fails what it has to fail, at a size a test run holds:
the control (the reference in bfloat16 put in the program's place) and
each planted fault, under the cells' own limits; sound runs pass."""

import time

import pytest
import torch

from conftest import CELLS, tiny_config
from clambench import compare, faults, harness, readings, registry

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell_name", CELLS)
def test_control_is_not_correct(bench, cell_name):
    cell, config = tiny_config(bench, cell_name)
    values = readings.control_readings(config, registry.mix(cell["traffic"]), 3, CPU)
    ok, _ = compare.judge(values, registry.limits(cell_name))
    assert not ok, values


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_planted_fault_is_not_correct(bench, cell_name, fault):
    cell, config = tiny_config(bench, cell_name)
    result, _ = harness.run(bench, cell, config, registry.mix(cell["traffic"]),
                            registry.limits(cell_name), 3, 0.3, False,
                            time.perf_counter(), device="cpu",
                            step_fault=faults.FAULTS[fault])
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell_name", CELLS)
def test_sound_runs_are_correct(bench, cell_name):
    """In float64: at 2,000 nodes one row in another accepted step is a
    share of 5e-4, where the limits were read at 1.13M nodes in float32."""
    cell, config = tiny_config(bench, cell_name, dtype="float64")
    for seed in (1, 2**31 + 3):
        values = readings.side_readings(config, registry.mix(cell["traffic"]), seed, CPU)
        ok, rows = compare.judge(values, registry.limits(cell_name))
        assert ok, rows


def test_judge_wants_every_number_and_no_other():
    assert compare.judge({"a": 1.0}, {"a": 1.0})[0]
    assert not compare.judge({"a": 1.0}, {"a": 0.5})[0]
    assert not compare.judge({"a": 1.0}, {"a": 1.0, "b": 1.0})[0]
    assert not compare.judge({"a": 1.0, "b": 0.0}, {"a": 1.0})[0]
