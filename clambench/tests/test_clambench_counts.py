"""The frozen counts reproduce the port's recorded bounds."""

import pytest

from clambench import counts

FULL = dict(n=300_000, e=8_512_796, k=1000, s=16)   # the repo's `full` graph


def test_fused_superstep_bound_at_full():
    b = counts.fused_superstep_bound(**FULL)
    assert b["bound_ms"] == pytest.approx(5.06, abs=0.005)
    assert b["bound_by"] == "operations"


def test_member_lookup_bound_is_bytes_bound():
    b = counts.member_bound(1_134_890, 5_979_498, 64)
    assert b["bound_by"] == "bytes"
    assert b["bytes"] == 8.0 * 1_134_890 * 64 + 16.0 * 5_979_498 + 4.0 * 5_979_498 * 64


def test_step_bounds_cover_their_kernel_work():
    dense = counts.dense_step(**FULL)
    fused = counts.fused_superstep_bound(**FULL)
    assert dense["ops"] > fused["ops"]
    sparse = counts.sparse_step(FULL["n"], FULL["e"], 64, 1000, 16)
    assert sparse["ops"] > counts.member_bound(FULL["n"], FULL["e"], 64)["ops"]
