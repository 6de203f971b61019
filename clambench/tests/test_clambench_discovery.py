"""Configurations, mixes, limits and metric readers are found by name, and
a new file is picked up without an edit."""

import json
import shutil

import pytest

from clambench import registry


def test_every_named_file_exists(bench):
    for cfg in bench["configs"]:
        assert (registry.REPO / cfg["file"]).is_file()
        assert registry.config(bench, cfg["name"])["source"] == cfg["source"]
    for cell in bench["workloads"]:
        registry.mix(cell["traffic"])
        assert set(registry.limits(cell["name"])) >= {"llh_rel", "seeds", "edges"}
    for m in bench["per_layer"]:
        reader = registry.metric(m["name"])
        assert reader.MOVES == m["moves"]
        assert callable(reader.read)


def test_each_cell_reports_a_per_layer_metric(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for cell in bench["workloads"]:
        entries = registry.per_layer_for(bench, cell["name"])
        assert entries and {m["moves"] for m in entries} <= e2e


@pytest.mark.parametrize("kind,body", [
    ("metrics", "MOVES = 'edges_per_s'\n\ndef read(record):\n    return 1.5\n"),
    ("traffic", json.dumps({"graph": {"kind": "agm_powerlaw"}})),
    ("limits", json.dumps({"llh_rel": 1.0})),
])
def test_a_new_file_is_found(tmp_path, kind, body):
    root = tmp_path / "clambench"
    shutil.copytree(registry.HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    suffix = ".py" if kind == "metrics" else ".json"
    (root / kind / f"brand_new{suffix}").write_text(body)
    assert "brand_new" in registry.names(kind, root)
    if kind == "metrics":
        assert registry.metric("brand_new", root).read(None) == 1.5
    elif kind == "traffic":
        assert registry.mix("brand_new", root)["graph"]["kind"] == "agm_powerlaw"
    else:
        assert registry.limits("brand_new", root) == {"llh_rel": 1.0}


def test_per_layer_without_a_list_follows_its_end_to_end_metric():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
             "per_layer": [{"name": "p", "moves": "a"}, {"name": "q", "moves": "b"},
                           {"name": "r", "moves": "a", "workloads": ["y"]}]}
    assert [m["name"] for m in registry.per_layer_for(bench, "x")] == ["p", "q"]
    assert [m["name"] for m in registry.per_layer_for(bench, "y")] == ["p", "r"]
