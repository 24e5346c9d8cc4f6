"""BENCHMARK.json against the benchmark's contract: names, units, keys,
bounds, and every file a cell, configuration, driver or metric needs."""

import json
import re

import pytest

from portbench import harness

M = harness.manifest()
HERE = harness.HERE
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(M) == KEYS
    assert (harness.CHECKOUT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= M["run_seconds"] <= 51
    assert M["paths"] == ["portbench"]
    assert len(M["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in M["command"])


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source",
                    "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves",
                   "workloads"}),
])
def test_entries_have_only_contract_keys(section, keys):
    names = [e["name"] for e in M[section]]
    assert len(names) == len(set(names))
    for e in M[section]:
        assert set(e) <= keys, e["name"]
        assert NAME.match(e["name"]), e["name"]


def test_units_better_sources_and_bounds():
    for e in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(e["unit"]), e["name"]
        assert e["better"] in ("lower", "higher")
    for e in M["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25, e["name"]
    for e in M["per_layer"]:
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(e["layer"])


def test_setup_s_everywhere_and_each_cell_reports_enough():
    e2e = {e["name"]: e for e in M["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in M["workloads"]:
        mine = [e for e in M["end_to_end"]
                if w["name"] in e.get("workloads", [w["name"]])]
        assert len(mine) >= 2, w["name"]
        assert any(w["name"] in e["workloads"] for e in M["per_layer"])


def test_per_layer_cells_report_what_they_move():
    e2e = {e["name"]: e for e in M["end_to_end"]}
    layers = {}
    for e in M["per_layer"]:
        moved = e2e[e["moves"]]
        for cell in e["workloads"]:
            assert cell in moved.get("workloads", [cell]), (e["name"], cell)
        layers.setdefault(e["layer"], []).append(e["name"])
    assert layers


def test_cells_configs_and_their_files():
    configs = {c["name"]: c for c in M["configs"]}
    pairs = set()
    for w in M["workloads"]:
        assert w["chips"] in (1, 4)
        assert LINE.match(w["why"])
        assert w["config"] in configs
        pairs.add((w["config"], w["traffic"]))
        cell = harness.load_json("workloads", w["name"])
        assert cell["config"] == w["config"]
        assert (HERE / "drivers" / f"{cell['driver']}.py").exists()
        cfg = harness.load_json("configs", cell["config"])
        assert (HERE / "topologies" / f"{cfg['topology']}.py").exists()
    assert len(pairs) == len(M["workloads"])
    assert sum(w["chips"] == 4 for w in M["workloads"]) <= 1
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert c["name"] in used
        assert LINE.match(c["source"]) and c["source"].startswith("https://")
        path = harness.CHECKOUT / c["file"]
        assert path.exists() and c["file"].startswith("portbench/")
        data = json.loads(path.read_text())
        assert len(c["reduced"]) <= 16
        assert set(c["reduced"]) == set(data["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank"))
            assert key in data


def test_every_per_layer_metric_has_a_reader():
    for e in M["per_layer"]:
        mod = harness.metric_reader(e["name"])
        assert callable(mod.read)


def test_files_under_paths_are_named_from_name_characters():
    for p in HERE.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(harness.CHECKOUT).as_posix()
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel
