"""BENCHMARK.json against the contract's shape, and every part of every cell
found by its name."""

from __future__ import annotations

import re

import pytest

from portbench import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = registry.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]
END_TO_END = [m["name"] for m in BENCH["end_to_end"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32 and not any(w.startswith("/") or ".." in w for w in BENCH["command"])


def test_names_units_and_keys():
    groups = (BENCH["configs"], BENCH["workloads"], BENCH["end_to_end"], BENCH["per_layer"])
    for group in groups:
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in END_TO_END
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    assert "setup_s" in END_TO_END


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    w = registry.cell(BENCH, cell)
    cfg = registry.config(w["config"])
    mix = registry.traffic(w["traffic"])
    assert cfg["name"] == w["config"] and mix["name"] == w["traffic"]
    registry.system(cfg["system"])
    registry.reference(cfg["reference"])
    registry.link(mix["link"])
    assert registry.limits(cell)["numbers"]
    assert registry.metrics_of(BENCH, "per_layer", cell)
    assert len(registry.metrics_of(BENCH, "end_to_end", cell)) >= 2


@pytest.mark.parametrize("name", PER_LAYER)
def test_per_layer_reader_found(name):
    assert callable(registry.per_layer_reader(name))


@pytest.mark.parametrize("name", END_TO_END)
def test_end_to_end_reader_found(name):
    assert callable(registry.end_to_end_reader(name))


def test_config_files_are_configs():
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert registry.config(c["name"])["source"] == c["source"]


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        registry.cell(BENCH, "no_such_cell")
    with pytest.raises(FileNotFoundError):
        registry.per_layer_reader("no_such_metric")
