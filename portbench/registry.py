"""Finds every part of a cell by its name.

- `BENCHMARK.json` at the root of the checkout: the cells and metrics.
- `configs/<config>.json`: a configuration's sizes and source; its
  ``system`` names the module under `systems/` that builds the program's
  step, its ``reference`` the module under `reference/` that checks it.
- `traffic/<mix>.json`: a mix's parameters; its ``link`` names the module
  under `links/` (what the pipeline is fed and hands back).
- `limits/<cell>.json`: the numbers a cell's output is compared by, each
  with its limit and the readings it was set from.
- `end_to_end/<metric>.py`, `metrics/<metric>.py`: one reader a metric,
  loaded from its file (metric names hold dots).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return read_json(path)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return read_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return read_json(HERE / "traffic" / f"{name}.json")


def limits(cell_name: str) -> dict:
    return read_json(HERE / "limits" / f"{cell_name}.json")


def system(name: str):
    return importlib.import_module(f"portbench.systems.{name}")


def link(name: str):
    return importlib.import_module(f"portbench.links.{name}")


def reference(name: str):
    return importlib.import_module(f"portbench.reference.{name}")


def _reader(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name.replace('.', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def end_to_end_reader(name: str):
    return _reader("end_to_end", name)


def per_layer_reader(name: str):
    return _reader("metrics", name)


def metrics_of(bench: dict, kind: str, cell_name: str) -> list[dict]:
    """The entries of `kind` ("end_to_end" or "per_layer") that `cell_name`
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[kind] if "workloads" not in m or cell_name in m["workloads"]]
