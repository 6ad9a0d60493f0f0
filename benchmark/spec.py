"""Finds everything a run needs by the names in ``BENCHMARK.json``.

A cell (``workloads`` entry) names a configuration and a traffic mix; the
configuration's file is the one ``configs`` gives it, the traffic mix is
``traffic/<traffic>.json``, the cell's correctness limits are
``limits/<cell>.json``, a per-layer metric's reader is
``metrics/<metric>.py`` and a traffic kind's loop is
``kinds/<kind>.py``.  Adding a cell, a mix, a metric or a kind adds files
and entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_spec(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(spec: dict, name: str) -> dict:
    return _by_name(spec["workloads"], name, "workload")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config_of(spec: dict, cell: dict, root: Path = ROOT) -> dict:
    entry = _by_name(spec["configs"], cell["config"], "configuration")
    return _json(Path(root) / entry["file"])


def traffic_path(name: str) -> Path:
    return HERE / "traffic" / f"{name}.json"


def traffic_of(cell: dict) -> dict:
    return _json(traffic_path(cell["traffic"]))


def limits_path(cell_name: str) -> Path:
    return HERE / "limits" / f"{cell_name}.json"


def limits_of(cell: dict) -> tuple:
    """The cell's correctness limits (number name -> limit) and decision
    margins (name -> margin)."""
    data = _json(limits_path(cell["name"]))
    return data["limits"], data.get("margins", {})


def metric_path(name: str) -> Path:
    return HERE / "metrics" / f"{name}.py"


def kind_module(kind: str):
    """The module of a traffic kind (``kinds/<kind>.py``)."""
    return importlib.import_module(f"benchmark.kinds.{kind}")


def reader(name: str):
    """The ``read(readings)`` function of a per-layer metric's file."""
    path = metric_path(name)
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def end_to_end_of(spec: dict, cell_name: str) -> list:
    """The end-to-end metrics a cell reports: those listing it, and those
    that list no cells."""
    return [m for m in spec["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer_of(spec: dict, cell_name: str) -> list:
    """The per-layer metrics a cell's traced run reports: those listing it,
    and those listing no cells whose ``moves`` the cell reports."""
    moved = {m["name"] for m in end_to_end_of(spec, cell_name)}
    return [m for m in spec["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]
