"""The benchmark's files: every cell's files found by its names, names and
units within the allowed characters, and no module of the benchmark that
loads JAX or the JAX package."""

import ast
import json
import re
from pathlib import Path

import pytest

from benchmark import spec as spec_mod

HERE = Path(__file__).resolve().parent
SPEC = spec_mod.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "audio_triangulation_tpu"}
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w = spec_mod.workload(SPEC, cell)
    config = spec_mod.config_of(SPEC, w)
    assert config["name"] == w["config"]
    traffic = spec_mod.traffic_of(w)
    assert hasattr(spec_mod.kind_module(traffic["kind"]), "run")
    limits, margins = spec_mod.limits_of(w)
    kind = spec_mod.kind_module(traffic["kind"])
    assert set(limits) == set(kind.NUMBERS)
    assert set(margins) == set(kind.MARGINS)
    metrics = spec_mod.per_layer_of(SPEC, cell)
    assert metrics, "every cell reports a per-layer metric"
    for m in metrics:
        assert callable(spec_mod.reader(m["name"]))
    e2e = {m["name"] for m in spec_mod.end_to_end_of(SPEC, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert w["chips"] == 1


def test_names_and_units():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in SPEC["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    metric_names = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in metric_names
        assert 1 <= len(m["layer"]) <= 200


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.add(node.module.split(".")[0])
    return found


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not (_imports(path) & FORBIDDEN), path


@pytest.mark.parametrize("name", ["reference.py", "scenes.py",
                                  "roofline.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    assert "audio_triangulation_tpu_torch" not in _imports(HERE / name)


def test_forbidden_names_compare_whole():
    from benchmark.run import FORBIDDEN as RUN_FORBIDDEN, loaded_forbidden

    assert set(RUN_FORBIDDEN) == FORBIDDEN
    assert "audio_triangulation_tpu_torch".split(".")[0] not in FORBIDDEN
    import sys

    sys.modules.setdefault("audio_triangulation_tpu_torch_probe", sys)
    assert "audio_triangulation_tpu_torch_probe" not in loaded_forbidden()
    del sys.modules["audio_triangulation_tpu_torch_probe"]
