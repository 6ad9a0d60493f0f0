"""PyTorch port, accuracy floors on the committed evaluation dataset
(``tests/data/eval``: 20 labeled 3-channel WAV scenes, anechoic and
reverberant, several SNRs): the cases of ``tests/test_eval_dataset.py``
with the same floors, on the port's ``evaluate`` (``--device cpu``), and
its report held to the JAX CLI's on the same manifest: the same detected
files, positions within 2e-4 m (printed to 1e-4 m) and errors within
0.03 cm."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import json
import os

import numpy as np
import pytest

DATA = os.path.join(os.path.dirname(__file__), "data", "eval")
MANIFEST = os.path.join(DATA, "manifest.json")


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    from audio_triangulation_tpu.cli import main as jcli
    from audio_triangulation_tpu_torch.cli import main as tcli

    out = {}
    for name, cli, extra in (("jax", jcli, []),
                             ("port", tcli, ["--device", "cpu"])):
        path = str(tmp_path_factory.mktemp("eval") / f"{name}.json")
        cli.main(["evaluate", MANIFEST, "--out", path, *extra])
        with open(path) as f:
            out[name] = json.load(f)
    return out


@pytest.fixture(scope="module")
def report(reports):
    return reports["port"]


def test_dataset_is_committed_and_complete(reports):
    with open(MANIFEST) as f:
        entries = json.load(f)
    assert len(entries) == 20
    for e in entries:
        assert os.path.exists(os.path.join(DATA, e["wav"])), e["wav"]
    # and the port's report agrees with the JAX CLI's, file by file
    ref, got = reports["jax"], reports["port"]
    assert [r["wav"] for r in got["rows"]] == [r["wav"] for r in ref["rows"]]
    for a, b in zip(ref["rows"], got["rows"]):
        assert a["detected"] == b["detected"], (a, b)
        if b["detected"]:
            np.testing.assert_allclose(b["xy"], a["xy"], atol=2e-4)
            assert abs(b["err_cm"] - a["err_cm"]) <= 0.03, (a, b)


def test_detection_rate_floor(report):
    assert report["summary"]["detection_rate"] >= 0.95, report["summary"]


def test_median_error_floor(report):
    assert report["summary"]["xy_err_median_cm"] < 2.0, report["summary"]
    assert report["summary"]["xy_err_p90_cm"] < 20.0, report["summary"]


def test_per_condition_floors(report):
    with open(MANIFEST) as f:
        entries = json.load(f)
    kind_by_wav = {e["wav"]: e["kind"] for e in entries}
    errs = {}
    for row in report["rows"]:
        if row.get("detected"):
            errs.setdefault(kind_by_wav[row["wav"]], []).append(
                row["err_cm"])
    floors = {"anechoic_hi": 1.0, "anechoic_lo": 2.0,
              "reverb_light": 8.0, "reverb_mod": 15.0}
    for kind, floor in floors.items():
        assert errs.get(kind), f"no detections for {kind}"
        med = float(np.median(errs[kind]))
        assert med < floor, (kind, med, sorted(errs[kind]))
