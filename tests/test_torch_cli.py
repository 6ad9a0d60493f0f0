"""PyTorch port, the command line (``cli.main``, ``python -m
audio_triangulation_tpu_torch``): the cases of ``tests/test_cli.py`` that
are not streams (those are in ``test_torch_cli_stream.py``), run through
the port's CLI with ``--device cpu`` and through the JAX package's CLI with
the same arguments, their printouts compared by one parser
(``torch_cli_helpers.compare_output``), and the files they write compared;
then ``map-room`` and ``bench``, a served request, the refusal without a
card, and (``gpu``) the module entry on the card.

Tolerances, from the measured gaps between the two CLIs on these scenes:
- integers equal: shifts, trigger samples, event counts, wall supports;
- printed positions within 1.5e-3 m (the Localizer tests' 2e-4 m plus the
  last printed digit), TDOAs and angles within the last printed digit plus
  the estimators' test tolerances (see each test);
- PNG files: the same size, and at most 0.5% of pixels differ (a heat
  level at a fraction-of-max threshold); the window plot bit-equal;
- WAV files of the beamformed events within 1e-3 of full scale.
"""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from audio_triangulation_tpu_torch.cli import main as tcli
from audio_triangulation_tpu_torch.core import geometry
from audio_triangulation_tpu_torch.utils import io as audio_io
from audio_triangulation_tpu_torch.utils import synth

from torch_cli_helpers import (compare_output, floats_after, png_pixels,
                               run_both)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _event_wav(tmp_path, name, mics, src, seed, t_len=10000):
    """A WAV of ADC-floor noise with one event burst at sample 4,000."""
    rng = np.random.default_rng(seed)
    fr = synth.synth_scene(src, mics, seed=seed)[0]
    streams = rng.integers(127, 130, size=(mics.shape[0], t_len)).astype(
        np.float64)
    streams[:, 4000:5024] += 110.0 * fr
    wav = str(tmp_path / name)
    audio_io.write_wav(
        wav, np.clip(np.round(streams), 0, 255).astype(np.int16), 50_000)
    return wav


def _sphere(x, y, h=1.2):
    p = np.array([x, y, h])
    return p * (h / np.linalg.norm(p))


def _png_close(ref_path, got_path, max_share=0.005):
    a, b = png_pixels(ref_path), png_pixels(got_path)
    assert a.shape == b.shape
    share = float((a != b).any(axis=-1).mean())
    assert share <= max_share, share


def test_simulate_writes_dashboard(tmp_path, capsys):
    ref_png, got_png = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    from audio_triangulation_tpu.cli import main as jcli

    jcli.main(["simulate", "--out", ref_png, "--x", "0.5", "--y", "0.4"])
    ref = capsys.readouterr().out
    tcli.main(["simulate", "--out", got_png, "--x", "0.5", "--y", "0.4",
               "--device", "cpu"])
    got = capsys.readouterr().out
    assert "estimate" in got
    compare_output(ref, got, tol=0.011, skip=("dashboard ->",))
    with open(got_png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    _png_close(ref_png, got_png)


def test_localize_wav_subspace_methods(tmp_path, capsys):
    """--method music/music-coherent: the WAV as one continuous source,
    localized from snapshot covariances instead of event detection."""
    mics = geometry.circular_array(8, 0.15)
    src = _sphere(0.6, 0.3)
    rng = np.random.default_rng(7)
    chunks = []
    for s in range(10):
        fr = synth.synth_scene(src, mics, n=1024, seed=100 + s,
                               noise_rms=0.0)[0]
        chunks.append(fr + rng.normal(0, 0.01, fr.shape))
    wav = str(tmp_path / "cont.wav")
    audio_io.write_wav(
        wav, (np.concatenate(chunks, axis=-1) * 1000).astype(np.int16),
        50_000)
    for extra in (["--method", "music"],
                  ["--method", "music-coherent", "--band", "800:6000"]):
        ref, got = run_both(capsys, ["localize-wav", wav, "--array",
                                     "circular", "--mics", "8",
                                     "--snapshots", "10", *extra])
        # the MUSIC grid peak: the same cell (the 24 cells/m grid)
        compare_output(ref, got)
        x, y = floats_after(got, "xy=(")
        assert np.hypot(x - 0.6, y - 0.3) < 0.12


def test_gen_window(capsys):
    ref, got = run_both(capsys, ["gen-window", "--length", "64"])
    assert ref == got
    assert "WINDOW_FUNCTION[64]" in got and "0x7fff" in got


def test_calibrate_improves(capsys):
    ref, got = run_both(capsys, ["calibrate", "--events", "16", "--steps",
                                 "30", "--noise", "0.003"])
    # the losses within 2e-4 relative and the geometry errors within
    # 0.02 mm (the training tests' 2e-5 m on the fitted mics)
    compare_output(ref, got, tol=0.02, rel=2e-4)
    line = [ln for ln in got.splitlines() if "geometry error" in ln][0]
    a = float(line.split(":")[1].split("mm")[0])
    b = float(line.split("->")[1].split("mm")[0])
    assert b < a


def test_localize_wav(tmp_path, capsys):
    wav = _event_wav(tmp_path, "scene.wav", geometry.reference_array(),
                     _sphere(0.6, 0.5), 3)
    ref, got = run_both(capsys, ["localize-wav", wav, "--diagnose"])
    assert "event @" in got and "faulty mics none" in got
    # the per-mic consistency scores in us (2 decimals) and the rms in s
    compare_output(ref, got, tol=0.011, rel=1e-2)

    ref_dst, got_dst = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    from audio_triangulation_tpu.cli import main as jcli

    jcli.main(["localize-wav", wav, "--extract", ref_dst,
               "--extract-method", "das"])
    capsys.readouterr()
    tcli.main(["localize-wav", wav, "--extract", got_dst,
               "--extract-method", "das", "--device", "cpu"])
    assert "extracted (das)" in capsys.readouterr().out
    mono, rate = audio_io.read_wav(str(tmp_path / "t_000.wav"))
    ref_mono, _ = audio_io.read_wav(str(tmp_path / "j_000.wav"))
    assert rate == 50_000 and mono.shape == (1, 1024)
    full = float(np.abs(ref_mono).max())
    assert np.abs(mono.astype(np.float64) - ref_mono).max() <= 1e-3 * full


def test_localize_wav_dereverb(tmp_path, capsys):
    wav = _event_wav(tmp_path, "scene.wav", geometry.reference_array(),
                     _sphere(0.6, 0.5), 3)
    ref, got = run_both(capsys, ["localize-wav", wav, "--dereverb"])
    assert "dereverberated: WPE frame=1024" in got and "event @" in got
    compare_output(ref, got)


def test_module_entry_runs_the_port(tmp_path):
    """``python -m audio_triangulation_tpu_torch`` is the port's CLI (the
    package's ``__main__``), and it imports no JAX."""
    code = ("import runpy, sys; sys.argv = ['x', 'gen-window', '--length', "
            "'64', '--device', 'cpu']; "
            "runpy.run_module('audio_triangulation_tpu_torch', "
            "run_name='__main__'); "
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('audio_triangulation_tpu.')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "static const int32_t WINDOW_FUNCTION[64] = {"
    assert lines[-1] == "[]"


def test_doa_command(capsys):
    ref, got = run_both(capsys, ["doa", "--azimuth", "84.0"])
    # 1-degree azimuth cells and the LS bearing: within 0.02 deg
    compare_output(ref, got, tol=0.02)
    est = float([ln for ln in got.splitlines() if "SRP estimate" in ln][0]
                .split(":")[1].split("deg")[0])
    assert abs(est - 84.0) < 4.0


def test_gen_window_plot(tmp_path, capsys):
    ref_png, got_png = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    from audio_triangulation_tpu.cli import main as jcli

    jcli.main(["gen-window", "--length", "128", "--plot", ref_png])
    tcli.main(["gen-window", "--length", "128", "--plot", got_png,
               "--device", "cpu"])
    capsys.readouterr()
    with open(got_png, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    with open(ref_png, "rb") as f:
        assert f.read() == data


def test_doa_music_method(capsys):
    ref, got = run_both(capsys, ["doa", "--azimuth", "137", "--method",
                                 "music", "--snapshots", "8"])
    compare_output(ref, got, tol=0.02)
    import re

    est = float(re.search(r"MUSIC estimate:\s+([0-9.]+)", got).group(1))
    assert abs(est - 137.0) < 4.0


def test_evaluate_manifest(tmp_path, capsys):
    mics = geometry.reference_array()
    entries = []
    for i, (x, y) in enumerate([(0.6, 0.5), (-0.4, 0.7)]):
        wav = _event_wav(tmp_path, f"scene{i}.wav", mics, _sphere(x, y),
                         10 + i)
        entries.append({"wav": wav, "x": x, "y": y})
    manifest = str(tmp_path / "manifest.json")
    with open(manifest, "w") as f:
        json.dump(entries, f)
    ref_rep, got_rep = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    from audio_triangulation_tpu.cli import main as jcli

    jcli.main(["evaluate", manifest, "--out", ref_rep])
    ref = capsys.readouterr().out
    tcli.main(["evaluate", manifest, "--out", got_rep, "--device", "cpu"])
    got = capsys.readouterr().out
    assert '"summary"' in got
    # xy printed to 1e-4 m, errors to 1e-2 cm: within 2e-4 m / 0.03 cm
    compare_output(ref, got, tol=0.03)
    with open(got_rep) as f:
        rep = json.load(f)
    with open(ref_rep) as f:
        jrep = json.load(f)
    assert rep["summary"]["files"] == 2
    assert rep["summary"]["detection_rate"] == 1.0
    assert rep["summary"]["xy_err_median_cm"] < 15.0
    assert all(r["detected"] for r in rep["rows"])
    assert [r["detected"] for r in rep["rows"]] == [
        r["detected"] for r in jrep["rows"]]


def test_simulate_volume(tmp_path, capsys):
    ref_png, got_png = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    args = ["simulate", "--volume", "--array", "tetra", "--x", "0.5", "--y",
            "-0.3", "--height", "1.4", "--phat", "--band", "700:7000"]
    from audio_triangulation_tpu.cli import main as jcli

    jcli.main(args + ["--out", ref_png])
    ref = capsys.readouterr().out
    tcli.main(args + ["--out", got_png, "--device", "cpu"])
    got = capsys.readouterr().out
    assert "estimate: (" in got and "volume view ->" in got
    # free xyz of a 30 cm tetrahedron: held in measurement space by the
    # volume tests; printed positions here within 5 mm, TDOAs 0.02 samples
    compare_output(ref, got, tol=0.02, skip=("volume view ->",))
    est = floats_after(got, "estimate: (")
    assert abs(est[0] - 0.5) < 0.15 and abs(est[1] + 0.3) < 0.15
    assert abs(est[2] - 1.4) < 0.25
    assert os.path.getsize(got_png) > 500
    _png_close(ref_png, got_png)


def test_localize_wav_volume(tmp_path, capsys):
    mics = geometry.tetrahedral_array(0.3)
    wav = _event_wav(tmp_path, "scene3d.wav", mics,
                     np.array([0.4, 0.3, 1.2]), 5)
    ref, got = run_both(capsys, ["localize-wav", wav, "--array", "tetra",
                                 "--volume", "--phat", "--band",
                                 "700:7000"])
    assert "xyz=(" in got
    compare_output(ref, got, tol=0.005)
    est = floats_after(got, "xyz=(")
    assert abs(est[0] - 0.4) < 0.2 and abs(est[1] - 0.3) < 0.2
    assert abs(est[2] - 1.2) < 0.35


def test_map_room(capsys):
    ref, got = run_both(capsys, ["map-room", "--events", "3"])
    # wall normals and distances to 1e-2, supports equal, rms in cm
    compare_output(ref, got, tol=0.011, rel=0.05)
    assert "mapped walls" in got


def test_bench_prints_the_three_lines(capsys):
    """``bench`` runs the port's ``tools.bench``: the root bench.py's three
    metric lines (names as the JAX package's bench prints them)."""
    tcli.main(["bench", "--batch", "8", "--trials", "1", "--device",
               "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    from audio_triangulation_tpu_torch.tools import bench

    assert [ln["metric"] for ln in lines] == [
        bench.METRIC + suffix for suffix, _, _ in bench.CONFIGS]
    assert all(ln["value"] > 0 and ln["batch"] == 8 for ln in lines)


def test_serve_answers_a_request():
    """``serve`` in a subprocess on an ephemeral port answers /healthz and
    one /localize with the Localizer's own result on the same frames."""
    from audio_triangulation_tpu_torch import Localizer, PipelineConfig

    proc = subprocess.Popen(
        [sys.executable, "-m", "audio_triangulation_tpu_torch", "serve",
         "--port", "0", "--device", "cpu"], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        t0, line = time.time(), ""
        while "serving on" not in line:
            assert proc.poll() is None, proc.stderr.read()
            assert time.time() - t0 < 60, "no serving line within 60 s"
            line = proc.stdout.readline()
        url = line.split()[2]
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health == {"ok": True, "backend": "cpu", "mics": 3}
        mics = geometry.reference_array()
        frames = synth.synth_scene(_sphere(0.5, 0.4), mics, seed=2)
        frames = np.repeat(frames, 2, axis=0).astype(np.float32)
        req = urllib.request.Request(
            url + "/localize", data=json.dumps(
                {"frames": frames.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        loc = Localizer.create(mics, PipelineConfig(), device="cpu")
        out = loc(torch.as_tensor(frames))
        np.testing.assert_array_equal(np.asarray(body["best_shift"]),
                                      out["best_shift"].numpy())
        np.testing.assert_array_equal(np.asarray(body["xy"], np.float32),
                                      out["xy"].numpy())
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


@pytest.mark.parametrize("cmd", [["simulate"], ["gen-window"],
                                 ["stream", "--duration-samples", "4096"]])
def test_refuses_without_a_card(cmd, monkeypatch):
    """Without a CUDA device and without ``--device cpu`` a command stops
    with the reason; it does not carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        tcli.main(cmd)


@pytest.mark.gpu
def test_module_entry_on_the_card(tmp_path):
    """``python -m audio_triangulation_tpu_torch simulate`` on the card
    (its default device), its estimate within 1.5e-3 m of the CPU run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    outs = {}
    for dev in ("cuda", "cpu"):
        out = subprocess.run(
            [sys.executable, "-m", "audio_triangulation_tpu_torch",
             "simulate", "--out", str(tmp_path / f"{dev}.png"),
             "--device", dev], capture_output=True, text=True, cwd=REPO,
            timeout=600)
        assert out.returncode == 0, out.stderr
        outs[dev] = out.stdout
    compare_output(outs["cpu"], outs["cuda"], tol=0.011,
                   skip=("dashboard ->",))
