"""PyTorch port, the command line's ``stream`` subcommand: the stream cases
of ``tests/test_cli.py`` and ``test_transport.py::
test_stream_cli_source_flag``, run through the port's CLI with ``--device
cpu`` and through the JAX package's CLI with the same arguments, their
printouts compared by one parser (``torch_cli_helpers.compare_output``:
trigger samples, shifts, event counts and track ids equal; printed
positions within 1.5e-3 m, track velocities within 0.011 m/s and sigmas
within 1.5e-3 m, the last printed digit over the tracking tests' 1e-3),
and the files they write compared (frame sequences by count and pixels,
extracted audio within 1e-3 of full scale)."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import os

import numpy as np
import pytest

from audio_triangulation_tpu_torch.cli import main as tcli
from audio_triangulation_tpu_torch.core import geometry
from audio_triangulation_tpu_torch.runtime import native_rt, transport
from audio_triangulation_tpu_torch.utils import io as audio_io
from audio_triangulation_tpu_torch.utils import synth

from torch_cli_helpers import compare_output, png_pixels, run_both


def _jcli():
    from audio_triangulation_tpu.cli import main as jcli

    return jcli


def test_stream_demo(capsys):
    ref, got = run_both(capsys, ["stream", "--duration-samples", "16000",
                                 "--chunk", "512"])
    assert "event @" in got and "native events" in got
    compare_output(ref, got)


def test_stream_dereverb_flag(capsys):
    ref, got = run_both(capsys, ["stream", "--duration-samples", "16000",
                                 "--chunk", "512", "--dereverb"])
    assert "dereverb: WPE frame=1024 hop=256" in got and "event @" in got
    compare_output(ref, got)


def test_stream_checkpoint_resume(tmp_path, capsys):
    outs = {}
    for name, cli, extra in (("jax", _jcli(), []),
                             ("port", tcli, ["--device", "cpu"])):
        ck = str(tmp_path / f"{name}_state")
        cli.main(["stream", "--duration-samples", "12000", "--chunk", "512",
                  "--checkpoint", ck, *extra])
        first = capsys.readouterr().out
        cli.main(["stream", "--duration-samples", "12000", "--chunk", "512",
                  "--checkpoint", ck, "--seed", "1", *extra])
        outs[name] = (first, capsys.readouterr().out)
    assert "state ->" in outs["port"][0]
    assert "resumed from" in outs["port"][1]
    for ref, got in zip(outs["jax"], outs["port"]):
        compare_output(ref, got, skip=("state ->", "resumed from"))
    # the resumed event count is the first run's, in both
    resumed = [ln.split("(")[1] for o in (outs["jax"], outs["port"])
               for ln in o[1].splitlines() if "resumed from" in ln]
    assert resumed[0] == resumed[1]


def test_stream_track_resumes_plain_checkpoint(tmp_path, capsys):
    """A checkpoint saved without --track resumes under --track: the
    streaming state restored, the tracker fresh, with a note."""
    outs = {}
    for name, cli, extra in (("jax", _jcli(), []),
                             ("port", tcli, ["--device", "cpu"])):
        ck = str(tmp_path / f"{name}_plain")
        cli.main(["stream", "--duration-samples", "12000", "--chunk", "512",
                  "--checkpoint", ck, *extra])
        capsys.readouterr()
        cli.main(["stream", "--duration-samples", "12000", "--chunk", "512",
                  "--checkpoint", ck, "--seed", "1", "--track", *extra])
        outs[name] = capsys.readouterr().out
    assert "tracker state starts fresh" in outs["port"]
    assert "resumed from" in outs["port"]
    compare_output(outs["jax"], outs["port"], tol=0.011,
                   skip=("state ->", "resumed from", "note: checkpoint"))


def test_stream_refresh_hz_free_runs(tmp_path, capsys):
    """--refresh-hz redraws on a stream-time timer whether or not an event
    arrived: a quiet stream still gives the full frame sequence, the same
    frames as the JAX CLI's."""
    dirs = {k: tmp_path / k for k in ("jax", "port")}
    args = ["stream", "--duration-samples", "15000", "--noise", "0.0",
            "--seed", "3", "--refresh-hz", "100"]
    _jcli().main(args + ["--frames-dir", str(dirs["jax"])])
    ref = capsys.readouterr().out
    tcli.main(args + ["--frames-dir", str(dirs["port"]), "--device", "cpu"])
    got = capsys.readouterr().out
    compare_output(ref, got, skip=("dashboard frames ->",))
    frames = sorted(dirs["port"].glob("frame_*.png"))
    ref_frames = sorted(dirs["jax"].glob("frame_*.png"))
    assert len(frames) == 30 == len(ref_frames), got
    assert frames[0].stat().st_size > 100
    for a, b in zip(ref_frames, frames):
        pa, pb = png_pixels(str(a)), png_pixels(str(b))
        assert pa.shape == pb.shape
        assert float((pa != pb).any(axis=-1).mean()) <= 0.005


def test_stream_track_flag(capsys):
    ref, got = run_both(capsys, ["stream", "--duration-samples", "28000",
                                 "--chunk", "512", "--track"])
    assert "track #1: spawned" in got
    assert "track #1*:" in got and "sigma=" in got
    compare_output(ref, got, tol=0.011)


def _extract(tmp_path, capsys, name, chunk, t_len):
    paths = {k: str(tmp_path / f"{k}_{name}") for k in ("jax", "port")}
    args = ["stream", "--duration-samples", str(t_len), "--chunk",
            str(chunk)]
    _jcli().main(args + ["--extract", paths["jax"]])
    ref = capsys.readouterr().out
    tcli.main(args + ["--extract", paths["port"], "--device", "cpu"])
    got = capsys.readouterr().out
    assert "extracted" in got
    compare_output(ref, got, skip=("extracted",))
    samples, rate = audio_io.read_wav(paths["port"])
    ref_samples, _ = audio_io.read_wav(paths["jax"])
    assert samples.shape == ref_samples.shape
    full = float(np.abs(ref_samples).max())
    assert np.abs(samples.astype(np.float64) - ref_samples).max() \
        <= 1e-3 * full
    return samples, rate


def test_stream_extract_writes_wav(tmp_path, capsys):
    samples, rate = _extract(tmp_path, capsys, "vmic.wav", 512, 16000)
    assert rate == 50_000 and samples.shape[0] == 1
    # latency-trimmed: the whole chunks processed minus the WOLA latency
    assert samples.shape[1] == (16000 // 512) * 512 - 256
    assert np.max(np.abs(samples)) > 1000


def test_stream_extract_odd_chunk_derives_hop(tmp_path, capsys):
    """--chunk 640 has no 256 divisor; the CLI derives hop=128."""
    samples, _ = _extract(tmp_path, capsys, "vmic640.wav", 640, 12800)
    assert samples.shape[1] == 12800 - 384


def test_stream_extract_rejects_live_mode():
    for cli, extra in ((_jcli(), []), (tcli, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="not supported with --source"):
            cli.main(["stream", "--source", "fifo:///tmp/nonexistent.fifo",
                      "--extract", "/tmp/x.wav", *extra])


def _scene_pcm(t_len=30_000, event_at=9_000, seed=0):
    """[T, 3] int16 interleaved stream with one known event burst."""
    mics = geometry.reference_array()
    src = np.array([0.5, 0.4, 1.2])
    src = src * 1.2 / np.linalg.norm(src)
    rng = np.random.default_rng(seed)
    streams = rng.integers(127, 130, size=(3, t_len)).astype(np.float64)
    frame = synth.synth_scene(src, mics, noise_rms=0.0, seed=seed)[0]
    streams[:, event_at: event_at + 1024] += 110.0 * frame
    return (np.clip(np.round(streams), 0, 255).astype(np.int16).T.copy(),
            src[:2])


@pytest.mark.skipif(not native_rt.native_available(),
                    reason="native toolchain unavailable")
@pytest.mark.parametrize("flags", [[], ["--track"]], ids=["plain", "track"])
def test_stream_cli_source_flag(tmp_path, capsys, flags):
    """`stream --source fifo://...` end to end: transported PCM -> native
    detector -> the port's EventPump -> per-event localization printed (and
    with --track the host tracker's line), as the JAX CLI prints."""
    pcm, plane = _scene_pcm(seed=5)
    outs = {}
    for name, cli, extra in (("jax", _jcli(), []),
                             ("port", tcli, ["--device", "cpu"])):
        path = str(tmp_path / f"{name}.fifo")
        os.mkfifo(path)
        transport.stream_pcm_to_fifo(path, pcm)
        cli.main(["stream", "--source", f"fifo://{path}", "--max-seconds",
                  "20", *flags, *extra])
        outs[name] = capsys.readouterr().out
    out = outs["port"]
    assert "source closed" in out and "1 events detected" in out
    lines = [ln for ln in out.splitlines() if ln.startswith("event @")]
    assert len(lines) == 1
    xy = np.array([float(v) for v in
                   lines[0].split("xy=(")[1].split(")")[0].split(",")])
    assert np.linalg.norm(xy - plane) < 0.1, (xy, plane)
    if flags:
        assert "track #1: spawned" in out
    compare_output(outs["jax"], out, skip=("attached",))
