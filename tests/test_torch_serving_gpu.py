"""PyTorch port, live serving on the card (every test is ``gpu``-marked and
skips without a CUDA device; this file imports no JAX, so it runs on a
machine that has none): the feeder's pinned ring and side-stream copies,
the localizer captured as a CUDA graph (replays bit-equal to eager calls),
the persistent kernel build, the launch counters under many threads and
the stage timer's CUDA events.  Each is held to the plain PyTorch
computation or the eager call on the same inputs.

    python -m pytest tests/test_torch_serving_gpu.py -m gpu -q
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from audio_triangulation_tpu_torch import Localizer, PipelineConfig, geometry
from audio_triangulation_tpu_torch.ops.cuda import detector_scan
from audio_triangulation_tpu_torch.runtime.feeder import DoubleBufferedFeeder
from audio_triangulation_tpu_torch.utils import profiling, serving, synth

SQUARE = geometry.square_array(0.3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (streams, pinned memory, graphs)")
    return torch.device("cuda")


def _square_frames(b, seed=0):
    src = np.array([0.5, 0.4, 1.2]) * (1.2 / np.linalg.norm([0.5, 0.4, 1.2]))
    f = synth.synth_scene(src, SQUARE, noise_rms=0.01, seed=seed)
    return np.broadcast_to(f, (b, 4, 1024)).astype(np.float32).copy()


@pytest.mark.gpu
def test_feeder_on_the_card(cuda_device):
    """Pinned ring, side-stream copies ordered by events and
    ``record_stream``: every batch arrives equal and in order while the
    consumer computes on the previous one, at depths 1-3."""
    rng = np.random.default_rng(0)
    batches = [rng.normal(size=(64, 4, 1024)).astype(np.float32)
               for _ in range(9)]
    for depth in (1, 2, 3):
        feeder = DoubleBufferedFeeder(iter(batches), depth=depth)
        doubled = [b * 2 for b in feeder]  # exact: compared bit for bit
        torch.cuda.synchronize()
        assert len(doubled) == len(batches)
        assert all(buf is None or buf.is_pinned() for buf in feeder._pinned)
        for d, b in zip(doubled, batches):
            assert d.is_cuda
            assert torch.equal(d.cpu(), torch.from_numpy(b * 2))


@pytest.mark.gpu
def test_aot_compile_replays_bit_equal(cuda_device):
    loc = Localizer.create(SQUARE, PipelineConfig(phat=True), device="cuda")
    g = serving.aot_compile(loc, batch=64)
    for seed in (0, 1):
        frames = torch.from_numpy(_square_frames(64, seed)).cuda()
        frames = frames + 0.01 * torch.randn_like(frames)
        want = loc(frames)
        got = g(frames)
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.gpu
def test_exported_artifact_on_the_card(cuda_device):
    """The plain-torch artifact on the card: within the CPU path's
    tolerance of the kernel route (xy 2e-4 m, tdoa 1e-3 samples)."""
    loc = Localizer.create(SQUARE, PipelineConfig(phat=True), device="cuda")
    fn = serving.load_exported(serving.export_localizer(loc))
    for b in (3, 64):
        frames = torch.from_numpy(_square_frames(b, seed=b)).cuda()
        got, want = fn(frames), loc(frames)
        assert got["xy"].is_cuda
        assert float((got["xy"] - want["xy"]).abs().max()) <= 2e-4
        assert float((got["tdoa_samples"]
                      - want["tdoa_samples"]).abs().max()) <= 1e-3


@pytest.mark.gpu
def test_compilation_cache_skips_nvcc_on_restart(tmp_path, cuda_device):
    """A second process with the same cache directory loads the library
    without nvcc (none on its PATH)."""
    code = ("import sys; from audio_triangulation_tpu_torch.utils import "
            "serving; from audio_triangulation_tpu_torch.ops.cuda import "
            "_build; serving.enable_compilation_cache(sys.argv[1]); "
            "_build.load_library(); print(_build.library_path("
            "_build.BUILD_DIR))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    first = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                           capture_output=True, text=True, cwd=root,
                           timeout=600)
    assert first.returncode == 0, first.stderr
    env = dict(os.environ, PATH="/nonexistent", CUDA_HOME="/nonexistent")
    second = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                            capture_output=True, text=True, cwd=root,
                            timeout=600, env=env)
    assert second.returncode == 0, second.stderr
    assert first.stdout == second.stdout


@pytest.mark.gpu
def test_launch_counter_under_threads(cuda_device):
    """16 threads launching the scan kernel at once, the interpreter
    switching threads every microsecond: the counter loses no launch."""
    x = torch.randn(8, 3, 1535, device=cuda_device)
    per_thread = 50
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        start = detector_scan.launches
        errors = []

        def worker():
            try:
                for _ in range(per_thread):
                    detector_scan.launch(x)
            except Exception as e:  # collected, raised below
                errors.append(e)

        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert all(not t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    torch.cuda.synchronize()
    assert not errors
    assert detector_scan.launches - start == 16 * per_thread


@pytest.mark.gpu
def test_stage_timer_on_the_card(cuda_device):
    t = profiling.StageTimer()
    x = torch.randn(2048, 2048, device=cuda_device)
    for _ in range(3):
        with t.stage("matmul"):
            x @ x
    assert t.calls["matmul"] == 3 and t.total_s["matmul"] > 0
    stats = profiling.device_memory_stats()
    assert stats["allocated_bytes.all.current"] > 0
