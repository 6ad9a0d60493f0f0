"""PyTorch port, detector and framing: the same numpy arrays through the JAX
package's ``ops.detector`` / ``ops.framing`` and the port's.  Trigger masks
and positions, the prefix sums, the detector powers and the captured frames
must be equal bit for bit (float32 adds made in the same order; integer
input in exact int64)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu.core import config as jcfg
from audio_triangulation_tpu.ops import detector as jdet, framing as jframe
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.ops import detector as tdet
from audio_triangulation_tpu_torch.ops import framing as tframe
from audio_triangulation_tpu_torch.ops.cuda import detector_scan

N = 1024


def _streams(seed, shape, bursts=((700, 300),), dtype=np.float32):
    """Idle ADC level with noise, plus loud bursts (start, length)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) * 2.0 + 128.0
    for at, length in bursts:
        x[..., at:at + length] += rng.normal(size=(*shape[:-1], length)) * 60.0
    x = np.clip(np.round(x), 0, 255)
    return x.astype(dtype)


# 1,535 is the streaming window (12 blocks of 128); 3,583 and 40,000 take
# the block totals past 16, where the reference's compiler sums them in
# tiles; 300 and 100 end inside a block
@pytest.mark.parametrize("shape", [(5, 3, 1535), (2, 3, 3583), (3, 300),
                                   (1, 2, 40000), (4, 100), (2, 4096),
                                   (2, 5000), (3, 128)],
                         ids=lambda s: "x".join(map(str, s)))
def test_blocked_cumsum_bit_equal(shape):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=shape) * 50 + 128).astype(np.float32)
    ref = np.asarray(jdet._blocked_cumsum_f32(jnp.asarray(x)))
    got = detector_scan.blocked_cumsum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)
    # and it is NOT the serial cumsum: the order is what is being ported
    assert got.dtype == np.float32


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int16],
                         ids=["f32", "i32", "i16"])
def test_half_window_powers_bit_equal(dtype):
    x = _streams(1, (3, 3, 2600), dtype=dtype)
    ref = jdet.half_window_powers(jnp.asarray(x), N)
    got = tdet.half_window_powers(torch.from_numpy(x), N)
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype
        np.testing.assert_array_equal(g.numpy(), r)


@pytest.mark.parametrize("dtype", [np.float32, np.int32], ids=["f32", "i32"])
@pytest.mark.parametrize("mode", ["absolute", "relative"])
def test_trigger_mask_and_first_trigger_equal(mode, dtype):
    x = _streams(2, (6, 3, 3000), bursts=((700, 300), (2100, 200)),
                 dtype=dtype)
    x[4] = _streams(3, (3, 3000), bursts=(), dtype=dtype)  # a silent stream
    kw = dict(trigger_mode=mode)
    ref = np.asarray(jdet.trigger_mask(jnp.asarray(x),
                                       jcfg.PipelineConfig(**kw)))
    got = tdet.trigger_mask(torch.from_numpy(x), tcfg.PipelineConfig(**kw))
    assert ref.any() and not ref[4].any()
    np.testing.assert_array_equal(got.numpy(), ref)
    ridx, rfound = jdet.first_trigger(jnp.asarray(x),
                                      jcfg.PipelineConfig(**kw))
    gidx, gfound = tdet.first_trigger(torch.from_numpy(x),
                                      tcfg.PipelineConfig(**kw))
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(gfound.numpy(), np.asarray(rfound))
    assert int(gidx[4]) == 0 and not bool(gfound[4])


def test_unknown_trigger_mode_raises():
    x = torch.zeros((1, 3, 1100))
    with pytest.raises(ValueError, match="trigger_mode"):
        tdet.trigger_mask(x, tcfg.PipelineConfig(trigger_mode="other"))


def test_first_true_takes_the_first_of_many():
    mask = torch.tensor([[False, True, True, False, True],
                         [False] * 5, [True] * 5])
    idx, found = tdet.first_true(mask)
    assert idx.tolist() == [1, 0, 0] and found.tolist() == [True, False, True]


@pytest.mark.parametrize("dtype", [np.float32, np.int64], ids=["f32", "i64"])
def test_extract_window_bit_equal(dtype):
    """The reference's one-hot matmul capture against the port's gather,
    starts in and past the range (clamped)."""
    rng = np.random.default_rng(4)
    w_len = N - 1 + 512
    window = (rng.normal(size=(3, w_len)) * 40 + 128).astype(dtype)
    for start in (0, 1, 127, 128, 300, 511, 600, -5):
        ref = np.asarray(jdet.extract_window_mm(
            jnp.asarray(window), jnp.asarray(start), N,
            max_start=w_len - N))
        got = tdet.extract_window_mm(torch.from_numpy(window),
                                     torch.tensor(start), N, w_len - N)
        np.testing.assert_array_equal(got.numpy(), ref)
    # batched over streams and event slots in one call
    starts = torch.tensor([[0, 511], [128, 77]])
    win2 = torch.from_numpy(np.stack([window, window[::-1].copy()]))
    got = tdet.extract_window_mm(win2[:, None].expand(-1, 2, -1, -1), starts,
                                 N, w_len - N)
    assert got.shape == (2, 2, 3, N)
    np.testing.assert_array_equal(got[1, 1].numpy(),
                                  window[::-1][:, 77:77 + N])


def test_extract_frames_at_bit_equal():
    x = _streams(5, (4, 3, 2600), dtype=np.int64)
    idx = np.array([1023, 1500, 2599, 10])  # the last clamps to start 0
    ref = np.asarray(jdet.extract_frames_at(jnp.asarray(x), jnp.asarray(idx),
                                            N))
    got = tdet.extract_frames_at(torch.from_numpy(x), torch.from_numpy(idx),
                                 N)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("refractory", [0, 300])
def test_all_triggers_capped_equal(refractory):
    x = _streams(6, (3, 3, 6000), bursts=((700, 300), (2500, 300),
                                          (4400, 300)))
    ref = jdet.all_triggers_capped(jnp.asarray(x), jcfg.PipelineConfig(), 4,
                                   refractory)
    got = tdet.all_triggers_capped(torch.from_numpy(x),
                                   tcfg.PipelineConfig(), 4, refractory)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert got[1].sum() >= 6


@pytest.mark.parametrize("t_len,frame,hop", [(4096, 1024, 512),
                                             (5000, 1024, 256),
                                             (3000, 1024, 300),
                                             (1024, 1024, 512)])
def test_framing_equal(t_len, frame, hop):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, t_len)).astype(np.float32)
    ref = np.asarray(jframe.frame_multichannel(jnp.asarray(x), frame, hop))
    got = tframe.frame_multichannel(torch.from_numpy(x), frame, hop)
    np.testing.assert_array_equal(got.numpy(), ref)
    ref1 = np.asarray(jframe.frame_stream(jnp.asarray(x[0]), frame, hop))
    np.testing.assert_array_equal(
        tframe.frame_stream(torch.from_numpy(x[0]), frame, hop).numpy(), ref1)
    if frame % hop == 0:
        rl, ro = jframe.frame_multichannel_lanes(jnp.asarray(x), frame, hop)
        gl, go = tframe.frame_multichannel_lanes(torch.from_numpy(x), frame,
                                                 hop)
        np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))
        np.testing.assert_array_equal(go, ro)
        np.testing.assert_array_equal(gl.numpy()[go], ref)  # time order
    else:
        with pytest.raises(ValueError, match="hop"):
            tframe.frame_multichannel_lanes(torch.from_numpy(x), frame, hop)


def test_framing_short_stream_raises():
    with pytest.raises(ValueError, match="shorter"):
        tframe.frame_stream(torch.zeros(100), 1024, 512)


# ---------------------------------------------------------------------------
# the scan kernel's wrapper and plain version

@pytest.mark.parametrize("t_len", [100, 1535, 4096, 5000, 1, 9000])
def test_prefix_sums_reference_is_both_blocked_sums(t_len):
    """The plain version of the scan kernel: the prefix sums of x and of
    x * x (the square rounded to f32 first), each equal to the JAX package's
    blocked cumsum bit for bit, on values large enough to round."""
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(2, 3, t_len)) * 9000.0).astype(np.float32)
    c1, c2 = detector_scan.prefix_sums_reference(torch.from_numpy(x))
    sq = x * x
    np.testing.assert_array_equal(
        c1.numpy(), np.asarray(jdet._blocked_cumsum_f32(jnp.asarray(x))))
    np.testing.assert_array_equal(
        c2.numpy(), np.asarray(jdet._blocked_cumsum_f32(jnp.asarray(sq))))
    # rounding did happen: past one block the serial f32 sum differs
    if t_len > detector_scan.CUMSUM_BLOCK:
        assert not np.array_equal(c2.numpy(), np.cumsum(sq, axis=-1,
                                                        dtype=np.float32))
    got = detector_scan.prefix_sums(torch.from_numpy(x))  # the CPU route
    assert torch.equal(got[0], c1) and torch.equal(got[1], c2)


def test_half_window_powers_uses_one_scan_for_both_sums(monkeypatch):
    calls = []
    real = detector_scan.prefix_sums

    def counting(x):
        calls.append(tuple(x.shape))
        return real(x)

    monkeypatch.setattr(detector_scan, "prefix_sums", counting)
    x = torch.from_numpy(_streams(9, (2, 3, 1535)))
    inc, out = tdet.half_window_powers(x, N)
    assert calls == [(2, 3, 1535)]
    ref = jdet.half_window_powers(jnp.asarray(x.numpy()), N)
    np.testing.assert_array_equal(inc.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref[1]))


def test_scan_kernel_refuses_what_it_does_not_take():
    before = detector_scan.launches
    with pytest.raises(ValueError, match="CUDA"):  # no plain fallback
        detector_scan.launch(torch.zeros((2, 100)))
    meta = torch.zeros((2, 100), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        detector_scan.prefix_sums(meta)
    assert detector_scan.launches == before


def test_scan_kernel_source_keeps_the_order_constants():
    """The kernel's block, tile and row limit are the plain version's."""
    from audio_triangulation_tpu_torch.ops.cuda import _build

    src = (_build.CSRC_DIR / "detector_scan.cu").read_text()
    assert f"constexpr int kBlock = {detector_scan.CUMSUM_BLOCK};" in src
    assert "constexpr int kTile = 16;" in src
    assert (f"constexpr int kMaxBlocks = "
            f"{detector_scan.MAX_SAMPLES // detector_scan.CUMSUM_BLOCK};"
            in src)
    assert "fmaf" not in src  # the square is rounded before it is added


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
# the last five: rows no multiple of 4 at the streaming length, fewer row
# groups than CTAs, rows of more than one unit of 64 blocks, the longest row
@pytest.mark.parametrize("shape", [(64, 3, 1535), (3, 100), (5, 128),
                                   (2, 2, 4096), (3, 5000), (1, 40000),
                                   (130, 1), (1023, 1535), (3, 1535),
                                   (4096, 3, 1535), (3, 9000), (2, 524288)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_scan_is_bit_equal_to_the_cpu_path(cuda_device, shape):
    rng = np.random.default_rng(10)
    x = torch.from_numpy(
        (rng.normal(size=shape) * 9000.0).astype(np.float32))
    want = detector_scan.prefix_sums_reference(x)
    got = detector_scan.launch(x.to(cuda_device))
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
