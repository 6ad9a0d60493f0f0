"""PyTorch port on the card: the SRP gather kernel (``csrc/srp_gather.cu``)
at the four benchmark cells' shapes, 1,024 frames a case.  The kernel
against its plain version (bit for bit, also at the cells' 16,384 frames,
where each CTA walks several tiles), against the cuBLAS one-hot product
and ``argmax`` it replaced (bit for bit at the 3-mic cells, where cuBLAS
adds K in order and an FFMA by 1.0 or 0.0 is exact; elsewhere within the
rounding of another order of the sums), the cells' estimators on their own
traffic against the product's route, a stream step captured as a CUDA
graph against the eager step, and the shapes whose table and tiles do not
fit shared memory.  Imports no JAX: on a CUDA machine,
``python -m pytest tests/test_torch_srp_gather_gpu.py -m gpu -q``."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import copy
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import scenes
from benchmark.harness import mics_of, port_configs
from benchmark.kinds import doa as doa_kind
from audio_triangulation_tpu_torch import (Localizer, StreamConfig,
                                           StreamingLocalizer)
from audio_triangulation_tpu_torch.models import doa as tdoa
from audio_triangulation_tpu_torch.models import localizer as tloc
from audio_triangulation_tpu_torch.ops import srp
from audio_triangulation_tpu_torch.ops.cuda import srp_gather
from audio_triangulation_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1] / "benchmark"
FRAMES = 1024
# cell -> (configuration, traffic, score type)
CELLS = {
    "square4_bandcrop.batch16k": ("square4_bandcrop", "batch16k", "bfloat16"),
    "ref3_firmware.batch16k": ("ref3_firmware", "batch16k", "float32"),
    "circ8_doa.batch16k": ("circ8_doa", "doa16k", "float32"),
    "ref3_firmware.stream4k": ("ref3_firmware", "stream4k", "float32"),
}


def _json(*parts):
    return json.loads((ROOT.joinpath(*parts)).read_text())


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _estimator(cell, device):
    """The cell's program object and its traffic, as the harness builds
    them."""
    name, traffic, _ = CELLS[cell]
    config = _json("configs", f"{name}.json")
    traffic = _json("traffic", f"{traffic}.json")
    if traffic["kind"] == "doa":
        est = tdoa.DoaEstimator.create(
            mics_of(config), doa_kind.pipeline_of(config),
            config["n_azimuths"], device=device)
    elif traffic["kind"] == "stream":
        est = StreamingLocalizer.create(
            mics_of(config), *port_configs(config),
            StreamConfig(chunk_size=config["stream"]["chunk_size"]),
            device=device)
    else:
        est = Localizer.create(mics_of(config), *port_configs(config),
                               device=device,
                               init_grid_stride=config["init_grid_stride"])
    return est, config, traffic


def _table_and_onehot(est):
    """(lag table [P, G] int32, one-hot steering matrix) of an estimator
    whose steering matrix is that table's one-hot."""
    assert est.params.lag_onehot
    if isinstance(est, tdoa.DoaEstimator):
        return est.lut_flat, est.onehot_az
    return est.params.lut_flat, est.params.onehot


def _non_finite_frames(frames):
    """The frames that hold a NaN (the first two) or an inf (the others):
    frames 1 and 2 sit in the first tile, half-way and three from the end
    in tiles that a CTA reaches after others once the frames outnumber
    the CTAs' tiles (264 CTAs of 8 frames, or 4 on the circle)."""
    return (1, frames - 3, 2, frames // 2 + 1)


def _correlograms(table, num_lags, frames, seed, device):
    """Noise [frames, P, L] with a peak planted at a drawn cell's lags a
    frame, a NaN in two frames and an inf in two
    (``_non_finite_frames``)."""
    rng = np.random.default_rng(seed)
    p, g = table.shape
    lut = table.long().cpu().numpy()
    corr = rng.normal(size=(frames, p, num_lags)).astype(np.float32)
    for f, cell in enumerate(rng.integers(0, g, frames)):
        corr[f, np.arange(p), lut[:, cell]] += 3.0
    nan1, nan2, inf1, inf2 = _non_finite_frames(frames)
    corr[nan1, 0, 0] = np.nan
    corr[nan2, p // 2, num_lags // 2] = np.nan
    corr[inf1, p - 1, num_lags - 1] = np.inf
    corr[inf2, 0, num_lags - 1] = -np.inf
    return torch.from_numpy(corr).to(device)


def _same(a, b):
    """Bit-equal, NaN where the other has NaN."""
    return a.shape == b.shape and bool(
        torch.equal(a.isnan(), b.isnan())
        and torch.equal(a.nan_to_num(nan=7.5), b.nan_to_num(nan=7.5)))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("frames", [FRAMES, FRAMES - 3, 16384])
def test_cuda_kernel_is_bit_equal_to_its_plain_version(cuda_device, cell,
                                                       frames):
    """Scores and cells equal to the plain version's on the CPU at the
    cell's lag table: a ragged last tile, and the cells' 16,384 frames,
    where each CTA scores several tiles in turn through its ring, some of
    them with non-finite frames."""
    est, _, _ = _estimator(cell, cuda_device)
    table, onehot = _table_and_onehot(est)
    dtype = CELLS[cell][2]
    num_lags = onehot.shape[0] // table.shape[0]
    corr = _correlograms(table, num_lags, frames, 11, cuda_device)
    before = srp_gather.launches
    got_s, got_c = srp_gather.launch(corr, table, dtype)
    torch.cuda.synchronize()
    assert srp_gather.launches == before + 1
    want_s, want_c = srp_gather.scores_first_max_reference(
        corr.cpu(), table.cpu(), dtype)
    assert _same(got_s.cpu(), want_s)
    assert torch.equal(got_c.cpu(), want_c)
    for f in _non_finite_frames(frames):
        assert bool(got_s[f].isnan().all()) and int(got_c[f]) == 0, f
    assert int(got_s.isnan().any(dim=-1).sum()) == 4


def _order_bound(corr, table, dtype):
    """Per cell, how far two sums of its P values in different orders may
    lie apart: (P - 1) float32 roundings of at most the sum of the
    magnitudes each."""
    mag, _ = srp_gather.scores_first_max_reference(corr.abs(), table, dtype)
    return (table.shape[0] - 1) * 2.0 ** -24 * mag


def _clear(scores, tol=1e-5):
    """Rows whose best score is more than ``tol`` of the row's scale above
    every lower score (as the benchmark's ``correct`` judges a cell)."""
    best = scores.amax(dim=-1, keepdim=True)
    below = torch.where(scores < best, scores, -torch.inf).amax(dim=-1)
    return (best[:, 0] - below) > tol * scores.abs().amax(dim=-1)


def _held_to_product(cell, corr, table, got_s, got_c, want_s):
    """The kernel's scores and cells against the product's: bit for bit
    where cuBLAS adds K in order (the 3-mic cells), else within the
    rounding of another order of the same P sums and the same cell on
    every row whose best is 1e-5 clear."""
    if cell.startswith("ref3"):
        assert _same(got_s, want_s)
        assert torch.equal(got_c, want_s.argmax(dim=-1))
        return
    assert torch.equal(got_s.isnan(), want_s.isnan())
    ok = ~want_s.isnan().any(dim=-1)
    bound = _order_bound(corr, table, CELLS[cell][2])
    assert bool(((got_s - want_s).abs() <= bound)[ok].all())
    clear = ok & _clear(want_s.nan_to_num(nan=-1.0))
    assert int(clear.sum()) >= 0.9 * int(ok.sum())
    assert torch.equal(got_c[clear], want_s.argmax(dim=-1)[clear])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cuda_kernel_is_held_to_the_cublas_product(cuda_device, cell):
    """The one-hot product on the card (cuBLAS, TF32 off) and its argmax
    (``_held_to_product``)."""
    est, _, _ = _estimator(cell, cuda_device)
    table, onehot = _table_and_onehot(est)
    dtype = CELLS[cell][2]
    tloc.pin_fp32()
    num_lags = onehot.shape[0] // table.shape[0]
    corr = _correlograms(table, num_lags, FRAMES, 12, cuda_device)
    want_s = srp.srp_scores_matmul(corr, onehot, dtype)
    got_s, got_c = srp_gather.launch(corr, table, dtype)
    _held_to_product(cell, corr, table, got_s, got_c, want_s)


def _product_route(est, frames):
    """``est(frames)`` with no lag table, so that its scoring keeps the
    product."""
    params = dataclasses.replace(est.params, lag_onehot=False)
    if isinstance(est, tdoa.DoaEstimator):
        return tdoa.estimate_doa(params, est.onehot_az, frames,
                                 cfg=est.pipeline, n_azimuths=est.n_azimuths)
    return tloc.localize_frames(
        params, frames, cfg=est.pipeline, grid_cfg=est.grid,
        solver_cfg=est.solver, srp_form=est.srp_form,
        with_solver=est.with_solver, with_heatmap=est.with_heatmap,
        gn=est.gn)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [c for c in sorted(CELLS)
                                  if not c.endswith("stream4k")])
def test_cuda_cells_route_through_the_kernel(cuda_device, cell):
    """Each batch cell's estimator on 1,024 frames of its own traffic takes
    the kernel once a call (``srp.route.kernel``) and gives every output of
    the product's route bit for bit."""
    est, config, traffic = _estimator(cell, cuda_device)
    traffic = dict(traffic, frames_per_call=FRAMES, pool_batches=1)
    pool = (doa_kind.plane_wave_pool if traffic["kind"] == "doa"
            else scenes.frame_pool)(config, traffic, 2 ** 31 + 5, cuda_device)
    frames = pool[0]
    profiling.reset()
    before = srp_gather.launches
    with profiling.tracing():
        out = est(frames)
        counts = profiling.counters()
    profiling.reset()
    assert srp_gather.launches == before + 1
    assert counts.get("srp.route.kernel") == 1
    assert "srp.route.product" not in counts
    want = _product_route(est, frames)
    assert set(out) == set(want)
    if cell.startswith("ref3"):
        for k in out:
            assert _same(out[k], want[k]), k
        return
    # another order of the same sums: the scores within its rounding, the
    # rest bit for bit on the rows whose best cell is clear (the azimuth's
    # refinement reads three of the scores)
    table, _ = _table_and_onehot(est)
    corr = (out["correlograms"] if "correlograms" in out
            else _tapered(est, frames))
    ok = _clear(want["scores"])
    assert int(ok.sum()) >= 0.9 * FRAMES
    _held_to_product(cell, corr, table, out["scores"],
                     out["scores"].argmax(dim=-1), want["scores"])
    for k in out:
        if k == "scores":
            continue
        if k == "azimuth_deg":
            err = (out[k] - want[k]).abs()[ok]
            assert float(torch.minimum(err, 360.0 - err).max()) < 1e-4
        else:
            assert _same(out[k][ok], want[k][ok]), k


def _tapered(est, frames):
    """The DoA estimator's scoring input: its raw correlograms, tapered
    around their first-max lag."""
    from audio_triangulation_tpu_torch.ops import xcorr

    cfg = est.pipeline
    flat = tloc._flat_frames(frames, cfg)
    corr = tloc.conditioned_correlograms(flat, est.params, cfg)
    shifts = xcorr.best_lag(corr, cfg.max_shift)
    return xcorr.peak_taper(corr, cfg.max_shift, cfg.taper_denom, shifts)


@pytest.mark.gpu
def test_cuda_graphed_stream_step_with_the_kernel_equals_eager(cuda_device):
    """The stream cell's step at 1,024 streams of its own traffic, captured
    as a CUDA graph with the kernel inside: every output and the carried
    state bit-equal to the eager step's, which itself equals the product's
    route."""
    sl, config, traffic = _estimator("ref3_firmware.stream4k", cuda_device)
    chunks = scenes.stream_pool(config, dict(traffic, pool_chunks=8),
                                2 ** 32 + 7, cuda_device, FRAMES)
    st = sl.init_states(FRAMES)
    prod = copy.copy(sl)  # its steps keep the product
    prod.params = dataclasses.replace(sl.params, lag_onehot=False)
    pst = sl.init_states(FRAMES)
    graphed = sl.graph_step_many(sl.init_states(FRAMES), chunks[0])
    n_events = 0
    for i in range(chunks.shape[0]):
        before = srp_gather.launches
        st, out = sl.step_many(st, chunks[i])
        assert srp_gather.launches == before + 1
        gout = graphed(chunks[i])
        pst, pout = prod.step_many(pst, chunks[i])
        assert srp_gather.launches == before + 1
        assert set(gout) == set(out) == set(pout)
        for k in out:
            assert _same(gout[k], out[k]), (i, k)
            assert _same(pout[k], out[k]), (i, k)
        n_events += int(out["events"].sum())
    assert n_events > 0
    for f in dataclasses.fields(st):
        assert torch.equal(getattr(graphed.states, f.name),
                           getattr(st, f.name)), f.name


@pytest.mark.gpu
def test_cuda_tile_sizes_are_the_librarys(cuda_device):
    """The library picks the tile: 8 frames at the 3- and 4-mic cells' and
    4 at the circle's, which two CTAs an SM fit; fewer where the table
    grows; none where the table and two tiles leave no room, and there the
    route keeps the product."""
    lib = srp_gather._lib()
    for (p, l, g), tile in (((3, 93, 10201), 8), ((6, 93, 1089), 8),
                            ((28, 91, 360), 4), ((28, 256, 10), 2),
                            ((64, 256, 64), 1), ((3, 93, 80000), 0),
                            ((2, 256, 100000), 4), ((3, 257, 10), 0)):
        assert lib.att_srp_gather_tile(p, l, g) == tile, (p, l, g)
    lut = torch.zeros((3, 80000), dtype=torch.int32, device=cuda_device)
    corr = torch.zeros((4, 3, 93), device=cuda_device)
    assert "shared memory" in srp_gather.refusal(corr, lut)
    assert not srp_gather.route(corr, lut, True)
    assert srp_gather.refusal(corr, lut[:, :10201]) is None
