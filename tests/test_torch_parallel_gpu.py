"""PyTorch port, multi-device pieces on the card (every test is
``gpu``-marked and skips without a CUDA device; this file imports no JAX,
so it runs on a machine that has none): the grid-parallel local argmax
through the SRP-argmax kernel (row 7) at a shard's width against its plain
version, and a model axis run shard by shard against the world of one.

    python -m pytest tests/test_torch_parallel_gpu.py -m gpu -q
"""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import numpy as np
import pytest
import torch

from audio_triangulation_tpu_torch import Localizer, geometry
from audio_triangulation_tpu_torch.models import localizer as lm
from audio_triangulation_tpu_torch.ops import srp
from audio_triangulation_tpu_torch.ops.cuda import srp_kernel
from audio_triangulation_tpu_torch.parallel import spmd
from audio_triangulation_tpu_torch.utils import synth


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the SRP-argmax kernel)")
    return torch.device("cuda")


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1.0, 1.0, (n, 2))
    v = np.concatenate([xy, np.full((n, 1), 1.2)], axis=1)
    src = v * (1.2 / np.linalg.norm(v, axis=1, keepdims=True))
    return synth.synth_scene(src, geometry.reference_array(), noise_rms=0.01,
                             seed=seed).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("ways", [2, 4])
def test_grid_argmax_body_matches_plain_at_shard_width(cuda_device, ways):
    """Each shard's local argmax through row 7 on the card equals the plain
    version on its columns (the first maximum; cells equal where the best
    score clears the runner-up by 1e-5 of scale, scores within 1e-5 of
    scale: the kernel's 3 x TF32 split sums to about 2^-21), and the
    combined argmax equals the whole grid's."""
    loc = Localizer.create(geometry.reference_array(), srp_form="matmul",
                           device="cuda")
    frames = torch.from_numpy(_frames(1027)).cuda()
    flat = lm._flat_frames(frames, loc.pipeline)
    corr_t = lm.gcc_peaks(flat, loc.params, loc.pipeline)[0]
    g = loc.grid.num_cells
    vals, cells = [], []
    before = srp_kernel.launches
    for i in range(ways):
        shard = spmd.grid_shard(loc.params, loc.pipeline, g, ways, i)
        val, cell = spmd.grid_argmax_body(corr_t, shard)
        ref_val, ref_cell = srp_kernel.srp_argmax_reference(
            corr_t.reshape(corr_t.shape[0], -1).double(),
            shard.onehot.double(), shard.num_cells)
        scores = corr_t.reshape(corr_t.shape[0], -1).double() @ \
            shard.onehot.double()[:, :shard.num_cells]
        top2 = scores.topk(2, dim=-1).values
        scale = float(scores.abs().max())
        clear = (top2[:, 0] - top2[:, 1]) > 1e-5 * scale
        assert torch.equal((cell - shard.start)[clear],
                           ref_cell.long()[clear])
        assert float((val.double() - ref_val).abs().max()) <= 1e-5 * scale
        vals.append(val)
        cells.append(cell)
    assert srp_kernel.launches - before == ways
    best, cell = spmd.argmax_combine(vals, cells)
    one = spmd.grid_shard(loc.params, loc.pipeline, g, 1, 0)
    best1, cell1 = spmd.grid_argmax_body(corr_t, one)
    assert torch.equal(cell, cell1) and torch.equal(best, best1)


@pytest.mark.gpu
def test_refined_peak_across_shards_on_the_card(cuda_device):
    """The peak fit of a combined argmax reads its neighbours from every
    shard (one sum): the refined grid peak equals one shard's, and the
    fit on the whole [B, G] scores within 2e-6 m (chip_smoke phase 17:
    3.6e-7 m at 4,096 frames)."""
    loc = Localizer.create(geometry.reference_array(), srp_form="matmul",
                           device="cuda")
    frames = torch.from_numpy(_frames(256, seed=1)).cuda()
    flat = lm._flat_frames(frames, loc.pipeline)
    corr_t = lm.gcc_peaks(flat, loc.params, loc.pipeline)[0]
    grid = loc.grid
    hw = (grid.height, grid.width)

    def run(ways):
        shards = [spmd.grid_shard(loc.params, loc.pipeline, grid.num_cells,
                                  ways, i) for i in range(ways)]
        vals, cells = zip(*[spmd.grid_argmax_body(corr_t, s)
                            for s in shards])
        _, cell = spmd.argmax_combine(vals, cells)
        idx = srp.peak_neighbours(cell, hw)
        nb = spmd.sum_combine([spmd.neighbour_body(corr_t, s, idx)
                               for s in shards])
        return cell, spmd.refined_xy(cell, nb, grid)

    (cell2, xy2), (cell1, xy1) = run(2), run(1)
    assert torch.equal(cell2, cell1) and torch.equal(xy2, xy1)
    scores = srp.srp_scores_matmul(corr_t, loc.params.onehot)
    whole = srp.grid_peak_xy(scores, hw, (grid.half_cells_x,
                                          grid.half_cells_y),
                             grid.cells_per_m, refine=True)
    # rows where the fp32 product's first maximum is the kernel's cell (a
    # near-tie may pick another)
    same = scores.argmax(-1) == cell1
    assert float(same.float().mean()) > 0.9
    assert float((xy1 - whole)[same].abs().max()) <= 2e-6
