// Fused GCC(-PHAT) for a batch of raw frames, in one pass per block of frames.
//
// Replaces audio_triangulation_tpu/ops/pallas/gcc_kernel.py::_gcc_kernel in
// its base mode (rows 1 and 2 of the port's kernel table: with and without
// the in-kernel peak stage; row 2 at many pairs in the pair instance), its
// compact "Mode B" (row 4, in-kernel SRP) and its spectral-stats mode (row
// 3, below).  Base mode, per frame [M, N]:
//
//   mean removal, x (window * gain)
//   Re/Im DFT against cos / -sin, split and packed by the host (pack_dft_split)
//   PHAT: per mic (M >= 3) or per pair (M = 2), rsqrt(re^2 + im^2 + eps^2)
//   per-pair cross-power, lag synthesis against sync / syns [F, L]
//   optional peaks: first-max argmax, parabolic sub-sample (interior peaks,
//   |den| > 1e-20, delta clipped to +-0.5), PSR (guard 3, floor 1e-20) on the
//   raw correlogram, then the Gaussian taper exp(-d^2 / taper_denom)
//
// The base body (base_tile) streams the bins instead of holding the spectra:
// a block takes up to 128 (frame, mic) rows (32 frames of 4 mics, 42 of 3)
// and walks the bins in chunks of kChunkBins.  Every bin's PHAT,
// cross-power and share of the lag synthesis is local to that bin, and the
// correlogram is a sum over bins, so per chunk it
//   computes the chunk's spectra of all its rows on the tensor cores, as a
//   split-fp32 product (wgmma m64n64k8, TF32 operands; see hopper.cuh).
//   The wrapper splits (cos, -sin) into TF32 hi and lo parts once per
//   configuration and stores them K-major (pack_dft_split).  Thread 0 keeps
//   a ring of 3 or 4 stages full by TMA, signalled through mbarriers: a
//   stage is 16 samples of the block's frames (128 rows, unswizzled) and of
//   the chunk's hi and lo coefficients (128 columns each, 64-byte swizzle),
//   24 KB; no thread loads or splits a coefficient.  Warpgroup w owns rows
//   64 w .. 64 w + 63 and the chunk's 128 columns as two halves of 64: a
//   thread reads its fragment's samples from the stage (a step's K slots t
//   and t + 4 hold samples 2 t and 2 t + 1), removes the mean, applies
//   window x gain, splits them into TF32 parts in registers, and issues for
//   each step of 8 samples the three products x_lo w_hi, x_hi w_lo,
//   x_hi w_hi with A from registers.  The tensor cores sum kTcSteps (2)
//   steps from zero; the CUDA cores then add that sum, and the sums are
//   flushed into the chunk's spectra in shared memory every kFlushSteps
//   steps.  The tensor cores cut where the CUDA cores round, and PHAT lifts
//   that on weak bins, so their sums stay short: 16 steps in them read
//   9e-05 of scale in the stats mode, 1 step 1.2e-05; 2 steps here read at
//   most 1.8e-05 of scale from float64 and 1.6e-05 from the plain version
//   in the same arithmetic (bench chirps at 2-4 mics, full band, band crop,
//   linear; NVIDIA H100 80GB HBM3, 700 W).  The halves take turns: one's
//   sum is added while the other's products run;
//   whitens the chunk (per mic), forms the cross-power of every (frame,
//   pair) row (per-pair PHAT for 2-mic arrays) 16 bins at a time, and adds
//   those bins' lag synthesis into the correlograms [frames x P, L], which
//   stay in shared memory for the whole call.  The synthesis stays on the
//   fp32 CUDA cores, a bin at a time in ascending order per lag: a thread
//   owns 4 rows x up to 4 lags and reads one staged (cos, sin) pair a lag
//   and one broadcast cross-power value a row for 8 FMAs.
// The frames are read once for the means and once per bin chunk, the split
// matrix once per block.  A bin that would take a chunk to itself (F = L/2
// + 1 with L a power of two leaves bin F - 1 alone) is summed over the
// samples by the warp that computes its row's mean, from its unsplit
// coefficients.  Rows are independent in every stage, so a row's outputs
// do not depend on which other rows share its block: the SRP mode and the
// pipelined instance, run at other tile sizes or with more shared memory,
// stay bit-equal to it.
//
// The pair instance (gcc_kernel<false, true>: row 2, the base mode without
// peaks, where the correlograms would crowd the tile).  The fused body
// holds a block's correlograms [TB P, L] in shared memory and cuts TB until
// they fit beside the ring: at 8 mics, 28 pairs and 91 lags 10 frames, 80
// of the 128 rows, and 280 (frame, pair) rows of synthesis on the CUDA
// cores a block.  The wrapper routes to this instance where fewer than
// 128 / M frames a block fit.  One persistent launch (SM count x blocks an
// SM) whose blocks claim work items in order from a counter, first every
// spectra tile, then every pair tile:
//   a spectra tile is base_tile at a full tile of 128 / M frames, its DFT
//   and per-mic PHAT as they stand; each chunk's whitened spectra (raw
//   without PHAT or at 2 mics) go out to a scratch buffer [B M, Fs] complex
//   (F padded with zeros to whole stages of kStageBins), and the tile then
//   sets its ready flag (release, after a proxy fence);
//   a pair tile is 128 consecutive (frame, pair) rows, warpgroup w's 64 w
//   ..; it waits (acquire) for the spectra tiles of the frames its rows
//   span.  A ring stage (TMA) holds kStageBins bins of the synthesis
//   matrices, split once and K-major (pack_synthesis_split: 1.6 MB at L =
//   91, resident in L2), a lag block of kPairCols lags, and the same bins
//   of the spanned frames' spectra.  A thread forms the cross-power of its
//   two rows at bin 4 s + t from the staged spectra (each staged row serves
//   M - 1 pairs; per-pair PHAT at 2 mics), splits it into TF32 parts in
//   registers and issues the DFT's scheme against the matrices: per step
//   x_lo w_hi, x_hi w_lo, x_hi w_hi (wgmma m64n48k8, two halves of 48 lags
//   taking turns), kTcSteps steps summed in the tensor cores from zero,
//   added on the CUDA cores into running sums that go into the totals every
//   kFlushSteps steps, all in registers; the totals go out [B, P, L] once.
// A pair tile waits only on spectra tiles, which blocks that run claimed
// before it and finish without waiting, so the launch cannot deadlock
// however many blocks are resident.
//
// What bounds it now.  The pair instance at 8 mics, 28 pairs, F = 1,025, L
// = 91, 16,384 frames: 15.9 ms against a bound of 4.41 ms (the fused body
// 31.9): the spectra phase about 10.1 ms, the pair phase about 3.8 ms, the
// rest (means, PHAT, the spectra out, 1.07 GB, and back, about 1.4 GB as a
// pair tile's first and last frames are read twice, under the products)
// about 2 ms (chip_variants.py rowtwo, each phase cut short; NVIDIA H100
// 80GB HBM3, 700 W).  Both phases run their products at about
// a third of the TF32 rate (8.2e11 and 2.7e11 multiply-adds), held back as
// the fused body's DFT is, below.  Left on the table there: the pair
// phase's B operand is read from L2 by every block (TMA multicast across a
// cluster would share it), and the lag blocks' padding (295 lags take four
// of 96).  The fused body: per multiply-add a block pulls 0.021 bytes of
// coefficients from L2 (128 rows share each) and 0.010 bytes of frames
// (from memory: a wave's 128 rows a block are 66 MB); at the F = 1,025 of a
// linear-padded 1,024-sample frame that is 6.5 GB and 3.2 GB a 16,384-frame
// 3-mic call, against 1.25 ms of TF32 products.  What holds the products
// back is how few are in flight: every group of steps needs its own
// accumulators until the CUDA cores have added them, and the registers
// hold two groups a warpgroup (the same issue pattern alone reaches 71-74%
// of the TF32 rate on this card); per step, forming A from shared memory
// adds ~180 cycles a warp.  Phase clocks of a block (16 chunks, F = 1,025,
// the DFT summing 1 step in the tensor cores): DFT 71%, synthesis 24%,
// means 4%, peaks 1%; one block fills an SM, so the synthesis does not run
// beside another block's DFT.  Left on the table: the synthesis beside the
// DFT (warp-specialised, or spectra double-buffered), wider chunks (N = 256
// would need twice the accumulators, or sums 16 steps long in the tensor
// cores), and the band crop's padding (106 bins take 2 chunks of 64).
//
// Dropped from the TPU kernel, because they existed for Mosaic or the MXU:
// the Nyquist fold (all F = L/2 + 1 bins are carried), the 128-lane padding
// of the lag axis, the one-hot neighbour sums (direct indexing here) and
// sub-tile emission order.
//
// In-kernel SRP (base_tile<true>: the TPU kernel's compact "Mode B",
// gcc_kernel.py:467-499): the base mode with peaks, and while the block
// still holds its correlograms, the SRP score of every grid cell, written
// out as [B, G], and the grid argmax.  The peak stage leaves each tapered
// row rounded to bf16 in the row's place; then the block stages the lag LUT
// in shared memory as int16, as many cells at a time as the staging region
// holds (so G has no limit), and every thread scores cells for 8 frames at a
// time: for each cell g the pairs' values at lut[p, g] summed in the order
// p = 0..P-1 in fp32 (the TPU kernel's per-pair products against the
// one-hot of that LUT have one nonzero term each, so this is the same sum),
// the score written coalesced and the first maximum kept per frame, then
// reduced across the block with ties to the lower cell.  Dropped: the
// 4 P + 2 <= 128 lane packing of the outputs and the VMEM budget of the
// steering matrix.
//
// Spectral-stats mode (gcc_stats_kernel, stats_tile; the TPU kernel's _smooth,
// stage_front_stats, stage_cross_stats and phase_slope_tdoa), for
// band_hz='auto' and the phase-slope / hybrid sub-sample TDOA.  Its DFT
// leaves the spectra RAW in shared memory; then
//   smoothed periodograms |X|^2 over +-hw bins (edge counts over all F bins),
//   per (frame, pair) the smoothed raw cross-power and the coherence
//   g2 = clip(|G_ab|^2 / (G_aa G_bb + eps^2), 0, 1), kept per row,
//   per frame the auto band: pair-mean g2 over the interior (DC and Nyquist
//   out) against max(rel * max, floor), the interior when fewer than
//   min_bins bins pass,
//   synthesis of the raw cross-power times the per-mic (M >= 3, tabled
//   once per bin in the periodograms' place) or per-pair PHAT factor and
//   the band weight, staged per chunk of bins for the pass's rows, then
//   the base mode's peaks,
//   per row (one warp, rows spread over all warps once the peaks are out)
//   the phase slope: weights |R|^2 g2 band over bins 0..F-2, normalised by
//   their maximum, two Gauss-Newton steps, and the hybrid coherence gate.
//   The steps use accurate atan2f and sincosf, no fast intrinsics (the
//   phase argument reaches ~145 rad, where those lose digits); each lane
//   takes two sincosf a step and advances its bins' rotation by complex
//   products, 16 of them, which adds ~1e-6 rad.
// The smoothing is a direct windowed sum, never a running-sum difference:
// power spectra span ~1e18, and the TPU kernel's banded smoothing matmul
// existed because its rolls were slow.
// What bounds it on an H100: the shared memory it keeps (raw spectra,
// smoothed periodograms, g2 per row, band per frame: about 39 KB a 4-mic
// frame at F = 513, 215 KB a block of 4) allows one block per SM where the
// base mode has two, so no second block hides a stage's latency, and two
// thirds of its time was the DFT on the fp32 CUDA cores (10.3 of 15.4 ms a
// 16,384-frame call).  So both of its products run on the tensor cores as
// split-fp32 products (mma.sync m16n8k8, TF32 operands; see hopper.cuh):
//   the DFT (spectra_tensor_cores): the block's 16 (frame, mic) rows are one
//   mma row tile; the conditioned samples are staged 128 at a time in two
//   buffers and split as they leave shared memory; every coefficient is
//   used by one warp only, so it comes from the packed matrix in L2 in
//   fragment order (the wrapper's pack_dft), a step ahead of its use, and is
//   split in registers.  The tensor cores add with truncation, which PHAT
//   turns into 9e-05 of scale on the correlogram when a chunk's 48 products
//   are summed in them; so a step's three products are summed there from
//   zero and the steps are added on the CUDA cores, 16 to a chunk and the
//   chunks into the spectrum in shared memory (1.2e-05, as the CUDA-core
//   stage's two-level sum).  The Nyquist bin, alone in its column tile, is
//   summed over the samples by the warp that computes the row's mean.
//   The synthesis: a pass's 32 rows x 2F x L against the matrices split
//   and packed once per configuration (pack_split_synthesis), 2 row tiles x
//   4 warps over the lag tiles, the cross-power whitened and banded once
//   per chunk.
// The window sums come from registers (a thread owns 16 consecutive bins of
// a row and loads their 48 terms once); that stage was 0.4 ms and stayed so.
// What is left (9.8 ms against a bound of 1.1): the DFT, 4.6 ms, waits for
// its coefficient loads (one step of 8 samples ahead is all the registers
// allow) and spends 10 of its 21 instructions a column tile and step on
// splitting them, for one row tile of 16 rows (the base body shares each
// coefficient among four).  Dropped as well: the polynomial atan2
// (Mosaic has none), the row expansion of the band weight, and the per-mic
// rsqrt the TPU kernel computes for 2-mic arrays without using it.
//
// Persistent, self-pipelined instance (gcc_pipelined_kernel; replaces
// tools/emit_pipeline_probe.py::outer, which drives the same body through
// pltpu.emit_pipeline as one program step).  The base mode takes one tile of
// frames per block, one block an SM, and its next tile's frames are read
// only once the next block starts.  Here (SM count x blocks an SM) blocks each walk the tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... themselves: a tile's frames arrive
// by cp.async in a staging buffer in shared memory (tb x M rows), the
// mean and DFT stages read them from there, and as soon as the last bin
// chunk's DFT is done the next tile's copy is issued into the same buffer,
// so it runs under the current tile's last synthesis and peak stage.  The
// TPU probe's "weights resident" has no shared-memory form on this card: the
// band-crop DFT matrices alone are 1,024 x 106 x 2 floats = 868 KB against
// 227 KB a block, so they stay where the base mode copies them from (L2).  The
// body is the base mode's (base_tile), at the tile that fits beside the
// staging buffer (7 frames of 4 x 1,024 where the base mode takes 32; its
// rows padded to N + 8 floats, so that a warp's fragment loads hit distinct
// banks); rows are independent in it, so the outputs are bit-equal.  What it
// costs: the smaller tile leaves the second warpgroup's products out and
// shares each coefficient stage among fewer rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// ---- the base body (base_tile: base, SRP and pipelined instances) ----------
// A block holds up to kBlockRows (frame, mic) rows: warpgroup w (threads
// 128 w ..) owns rows 64 w .. 64 w + 63, one wgmma row tile.  The bins go in
// chunks of kChunkBins, kChunkCols columns as (re, im) pairs, which each
// warpgroup multiplies as two halves of kHalfCols (one wgmma m64n64k8
// each).  The operands arrive by TMA, kKStage samples a ring stage: the
// block's frames tile (kBlockRows rows of kKStage samples, unswizzled),
// then the coefficients' hi tile and lo tile (kChunkCols rows of kKStage
// samples each under the 64-byte swizzle).  The ring has as many stages as
// shared memory holds, kMinRing to kMaxRing.
constexpr int kBlockRows = 128;
constexpr int kChunkBins = 64;    // ops/cuda/gcc_kernel.py CHUNK_BINS
constexpr int kChunkCols = 2 * kChunkBins;
constexpr int kHalfCols = kChunkCols / 2;
static_assert(kBlockRows == 64 * (kThreads / 128), "a warpgroup a row tile of 64");
constexpr int kKStage = 16;       // ops/cuda/gcc_kernel.py SPLIT_STAGE_SAMPLES
constexpr int kStageSteps = kKStage / 8;
constexpr int kRowBytes = kKStage * 4;
constexpr int kXTileBytes = kBlockRows * kRowBytes;
constexpr int kBTileBytes = kChunkCols * kRowBytes;
constexpr int kStageBytes = kXTileBytes + 2 * kBTileBytes;
constexpr int kMinRing = 3, kMaxRing = 4;
static_assert(kRowBytes == 64 && kXTileBytes % 512 == 0 && kBTileBytes % 512 == 0 &&
                  (kHalfCols * kRowBytes) % 512 == 0,
              "64-byte swizzled tiles and halves start on 512-byte boundaries");
constexpr int kFlushSteps = 16;   // ops/cuda/gcc_kernel.py DFT_FLUSH_STEPS
// steps (of 8 samples) the base body's tensor cores sum from zero before the
// CUDA cores add them (ops/cuda/gcc_kernel.py DFT_TC_STEPS)
constexpr int kTcSteps = 2;
static_assert(kStageSteps % kTcSteps == 0 && kFlushSteps % kTcSteps == 0,
              "whole groups of steps a stage and a flush");
// a spectrum row of the chunk: its bins, the lone tail bin and padding, 8
// words apart modulo the banks, so that a warp's flush of 8 rows x 4 bins
// hits every bank once a half-warp
constexpr int kSpecStride = kChunkBins + 4;
constexpr int kSub = 16;          // bins of a synthesis step
constexpr int kLagBlock = 128;    // lags per synthesis block
constexpr int kLagsPerLane = kLagBlock / 32;
static_assert(kSub * kLagBlock % kThreads == 0, "whole staging loads a thread");
constexpr int kRowsPerGroup = 4;  // (frame, pair) rows a warp synthesises together
constexpr int kSrpFrames = 8;     // frames a thread scores at a time
// ---- the pair phase (pair_tile) --------------------------------------------
// A pair tile is kBlockRows (frame, pair) rows, warpgroup w's the rows 64 w
// .. 64 w + 63, against a lag block of kPairCols lags, which each
// warpgroup multiplies as two halves of kPairHalf (one wgmma m64n48k8
// each).  K runs over the bins, 4 a step of 8 (their rr, then their jj);
// a ring stage is kKStage values of K, kStageBins bins: the synthesis
// matrices' hi and lo tiles (kPairCols rows each under the 64-byte swizzle),
// then the spectra of the frames the tile's rows span, unswizzled, in
// boxes of at most kBoxRows rows.
constexpr int kPairHalf = 48;     // ops/cuda/gcc_kernel.py PAIR_LAG_COLS / 2
constexpr int kPairCols = 2 * kPairHalf;
constexpr int kStageBins = kKStage / 2;
constexpr int kPairBTileBytes = kPairCols * kRowBytes;
constexpr int kBoxRows = 256;     // rows of a TMA box, at most
static_assert(kPairHalf % 8 == 0 && (kPairHalf * kRowBytes) % 512 == 0,
              "a half is whole wgmma column groups and starts on a swizzle boundary");
// ---- the stats mode (stats_tile) -------------------------------------------
// DFT on the tensor cores: the block's (frame, mic) rows are one mma row
// tile of kDftRows; the columns are (re, im) pairs, 4 bins a column tile of
// 8; a pass covers kDftTiles column tiles a warp, and the conditioned
// samples are staged kAChunk at a time in two buffers
constexpr int kDftRows = 16;
constexpr int kDftTiles = 8;
constexpr int kDftPassTiles = kWarps * kDftTiles;
constexpr int kAChunk = 128;             // 16 mma steps of 8 samples
constexpr int kAStride = kAChunk + 4;    // staged row (floats): bank 4 g + t
constexpr int kAPerThread = kDftRows * kAChunk / kThreads;
static_assert(kDftRows * kAChunk % kThreads == 0, "whole staged samples per thread");
static_assert(kThreads % kAChunk == 0, "a thread stages one sample column");
constexpr int kStatsStage = 2 * kDftRows * kAStride;   // the two sample buffers
constexpr int kFChunk = 16;       // synthesis-matrix bins staged per step
constexpr int kRowsPerPass = 32;  // (frame, pair) rows a synthesis pass
// the synthesis runs on the tensor cores, a pass of 32 (frame, pair) rows
// as 2 mma row tiles x up to 16 lag tiles, 4 warps side by side over the lag
// tiles of each row tile
constexpr int kStatsTilesN = kLagBlock / 8;     // lag tiles per lag block, at most
constexpr int kStatsWarpsN = 4;
constexpr int kStatsTilesPerWarp = kStatsTilesN / kStatsWarpsN;
static_assert(kWarps == 2 * kStatsWarpsN, "2 row tiles x 4 warps");
// the pass's whitened, banded cross-power of a staged chunk: rows of
// kFChunk (rr, jj) pairs, padded so that a fragment load hits every bank once
constexpr int kXpStride = kFChunk + 4;
constexpr int kStatsXp = kRowsPerPass * kXpStride;
// window sums from registers: a thread owns kRun consecutive bins and holds
// their terms and those of kRegHw neighbours on either side
constexpr int kRun = 16;
constexpr int kRegHw = 16;
constexpr size_t kMaxSmem = 227 * 1024;

// lag tiles (of 8) per lag block of the stats mode's packed synthesis matrix
__host__ __device__ inline int stats_tiles(int l) {
  return (l + 7) / 8 < kStatsTilesN ? (l + 7) / 8 : kStatsTilesN;
}

// Floats of the stats mode's dynamic shared memory for tb frames per block,
// in layout order (16-byte and 8-byte aligned regions first): the sample
// buffers, the packed synthesis chunk, the staged cross-power, the spectra,
// per-row means, a pass's raw correlograms, the smoothed periodograms,
// per-row coherence and per-frame band weight.
size_t stats_smem_floats(int tb, int m, int f, int l, int p) {
  const size_t rows = (size_t)tb * m;
  return (size_t)kStatsStage + (size_t)kFChunk * 32 * stats_tiles(l) + 2 * (size_t)kStatsXp +
         2 * rows * f + rows + (size_t)kRowsPerPass * l + rows * f + (size_t)tb * p * f +
         (size_t)tb * f;
}

// The base body's dynamic shared memory for TB frames of m mics and p pairs
// x l lags with a ring of `ring` stages, in bytes from a 1,024-byte
// boundary, in layout order: the staging region (the DFT's ring; then a
// synthesis step's lag matrices and cross-power of the (frame, pair) rows,
// padded to whole row groups; then the SRP mode's LUT chunk), the ring's
// full and empty barriers, chunk spectra [TB m][kSpecStride] float2, tail
// bins [TB m] float2, means [TB m], the SRP argmax's reduction (kWarps x
// kSrpFrames scores and cells), correlograms [TB p][l].
struct BaseLayout {
  size_t bars, spec, tail, mean, red, corr, end;
  __host__ __device__ BaseLayout(int TB, int m, int p, int l, int ring) {
    const size_t rows = (size_t)TB * m;
    const size_t rp = ((size_t)TB * p + kRowsPerGroup - 1) / kRowsPerGroup * kRowsPerGroup;
    const size_t syn = 4 * (2 * (size_t)kSub * kLagBlock + 2 * rp * kSub);
    const size_t dft = (size_t)ring * kStageBytes;
    bars = ((syn > dft ? syn : dft) + 15) & ~(size_t)15;
    spec = bars + 2 * kMaxRing * sizeof(uint64_t);
    tail = spec + rows * kSpecStride * sizeof(float2);
    mean = tail + rows * sizeof(float2);
    red = mean + rows * sizeof(float);
    corr = red + 2 * (size_t)kWarps * kSrpFrames * sizeof(float);
    end = corr + (size_t)TB * p * l * sizeof(float);
  }
};

// what a block asks for: the layout, the slack that aligns its start and
// `extra` bytes after it (16-byte aligned)
__host__ __device__ inline size_t base_smem_bytes(int TB, int m, int p, int l, int ring,
                                                  size_t extra = 0) {
  return 1024 + ((BaseLayout(TB, m, p, l, ring).end + 15) & ~(size_t)15) + extra;
}

// The ring stages that fit beside the rest (and `extra` bytes), at most
// kMaxRing; fewer than kMinRing: the frames do not fit.
__host__ __device__ inline int ring_stages(int TB, int m, int p, int l, size_t extra = 0) {
  int ring = kMaxRing;
  while (ring >= kMinRing && base_smem_bytes(TB, m, p, l, ring, extra) > kMaxSmem) --ring;
  return ring;
}

__device__ __forceinline__ uint8_t* smem_base() {
  extern __shared__ uint8_t smem_raw[];
  return reinterpret_cast<uint8_t*>(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
}

// The ring's barriers, once a block: full (one arrival, the TMA bytes),
// empty (every warp of the block).
__device__ __forceinline__ void init_ring(uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kMaxRing; ++i) {
      hopper::mbar_init(bars + i, 1);
      hopper::mbar_init(bars + kMaxRing + i, kWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
}

// The stats mode's settings.
struct Stats {
  // the synthesis matrices split and in mma fragment order (the wrapper's
  // pack_split_synthesis): [lag blocks, steps of 4 bins, lag tiles, 32 lanes]
  const float4* synp;
  float* band_out;   // [B, F] per-frame auto band weights, or null
  int band_auto;     // weight the cross-power by the per-event auto band
  int phase;         // phase-slope sub-sample TDOA (with peaks)
  int hybrid;        // keep it only where the row's band coherence clears
  int hw;            // coherence smoothing half-width (bins)
  int min_bins;      // auto band: fewer selected bins -> the interior
  int lo, hi;        // without the auto band: bins [lo, hi) weight the phase
  float rel, floor_, hybrid_min, omega, gain_d;
};

// The SRP mode's operands and outputs (zero in the other instances).
struct Srp {
  const int* lut;    // [P, G] lag index of each (pair, cell)
  int* cell_out;     // [B] first best cell
  float* score_out;  // [B] its score
  float* scores_out; // [B, G] every cell's score
  int G;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Sum of |X[q]|^2 over the bins q of [lo, hi], in ascending order.
__device__ __forceinline__ float window_power(const float2* a, int lo, int hi) {
  float acc = 0.f;
  for (int q = lo; q <= hi; ++q) {
    const float2 v = a[q];
    acc += v.x * v.x + v.y * v.y;
  }
  return acc;
}

// Phase-slope TDOA of one (frame, pair) row, by its warp (the TPU kernel's
// phase_slope_tdoa, without its polynomial atan2).  a, b: the pair's raw
// spectra; g2r: the row's coherence; wb: the frame's auto band or null for
// the bins [lo, hi); bins 0..F-2 take part (Nyquist's phase is sign-only).
__device__ float phase_slope(const float2* a, const float2* b,
                             const float* g2r, const float* wb, int F,
                             float d, float tdoa_par, const Stats& st) {
  const int lane = threadIdx.x & 31;
  const int fk = F - 1;
  auto band = [&](int f) {
    return wb ? wb[f] : (f >= st.lo && f < st.hi ? 1.f : 0.f);
  };
  auto weight = [&](int f, float& rr, float& jj) {
    const float2 x = a[f], y = b[f];
    rr = x.x * y.x + x.y * y.y;
    jj = x.x * y.y - x.y * y.x;
    return (rr * rr + jj * jj) * g2r[f] * band(f);
  };
  float rr, jj, wmax = 0.f;
  for (int f = lane; f < fk; f += 32) wmax = fmaxf(wmax, weight(f, rr, jj));
  const float norm = fmaxf(warp_max(wmax), 1e-30f);
  float den = 0.f;
  for (int f = lane; f < fk; f += 32) {
    const float k = (float)f;
    den += weight(f, rr, jj) / norm * k * k;
  }
  den = fmaxf(warp_sum(den), 1e-20f);
  for (int it = 0; it < 2; ++it) {  // Gauss-Newton on the wrapped phase
    // the derotation e^{i omega f d} of this lane's bins f = lane + 32 j,
    // advanced from bin to bin by the rotation of 32 bins
    float s, c, s32, c32;
    sincosf(st.omega * (float)lane * d, &s, &c);
    sincosf(st.omega * 32.f * d, &s32, &c32);
    float num = 0.f;
    for (int f = lane; f < fk; f += 32) {
      const float k = (float)f;
      const float w = weight(f, rr, jj) / norm;
      num += w * k * atan2f(rr * s + jj * c, rr * c - jj * s);
      const float cn = c * c32 - s * s32;
      s = s * c32 + c * s32;
      c = cn;
    }
    num = warp_sum(num);
    d += fminf(fmaxf(st.gain_d * num / den, -1.f), 1.f);
  }
  if (!st.hybrid) return d;
  float sg = 0.f, sw = 0.f;
  for (int f = lane; f < fk; f += 32) {
    const float v = band(f);
    sg += g2r[f] * v;
    sw += v;
  }
  const float coh = warp_sum(sg) / fmaxf(warp_sum(sw), 1e-12f);
  return coh >= st.hybrid_min ? d : tdoa_par;
}

// Stages 1 and 2 of the stats mode, by the whole block: the per-row means
// and the raw spectra of the tile's R (frame, mic) rows, the DFT on the
// tensor cores.  wp: the packed DFT matrix [N / 8, Fp / 4, 32]; xs: two
// buffers of [kDftRows][kAStride] floats.
__device__ __forceinline__ void
spectra_tensor_cores(const float* x0, int R, int N, int F, int Fp,
                     const float* __restrict__ win, const float2* __restrict__ wp,
                     float* xs, float* mean, float2* spec) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g_ = lane >> 2, t_ = lane & 3;   // the fragments' row and column index
  // ---- 1. per-row mean, and a bin that would have a column tile to itself -
  // With F = L/2 + 1 and L a power of two, F - 1 is whole column tiles of 4
  // bins (and whole passes of them) and the Nyquist bin would cost a further
  // tile, often a further pass, for one bin.  The warp that has just read
  // the row sums that bin instead, over the samples (32 strided terms a
  // lane, then across the lanes).
  const int nt_all = Fp / 4;                 // column tiles of the packed matrix
  const int tail = (F > 1 && F % 4 == 1) ? 1 : 0;
  const int Fd = F - tail;                   // bins of the DFT passes
  const int nt = (Fd + 3) / 4;
  for (int r = warp; r < R; r += kWarps) {
    const float* xr = x0 + (size_t)r * N;
    float s = 0.f;
    for (int n = lane; n < N; n += 32) s += xr[n];
    s = warp_sum(s);
    const float mu = s / (float)N;
    if (lane == 0) mean[r] = mu;
    if (tail) {
      // bin F - 1 is column pair 0 of tile (F - 1) / 4: lanes t (re) and
      // 4 + t (im) of sample n's step, half n / 4 % 2
      const float2* wt = wp + (size_t)((F - 1) / 4) * 32;
      float re0 = 0.f, im0 = 0.f;
      for (int n = lane; n < N; n += 32) {
        const float v = (xr[n] - mu) * win[n];
        const float2* at = wt + (size_t)(n / 8) * nt_all * 32 + n % 4;
        const float2 cr = __ldg(at), ci = __ldg(at + 4);
        const bool hi = (n & 4) != 0;
        re0 = fmaf(v, hi ? cr.y : cr.x, re0);
        im0 = fmaf(v, hi ? ci.y : ci.x, im0);
      }
      re0 = warp_sum(re0);
      im0 = warp_sum(im0);
      if (lane == 0) spec[(size_t)r * F + F - 1] = make_float2(re0, im0);
    }
  }
  __syncthreads();

  // ---- 2. DFT on the tensor cores ------------------------------------------
  // [16 rows, N] x [N, 2 Fd] as a split-fp32 product (mma.sync m16n8k8, TF32
  // operands, fp32 sums): the conditioned samples are staged and split as
  // they leave shared memory; every coefficient is used by one warp of the
  // block only, so it comes straight from the packed matrix in L2 as the
  // fragment wants it (8 bytes a lane, a step ahead of its use) and is split
  // in registers.  A step of 8 samples adds x_lo w_hi, then x_hi w_lo, then
  // x_hi w_hi.  The sum has two levels: the 16 steps of a staged chunk in
  // the accumulators, then into the spectrum in shared memory (fp32, round
  // to nearest), so the tensor cores' truncating adds stay short.
  const int n_steps = (N + 7) / 8;
  const int n_chunks = (N + kAChunk - 1) / kAChunk;
  for (int r0 = 0; r0 < R; r0 += kDftRows) {
    for (int j0 = 0; j0 < nt; j0 += kDftPassTiles) {
      // the conditioned samples of the next chunk wait in registers while
      // the current chunk multiplies
      float xr[kAPerThread];
      auto fetch = [&](int n0) {
        const int n = n0 + tid % kAChunk;
#pragma unroll
        for (int i = 0; i < kAPerThread; ++i) {
          const int r = r0 + tid / kAChunk + i * (kThreads / kAChunk);
          xr[i] = (r < R && n < N) ? (x0[(size_t)r * N + n] - mean[r]) * win[n] : 0.f;
        }
      };
      // this warp's column tiles of the pass: j0 + warp + 8 jj
      auto load_b = [&](float2 (&dst)[kDftTiles], int s) {
#pragma unroll
        for (int jj = 0; jj < kDftTiles; ++jj) {
          const int j = j0 + warp + kWarps * jj;
          dst[jj] = j < nt ? __ldg(wp + ((size_t)s * nt_all + j) * 32 + lane)
                           : make_float2(0.f, 0.f);
        }
      };
      fetch(0);
      for (int c = 0; c < n_chunks; ++c) {
        float* buf = xs + (c & 1) * kDftRows * kAStride;
#pragma unroll
        for (int i = 0; i < kAPerThread; ++i)
          buf[(tid / kAChunk + i * (kThreads / kAChunk)) * kAStride + tid % kAChunk] = xr[i];
        __syncthreads();   // the buffer of chunk c - 1 is free again after the next one
        if (c + 1 < n_chunks) fetch((c + 1) * kAChunk);
        float part[kDftTiles][4];
#pragma unroll
        for (int jj = 0; jj < kDftTiles; ++jj)
#pragma unroll
          for (int k = 0; k < 4; ++k) part[jj][k] = 0.f;
        const int s0 = c * (kAChunk / 8);
        const int steps = min(kAChunk / 8, n_steps - s0);
        float2 bcur[kDftTiles], bnxt[kDftTiles];
        load_b(bcur, s0);
#pragma unroll 2
        for (int q = 0; q < steps; ++q) {
          if (q + 1 < steps) load_b(bnxt, s0 + q + 1);
          const float* ap = buf + g_ * kAStride + 8 * q + t_;
          uint32_t ah[4], al[4];
          hopper::tf32_split(ap[0], ah[0], al[0]);
          hopper::tf32_split(ap[8 * kAStride], ah[1], al[1]);
          hopper::tf32_split(ap[4], ah[2], al[2]);
          hopper::tf32_split(ap[8 * kAStride + 4], ah[3], al[3]);
          uint32_t bh[kDftTiles][2], bl[kDftTiles][2];
#pragma unroll
          for (int jj = 0; jj < kDftTiles; ++jj) {
            hopper::tf32_split(bcur[jj].x, bh[jj][0], bl[jj][0]);
            hopper::tf32_split(bcur[jj].y, bh[jj][1], bl[jj][1]);
          }
          // A step's three products are summed in the tensor cores, small
          // terms first, from zero; the step is then added to the chunk's
          // sum on the CUDA cores, which round where the tensor cores cut.
          // Four column tiles at a time.
#pragma unroll
          for (int j4 = 0; j4 < kDftTiles; j4 += 4) {
            float step[4][4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              if (j0 + warp + kWarps * (j4 + jj) < nt)
                hopper::mma_tf32_zero(step[jj], al, bh[j4 + jj]);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              if (j0 + warp + kWarps * (j4 + jj) < nt)
                hopper::mma_tf32(step[jj], ah, bl[j4 + jj]);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              if (j0 + warp + kWarps * (j4 + jj) < nt)
                hopper::mma_tf32(step[jj], ah, bh[j4 + jj]);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              if (j0 + warp + kWarps * (j4 + jj) < nt) {
#pragma unroll
                for (int k = 0; k < 4; ++k) part[j4 + jj][k] += step[jj][k];
              }
          }
#pragma unroll
          for (int jj = 0; jj < kDftTiles; ++jj) bcur[jj] = bnxt[jj];
        }
        // the chunk's sums into the spectrum: fragment rows g and g + 8,
        // columns (re, im) of bin 4 j + t
#pragma unroll
        for (int jj = 0; jj < kDftTiles; ++jj) {
          const int f = 4 * (j0 + warp + kWarps * jj) + t_;
          if (f >= Fd) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + g_ + 8 * h;
            if (row >= R) continue;
            float2* at = spec + (size_t)row * F + f;
            float2 v = make_float2(part[jj][2 * h], part[jj][2 * h + 1]);
            if (c > 0) {
              const float2 o = *at;
              v.x += o.x;
              v.y += o.y;
            }
            *at = v;
          }
        }
      }
      __syncthreads();   // both buffers are free for the next pass
    }
  }
}

// The peak stage of one raw correlogram row c [L], by its warp: without
// peaks the row is written out as it is; with them the first maximum, the
// parabolic sub-sample offset and the PSR of the raw row, and the tapered
// row written out.  keep_tapered leaves the tapered values, rounded to bf16,
// in the row's place (the SRP mode scores them).
__device__ void row_peaks(float* c, int L, float* __restrict__ out, size_t grow,
                          int* __restrict__ shift_out, float* __restrict__ tdoa_out,
                          float* __restrict__ peak_out, float* __restrict__ psr_out,
                          float taper_denom, int with_peaks, bool keep_tapered) {
  const int lane = threadIdx.x & 31;
  if (!with_peaks) {
    for (int l = lane; l < L; l += 32) out[l] = c[l];
    return;
  }
  const int K = (L - 1) / 2;
  // first maximum: lanes scan ascending lags, ties go to the lower lag
  float best = -INFINITY;
  int bi = L;
  for (int l = lane; l < L; l += 32) {
    const float v = c[l];
    if (v > best) { best = v; bi = l; }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (ov > best || (ov == best && oi < bi)) { best = ov; bi = oi; }
  }
  const int idx = bi < L ? bi : 0;   // all-NaN / all -inf rows
  const float v0 = c[idx];
  const bool interior = idx >= 1 && idx <= L - 2;
  const float cm = idx >= 1 ? c[idx - 1] : 0.f;
  const float cp = idx <= L - 2 ? c[idx + 1] : 0.f;
  const float den = cm - 2.f * v0 + cp;
  float delta = (interior && fabsf(den) > 1e-20f) ? 0.5f * (cm - cp) / den : 0.f;
  delta = fminf(fmaxf(delta, -0.5f), 0.5f);

  float side = -INFINITY;
  for (int l = lane; l < L; l += 32)
    if (abs(l - idx) > 3) side = fmaxf(side, c[l]);
  side = warp_max(side);
  __syncwarp();   // every lane has read the peak's neighbours

  for (int l = lane; l < L; l += 32) {
    const float d = (float)(l - idx);
    const float v = c[l] * expf(-(d * d) / taper_denom);
    out[l] = v;
    if (keep_tapered) c[l] = round_bf16(v);
  }
  if (lane == 0) {
    shift_out[grow] = idx - K;
    tdoa_out[grow] = (float)(idx - K) + delta;
    peak_out[grow] = v0;
    psr_out[grow] = fabsf(v0) / fmaxf(fabsf(side), 1e-20f);
  }
}

// A warp adds the staged bins (fmax of them) into the correlograms of the
// kRowsPerGroup (frame, pair) rows from r0 (staged cross-power xp [rows][kSub],
// zero past RP), a lane owning the lags l0 + lane + 32 j, j < kJ, of the lag
// block (staged (cos, sin) syn [kSub][kLagBlock], zero past L), in ascending
// bin order.
template <int kJ>
__device__ __forceinline__ void synth_rows(float* corr, const float2* xp, const float2* syn,
                                           int r0, int RP, int L, int l0, int fmax) {
  const int lane = threadIdx.x & 31;
  float acc[kRowsPerGroup][kJ];
#pragma unroll
  for (int k = 0; k < kRowsPerGroup; ++k)
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int l = l0 + lane + 32 * j;
      acc[k][j] = (r0 + k < RP && l < L) ? corr[(size_t)(r0 + k) * L + l] : 0.f;
    }
#pragma unroll 4
  for (int ff = 0; ff < fmax; ++ff) {
    float2 cs[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) cs[j] = syn[ff * kLagBlock + lane + 32 * j];
#pragma unroll
    for (int k = 0; k < kRowsPerGroup; ++k) {
      const float2 v = xp[(r0 + k) * kSub + ff];
#pragma unroll
      for (int j = 0; j < kJ; ++j) acc[k][j] = fmaf(v.x, cs[j].x, fmaf(v.y, cs[j].y, acc[k][j]));
    }
  }
#pragma unroll
  for (int k = 0; k < kRowsPerGroup; ++k)
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int l = l0 + lane + 32 * j;
      if (r0 + k < RP && l < L) corr[(size_t)(r0 + k) * L + l] = acc[k][j];
    }
}

// One tile of tb frames in the base mode (kSrp: and the SRP scores), by the
// whole block; see the note at the top.  x0 points at the tile's frames
// [tb, M, N], rows ld floats apart (device memory, or with !kXTma the
// pipelined instance's staging buffer, from which the DFT also reads them),
// b0 is its first frame's index in the outputs.  The shared memory at sm is
// laid out for TB frames and `nring` ring stages (BaseLayout), its ring
// barriers initialised (init_ring); ring counts the ring's stages loaded so
// far by this block, across tiles.  wmap: the split coefficients (the
// wrapper's pack_dft_split) as a [2 cp, K] matrix, hi rows then lo rows;
// xmap (kXTma): the frames as [B M, ld], the tile's rows from xrow.
// after_dft() is called by every thread once the last bin chunk's DFT is
// done and x0 is spent.  kSpectra (the pair instance's spectra phase; P = L
// = 0): no synthesis and no peaks; each chunk's whitened (M >= 3) or raw
// spectra go out to spec_out [B M][sld] float2 instead, and the last chunk
// zero-fills each row's bins past F.
template <bool kXTma, bool kSrp, bool kSpectra, typename AfterDft>
__device__ __forceinline__ void
base_tile(const float* x0, int ld, int b0, int tb, int TB, uint8_t* sm, int nring,
          uint32_t& ring, const CUtensorMap* wmap, int cp, const CUtensorMap* xmap, int xrow,
          const float* __restrict__ win,      // [N] window * gain
          const float2* __restrict__ wtail,   // [N] (cos, -sin) of bin F - 1
          const float* __restrict__ sync,     // [F, L]
          const float* __restrict__ syns,     // [F, L]
          const int* __restrict__ pairs,      // [P, 2]
          float* __restrict__ corr_out,       // [B, P, L]
          int* __restrict__ shift_out,        // [B, P] (peaks only)
          float* __restrict__ tdoa_out,
          float* __restrict__ peak_out,
          float* __restrict__ psr_out,
          int M, int N, int F, int P, int L,
          int phat, int per_mic, float eps2, float taper_denom, int with_peaks,
          Srp srp, float2* __restrict__ spec_out, int sld, AfterDft after_dft) {
  const BaseLayout lay(TB, M, P, L, nring);
  const int R = tb * M;    // (frame, mic) rows of this tile, at most kBlockRows
  const int RP = tb * P;   // (frame, pair) rows of this tile
  const size_t stage_n = lay.bars / sizeof(float);
  float* stage = reinterpret_cast<float*>(sm);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + lay.bars);
  uint64_t* empty = full + kMaxRing;
  float2* spec = reinterpret_cast<float2*>(sm + lay.spec);      // [R][kSpecStride]
  float2* tailv = reinterpret_cast<float2*>(sm + lay.tail);     // [R]
  float* mean = reinterpret_cast<float*>(sm + lay.mean);
  float* red = reinterpret_cast<float*>(sm + lay.red);          // [2][kWarps][kSrpFrames]
  float* corr = reinterpret_cast<float*>(sm + lay.corr);        // [RP][L]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g_ = lane >> 2, t_ = lane & 3;   // the fragments' row and column index
  const int tail = (F > 1 && F % 4 == 1) ? 1 : 0;
  const int Fd = F - tail;                   // bins of the DFT chunks
  const int n_chunks = (Fd + kChunkBins - 1) / kChunkBins;
  const int nkb = (N + kKStage - 1) / kKStage;   // ring stages a chunk
  const uint32_t xbytes = kXTma ? kXTileBytes : 0;

  // Stage kb of chunk c into the ring's slot for the block's k-th load (by
  // thread 0), once every warp has released the slot's previous load: the
  // frames tile (kXTma) and the coefficients' hi and lo tiles.
  auto issue = [&](uint32_t k, int kb, int c) {
    const int slot = k % nring;
    if (!hopper::mbar_wait_bounded(empty + slot, ((k / nring) & 1) ^ 1)) __trap();
    uint8_t* dst = sm + slot * kStageBytes;
    hopper::mbar_expect_tx(full + slot, xbytes + 2 * kBTileBytes);
    if (kXTma) hopper::tma_load_2d(dst, xmap, full + slot, kKStage * kb, xrow);
    dst += kXTileBytes;
    hopper::tma_load_2d(dst, wmap, full + slot, kKStage * kb, kChunkCols * c);
    hopper::tma_load_2d(dst + kBTileBytes, wmap, full + slot, kKStage * kb,
                        cp + kChunkCols * c);
  };
  // a warp's release of the slot of the k-th load
  auto release = [&](uint32_t k) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + k % nring);
  };
  // the staging region's last generic accesses come before the copies into it
  auto sync_block = [&] {
    hopper::fence_proxy_async();
    __syncthreads();
  };
  sync_block();
  if (tid == 0)
    for (int kb = 0; kb < nring && kb < nkb; ++kb) issue(ring + kb, kb, 0);

  // ---- 1. per-row mean, and a bin that would have a column tile to itself -
  // With F = L/2 + 1 and L a power of two, F - 1 is whole chunks of bins and
  // the Nyquist bin would cost a further chunk for one bin.  The warp that
  // has just read the row sums that bin instead, over the samples (32
  // strided terms a lane, then across the lanes), against its unsplit
  // coefficients.
  for (int r = warp; r < R; r += kWarps) {
    float mu = 0.f, re0 = 0.f, im0 = 0.f;
    const float* xr = x0 + (size_t)r * ld;
    float s = 0.f;
    for (int n = lane; n < N; n += 32) s += xr[n];
    mu = warp_sum(s) / (float)N;
    if (tail) {
      for (int n = lane; n < N; n += 32) {
        const float v = (xr[n] - mu) * __ldg(win + n);
        const float2 w = __ldg(wtail + n);
        re0 = fmaf(v, w.x, re0);
        im0 = fmaf(v, w.y, im0);
      }
      re0 = warp_sum(re0);
      im0 = warp_sum(im0);
    }
    if (lane == 0) {
      mean[r] = mu;
      tailv[r] = make_float2(re0, im0);
    }
  }
  for (int e = tid; e < RP * L; e += kThreads) corr[e] = 0.f;
  __syncthreads();

  // This thread's DFT rows: rows ra and ra + 8 of its warp's 16 in its
  // warpgroup's row tile.  A step of 8 samples holds sample 8 s + 2 t in K
  // slot t and 8 s + 2 t + 1 in slot t + 4 (pack_dft_split orders the
  // coefficients so), so a lane reads its four A values as two 8-byte pairs
  // of shared memory.
  const int wg = warp >> 2;
  const int ra = 64 * wg + 16 * (warp & 3) + g_, rb = ra + 8;
  const bool ok_a = ra < R, ok_b = rb < R;
  const float mu_a = ok_a ? mean[ra] : 0.f, mu_b = ok_b ? mean[rb] : 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int f0 = kChunkBins * c;             // the chunk's first bin
    const int nb = min(kChunkBins, Fd - f0);   // its DFT bins
    const bool last = c + 1 == n_chunks;
    const int nbs = nb + (last ? tail : 0);    // and the bins it synthesises
    if (c > 0) {
      // the synthesis's writes to the staging region come before the copies
      sync_block();
      if (tid == 0)
        for (int kb = 0; kb < nring && kb < nkb; ++kb) issue(ring + kb, kb, c);
    }

    // ---- 2. the chunk's spectra on the tensor cores ----------------------
    // [R rows, N] x [N, 2 nb] as a split-fp32 product: each warpgroup its 64
    // rows x kChunkCols columns as two halves (wgmma m64n64k8, A from
    // registers, B from the ring).  A step's three products are summed in
    // the tensor cores from zero, small terms first; the step is then added
    // on the CUDA cores (which round where the tensor cores cut), and the
    // sum flushed into the spectra every kFlushSteps steps.  The halves take
    // turns: while one half's products run, the other's sum of the step
    // before is added, so one group of products is always in flight.
    float acc0[32], acc1[32], part[64];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = part[i] = part[32 + i] = 0.f;
    // two groups' fragments: one multiplies, one is formed
    uint32_t ah[2][kTcSteps][4], al[2][kTcSteps][4];
    // half h's fragment rows ra and rb, columns (re, im) of bin 32 h + 4 j + t
    auto flush = [&](bool first) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int bin = 32 * (j / 8) + 4 * (j % 8) + t_;
        if (bin < nb) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (!(h ? ok_b : ok_a)) continue;
            float2* at = spec + (h ? rb : ra) * kSpecStride + bin;
            float2 v = make_float2(part[4 * j + 2 * h], part[4 * j + 2 * h + 1]);
            if (!first) {
              const float2 o = *at;
              v.x += o.x;
              v.y += o.y;
            }
            *at = v;
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) part[4 * j + k] = 0.f;
      }
    };
    // two stages a turn, so that a group's fragment buffer is known at
    // compile time
    for (int kb0 = 0; kb0 < nkb; kb0 += 2) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kb = kb0 + u;
        if (kb >= nkb) break;
        const int s0 = kStageSteps * kb;
        const uint32_t k = ring + kb;
        const uint8_t* st = sm + (k % nring) * kStageBytes;
        // a copy that never lands is a fault of a tensor map or the card: stop
        // the kernel with an error where waiting on would hang it
        if (!hopper::mbar_wait_bounded(full + k % nring, (k / nring) & 1)) __trap();
        // this stage's samples of rows ra and rb: the frames tile, or the
        // staging buffer
        const float* xa = kXTma ? reinterpret_cast<const float*>(st) + ra * kKStage
                                : x0 + (size_t)(ok_a ? ra : 0) * ld + kKStage * kb;
        const float* xb = kXTma ? reinterpret_cast<const float*>(st) + rb * kKStage
                                : x0 + (size_t)(ok_b ? rb : 0) * ld + kKStage * kb;
        const uint64_t dh = hopper::wgmma_desc_k64(st + kXTileBytes);
        const uint64_t dl = hopper::wgmma_desc_k64(st + kXTileBytes + kBTileBytes);
        constexpr uint64_t kHalf = (kHalfCols * kRowBytes) >> 4;   // descriptor units
#pragma unroll
        for (int gq = 0; gq < kStageSteps / kTcSteps; ++gq) {
          const int sg = s0 + kTcSteps * gq;   // the group's first step
          const int b = (u * (kStageSteps / kTcSteps) + gq) & 1;
          // the group's A fragments: samples 8 s + 2 t and + 1 of each step
          // (zero past N, or outside the tile)
#pragma unroll
          for (int j = 0; j < kTcSteps; ++j) {
            const int n = 8 * (sg + j) + 2 * t_;
            const bool i0 = n < N, i1 = n + 1 < N;
            const int o = 8 * (kTcSteps * gq + j) + 2 * t_;
            const float2 va =
                make_float2(ok_a && i0 ? xa[o] : 0.f, ok_a && i1 ? xa[o + 1] : 0.f);
            const float2 vb =
                make_float2(ok_b && i0 ? xb[o] : 0.f, ok_b && i1 ? xb[o + 1] : 0.f);
            const float2 w =
                make_float2(i0 ? __ldg(win + n) : 0.f, i1 ? __ldg(win + n + 1) : 0.f);
            hopper::tf32_split((va.x - mu_a) * w.x, ah[b][j][0], al[b][j][0]);
            hopper::tf32_split((vb.x - mu_b) * w.x, ah[b][j][1], al[b][j][1]);
            hopper::tf32_split((va.y - mu_a) * w.y, ah[b][j][2], al[b][j][2]);
            hopper::tf32_split((vb.y - mu_b) * w.y, ah[b][j][3], al[b][j][3]);
          }
          // half h's products of the group: each step's three in today's
          // order, the first from zero
          auto products = [&](float (&acc)[32], uint64_t off) {
#pragma unroll
            for (int i = 0; i < 32; ++i) hopper::keep(acc[i]);
            hopper::wgmma_fence();
#pragma unroll
            for (int j = 0; j < kTcSteps; ++j) {
              const int q = kTcSteps * gq + j;   // the step within the stage
              hopper::wgmma_m64n64_tf32(acc, al[b][j], dh + off + 2 * q, j > 0);
              hopper::wgmma_m64n64_tf32(acc, ah[b][j], dl + off + 2 * q);
              hopper::wgmma_m64n64_tf32(acc, ah[b][j], dh + off + 2 * q);
            }
            hopper::wgmma_commit();
          };
          products(acc0, 0);
          if (sg > 0) {
            // half 1 of the group before is done: its sum, the flush of the
            // steps before sg, the release of the stage that ended there and
            // the next copy into its slot
            hopper::wgmma_wait<1>();
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              hopper::keep(acc1[i]);
              part[32 + i] += acc1[i];
            }
            if (sg % kFlushSteps == 0) flush(sg == kFlushSteps);
            if (gq == 0) {
              release(k - 1);
              if (kb + nring - 1 < nkb) {
                if (tid == 0) issue(k + nring - 1, kb + nring - 1, c);
                __syncwarp();
              }
            }
          }
          products(acc1, kHalf);
          hopper::wgmma_wait<1>();   // half 0 of the group is done
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            hopper::keep(acc0[i]);
            part[i] += acc0[i];
          }
        }
      }
    }
    hopper::wgmma_wait0();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      hopper::keep(acc1[i]);
      part[32 + i] += acc1[i];
    }
    flush(kStageSteps * nkb <= kFlushSteps);
    release(ring + nkb - 1);
    ring += nkb;
    __syncthreads();   // the chunk's spectra are whole; the staging region is free
    if (last) after_dft();

    // ---- 3. per-mic PHAT, and the tail bin into its column ----------------
    if (per_mic || nbs > nb) {
      for (int e = tid; e < R * nbs; e += kThreads) {
        const int r = e / nbs, col = e % nbs;
        float2* at = spec + r * kSpecStride + col;
        float2 v = col < nb ? *at : tailv[r];
        if (per_mic) {
          const float inv = rsqrtf(v.x * v.x + v.y * v.y + eps2);
          v.x *= inv;
          v.y *= inv;
        }
        *at = v;
      }
      __syncthreads();
    }

    if constexpr (kSpectra) {
      // ---- 4. (spectra phase) the chunk's bins of every row out ----------
      const int ncol = last ? sld - f0 : nbs;
      for (int e = tid; e < R * ncol; e += kThreads) {
        const int r = e / ncol, col = e % ncol;
        spec_out[((size_t)b0 * M + r) * sld + f0 + col] =
            col < nbs ? spec[r * kSpecStride + col] : make_float2(0.f, 0.f);
      }
      continue;
    }

    // ---- 4. cross-power and lag synthesis, kSub bins at a time -------------
    // The cross-power of every (frame, pair) row (per-pair PHAT for 2-mic
    // arrays) and the bins' (cos, sin) rows of a lag block are staged; a
    // warp then adds the bins, in ascending order, into the correlograms of
    // kRowsPerGroup rows at a time, a lane owning the lags lane + 32 j.
    const int rpg = (RP + kRowsPerGroup - 1) / kRowsPerGroup * kRowsPerGroup;
    float2* xp = reinterpret_cast<float2*>(stage);   // [rpg][kSub]
    float2* syn = xp + (size_t)rpg * kSub;           // [kSub][kLagBlock]
    for (int fb = 0; fb < nbs; fb += kSub) {
      const int fmax = min(kSub, nbs - fb);
      for (int e = tid; e < rpg * kSub; e += kThreads) {
        const int row = e / kSub, ff = e % kSub;
        float rr = 0.f, jj = 0.f;
        if (row < RP && ff < fmax) {
          const int t = row / P, p = row % P;
          const float2 a = spec[(t * M + __ldg(pairs + 2 * p)) * kSpecStride + fb + ff];
          const float2 b = spec[(t * M + __ldg(pairs + 2 * p + 1)) * kSpecStride + fb + ff];
          rr = a.x * b.x + a.y * b.y;
          jj = a.x * b.y - a.y * b.x;
          if (phat && !per_mic) {
            const float inv = rsqrtf(rr * rr + jj * jj + eps2);
            rr *= inv;
            jj *= inv;
          }
        }
        xp[e] = make_float2(rr, jj);
      }
      for (int l0 = 0; l0 < L; l0 += kLagBlock) {
        // every load of the step in flight at once
#pragma unroll
        for (int i = 0; i < kSub * kLagBlock / kThreads; ++i) {
          const int e = tid + i * kThreads;
          const int ff = e / kLagBlock, l = l0 + e % kLagBlock;
          const size_t f = (size_t)f0 + fb + ff;
          syn[e] = (ff < fmax && l < L)
                       ? make_float2(__ldg(sync + f * L + l), __ldg(syns + f * L + l))
                       : make_float2(0.f, 0.f);
        }
        __syncthreads();
        const int nj = min(kLagsPerLane, (L - l0 + 31) / 32);
        for (int r0 = warp * kRowsPerGroup; r0 < RP; r0 += kWarps * kRowsPerGroup) {
          switch (nj) {
            case 4: synth_rows<4>(corr, xp, syn, r0, RP, L, l0, fmax); break;
            case 3: synth_rows<3>(corr, xp, syn, r0, RP, L, l0, fmax); break;
            case 2: synth_rows<2>(corr, xp, syn, r0, RP, L, l0, fmax); break;
            default: synth_rows<1>(corr, xp, syn, r0, RP, L, l0, fmax); break;
          }
        }
        __syncthreads();
      }
    }
  }

  if constexpr (kSpectra) return;

  // ---- 5. peaks, a row per warp ----------------------------------------------
  for (int row = warp; row < RP; row += kWarps) {
    const size_t grow = (size_t)b0 * P + row;   // global (frame, pair) row
    row_peaks(corr + (size_t)row * L, L, corr_out + grow * L, grow, shift_out, tdoa_out,
              peak_out, psr_out, taper_denom, with_peaks, kSrp);
  }

  if constexpr (kSrp) {
    // ---- 6. SRP scores and grid argmax ---------------------------------------
    // The LUT is staged as int16, clamped to the lag axis, as many cells at a
    // time as the staging region holds; a thread scores its cells for
    // kSrpFrames frames at a time, the pairs' bf16-rounded tapered values
    // summed in pair order, and keeps each frame's first maximum; the block
    // then reduces them with ties to the lower cell.
    short* lut_s = reinterpret_cast<short*>(stage);
    const int cap = (int)(stage_n * 2 / (size_t)P);
    const int gc = srp.G < cap ? srp.G : cap;
    int* red_c = reinterpret_cast<int*>(red + kWarps * kSrpFrames);
    for (int t0 = 0; t0 < tb; t0 += kSrpFrames) {
      float best[kSrpFrames];
      int cell[kSrpFrames];
#pragma unroll
      for (int tt = 0; tt < kSrpFrames; ++tt) {
        best[tt] = -INFINITY;
        cell[tt] = 0x7fffffff;
      }
      for (int g0 = 0; g0 < srp.G; g0 += gc) {
        const int nc = min(gc, srp.G - g0);
        __syncthreads();   // the rows are tapered; the last LUT chunk is spent
        for (int e = tid; e < P * nc; e += kThreads) {
          const int p = e / nc, g = e % nc;
          lut_s[e] = (short)min(max(__ldg(srp.lut + (size_t)p * srp.G + g0 + g), 0), L - 1);
        }
        __syncthreads();
        for (int g = tid; g < nc; g += kThreads) {
#pragma unroll
          for (int tt = 0; tt < kSrpFrames; ++tt) {
            const int t = t0 + tt;
            if (t >= tb) break;
            const float* tp = corr + (size_t)t * P * L;
            float s = 0.f;
            for (int p = 0; p < P; ++p) s += tp[(size_t)p * L + lut_s[p * nc + g]];
            srp.scores_out[(size_t)(b0 + t) * srp.G + g0 + g] = s;
            if (s > best[tt]) {   // ascending g: first maximum
              best[tt] = s;
              cell[tt] = g0 + g;
            }
          }
        }
      }
#pragma unroll
      for (int tt = 0; tt < kSrpFrames; ++tt) {
        float b = best[tt];
        int cc = cell[tt];
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, b, off);
          const int oc = __shfl_xor_sync(0xffffffffu, cc, off);
          if (ov > b || (ov == b && oc < cc)) { b = ov; cc = oc; }
        }
        if (lane == 0) {
          red[warp * kSrpFrames + tt] = b;
          red_c[warp * kSrpFrames + tt] = cc;
        }
      }
      __syncthreads();
      if (warp == 0 && lane < kSrpFrames && t0 + lane < tb) {
        float b = -INFINITY;
        int cc = 0x7fffffff;
        for (int w = 0; w < kWarps; ++w) {
          const float ov = red[w * kSrpFrames + lane];
          const int oc = red_c[w * kSrpFrames + lane];
          if (ov > b || (ov == b && oc < cc)) { b = ov; cc = oc; }
        }
        srp.cell_out[b0 + t0 + lane] = cc < srp.G ? cc : 0;   // all-NaN scores
        srp.score_out[b0 + t0 + lane] = b;
      }
    }
  }
}

// The pair instance's plan: the spectra phase's ring (base_tile at a full
// tile of kBlockRows / m frames, no correlograms) and the pair phase's ring
// in the same staging region, stages of `slot` bytes.
struct PairPlan {
  int nring;   // the spectra phase's ring stages
  int sbox;    // rows of a spectra box
  int nbox;    // spectra boxes a stage
  int slot;    // bytes of a pair-phase stage
  int pring;   // the pair phase's ring stages
};

// Frames that kBlockRows consecutive (frame, pair) rows span, at most.
__host__ __device__ inline int pair_tile_frames(int p) { return (kBlockRows - 1) / p + 2; }

// false when the pair phase does not take m mics and p pairs (its ring
// would have fewer than kMinRing stages)
inline bool pair_plan(int m, int p, PairPlan* pl) {
  if (m < 2 || m > kBlockRows || p < 1) return false;
  const int tb = kBlockRows / m;
  pl->nring = ring_stages(tb, m, 0, 0);
  if (pl->nring < kMinRing) return false;
  const int rows = pair_tile_frames(p) * m;
  pl->nbox = (rows + kBoxRows - 1) / kBoxRows;
  pl->sbox = (rows + pl->nbox - 1) / pl->nbox;
  pl->slot = (2 * kPairBTileBytes + pl->nbox * pl->sbox * kRowBytes + 1023) & ~1023;
  const size_t stages = BaseLayout(tb, m, 0, 0, pl->nring).bars / (size_t)pl->slot;
  pl->pring = stages < (size_t)kMaxRing ? (int)stages : kMaxRing;
  return pl->pring >= kMinRing;
}

// One pair tile, the kBlockRows (frame, pair) rows from q kBlockRows, by the
// whole block; see the note at the top.  The ring (pl.pring stages of
// pl.slot bytes at sm) has its barriers at full (full, then empty); ring
// counts its loads so far.  smap: the spectra [B M, 2 Fs] (Fs = F padded to
// whole stages), written by spectra tile s (TBs frames) once ready[s] is
// set; bmap: the synthesis matrices split (the wrapper's
// pack_synthesis_split) as [2 n_lb kPairCols, 2 Fs], hi rows then lo rows.
__device__ __forceinline__ void
pair_tile(int q, uint8_t* sm, const PairPlan& pl, uint64_t* full, uint32_t& ring,
          const CUtensorMap* smap, const CUtensorMap* bmap,
          const int* __restrict__ pairs,   // [P, 2]
          const int* ready,                // [spectra tiles]
          float* __restrict__ corr_out,    // [B, P, L]
          int B, int M, int F, int P, int L, int TBs, int phat, int per_mic, float eps2) {
  uint64_t* empty = full + kMaxRing;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t_ = lane & 3;
  const long long rows = (long long)B * P;
  const long long r0 = (long long)q * kBlockRows;
  const int f_lo = (int)(r0 / P);
  const int f_hi = (int)(((r0 + kBlockRows < rows ? r0 + kBlockRows : rows) - 1) / P);
  const int nks = (F + kStageBins - 1) / kStageBins;   // ring stages a lag block
  const int n_lb = (L + kPairCols - 1) / kPairCols;
  const uint32_t bytes = 2 * kPairBTileBytes + pl.nbox * pl.sbox * kRowBytes;

  // This thread's rows ra and rb of its warpgroup's row tile (as the DFT's),
  // and where their pairs' mics lie in a stage's spectra (floats).
  const long long ra = r0 + 64 * (warp >> 2) + 16 * (warp & 3) + (lane >> 2), rb = ra + 8;
  const bool ok_a = ra < rows, ok_b = rb < rows;
  auto mic_at = [&](long long r, int k) {
    const int p = (int)(r % P);
    return (((int)(r / P) - f_lo) * M + __ldg(pairs + 2 * p + k)) * kKStage;
  };
  const int ia = ok_a ? mic_at(ra, 0) : 0, ja = ok_a ? mic_at(ra, 1) : 0;
  const int ib = ok_b ? mic_at(rb, 0) : 0, jb = ok_b ? mic_at(rb, 1) : 0;

  // Stage kb of lag block lb into the ring's slot for the block's k-th load
  // (by thread 0), once every warp has released the slot's previous load.
  auto issue = [&](uint32_t k, int kb, int lb) {
    const int slot = k % pl.pring;
    if (!hopper::mbar_wait_bounded(empty + slot, ((k / pl.pring) & 1) ^ 1)) __trap();
    uint8_t* dst = sm + (size_t)slot * pl.slot;
    hopper::mbar_expect_tx(full + slot, bytes);
    hopper::tma_load_2d(dst, bmap, full + slot, kKStage * kb, kPairCols * lb);
    hopper::tma_load_2d(dst + kPairBTileBytes, bmap, full + slot, kKStage * kb,
                        kPairCols * (n_lb + lb));
    for (int i = 0; i < pl.nbox; ++i)
      hopper::tma_load_2d(dst + 2 * kPairBTileBytes + i * pl.sbox * kRowBytes, smap,
                          full + slot, kKStage * kb, f_lo * M + i * pl.sbox);
  };
  auto release = [&](uint32_t k) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + k % pl.pring);
  };

  // the spectra of the tile's frames are whole, and visible to the copies
  if (tid == 0) {
    for (int s = f_lo / TBs; s <= f_hi / TBs; ++s)
      if (!hopper::wait_flag(ready + s)) __trap();
    hopper::fence_proxy_async_global();
  }

  for (int lb = 0; lb < n_lb; ++lb) {
    __syncthreads();   // every warp has left the lag block before
    if (tid == 0)
      for (int kb = 0; kb < pl.pring && kb < nks; ++kb) issue(ring + kb, kb, lb);

    // [128 rows, K] x [K, kPairCols] as a split-fp32 product, the DFT's
    // scheme: each warpgroup its 64 rows as two halves of kPairHalf lags
    // (wgmma m64n48k8, A from registers, B from the ring); a group of
    // kTcSteps steps' three products summed in the tensor cores from zero,
    // small terms first, then added on the CUDA cores into `part`, which
    // goes into `tot` every kFlushSteps steps.  The halves take turns, so
    // one group of products is always in flight.
    float acc0[kPairHalf / 2], acc1[kPairHalf / 2], part[kPairHalf], tot[kPairHalf];
#pragma unroll
    for (int i = 0; i < kPairHalf / 2; ++i) acc0[i] = acc1[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kPairHalf; ++i) part[i] = tot[i] = 0.f;
    uint32_t ah[2][kTcSteps][4], al[2][kTcSteps][4];
    auto flush = [&] {
#pragma unroll
      for (int i = 0; i < kPairHalf; ++i) {
        tot[i] += part[i];
        part[i] = 0.f;
      }
    };
    for (int kb0 = 0; kb0 < nks; kb0 += 2) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kb = kb0 + u;
        if (kb >= nks) break;
        const int s0 = kStageSteps * kb;
        const uint32_t k = ring + kb;
        const uint8_t* st = sm + (size_t)(k % pl.pring) * pl.slot;
        if (!hopper::mbar_wait_bounded(full + k % pl.pring, (k / pl.pring) & 1)) __trap();
        const float* sp = reinterpret_cast<const float*>(st + 2 * kPairBTileBytes);
        const uint64_t dh = hopper::wgmma_desc_k64(st);
        const uint64_t dl = hopper::wgmma_desc_k64(st + kPairBTileBytes);
        constexpr uint64_t kHalf = (kPairHalf * kRowBytes) >> 4;   // descriptor units
        // the cross-power of a row at the stage's float o (re) and o + 1
        // (im) of its pair's mics x at i and y at j: conj(x) y, whitened per
        // pair for 2-mic arrays
        auto cross = [&](bool ok, int i, int j, int o, float& rr, float& jj) {
          const float2 a =
              ok ? *reinterpret_cast<const float2*>(sp + i + o) : make_float2(0.f, 0.f);
          const float2 b =
              ok ? *reinterpret_cast<const float2*>(sp + j + o) : make_float2(0.f, 0.f);
          rr = a.x * b.x + a.y * b.y;
          jj = a.x * b.y - a.y * b.x;
          if (phat && !per_mic) {
            const float inv = rsqrtf(rr * rr + jj * jj + eps2);
            rr *= inv;
            jj *= inv;
          }
        };
#pragma unroll
        for (int gq = 0; gq < kStageSteps / kTcSteps; ++gq) {
          const int sg = s0 + kTcSteps * gq;   // the group's first step
          const int b = (u * (kStageSteps / kTcSteps) + gq) & 1;
          // the group's A fragments: K slot t the rr of bin 4 s + t, slot
          // t + 4 its jj
#pragma unroll
          for (int j = 0; j < kTcSteps; ++j) {
            const int o = 2 * (4 * (kTcSteps * gq + j) + t_);
            float rra, jja, rrb, jjb;
            cross(ok_a, ia, ja, o, rra, jja);
            cross(ok_b, ib, jb, o, rrb, jjb);
            hopper::tf32_split(rra, ah[b][j][0], al[b][j][0]);
            hopper::tf32_split(rrb, ah[b][j][1], al[b][j][1]);
            hopper::tf32_split(jja, ah[b][j][2], al[b][j][2]);
            hopper::tf32_split(jjb, ah[b][j][3], al[b][j][3]);
          }
          auto products = [&](float (&acc)[kPairHalf / 2], uint64_t off) {
#pragma unroll
            for (int i = 0; i < kPairHalf / 2; ++i) hopper::keep(acc[i]);
            hopper::wgmma_fence();
#pragma unroll
            for (int j = 0; j < kTcSteps; ++j) {
              const int qq = kTcSteps * gq + j;   // the step within the stage
              hopper::wgmma_m64n48_tf32(acc, al[b][j], dh + off + 2 * qq, j > 0);
              hopper::wgmma_m64n48_tf32(acc, ah[b][j], dl + off + 2 * qq);
              hopper::wgmma_m64n48_tf32(acc, ah[b][j], dh + off + 2 * qq);
            }
            hopper::wgmma_commit();
          };
          products(acc0, 0);
          if (sg > 0) {
            // half 1 of the group before is done: its sum, the flush of the
            // steps before sg, the release of the stage that ended there and
            // the next copy into its slot
            hopper::wgmma_wait<1>();
#pragma unroll
            for (int i = 0; i < kPairHalf / 2; ++i) {
              hopper::keep(acc1[i]);
              part[kPairHalf / 2 + i] += acc1[i];
            }
            if (sg % kFlushSteps == 0) flush();
            if (gq == 0) {
              release(k - 1);
              if (kb + pl.pring - 1 < nks) {
                if (tid == 0) issue(k + pl.pring - 1, kb + pl.pring - 1, lb);
                __syncwarp();
              }
            }
          }
          products(acc1, kHalf);
          hopper::wgmma_wait<1>();   // half 0 of the group is done
#pragma unroll
          for (int i = 0; i < kPairHalf / 2; ++i) {
            hopper::keep(acc0[i]);
            part[i] += acc0[i];
          }
        }
      }
    }
    hopper::wgmma_wait0();
#pragma unroll
    for (int i = 0; i < kPairHalf / 2; ++i) {
      hopper::keep(acc1[i]);
      part[kPairHalf / 2 + i] += acc1[i];
    }
    flush();
    release(ring + nks - 1);
    ring += nks;

    // the lag block out: half h's fragment rows ra (c < 2) and rb, lags
    // 8 j + 2 t and + 1 of the half
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < kPairHalf / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool top = c < 2;
          const int l = kPairCols * lb + kPairHalf * h + 8 * j + 2 * t_ + (c & 1);
          if ((top ? ok_a : ok_b) && l < L)
            corr_out[(size_t)(top ? ra : rb) * L + l] = tot[kPairHalf / 2 * h + 4 * j + c];
        }
  }
}

// One tile of tb frames in the stats mode, by the whole block: x0 points at
// the tile's frames [tb, M, N] in device memory, b0 is its first frame's
// index in the outputs.
__device__ __forceinline__ void
stats_tile(const float* x0, int b0, int tb,
           const float* __restrict__ win,      // [N] window * gain
           const float2* __restrict__ wp,      // packed DFT [N / 8, Fp / 4, 32] float2
           const int* __restrict__ pairs,      // [P, 2]
           float* __restrict__ corr_out,       // [B, P, L]
           int* __restrict__ shift_out,        // [B, P] (peaks only)
           float* __restrict__ tdoa_out,
           float* __restrict__ peak_out,
           float* __restrict__ psr_out,
           int M, int N, int F, int Fp, int P, int L, int TB,
           int phat, int per_mic, float eps2, float taper_denom, int with_peaks,
           Stats st) {
  extern __shared__ float4 smem4[];
  const int R = tb * M;    // (frame, mic) rows of this tile
  const int RP = tb * P;   // (frame, pair) rows of this tile
  const size_t rows_max = (size_t)TB * M;
  float* xs = reinterpret_cast<float*>(smem4);   // [2][kDftRows][kAStride]
  // the packed, split matrices of a chunk (float4 per lane), then the
  // pass's staged cross-power
  float2* syn = reinterpret_cast<float2*>(xs + kStatsStage);
  float2* xp = syn + kFChunk * 16 * stats_tiles(L);
  float2* spec = xp + kStatsXp;
  float* mean = reinterpret_cast<float*>(spec + rows_max * F);
  float* rowbuf = mean + rows_max;
  // smoothed periodograms [rows][F], coherence [TB * P][F], band weight [TB][F]
  float* auto_s = rowbuf + (size_t)kRowsPerPass * L;
  float* g2 = auto_s + rows_max * F;
  float* wband = g2 + (size_t)TB * P * F;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // raw spectra; the DFT runs on the tensor cores
  spectra_tensor_cores(x0, R, N, F, Fp, win, wp, xs, mean, spec);
  __syncthreads();

  // ---- 2a. smoothed periodograms ---------------------------------------
  // A thread owns kRun consecutive bins of a row: it loads their terms and
  // those of kRegHw neighbours on either side once (zero outside the
  // spectrum, which adds nothing), then sums every window from registers
  // in ascending bin order, each a direct sum.  Lanes take neighbouring
  // rows, which lie 8 bytes apart modulo the banks.  A half-width past
  // kRegHw walks shared memory instead.
  const int hw = st.hw;
  const int runs = (F + kRun - 1) / kRun;
  if (hw <= kRegHw) {
    for (int e = tid; e < R * runs; e += kThreads) {
      const int r = e % R, f0 = (e / R) * kRun;
      const float2* a = spec + (size_t)r * F;
      float pw[kRun + 2 * kRegHw];
#pragma unroll
      for (int k = 0; k < kRun + 2 * kRegHw; ++k) {
        const int q = f0 - kRegHw + k;
        float v = 0.f;
        if (q >= 0 && q < F) {
          const float2 x = a[q];
          v = x.x * x.x + x.y * x.y;
        }
        pw[k] = v;
      }
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        const int f = f0 + k;
        if (f >= F) break;
        float acc = 0.f;
#pragma unroll
        for (int d = -kRegHw; d <= kRegHw; ++d)
          if (d >= -hw && d <= hw) acc += pw[k + kRegHw + d];
        const int lo = max(f - hw, 0), hi = min(f + hw, F - 1);
        auto_s[(size_t)r * F + f] = acc / (float)(hi - lo + 1);
      }
    }
  } else {
    for (int e = tid; e < R * F; e += kThreads) {
      const int r = e / F, f = e % F;
      const int lo = max(f - hw, 0), hi = min(f + hw, F - 1);
      auto_s[e] = window_power(spec + (size_t)r * F, lo, hi) / (float)(hi - lo + 1);
    }
  }
  __syncthreads();
  // ---- 2b. coherence per (frame, pair) row -----------------------------
  auto coherence = [&](int row, int f, int ia, int ib, float sr, float sj) {
    const int lo = max(f - hw, 0), hi = min(f + hw, F - 1);
    const float cnt = (float)(hi - lo + 1);
    sr /= cnt;
    sj /= cnt;
    const float gab = sr * sr + sj * sj;
    const float gg = auto_s[(size_t)ia * F + f] * auto_s[(size_t)ib * F + f] + eps2;
    g2[(size_t)row * F + f] = fminf(fmaxf(gab / gg, 0.f), 1.f);
  };
  if (hw <= kRegHw) {
    for (int e = tid; e < RP * runs; e += kThreads) {
      const int row = e % RP, f0 = (e / RP) * kRun;
      const int t = row / P, p = row % P;
      const int ia = t * M + __ldg(pairs + 2 * p), ib = t * M + __ldg(pairs + 2 * p + 1);
      const float2* a = spec + (size_t)ia * F;
      const float2* b = spec + (size_t)ib * F;
      float tr[kRun + 2 * kRegHw], tj[kRun + 2 * kRegHw];
#pragma unroll
      for (int k = 0; k < kRun + 2 * kRegHw; ++k) {
        const int q = f0 - kRegHw + k;
        float vr = 0.f, vj = 0.f;
        if (q >= 0 && q < F) {
          const float2 x = a[q], y = b[q];
          vr = x.x * y.x + x.y * y.y;
          vj = x.x * y.y - x.y * y.x;
        }
        tr[k] = vr;
        tj[k] = vj;
      }
#pragma unroll
      for (int k = 0; k < kRun; ++k) {
        const int f = f0 + k;
        if (f >= F) break;
        float sr = 0.f, sj = 0.f;
#pragma unroll
        for (int d = -kRegHw; d <= kRegHw; ++d)
          if (d >= -hw && d <= hw) {
            sr += tr[k + kRegHw + d];
            sj += tj[k + kRegHw + d];
          }
        coherence(row, f, ia, ib, sr, sj);
      }
    }
  } else {
    for (int e = tid; e < RP * F; e += kThreads) {
      const int row = e / F, f = e % F;
      const int t = row / P, p = row % P;
      const int ia = t * M + __ldg(pairs + 2 * p), ib = t * M + __ldg(pairs + 2 * p + 1);
      const float2* a = spec + (size_t)ia * F;
      const float2* b = spec + (size_t)ib * F;
      const int lo = max(f - hw, 0), hi = min(f + hw, F - 1);
      float sr = 0.f, sj = 0.f;
      for (int q = lo; q <= hi; ++q) {
        const float2 x = a[q], y = b[q];
        sr += x.x * y.x + x.y * y.y;
        sj += x.x * y.y - x.y * y.x;
      }
      coherence(row, f, ia, ib, sr, sj);
    }
  }
  __syncthreads();
  // ---- 2c. per-frame auto band, one warp per frame ----------------------
  if (st.band_auto) {
    const int fk = F - 1;  // Nyquist is never in the band
    for (int t = warp; t < tb; t += kWarps) {
      float* w = wband + (size_t)t * F;
      const float* g = g2 + (size_t)t * P * F;
      float mx = 0.f;
      for (int f = lane; f < F; f += 32) {
        float s = 0.f;
        for (int p = 0; p < P; ++p) s += g[(size_t)p * F + f];
        const float g2i = (f > 0 && f < fk) ? s / (float)P : 0.f;
        w[f] = g2i;
        mx = fmaxf(mx, g2i);
      }
      const float thr = fmaxf(st.rel * warp_max(mx), st.floor_);
      int cnt = 0;
      for (int f = lane; f < fk; f += 32) cnt += w[f] >= thr;
      for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
      const bool enough = cnt >= st.min_bins;
      for (int f = lane; f < F; f += 32) {
        const bool interior = f > 0 && f < fk;
        const float v = f < fk && (enough ? w[f] >= thr : interior) ? 1.f : 0.f;
        w[f] = v;
        if (st.band_out) st.band_out[(size_t)(b0 + t) * F + f] = v;
      }
    }
    __syncthreads();
  }
  // ---- 2d. per-mic PHAT factors (M >= 3), band folded in ----------------
  // The smoothed periodograms are spent: their place takes
  // rsqrt(|X|^2 + eps^2) (times the 0/1 band weight), so the synthesis
  // loop reads two factors where it would evaluate two rsqrts.
  if (phat && per_mic) {
    for (int e = tid; e < R * F; e += kThreads) {
      const int r = e / F, f = e % F;
      const float2 x = spec[e];
      const float inv = rsqrtf(x.x * x.x + x.y * x.y + eps2);
      auto_s[e] = st.band_auto ? inv * wband[(size_t)(r / M) * F + f] : inv;
    }
    __syncthreads();
  }

  // ---- 3. cross-power + lag synthesis, then 4. peaks -------------------
  for (int q0 = 0; q0 < RP; q0 += kRowsPerPass) {
    // The pass's 32 rows x 2F x L product on the tensor cores (mma.sync
    // m16n8k8, TF32 operands, fp32 sums), as a split-fp32 product: the
    // whitened, banded cross-power is staged once per chunk of 16 bins and
    // split as it leaves shared memory, the matrices arrive split and in
    // fragment order, and a step of 4 bins (their rr, then their jj) adds
    // a_lo b_hi, then a_hi b_lo, then a_hi b_hi.  Warp (wm, wn) owns row
    // tile wm and the lag tiles wn, wn + 4, ...
    const int g_ = lane >> 2, t_ = lane & 3;
    const int wm = warp / kStatsWarpsN, wn = warp % kStatsWarpsN;
    const int ntb = stats_tiles(L);
    const int n_steps = ((F + kFChunk - 1) / kFChunk) * (kFChunk / 4);
    float4* bst = reinterpret_cast<float4*>(syn);   // [kFChunk / 4][ntb][32]
    for (int lb = 0; lb * ntb * 8 < L; ++lb) {
      float acc[kStatsTilesPerWarp][4];
#pragma unroll
      for (int j = 0; j < kStatsTilesPerWarp; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
      for (int fb = 0; fb < F; fb += kFChunk) {
        const float4* src = st.synp + ((size_t)lb * n_steps + fb / 4) * ntb * 32;
        for (int e = tid; e < (kFChunk / 4) * ntb * 32; e += kThreads) bst[e] = __ldg(src + e);
        // the raw spectra's cross-power for the pass's rows and the
        // chunk's bins, whitened and banded once
        for (int e = tid; e < kRowsPerPass * kFChunk; e += kThreads) {
          const int row = q0 + e / kFChunk, f = fb + e % kFChunk;
          float rr = 0.f, jj = 0.f;
          if (row < RP && f < F) {
            const int t = row / P, p = row % P;
            const size_t ia = ((size_t)t * M + __ldg(pairs + 2 * p)) * F + f;
            const size_t ib = ((size_t)t * M + __ldg(pairs + 2 * p + 1)) * F + f;
            const float2 a = spec[ia], b = spec[ib];
            rr = a.x * b.x + a.y * b.y;
            jj = a.x * b.y - a.y * b.x;
            if (phat && per_mic) {  // band already in the factors
              const float inv = auto_s[ia] * auto_s[ib];
              rr *= inv;
              jj *= inv;
            } else {
              if (phat) {
                const float inv = rsqrtf(rr * rr + jj * jj + eps2);
                rr *= inv;
                jj *= inv;
              }
              if (st.band_auto) {
                const float wv = wband[(size_t)t * F + f];
                rr *= wv;
                jj *= wv;
              }
            }
          }
          xp[(e / kFChunk) * kXpStride + e % kFChunk] = make_float2(rr, jj);
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < kFChunk / 4; ++q) {
          // A: rows g and g + 8 of the row tile at bin 4 q + t; k = t is
          // its rr, k = t + 4 its jj
          const float2 v0 = xp[(wm * 16 + g_) * kXpStride + 4 * q + t_];
          const float2 v1 = xp[(wm * 16 + g_ + 8) * kXpStride + 4 * q + t_];
          uint32_t ah[4], al[4];
          hopper::tf32_split(v0.x, ah[0], al[0]);
          hopper::tf32_split(v1.x, ah[1], al[1]);
          hopper::tf32_split(v0.y, ah[2], al[2]);
          hopper::tf32_split(v1.y, ah[3], al[3]);
          uint32_t bf[kStatsTilesPerWarp][4];   // (hi k, hi k + 4, lo k, lo k + 4)
#pragma unroll
          for (int j = 0; j < kStatsTilesPerWarp; ++j)
            if (wn + kStatsWarpsN * j < ntb)
              hopper::lds128(bf[j], bst + (q * ntb + wn + kStatsWarpsN * j) * 32 + lane);
          // small terms first; each pass touches every accumulator once
#pragma unroll
          for (int j = 0; j < kStatsTilesPerWarp; ++j)
            if (wn + kStatsWarpsN * j < ntb) {
              const uint32_t bh[2] = {bf[j][0], bf[j][1]};
              hopper::mma_tf32(acc[j], al, bh);
            }
#pragma unroll
          for (int j = 0; j < kStatsTilesPerWarp; ++j)
            if (wn + kStatsWarpsN * j < ntb) {
              const uint32_t bl[2] = {bf[j][2], bf[j][3]};
              hopper::mma_tf32(acc[j], ah, bl);
            }
#pragma unroll
          for (int j = 0; j < kStatsTilesPerWarp; ++j)
            if (wn + kStatsWarpsN * j < ntb) {
              const uint32_t bh[2] = {bf[j][0], bf[j][1]};
              hopper::mma_tf32(acc[j], ah, bh);
            }
        }
        __syncthreads();
      }
      // fragment: rows g and g + 8, lags 8 j + 2 t and + 1 of the tile
#pragma unroll
      for (int j = 0; j < kStatsTilesPerWarp; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = wm * 16 + g_ + 8 * (c / 2);
          const int l = (lb * ntb + wn + kStatsWarpsN * j) * 8 + 2 * t_ + c % 2;
          if (wn + kStatsWarpsN * j < ntb && l < L) rowbuf[(size_t)r * L + l] = acc[j][c];
        }
    }
    __syncthreads();   // a row's lags come from four warps
    for (int r = warp; r < kRowsPerPass && q0 + r < RP; r += kWarps) {
      const size_t grow = (size_t)b0 * P + q0 + r;   // global (frame, pair) row
      row_peaks(rowbuf + (size_t)r * L, L, corr_out + grow * L, grow, shift_out, tdoa_out,
                peak_out, psr_out, taper_denom, with_peaks, false);
    }
    __syncthreads();   // rowbuf is the next pass's
  }

  // ---- 5. phase-slope TDOA, a row per warp ------------------------------
  // from this block's shifts and parabolic TDOAs, now in global memory
  if (st.phase && with_peaks) {
    __syncthreads();
    for (int row = warp; row < RP; row += kWarps) {
      const int t = row / P, p = row % P;
      const size_t grow = (size_t)b0 * P + row;
      const float d = phase_slope(
          spec + ((size_t)t * M + __ldg(pairs + 2 * p)) * F,
          spec + ((size_t)t * M + __ldg(pairs + 2 * p + 1)) * F,
          g2 + (size_t)row * F, st.band_auto ? wband + (size_t)t * F : nullptr,
          F, (float)shift_out[grow], tdoa_out[grow], st);
      if (lane == 0) tdoa_out[grow] = d;
    }
  }
}

// The base and SRP modes: one block an SM (up to 128 rows, about 220 KB of
// shared memory), the frames and the split coefficients by TMA.
template <bool kSrp>
__global__ void __launch_bounds__(kThreads, 1)
gcc_kernel(const __grid_constant__ CUtensorMap wmap, int cp,
           const __grid_constant__ CUtensorMap xmap, int ld, int nring,
           const float* __restrict__ frames,   // [B, M, N], rows ld floats apart
           const float* __restrict__ win, const float2* __restrict__ wtail,
           const float* __restrict__ sync, const float* __restrict__ syns,
           const int* __restrict__ pairs, float* __restrict__ corr_out,
           int* __restrict__ shift_out, float* __restrict__ tdoa_out,
           float* __restrict__ peak_out, float* __restrict__ psr_out,
           int B, int M, int N, int F, int P, int L, int TB,
           int phat, int per_mic, float eps2, float taper_denom, int with_peaks,
           Srp srp) {
  uint8_t* sm = smem_base();
  init_ring(reinterpret_cast<uint64_t*>(sm + BaseLayout(TB, M, P, L, nring).bars));
  const int b0 = blockIdx.x * TB;
  uint32_t ring = 0;
  base_tile<true, kSrp, false>(frames + (size_t)b0 * M * ld, ld, b0, min(TB, B - b0), TB, sm,
                               nring, ring, &wmap, cp, &xmap, b0 * M, win, wtail, sync, syns,
                               pairs, corr_out, shift_out, tdoa_out, peak_out, psr_out, M, N,
                               F, P, L, phat, per_mic, eps2, taper_denom, with_peaks, srp,
                               nullptr, 0, [] {});
}

// The base mode without peaks where the correlograms would crowd the tile:
// one persistent launch whose blocks claim work items in order, all spectra
// tiles (base_tile at kBlockRows / M frames, spectra out), then all pair
// tiles (pair_tile).  work: [0] the next item, [1 + s] spectra tile s is
// written.  A pair tile waits only on spectra tiles, claimed before it by
// blocks that run and wait on nothing, so the launch cannot deadlock.
template <bool kSrp, bool kPairs>
__global__ void __launch_bounds__(kThreads, 1)
gcc_kernel(const __grid_constant__ CUtensorMap wmap, int cp,
           const __grid_constant__ CUtensorMap xmap, int ld,
           const __grid_constant__ CUtensorMap smap,
           const __grid_constant__ CUtensorMap bmap, PairPlan pl,
           const float* __restrict__ frames,   // [B, M, N], rows ld floats apart
           const float* __restrict__ win, const float2* __restrict__ wtail,
           const int* __restrict__ pairs, float2* __restrict__ spectra, int sld,
           int* __restrict__ work, float* __restrict__ corr_out,
           int B, int M, int N, int F, int P, int L, int phat, int per_mic, float eps2) {
  static_assert(kPairs && !kSrp, "the pair instance");
  __shared__ int item_s;
  uint8_t* sm = smem_base();
  const int TB = kBlockRows / M;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + BaseLayout(TB, M, 0, 0, pl.nring).bars);
  init_ring(full);
  const int n_spec = (B + TB - 1) / TB;
  const int n_items = n_spec + (int)(((long long)B * P + kBlockRows - 1) / kBlockRows);
  uint32_t ring = 0;
  bool paired = false;
  for (;;) {
    if (threadIdx.x == 0) item_s = atomicAdd(work, 1);
    __syncthreads();
    const int item = item_s;
    __syncthreads();   // every thread has read it
    if (item >= n_items) break;
    if (item < n_spec) {
      const int b0 = item * TB;
      base_tile<true, false, true>(frames + (size_t)b0 * M * ld, ld, b0, min(TB, B - b0), TB,
                                   sm, pl.nring, ring, &wmap, cp, &xmap, b0 * M, win, wtail,
                                   nullptr, nullptr, pairs, nullptr, nullptr, nullptr, nullptr,
                                   nullptr, M, N, F, 0, 0, phat, per_mic, eps2, 0.f, 0, Srp{},
                                   spectra, sld, [] {});
      __syncthreads();   // every row of the tile is written
      if (threadIdx.x == 0) {
        __threadfence();
        hopper::fence_proxy_async_global();
        hopper::st_release(work + 1 + item, 1);
      }
    } else {
      if (!paired) {
        // the pair ring's stages are other than the spectra ring's: its
        // barriers start over (every load so far has landed and been read)
        init_ring(full);
        ring = 0;
        paired = true;
      }
      pair_tile(item - n_spec, sm, pl, full, ring, &smap, &bmap, pairs, work + 1, corr_out,
                B, M, F, P, L, TB, phat, per_mic, eps2);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gcc_stats_kernel(const float* __restrict__ frames,   // [B, M, N]
                 const float* __restrict__ win, const float2* __restrict__ wp,
                 const int* __restrict__ pairs, float* __restrict__ corr_out,
                 int* __restrict__ shift_out, float* __restrict__ tdoa_out,
                 float* __restrict__ peak_out, float* __restrict__ psr_out,
                 int B, int M, int N, int F, int Fp, int P, int L, int TB,
                 int phat, int per_mic, float eps2, float taper_denom, int with_peaks,
                 Stats st) {
  const int b0 = blockIdx.x * TB;
  stats_tile(frames + (size_t)b0 * M * N, b0, min(TB, B - b0), win, wp, pairs, corr_out,
             shift_out, tdoa_out, peak_out, psr_out, M, N, F, Fp, P, L, TB, phat, per_mic,
             eps2, taper_denom, with_peaks, st);
}

// The pipelined instance's frames staging buffer: rows of N samples padded to
// stage_ld(N) floats (8 more: a warp's fragment loads of 8 rows hit distinct
// banks), after the base body's shared memory.
__host__ __device__ inline int stage_ld(int n) { return n + 8; }
__host__ __device__ inline size_t stage_bytes(int tb, int m, int n) {
  return (size_t)tb * m * stage_ld(n) * sizeof(float);
}

// The base mode as a persistent block that walks the tiles itself, each
// tile's frames staged in shared memory one tile ahead of the last synthesis
// and peak stage; the DFT reads them there (its ring carries only the
// coefficients).
__global__ void __launch_bounds__(kThreads, 1)
gcc_pipelined_kernel(const __grid_constant__ CUtensorMap wmap, int cp, int nring,
                     const float* __restrict__ frames,   // [B, M, N], 16-byte aligned
                     const float* __restrict__ win, const float2* __restrict__ wtail,
                     const float* __restrict__ sync, const float* __restrict__ syns,
                     const int* __restrict__ pairs, float* __restrict__ corr_out,
                     int* __restrict__ shift_out, float* __restrict__ tdoa_out,
                     float* __restrict__ peak_out, float* __restrict__ psr_out,
                     int B, int M, int N, int F, int P, int L, int TB,
                     int phat, int per_mic, float eps2, float taper_denom,
                     int with_peaks) {
  uint8_t* sm = smem_base();
  const BaseLayout lay(TB, M, P, L, nring);
  init_ring(reinterpret_cast<uint64_t*>(sm + lay.bars));
  float* stage = reinterpret_cast<float*>(sm + ((lay.end + 15) & ~(size_t)15));
  const int ld = stage_ld(N), q4 = N / 4;
  const int n_tiles = (B + TB - 1) / TB;
  auto prefetch = [&](int tile) {
    if (tile < n_tiles) {
      const int b0 = tile * TB;
      const int n16 = min(TB, B - b0) * M * q4;
      const float4* src = reinterpret_cast<const float4*>(frames + (size_t)b0 * M * N);
      for (int e = threadIdx.x; e < n16; e += kThreads)
        hopper::cp_async16(stage + (size_t)(e / q4) * ld + 4 * (e % q4), src + e);
    }
    hopper::cp_async_commit();
  };
  uint32_t ring = 0;
  prefetch(blockIdx.x);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    // the tile's frames have arrived, and every warp has left the tile before
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    const int b0 = tile * TB;
    base_tile<false, false, false>(stage, ld, b0, min(TB, B - b0), TB, sm, nring, ring, &wmap,
                                   cp, nullptr, 0, win, wtail, sync, syns, pairs, corr_out,
                                   shift_out, tdoa_out, peak_out, psr_out, M, N, F, P, L, phat,
                                   per_mic, eps2, taper_denom, with_peaks, Srp{}, nullptr, 0,
                                   [&] { prefetch(tile + gridDim.x); });
  }
}

// Frames per block of the base body (and its ring stages): up to kBlockRows
// (frame, mic) rows, fewer when the correlograms of their pairs and a ring
// of kMinRing stages would not fit shared memory (with `extra` bytes more).
// Returns 0 when one frame does not fit.
int frames_per_block(int m, int p, int l, size_t extra_per_frame = 0, int* nring = nullptr) {
  if (m < 1 || m > kBlockRows) return 0;
  int tb = kBlockRows / m;
  while (tb > 0 && ring_stages(tb, m, p, l, tb * extra_per_frame) < kMinRing) --tb;
  if (nring) *nring = tb > 0 ? ring_stages(tb, m, p, l, tb * extra_per_frame) : 0;
  return tb;
}

// Frames per block of the stats mode: up to kDftRows (frame, mic) rows,
// fewer when the spectra and the mode's buffers would not fit.
int stats_frames_per_block(int m, int f, int l, int p) {
  int tb = m >= kDftRows ? 1 : kDftRows / m;
  while (tb > 0 && stats_smem_floats(tb, m, f, l, p) * sizeof(float) > kMaxSmem) --tb;
  return tb;
}

// Columns of a part (hi or lo) of the split coefficient matrix: (re, im) of
// every bin, padded to whole chunks (ops/cuda/gcc_kernel.py pack_dft_split).
int split_cols(int f) { return (2 * f + kChunkCols - 1) / kChunkCols * kChunkCols; }
// its K: samples padded to whole ring stages
int split_k(int n) { return (n + kKStage - 1) / kKStage * kKStage; }

// The tensor map of the split coefficients [2 cp, K], read a stage (kKStage
// samples x kChunkCols columns) at a time under the 64-byte swizzle.
bool split_map(CUtensorMap* map, const void* wk, int n, int f) {
  return ((uintptr_t)wk & 15) == 0 &&
         hopper::make_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, wk, 2 * split_cols(f),
                          split_k(n), kChunkCols, kRowBytes);
}

template <bool kSrp>
int launch(const void* frames, int ld, const void* win, const void* wtail, const void* wk,
           const void* sync, const void* syns, const void* pairs, void* corr_out,
           void* shift_out, void* tdoa_out, void* peak_out, void* psr_out, int B, int M,
           int N, int F, int P, int L, int phat, int per_mic, float eps,
           float taper_denom, int with_peaks, void* stream, const Srp& srp) {
  int nring = 0;
  const int tb = frames_per_block(M, P, L, 0, &nring);
  if (tb < 1 || F < 1 || ld < N || ld % 4 != 0 || ((uintptr_t)frames & 15) != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap wmap, xmap;
  if (!split_map(&wmap, wk, N, F) ||
      !hopper::make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, frames, B * M, ld,
                        kBlockRows, 0, kRowBytes))
    return hopper::kErrTensorMap;
  const size_t smem = base_smem_bytes(tb, M, P, L, nring);
  cudaError_t err = cudaFuncSetAttribute(
      gcc_kernel<kSrp>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + tb - 1) / tb;
  gcc_kernel<kSrp><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      wmap, split_cols(F), xmap, ld, nring, (const float*)frames, (const float*)win,
      (const float2*)wtail, (const float*)sync, (const float*)syns, (const int*)pairs,
      (float*)corr_out, (int*)shift_out, (float*)tdoa_out, (float*)peak_out,
      (float*)psr_out, B, M, N, F, P, L, tb, phat, per_mic, eps * eps,
      taper_denom, with_peaks, srp);
  return (int)cudaGetLastError();
}

int pipelined_frames_per_block(int m, int n, int p, int l, int* nring = nullptr) {
  return frames_per_block(m, p, l, (size_t)m * stage_ld(n) * sizeof(float), nring);
}

}  // namespace

extern "C" int att_gcc_pipelined_frames_per_block(int m, int n, int p, int l) {
  return pipelined_frames_per_block(m, n, p, l);
}

// The pipelined instance of the base mode: att_gcc's operands and outputs
// (frames rows of N floats, 16-byte aligned).  blocks_out (host, may be null)
// receives the grid size it launched.
extern "C" int att_gcc_pipelined(const void* frames, const void* win, const void* wtail,
                                 const void* wk, const void* sync, const void* syns,
                                 const void* pairs, void* corr_out,
                                 void* shift_out, void* tdoa_out, void* peak_out,
                                 void* psr_out, int B, int M, int N, int F,
                                 int P, int L, int phat, int per_mic, float eps,
                                 float taper_denom, int with_peaks, int* blocks_out,
                                 void* stream) {
  int nring = 0;
  const int tb = pipelined_frames_per_block(M, N, P, L, &nring);
  if (tb < 1 || F < 1 || N % 4 != 0 || ((uintptr_t)frames & 15) != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (!split_map(&map, wk, N, F)) return hopper::kErrTensorMap;
  const size_t smem = base_smem_bytes(tb, M, P, L, nring, stage_bytes(tb, M, N));
  cudaError_t err = cudaFuncSetAttribute(
      gcc_pipelined_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, gcc_pipelined_kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  const int n_tiles = (B + tb - 1) / tb;
  const int grid = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
  if (blocks_out) *blocks_out = grid;
  gcc_pipelined_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      map, split_cols(F), nring, (const float*)frames, (const float*)win,
      (const float2*)wtail, (const float*)sync, (const float*)syns, (const int*)pairs,
      (float*)corr_out, (int*)shift_out, (float*)tdoa_out, (float*)peak_out,
      (float*)psr_out, B, M, N, F, P, L, tb, phat, per_mic, eps * eps,
      taper_denom, with_peaks);
  return (int)cudaGetLastError();
}

// Frames a block of the base and SRP modes takes; 0 when one frame of m mics
// and p pairs x l lags does not fit.
extern "C" int att_gcc_frames_per_block(int m, int p, int l) {
  return frames_per_block(m, p, l);
}

extern "C" int att_gcc_stats_frames_per_block(int m, int f, int l, int p) {
  return stats_frames_per_block(m, f, l, p);
}

// The base mode.  frames: [B, M, N] with rows ld floats apart (ld >= N, a
// multiple of 4; 16-byte aligned), read by TMA; wtail: [N] float2, the
// (cos, -sin) coefficients of bin F - 1 (read when it is summed apart,
// F % 4 == 1); wk: the split coefficients (pack_dft_split) [2,
// split_cols(F), split_k(N)], 16-byte aligned.  Returns a cudaError_t, or -1
// when a tensor map could not be encoded.
extern "C" int att_gcc(const void* frames, int ld, const void* win, const void* wtail,
                       const void* wk, const void* sync, const void* syns, const void* pairs,
                       void* corr_out, void* shift_out, void* tdoa_out,
                       void* peak_out, void* psr_out, int B, int M, int N,
                       int F, int P, int L, int phat, int per_mic,
                       float eps, float taper_denom, int with_peaks,
                       void* stream) {
  return launch<false>(frames, ld, win, wtail, wk, sync, syns, pairs, corr_out, shift_out,
                       tdoa_out, peak_out, psr_out, B, M, N, F, P, L, phat,
                       per_mic, eps, taper_denom, with_peaks, stream, Srp{});
}

// The SRP mode: the base mode with peaks, plus the lag LUT [P, G] in and the
// first best cell [B], its score [B] and every cell's score [B, G] out.
extern "C" int att_gcc_srp(const void* frames, int ld, const void* win, const void* wtail,
                           const void* wk, const void* sync, const void* syns,
                           const void* pairs, const void* lut, void* corr_out,
                           void* shift_out, void* tdoa_out, void* peak_out, void* psr_out,
                           void* cell_out, void* score_out, void* scores_out, int B,
                           int M, int N, int F, int P, int L, int G, int phat,
                           int per_mic, float eps, float taper_denom, void* stream) {
  if (G < 1 || L > 32767) return (int)cudaErrorInvalidValue;   // int16 LUT
  const Srp srp{(const int*)lut, (int*)cell_out, (float*)score_out, (float*)scores_out, G};
  return launch<true>(frames, ld, win, wtail, wk, sync, syns, pairs, corr_out, shift_out,
                      tdoa_out, peak_out, psr_out, B, M, N, F, P, L, phat,
                      per_mic, eps, taper_denom, 1, stream, srp);
}

// Whether the base mode without peaks takes the pair phase at m mics and
// p pairs (its ring fits); the wrapper routes to it where fewer than
// 128 / m frames a block fit the fused body.
extern "C" int att_gcc_pairs_fit(int m, int p) {
  PairPlan pl;
  return pair_plan(m, p, &pl);
}

// The pair instance of the base mode without peaks: att_gcc's operands and
// correlograms, plus wsyn (the synthesis matrices split, pack_synthesis_split:
// [2, n_lb kPairCols, 2 Fs], Fs = F padded to whole stages; 16-byte
// aligned), spectra (scratch [B M, Fs] float2, 16-byte aligned) and work
// (n_work >= 1 + spectra tiles ints, zero).
extern "C" int att_gcc_pairs(const void* frames, int ld, const void* win, const void* wtail,
                             const void* wk, const void* wsyn, const void* pairs,
                             void* corr_out, void* spectra, void* work, int n_work, int B,
                             int M, int N, int F, int P, int L, int phat, int per_mic,
                             float eps, void* stream) {
  PairPlan pl;
  const int TB = kBlockRows / (M > 0 ? M : 1);
  if (!pair_plan(M, P, &pl) || F < 1 || L < 1 || ld < N || ld % 4 != 0 ||
      n_work < 1 + (B + TB - 1) / TB ||
      (((uintptr_t)frames | (uintptr_t)wsyn | (uintptr_t)spectra) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int sld = (F + kStageBins - 1) / kStageBins * kStageBins;
  const int n_lb = (L + kPairCols - 1) / kPairCols;
  CUtensorMap wmap, xmap, smap, bmap;
  if (!split_map(&wmap, wk, N, F) ||
      !hopper::make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, frames, B * M, ld,
                        kBlockRows, 0, kRowBytes) ||
      !hopper::make_map(&smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, spectra, B * M, 2 * sld,
                        pl.sbox, 0, kRowBytes) ||
      !hopper::make_map(&bmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, wsyn, 2 * n_lb * kPairCols,
                        2 * sld, kPairCols, kRowBytes))
    return hopper::kErrTensorMap;
  const size_t smem = base_smem_bytes(TB, M, 0, 0, pl.nring);
  cudaError_t err = cudaFuncSetAttribute(
      gcc_kernel<false, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gcc_kernel<false, true>,
                                                           kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  const long long items = (B + TB - 1) / TB + ((long long)B * P + kBlockRows - 1) / kBlockRows;
  const int grid = items < (long long)sms * per_sm ? (int)items : sms * per_sm;
  gcc_kernel<false, true><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      wmap, split_cols(F), xmap, ld, smap, bmap, pl, (const float*)frames, (const float*)win,
      (const float2*)wtail, (const int*)pairs, (float2*)spectra, sld, (int*)work,
      (float*)corr_out, B, M, N, F, P, L, phat, per_mic, eps * eps);
  return (int)cudaGetLastError();
}

// The stats mode: the base mode's operands and outputs, plus synp (the
// synthesis matrices split and packed by the wrapper, 16-byte aligned; sync
// and syns are not read), band_out ([B, F] auto band weights, may be null)
// and the mode's settings.
extern "C" int att_gcc_stats(const void* frames, const void* win, const void* wp,
                             const void* sync, const void* syns, const void* synp,
                             const void* pairs, void* corr_out, void* shift_out,
                             void* tdoa_out, void* peak_out, void* psr_out,
                             void* band_out, int B, int M, int N, int F, int Fp,
                             int P, int L, int phat, int per_mic, float eps,
                             float taper_denom, int with_peaks, int band_auto,
                             int phase, int hybrid, int hw, int min_bins,
                             int lo, int hi, int fft_length, float rel,
                             float floor_, float hybrid_min, void* stream) {
  (void)sync;
  (void)syns;
  if ((phase && !with_peaks) || !synp || ((uintptr_t)synp & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int tb = stats_frames_per_block(M, F, L, P);
  if (tb < 1 || Fp % 4 != 0 || Fp < F) return (int)cudaErrorInvalidValue;
  const double two_pi = 6.283185307179586;
  const Stats st{(const float4*)synp, (float*)band_out, band_auto, phase, hybrid, hw, min_bins,
                 lo, hi, rel, floor_, hybrid_min, (float)(two_pi / fft_length),
                 (float)(-fft_length / two_pi)};
  const size_t smem = stats_smem_floats(tb, M, F, L, P) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gcc_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + tb - 1) / tb;
  gcc_stats_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)frames, (const float*)win, (const float2*)wp, (const int*)pairs,
      (float*)corr_out, (int*)shift_out, (float*)tdoa_out, (float*)peak_out,
      (float*)psr_out, B, M, N, F, Fp, P, L, tb, phat, per_mic, eps * eps, taper_denom,
      with_peaks, st);
  return (int)cudaGetLastError();
}
