// The detector's two prefix sums in one pass: for x [R, T] fp32 the inclusive
// prefix sums of x and of x * x along T, every add made in the order of the
// package's CPU path (ops/cuda/detector_scan.py::prefix_sums_reference), so
// that the results are equal bit for bit and a detector power within
// rounding of its threshold fires at the same sample on both devices.
//
// The JAX package has no Pallas kernel here: its detector computes the sums
// as a triangular matmul on the MXU per 128-wide block plus a cumsum of the
// block totals (audio_triangulation_tpu/ops/detector.py::_blocked_cumsum_f32).
// The order that results, and that this kernel repeats:
//
//   inside a block of 128 samples: serial fp32 adds in index order
//   (x * x is rounded to fp32 before it is added: no fused multiply-add);
//   block totals: an inclusive scan that is serial inside tiles of 16, the
//   tile totals scanned the same way (recursively) and added shifted by one
//   tile; offsets = inclusive - totals; out = in-block sum + offset.
//   A row is padded with zeros to whole blocks and whole tiles.
//
// What bounds it on an H100: bytes.  x is read once and two arrays of its
// size are written (226 MB at 4,096 streams x 3 mics x 1,535 samples, 0.068
// ms at 3.35 TB/s); the adds are one per value.  The serial order leaves
// one chain of 128 dependent adds per (row, block, sum), so every chain is
// one thread's, and the design keeps device memory busy while those chains
// are walked:
//
//   - persistent CTAs, as many as fit the SMs (two an SM at the streaming
//     window), each walking units of its own: a unit is a group of whole
//     rows (64 / nb of them) or, for a row longer than 64 blocks, a segment
//     of 64 blocks of one row;
//   - a ring of two shared-memory slots: while one unit is walked, scanned
//     and written out, the next one lands by 4-byte cp.async (rows of T
//     floats start on 4-byte boundaries only; a copy is issued per sample
//     and needs no register), straight into a layout of one padded block
//     per chain (128 + 4 floats), zero past T;
//   - the walk: each thread reads its block four samples at a time (16-byte
//     loads: the 4-float pad puts the eight threads of each quarter warp on
//     eight different 16-byte bank groups) and writes both running sums in
//     place, the sums of x over x and those of x * x beside them;
//   - the block totals scanned tile by tile, then the output written with
//     its block's offset added, a warp's 32 neighbouring samples a 128-byte
//     line (the rows' 4-byte alignment rules out 16-byte stores).
//
// A row longer than a unit is walked twice (the totals first, then again
// for the output); the second read comes from L2.  What is left between
// the kernel and its bound: the walk of a unit is 128 dependent adds deep
// and runs on 64 of the CTA's 128 threads, so an SM overlaps its loads with
// at most two CTAs' walks.

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBlock = 128;          // samples per serial block
constexpr int kTile = 16;            // block totals per serial tile
constexpr int kChains = 64;          // 128-wide blocks staged per unit
constexpr int kStride = kBlock + 4;  // staged block, padded (floats)
constexpr int kStages = 2;           // units in shared memory: one walked, one landing
constexpr int kMaxBlocks = 4096;     // blocks a row (T <= 524,288)
constexpr int kMaxLevels = 4;        // 16^3 = 4,096 totals in three tilings
static_assert(kThreads == kBlock, "thread i stages sample i of a block");

// floats of the scan levels of one row's totals: the totals' inclusive scan
// (level 0), then each level's tile totals while a level exceeds one tile
__host__ __device__ inline int level_floats(int nb) {
  int n = nb, sum = nb;
  while (n > kTile) {
    n = (n + kTile - 1) / kTile;
    sum += n;
  }
  return sum;
}

// Inclusive scans of the block totals of `rows` rows (both sums: 2 * rows
// scans) in place at lev, row stride lf floats, by the whole CUDA block.
__device__ void scan_totals(float* lev, int scans, int nb, int lf) {
  int off[kMaxLevels], cnt[kMaxLevels];
  int top = 0;
  off[0] = 0;
  cnt[0] = nb;
  while (cnt[top] > kTile) {
    off[top + 1] = off[top] + cnt[top];
    cnt[top + 1] = (cnt[top] + kTile - 1) / kTile;
    ++top;
  }
  // up: serial inside every tile, tile totals to the next level
  for (int k = 0; k < top; ++k) {
    const int tiles = cnt[k + 1];
    for (int e = threadIdx.x; e < scans * tiles; e += kThreads) {
      float* a = lev + (e / tiles) * lf + off[k];
      const int t = e % tiles;
      const int i0 = t * kTile, i1 = min(i0 + kTile, cnt[k]);
      float acc = a[i0];
      for (int i = i0 + 1; i < i1; ++i) {
        acc = __fadd_rn(acc, a[i]);
        a[i] = acc;
      }
      // a tile cut short is padded with zeros: its total is its last sum
      lev[(e / tiles) * lf + off[k + 1] + t] = acc;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < scans; e += kThreads) {
    float* a = lev + e * lf + off[top];
    float acc = a[0];
    for (int i = 1; i < cnt[top]; ++i) {
      acc = __fadd_rn(acc, a[i]);
      a[i] = acc;
    }
  }
  __syncthreads();
  // down: every tile but the first takes the scan of the tile totals
  // before it
  for (int k = top - 1; k >= 0; --k) {
    const int n = cnt[k];
    for (int e = threadIdx.x; e < scans * n; e += kThreads) {
      const int i = e % n;
      if (i >= kTile) {
        float* a = lev + (e / n) * lf;
        a[off[k] + i] = __fadd_rn(a[off[k] + i], a[off[k + 1] + i / kTile - 1]);
      }
    }
    __syncthreads();
  }
}

// one load unit: `rows` rows from row r0, blocks [c0, c0 + n) of each;
// `scan` when the row totals are whole after its walk, `emit` when it
// writes the output
struct Unit {
  int r0, rows, c0, n;
  bool scan, emit;
};

__global__ void __launch_bounds__(kThreads)
detector_scan_kernel(const float* __restrict__ x,   // [R, T]
                     float* __restrict__ out1,      // [R, T] prefix sums of x
                     float* __restrict__ out2,      // [R, T] and of x * x
                     int R, int T, int nb, int rows_per_item) {
  extern __shared__ __align__(16) float smem[];
  float* slots = smem;                                  // [kStages][kChains][kStride]
  float* s2 = slots + kStages * kChains * kStride;      // [kChains][kStride]
  const int lf = level_floats(nb);
  float* tot = s2 + kChains * kStride;                  // [2 rows_per_item][nb]
  float* lev = tot + 2 * rows_per_item * nb;            // [2 rows_per_item][lf]

  const int tid = threadIdx.x;
  const int items = (R + rows_per_item - 1) / rows_per_item;
  const int segs = (nb + kChains - 1) / kChains;   // 1 unless the row is long
  const int per_item = segs == 1 ? 1 : 2 * segs;   // long rows: totals, then output

  // the k-th unit of this CTA; false past its last
  auto unit = [&](int k, Unit& u) {
    const int item = blockIdx.x + (k / per_item) * gridDim.x;
    if (item >= items) return false;
    const int within = k % per_item, seg = within % segs;
    u.r0 = item * rows_per_item;
    u.rows = min(rows_per_item, R - u.r0);
    u.c0 = seg * kChains;
    u.n = min(kChains, nb - u.c0);
    u.scan = segs == 1 || within == segs - 1;
    u.emit = segs == 1 || within >= segs;
    return true;
  };

  // unit k's samples into its slot by 4-byte cp.async (a row of T floats
  // starts on a 4-byte boundary only), sample i of a block by thread i,
  // zero past T; one commit group a unit, empty past the last
  auto issue = [&](int k) {
    Unit u;
    if (unit(k, u)) {
      float* slot = slots + (k % kStages) * kChains * kStride;
      for (int g = 0; g < u.rows; ++g) {
        const float* row = x + (size_t)(u.r0 + g) * T;
        for (int cb = 0; cb < u.n; ++cb) {
          const int t = (u.c0 + cb) * kBlock + tid;
          hopper::cp_async4(slot + (g * u.n + cb) * kStride + tid, t < T ? row + t : x, t < T);
        }
      }
    }
    hopper::cp_async_commit();
  };

  for (int k = 0; k < kStages; ++k) issue(k);
  Unit u;
  for (int k = 0; unit(k, u); ++k) {
    hopper::cp_async_wait<kStages - 1>();   // unit k has landed (this thread's part)
    __syncthreads();
    float* slot = slots + (k % kStages) * kChains * kStride;

    // walk: a thread a 128-wide block, four samples a 16-byte load, both
    // running sums written in place (s1 over x, s2 beside it)
    for (int c = tid; c < u.rows * u.n; c += kThreads) {
      float4* p1 = reinterpret_cast<float4*>(slot + c * kStride);
      float4* p2 = reinterpret_cast<float4*>(s2 + c * kStride);
      float4 v = p1[0];
      float acc1 = v.x, acc2 = __fmul_rn(v.x, v.x);
      float4 o1, o2;
      o1.x = acc1;
      o2.x = acc2;
#define ATT_STEP(f)                              \
  acc1 = __fadd_rn(acc1, v.f);                   \
  acc2 = __fadd_rn(acc2, __fmul_rn(v.f, v.f));   \
  o1.f = acc1;                                   \
  o2.f = acc2;
      ATT_STEP(y)
      ATT_STEP(z)
      ATT_STEP(w)
      p1[0] = o1;
      p2[0] = o2;
#pragma unroll 4
      for (int j = 1; j < kBlock / 4; ++j) {
        v = p1[j];
        ATT_STEP(x)
        ATT_STEP(y)
        ATT_STEP(z)
        ATT_STEP(w)
        p1[j] = o1;
        p2[j] = o2;
      }
#undef ATT_STEP
      const int g = c / u.n, b = u.c0 + c % u.n;
      tot[(2 * g) * nb + b] = acc1;
      tot[(2 * g + 1) * nb + b] = acc2;
    }
    __syncthreads();

    if (u.scan) {   // the rows' block totals are whole
      for (int e = tid; e < 2 * u.rows * nb; e += kThreads)
        lev[(e / nb) * lf + e % nb] = tot[e];
      __syncthreads();
      scan_totals(lev, 2 * u.rows, nb, lf);
    }

    if (u.emit) {   // the walked blocks plus their offsets, out
      for (int g = 0; g < u.rows; ++g) {
        const size_t row = (size_t)(u.r0 + g) * T;
#pragma unroll 4
        for (int cb = 0; cb < u.n; ++cb) {
          const int b = u.c0 + cb, t = b * kBlock + tid;
          if (t >= T) continue;
          const int c = g * u.n + cb;
          const float off1 = __fsub_rn(lev[(2 * g) * lf + b], tot[(2 * g) * nb + b]);
          const float off2 = __fsub_rn(lev[(2 * g + 1) * lf + b], tot[(2 * g + 1) * nb + b]);
          out1[row + t] = __fadd_rn(slot[c * kStride + tid], off1);
          out2[row + t] = __fadd_rn(s2[c * kStride + tid], off2);
        }
      }
    }
    __syncthreads();   // the slot and s2 are free
    issue(k + kStages);
  }
}

}  // namespace

// Inclusive prefix sums of x [R, T] f32 and of x * x along T into out1 and
// out2, in the order stated at the top.  Launches on `stream` and allocates
// nothing, so it can be captured into a CUDA graph.
extern "C" int att_detector_scan(const void* x, void* out1, void* out2, int R, int T,
                                 void* stream) {
  if (R < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const int nb = (T + kBlock - 1) / kBlock;
  if (nb > kMaxBlocks) return (int)cudaErrorInvalidValue;
  const int rows_per_item = nb >= kChains ? 1 : kChains / nb;
  const size_t smem = sizeof(float) * ((kStages + 1) * (size_t)kChains * kStride +
                                       2 * (size_t)rows_per_item * (nb + level_floats(nb)));
  cudaError_t err = cudaFuncSetAttribute(
      detector_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, detector_scan_kernel,
                                                           kThreads, smem)) != cudaSuccess)
    return (int)err;
  const int items = (R + rows_per_item - 1) / rows_per_item;
  const int slots = sms * (per_sm > 1 ? per_sm : 1);
  const int grid = items < slots ? items : slots;
  detector_scan_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out1, (float*)out2, R, T, nb, rows_per_item);
  return (int)cudaGetLastError();
}
