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
// size are written (226 MB at 4,096 streams x 3 mics x 1,535 samples); the
// adds are one per value.  The serial order leaves one chain per (row,
// block, sum), so the design gives every chain of 128 adds to one thread
// and keeps those threads off device memory: a CUDA block loads the blocks
// of its rows (several short rows, or a long row in segments of 64 blocks)
// into shared memory with coalesced reads, each thread walks one 128-wide
// block there (rows of 129 floats, so the 64 walkers hit 64 banks) and
// leaves both running sums in its place, the block totals are scanned tile
// by tile, and the results go out with coalesced writes, each with its
// block's offset added.  A row longer than a segment is walked twice (the
// totals first, then again for the output); the second read comes from L2.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlock = 128;          // samples per serial block
constexpr int kTile = 16;            // block totals per serial tile
constexpr int kChains = 64;          // 128-wide blocks staged per pass
constexpr int kStride = kBlock + 1;  // staged block, padded (floats)
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

__global__ void __launch_bounds__(kThreads)
detector_scan_kernel(const float* __restrict__ x,   // [R, T]
                     float* __restrict__ out1,      // [R, T] prefix sums of x
                     float* __restrict__ out2,      // [R, T] and of x * x
                     int R, int T, int nb, int rows_per_cta) {
  extern __shared__ float smem[];
  float* s1 = smem;                       // [kChains][kStride]
  float* s2 = s1 + kChains * kStride;     // [kChains][kStride]
  const int lf = level_floats(nb);
  float* tot = s2 + kChains * kStride;    // [2 rows_per_cta][nb] block totals
  float* lev = tot + 2 * rows_per_cta * nb;   // [2 rows_per_cta][lf]

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * rows_per_cta;
  const int rows = min(rows_per_cta, R - r0);
  const int segs = (nb + kChains - 1) / kChains;   // 1 unless the row is long

  // stage the blocks [c0, c0 + n) of this CUDA block's rows and walk them
  auto walk = [&](int c0, int n) {
    // one staged block per step: thread i takes its sample i
#pragma unroll 4
    for (int c = 0; c < rows * n; ++c) {
      const int g = c / n, t = (c0 + c % n) * kBlock + tid;
      s1[c * kStride + tid] = t < T ? x[(size_t)(r0 + g) * T + t] : 0.f;
    }
    __syncthreads();
    for (int c = tid; c < rows * n; c += kThreads) {
      float* a1 = s1 + c * kStride;
      float* a2 = s2 + c * kStride;
      const float v0 = a1[0];
      float acc1 = v0, acc2 = __fmul_rn(v0, v0);
      a2[0] = acc2;
#pragma unroll 8
      for (int i = 1; i < kBlock; ++i) {
        const float v = a1[i];
        acc1 = __fadd_rn(acc1, v);
        acc2 = __fadd_rn(acc2, __fmul_rn(v, v));
        a1[i] = acc1;
        a2[i] = acc2;
      }
      const int g = c / n, b = c0 + c % n;
      tot[(2 * g) * nb + b] = acc1;
      tot[(2 * g + 1) * nb + b] = acc2;
    }
    __syncthreads();
  };

  // the staged blocks plus their offsets, out
  auto emit = [&](int c0, int n) {
#pragma unroll 4
    for (int c = 0; c < rows * n; ++c) {
      const int g = c / n, b = c0 + c % n;
      const int t = b * kBlock + tid;
      if (t >= T) continue;
      const float off1 = __fsub_rn(lev[(2 * g) * lf + b], tot[(2 * g) * nb + b]);
      const float off2 = __fsub_rn(lev[(2 * g + 1) * lf + b], tot[(2 * g + 1) * nb + b]);
      const size_t o = (size_t)(r0 + g) * T + t;
      out1[o] = __fadd_rn(s1[c * kStride + tid], off1);
      out2[o] = __fadd_rn(s2[c * kStride + tid], off2);
    }
    __syncthreads();
  };

  for (int s = 0; s < segs; ++s) walk(s * kChains, min(kChains, nb - s * kChains));
  for (int e = tid; e < 2 * rows * nb; e += kThreads)
    lev[(e / nb) * lf + e % nb] = tot[e];
  __syncthreads();
  scan_totals(lev, 2 * rows, nb, lf);
  if (segs == 1) {
    emit(0, nb);
  } else {
    for (int s = 0; s < segs; ++s) {
      const int n = min(kChains, nb - s * kChains);
      walk(s * kChains, n);   // the same adds again: the same sums
      emit(s * kChains, n);
    }
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
  const int rows_per_cta = nb >= kChains ? 1 : kChains / nb;
  const size_t smem = sizeof(float) * (2 * (size_t)kChains * kStride +
                                       2 * (size_t)rows_per_cta * (nb + level_floats(nb)));
  cudaError_t err = cudaFuncSetAttribute(
      detector_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (R + rows_per_cta - 1) / rows_per_cta;
  detector_scan_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out1, (float*)out2, R, T, nb, rows_per_cta);
  return (int)cudaGetLastError();
}
