// SRP scoring as a gather: correlograms [B, P, L] fp32 and the lag table
// [P, G] (int32 lags, each < L <= 256) -> every cell's score [B, G] fp32
// and each frame's first-max cell [B] int64, in one pass.
//
// No TPU kernel is ported here.  The JAX package leaves this product to XLA
// as a matmul against a one-hot steering matrix [P * L, G] (each column one
// 1 a pair, at the cell's lag: ops/srp.py::srp_scores_matmul), because the
// MXU multiplies where a gather would be slow; the port ran the same
// product through cuBLAS, an SGEMM whose operations are almost all products
// by zero (3 useful terms in 279 on the 3-mic full grid).  This kernel
// replaces that one-hot workaround and the argmax after it.
//
// The numbers are the product's:
//   - a score is the float32 sum of the P correlogram values at the cell's
//     lags, in pair order, ((0 + c0) + c1) + ...: an FFMA by 1.0 or by 0.0
//     is exact, so a product that adds K in order gives the same bits;
//   - with bf16 on, each value is first rounded to bf16 (nearest, ties to
//     even), as ops/srp.py::_round does;
//   - a frame that holds a non-finite value (after that rounding) scores
//     NaN in every cell, as the product does (0 * inf and 0 * NaN are NaN);
//   - the cell is torch.argmax's: NaN above every number, the first index
//     on a tie.
//
// What bounds it on an H100: bytes.  The scores are written once and the
// correlograms read once (the 3-mic full grid at 16,384 frames: 668 MB
// written and 18.3 MB read, 0.205 ms at 3.35 TB/s); the adds are P an
// output.  A warp stores 32 neighbouring scores of a row; where the rows
// start anywhere in a 32-byte sector (G is odd on the cells' grids) those
// stores split sectors, and the same kernel took 0.39 ms at that shape
// against 0.27 with rows that start on a sector (NVIDIA H100 80GB HBM3).
// So the rows of the scores are `ldo` floats apart, a multiple of 8 that
// the wrapper pads G to (the scores it returns are a view of the first G
// of each row).  The design:
//
//   - persistent CTAs, as many as fit the SMs, each walking tiles of kT
//     frames (the most of 8, 4, 2, 1 with which two CTAs fit an SM's
//     shared memory, else the most with which one fits);
//   - the lag table [P, G] copied into shared memory once a CTA, each lag
//     narrowed to a byte (30 KB on the full grid);
//   - a ring of two frame tiles in shared memory: while one tile is scored,
//     the next one lands by cp.async (16 bytes where the rows allow it);
//     a pass over the landed tile rounds it to bf16 in place and flags the
//     frames that hold a non-finite value, whose values then all become
//     NaN, so that their sums are NaN with no test an output;
//   - a thread owns cells g = tid, tid + 256, ...: it reads a cell's lag a
//     pair once a tile and sums that cell for every frame of the tile, so
//     a warp stores 32 neighbouring cells of a frame (one 128-byte line on
//     sectors of its own, streaming past L2 with st.global.cs);
//   - each thread keeps a running first maximum per frame, reduced by warp
//     shuffles and then across the warps in shared memory.
//
// What is left between it and its bound: the sums and the running maximum
// (some 12 instructions an output; P shared-memory loads an output, which
// conflict where a warp's cells read lags far apart), the tail of the
// tiles (16,384 frames are 2,048 tiles of 8 over some 264 CTAs), and each
// CTA's read of the int32 table (122 KB on the full grid, from L2 after
// the first CTA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;              // frame tiles in shared memory
constexpr int kMaxLags = 256;           // lags staged as bytes
constexpr int kRowAlign = 8;            // the scores' rows start on 32-byte sectors
constexpr size_t kSmemLimit = 232448;   // a block's shared memory on an H100
constexpr size_t kSmemPerSm = 233472;   // an SM's
constexpr size_t kReservedPerBlock = 1024;
constexpr int kNoCell = 0x7fffffff;     // a thread that owns no cell

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__host__ __device__ inline size_t tile_bytes(int p, int l, int t) {
  return align16((size_t)t * p * l * sizeof(float));
}

// shared memory of a launch with tiles of t frames: the tile ring, the lag
// table, the frames' flags, the cross-warp reduction
__host__ __device__ inline size_t smem_bytes(int p, int l, int g, int t) {
  return kStages * tile_bytes(p, l, t) + align16((size_t)p * g) + t * sizeof(int) +
         (size_t)kWarps * t * (sizeof(float) + sizeof(int));
}

// whether (v, i) comes before (bv, bi) in torch.argmax's order: NaN above
// every number, then the larger value, then the lower index
__device__ __forceinline__ bool ahead(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

template <int kT>
__global__ void __launch_bounds__(kThreads)
srp_gather_kernel(const float* __restrict__ corr,     // [B, P, L]
                  const int32_t* __restrict__ lut,    // [P, G] lags
                  float* __restrict__ scores,         // [B, ldo], the first G of a row
                  int64_t* __restrict__ cell,         // [B] first-max cell
                  int B, int P, int L, int G, int ldo, int bf16, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pl = P * L;
  const size_t tile_floats = tile_bytes(P, L, kT) / sizeof(float);
  float* tiles = reinterpret_cast<float*>(smem);                               // [kStages][kT pl]
  uint8_t* s_lut = smem + kStages * tile_floats * sizeof(float);               // [P][G]
  int* bad = reinterpret_cast<int*>(s_lut + align16((size_t)P * G));           // [kT]
  float* red_v = reinterpret_cast<float*>(bad + kT);                           // [kWarps][kT]
  int* red_i = reinterpret_cast<int*>(red_v + kWarps * kT);                    // [kWarps][kT]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_tiles = (B + kT - 1) / kT;

  // tile k of this CTA into slot k % kStages; one commit group a tile, empty
  // past the last
  auto issue = [&](int k) {
    const int t = blockIdx.x + k * gridDim.x;
    if (t < n_tiles) {
      const int f0 = t * kT, nf = min(kT, B - f0);
      const size_t n = (size_t)nf * pl;
      const float* src = corr + (size_t)f0 * pl;
      float* dst = tiles + (k % kStages) * tile_floats;
      size_t done = 0;
      if (vec) {   // the tile starts on a 16-byte boundary
        const size_t n4 = n / 4;
        for (size_t i = tid; i < n4; i += kThreads) hopper::cp_async16(dst + 4 * i, src + 4 * i);
        done = n4 * 4;
      }
      for (size_t i = done + tid; i < n; i += kThreads) hopper::cp_async4(dst + i, src + i, true);
    }
    hopper::cp_async_commit();
  };

  for (int k = 0; k < kStages; ++k) issue(k);

  // the lag table, once, a byte a lag
  const int lut_n = P * G;
  int lut_done = 0;
  if ((reinterpret_cast<uintptr_t>(lut) & 15) == 0) {
    const int n4 = lut_n / 4;
    for (int i = tid; i < n4; i += kThreads) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(lut) + i);
      reinterpret_cast<uchar4*>(s_lut)[i] = make_uchar4((uint8_t)v.x, (uint8_t)v.y, (uint8_t)v.z, (uint8_t)v.w);
    }
    lut_done = n4 * 4;
  }
  for (int i = lut_done + tid; i < lut_n; i += kThreads) s_lut[i] = (uint8_t)__ldg(lut + i);
  for (int i = tid; i < kT; i += kThreads) bad[i] = 0;

  for (int k = 0;; ++k) {
    const int t = blockIdx.x + k * gridDim.x;
    if (t >= n_tiles) break;
    const int f0 = t * kT, nf = min(kT, B - f0);
    float* tile = tiles + (k % kStages) * tile_floats;
    hopper::cp_async_wait<kStages - 1>();   // tile k has landed (this thread's part)
    __syncthreads();

    // staging pass: bf16 rounding in place, a flag for a frame that holds a
    // non-finite value
    for (int f = 0; f < nf; ++f) {
      float* row = tile + f * pl;
      bool nonfinite = false;
      for (int j = tid; j < pl; j += kThreads) {
        float v = row[j];
        if (bf16) {
          v = __bfloat162float(__float2bfloat16_rn(v));
          row[j] = v;
        }
        nonfinite |= !isfinite(v);
      }
      if (nonfinite) bad[f] = 1;
    }
    __syncthreads();
    bool any_bad = false;
    for (int f = 0; f < nf; ++f) any_bad |= bad[f] != 0;
    if (any_bad) {   // the same for every thread: the product's NaN, everywhere
      for (int f = 0; f < nf; ++f)
        if (bad[f])
          for (int j = tid; j < pl; j += kThreads) tile[f * pl + j] = __int_as_float(0x7fffffff);
      __syncthreads();
    }

    float bv[kT];
    int bi[kT];
#pragma unroll
    for (int f = 0; f < kT; ++f) {
      bv[f] = -INFINITY;
      bi[f] = tid < G ? tid : kNoCell;   // the first cell it owns, or none
    }
    float* out = scores + (size_t)f0 * ldo;
    for (int g = tid; g < G; g += kThreads) {
      float acc[kT];
#pragma unroll
      for (int f = 0; f < kT; ++f) acc[f] = 0.0f;
      for (int p = 0; p < P; ++p) {   // pair order
        const float* src = tile + p * L + s_lut[p * G + g];
#pragma unroll
        for (int f = 0; f < kT; ++f) acc[f] = __fadd_rn(acc[f], src[f * pl]);
      }
#pragma unroll
      for (int f = 0; f < kT; ++f) {
        if (f < nf) {
          __stcs(out + (size_t)f * ldo + g, acc[f]);
          // cells come in rising order: a tie keeps the earlier one, and a
          // NaN is never passed
          if (!isnan(bv[f]) && !(acc[f] <= bv[f])) {
            bv[f] = acc[f];
            bi[f] = g;
          }
        }
      }
    }

    // each frame's first maximum: across the warp, then across the warps
#pragma unroll
    for (int f = 0; f < kT; ++f) {
      float v = bv[f];
      int i = bi[f];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, o);
        const int oi = __shfl_xor_sync(0xffffffffu, i, o);
        if (ahead(ov, oi, v, i)) {
          v = ov;
          i = oi;
        }
      }
      if (lane == 0) {
        red_v[warp * kT + f] = v;
        red_i[warp * kT + f] = i;
      }
    }
    __syncthreads();
    if (tid < nf) {
      float v = red_v[tid];
      int i = red_i[tid];
      for (int w = 1; w < kWarps; ++w) {
        if (ahead(red_v[w * kT + tid], red_i[w * kT + tid], v, i)) {
          v = red_v[w * kT + tid];
          i = red_i[w * kT + tid];
        }
      }
      cell[f0 + tid] = i;
    }
    if (tid < kT) bad[tid] = 0;
    __syncthreads();   // the slot, the flags and the reduction are free
    issue(k + kStages);
  }
}

template <int kT>
int launch_tiles(const float* corr, const int32_t* lut, float* scores, int64_t* cell, int B,
                 int P, int L, int G, int ldo, int bf16, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, L, G, kT);
  cudaError_t err = cudaFuncSetAttribute(srp_gather_kernel<kT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, srp_gather_kernel<kT>,
                                                           kThreads, smem)) != cudaSuccess)
    return (int)err;
  const int n_tiles = (B + kT - 1) / kT;
  const int slots = sms * (per_sm > 1 ? per_sm : 1);
  const int grid = n_tiles < slots ? n_tiles : slots;
  const int vec = (reinterpret_cast<uintptr_t>(corr) & 15) == 0 && ((size_t)kT * P * L) % 4 == 0;
  srp_gather_kernel<kT><<<grid, kThreads, smem, stream>>>(corr, lut, scores, cell, B, P, L, G,
                                                          ldo, bf16, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Frames a tile for P pairs x L lags and G cells: the most of 8, 4, 2, 1
// with which two CTAs fit an SM's shared memory, else the most with which
// one fits a block's; 0 when none does or the shape is out of range.
extern "C" int att_srp_gather_tile(int P, int L, int G) {
  if (P < 1 || L < 1 || L > kMaxLags || G < 1) return 0;
  for (int t = 8; t >= 1; t /= 2)
    if (smem_bytes(P, L, G, t) <= kSmemPerSm / 2 - kReservedPerBlock) return t;
  for (int t = 8; t >= 1; t /= 2)
    if (smem_bytes(P, L, G, t) <= kSmemLimit) return t;
  return 0;
}

// Scores and first-max cells [B] of correlograms [B, P, L] (bf16: each
// value rounded to bf16 first) at the lags `lut` [P, G] (each < L), as
// stated at the top: the scores of frame b are the first G floats of row b
// of [B, ldo], ldo a multiple of 8 (32 bytes) from a 32-byte aligned
// `scores`.  Launches on `stream` and allocates nothing, so it can be
// captured into a CUDA graph.
extern "C" int att_srp_gather(const void* corr, const void* lut, void* scores, void* cell, int B,
                              int P, int L, int G, int ldo, int bf16, void* stream) {
  if (B < 1 || ldo < G || ldo % kRowAlign != 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(scores) & (kRowAlign * sizeof(float) - 1)) != 0)
    return (int)cudaErrorMisalignedAddress;
  const float* c = (const float*)corr;
  const int32_t* t = (const int32_t*)lut;
  float* s = (float*)scores;
  int64_t* i = (int64_t*)cell;
  cudaStream_t st = (cudaStream_t)stream;
  switch (att_srp_gather_tile(P, L, G)) {
    case 8: return launch_tiles<8>(c, t, s, i, B, P, L, G, ldo, bf16, st);
    case 4: return launch_tiles<4>(c, t, s, i, B, P, L, G, ldo, bf16, st);
    case 2: return launch_tiles<2>(c, t, s, i, B, P, L, G, ldo, bf16, st);
    case 1: return launch_tiles<1>(c, t, s, i, B, P, L, G, ldo, bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
