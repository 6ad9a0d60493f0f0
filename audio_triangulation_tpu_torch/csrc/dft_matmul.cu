// The DFT-shaped pair of products  out = (x + s) @ w1 + (x + s) @ w2  in
// three type sets: f32 x f32 -> f32, bf16 x bf16 -> f32, int8 x int8 -> int32.
//
// Replaces tools/int8_microbench.py::_kernel, the TPU microbenchmark of the
// fused GCC kernel's matmul shape ([rows, N] @ [N, F], twice, for the cos and
// the -sin matrix) in each operand type.  x is [R, N], w1 and w2 are [N, F],
// s is ONE scalar read from device memory (a chained loop feeds it from the
// last output without the host) and added to x in x's own type before the
// products: a bf16 add rounded to bf16, an int8 add that wraps as two's
// complement.  Both products are formed; w1 + w2 never is.
//
// What bounds it on an H100: operations in f32 (137 GFLOP at R = 65,536,
// N = 1,024, F = 512 against the 67 TFLOP/s of the CUDA cores).  In bf16 and
// int8 the tensor cores (989 TFLOP/s, 1,979 TOP/s) bring the operations down
// to the time of the bytes: x is read once and the 4-byte output, as large
// as x in bf16 and twice x in int8, is written once, and each SM must be
// fed its operand tiles from L2 fast enough.
//
// bf16 and int8: dft_wgmma_kernel.  A block of three warpgroups owns 256
// rows x 128 columns.  One thread of the producer warpgroup keeps a ring of
// three 64 KB stages full with TMA tile loads (128 bytes of K a stage: the x
// tile and the two w tiles, all K-major under the 128-byte swizzle, ragged
// edges zero-filled by TMA), signalled through mbarriers.  Each of the two
// consumer warpgroups owns 128 rows: it adds s to its half of the x tile in
// place (an elementwise pass does not care where the swizzle put an
// element), fences the async proxy, and issues wgmma m64n128 (k16 bf16, k32
// int8) from shared memory for both w tiles into ONE accumulator per 64
// rows: int32 sums are exact, and the f32 sum of the two products stays
// inside the 1e-5 tolerance.  The add of the next stage runs while the
// current stage's products are in flight.  The tile is 256 x 128 because
// the operand bytes an SM pulls per multiply-add are 2 / rows + 1 / columns
// of the tile.  int8 wgmma takes both operands K-major only, so w1 and w2
// arrive as [F, N] copies (k_major_kernel transposes them on every call;
// that time is the call's); bf16 takes the same route to share one kernel.
// Accumulators go to global memory as 8-byte stores from the fragments.
// What the design leaves on the table: with 192 KB of stages one block fits
// an SM, so a block's 128 KB of stores run with no products under them; a
// persistent block with a staged, overlapped epilogue is the next step.
// Dropped from the CUDA-core template that served these type sets before:
// bf16 widened to f32 for fp32 FMAs, int8 packed four to a word for __dp4a.
//
// f32: dft_matmul_kernel, a shared-memory SGEMM on the CUDA cores (the fp32
// baseline of the tool): a block of 256 threads owns 128 rows x
// 64 columns, a thread 8 rows x 4 columns of both products, K advances 16
// values a step, x is staged K-major so a thread's 8 rows are two 16-byte
// loads, and the next step's global loads are issued before the current
// step is computed.  Its two products have their own accumulators.
//
// Dropped from the TPU kernel: the rows-per-grid-step tiling, the VMEM block
// specs, and the scalar passed through a VMEM block (Mosaic could not
// extract an int8 scalar).
//
// Shapes it takes: N a multiple of 64, F a multiple of 16; any R.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32 on the CUDA cores

constexpr int kThreads = 256;
constexpr int kBM = 128;             // rows of a block's tile
constexpr int kBN = 64;              // columns of a block's tile
constexpr int kTM = 8;               // rows a thread owns
constexpr int kTN = 4;               // columns a thread owns
constexpr int kDepth = 16;           // values of K staged per step
constexpr int kXsStride = kBM + 4;   // staged x row (K-major), padded
static_assert((kBM / kTM) * (kBN / kTN) == kThreads && kTN == 4 && kTM == 8,
              "one thread per 8 x 4 patch");

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ float val(uint32_t w) { return __uint_as_float(w); }

// Operands travel as 32-bit words, four to a 16-byte load or store, from
// global memory through registers to shared memory; a word becomes a float
// only where x + s is formed and in the FMAs.
__global__ void __launch_bounds__(kThreads, 2)
dft_matmul_kernel(const float* __restrict__ x,      // [R, N]
                  const float* __restrict__ w1,     // [N, F]
                  const float* __restrict__ w2,     // [N, F]
                  const float* __restrict__ s_ptr,  // one scalar
                  float* __restrict__ out,          // [R, F]
                  int R, int N, int F) {
  constexpr int kXVecsPerRow = kDepth / 4;                     // 16-byte loads
  constexpr int kXVecs = kBM * kXVecsPerRow / kThreads;        // per thread
  constexpr int kWVecsPerRow = kBN / 4;
  constexpr int kWVecsPerMat = kDepth * kWVecsPerRow;
  constexpr int kWVecs = 2 * kWVecsPerMat / kThreads;          // per thread
  static_assert(kBM * kXVecsPerRow % kThreads == 0 && 2 * kWVecsPerMat % kThreads == 0,
                "whole loads per thread");

  __shared__ __align__(16) uint32_t xs[kDepth * kXsStride];   // [k][row]
  __shared__ __align__(16) uint32_t ws[2][kDepth * kBN];      // [matrix][k][col]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int ty = tid / (kBN / kTN), tx = tid % (kBN / kTN);
  const float s = *s_ptr;

  float acc1[kTM][kTN], acc2[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc1[i][j] = acc2[i][j] = 0.0f;

  uint4 xr[kXVecs], wr[kWVecs];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kXVecs; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kXVecsPerRow, q = e % kXVecsPerRow;
      xr[i] = row0 + r < R
                  ? __ldg(reinterpret_cast<const uint4*>(
                        x + (size_t)(row0 + r) * N + k0 + q * 4))
                  : zero;
    }
#pragma unroll
    for (int i = 0; i < kWVecs; ++i) {
      const int e = tid + i * kThreads;
      const float* wm = e / kWVecsPerMat ? w2 : w1;
      const int e2 = e % kWVecsPerMat;
      const int k = e2 / kWVecsPerRow, c = e2 % kWVecsPerRow;
      wr[i] = col0 + c * 4 < F
                  ? __ldg(reinterpret_cast<const uint4*>(
                        wm + (size_t)(k0 + k) * F + col0 + c * 4))
                  : zero;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < kXVecs; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kXVecsPerRow, q = e % kXVecsPerRow;
#pragma unroll
      for (int j = 0; j < 4; ++j)   // x + s, transposed to K-major
        xs[(q * 4 + j) * kXsStride + r] = bits(val(word(xr[i], j)) + s);
    }
#pragma unroll
    for (int i = 0; i < kWVecs; ++i) {
      const int e = tid + i * kThreads;
      uint32_t* wm = ws[e / kWVecsPerMat];
      const int e2 = e % kWVecsPerMat;
      const int k = e2 / kWVecsPerRow, c = e2 % kWVecsPerRow;
      *reinterpret_cast<uint4*>(wm + k * kBN + c * 4) = wr[i];
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < N; k0 += kDepth) {
    stage();
    __syncthreads();
    if (k0 + kDepth < N) fetch(k0 + kDepth);
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const uint4 xa0 = *reinterpret_cast<const uint4*>(xs + d * kXsStride + ty * kTM);
      const uint4 xa1 = *reinterpret_cast<const uint4*>(xs + d * kXsStride + ty * kTM + 4);
      const uint4 b1 = *reinterpret_cast<const uint4*>(ws[0] + d * kBN + tx * kTN);
      const uint4 b2 = *reinterpret_cast<const uint4*>(ws[1] + d * kBN + tx * kTN);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float a = val(i < 4 ? word(xa0, i) : word(xa1, i - 4));
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          acc1[i][j] = fmaf(a, val(word(b1, j)), acc1[i][j]);
          acc2[i][j] = fmaf(a, val(word(b2, j)), acc2[i][j]);
        }
      }
    }
    __syncthreads();
  }

  const int col = col0 + tx * kTN;
  if (col < F) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = row0 + ty * kTM + i;
      if (row >= R) continue;
      *reinterpret_cast<uint4*>(out + (size_t)row * F + col) = make_uint4(
          bits(acc1[i][0] + acc2[i][0]), bits(acc1[i][1] + acc2[i][1]),
          bits(acc1[i][2] + acc2[i][2]), bits(acc1[i][3] + acc2[i][3]));
    }
  }
}

int launch_f32(const void* x, const void* w1, const void* w2, const void* s, void* out,
               int R, int N, int F, cudaStream_t stream) {
  const dim3 grid((F + kBN - 1) / kBN, (R + kBM - 1) / kBM);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  dft_matmul_kernel<<<grid, kThreads, 0, stream>>>(
      (const float*)x, (const float*)w1, (const float*)w2, (const float*)s,
      (float*)out, R, N, F);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 and int8 on wgmma

constexpr int kWgRows = 256;              // rows of a block's tile
constexpr int kWgCols = 128;              // columns of a block's tile
constexpr int kWgKBytes = 128;            // bytes of K a stage: one swizzled row
constexpr int kWgStages = 3;
constexpr int kWgThreads = 384;           // two consumer warpgroups, one producer
constexpr int kWgXBytes = kWgRows * kWgKBytes;        // 32 KB
constexpr int kWgWBytes = kWgCols * kWgKBytes;        // 16 KB, twice
constexpr int kWgStageBytes = kWgXBytes + 2 * kWgWBytes;
constexpr int kWgSmemBytes = kWgStages * kWgStageBytes + 1024 /* alignment */ + 64;
static_assert(kWgSmemBytes <= 232448, "fits an SM's shared memory");

// x + s on one 32-bit word of x (two bf16 or four int8 values), in x's own type
template <typename TIn>
__device__ __forceinline__ uint32_t add_word(uint32_t raw, uint32_t sbits) {
  if constexpr (sizeof(TIn) == 2) {
    // bf16 + bf16 rounded once to bf16 (the fp32 sum of two bf16 values is
    // exact up to that one rounding)
    const __nv_bfloat162 r = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&raw),
                                     *reinterpret_cast<const __nv_bfloat162*>(&sbits));
    return *reinterpret_cast<const uint32_t*>(&r);
  } else {
    return __vadd4(raw, sbits);   // per-byte add, wrapping
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(int* p, int a, int b) {
  *reinterpret_cast<int2*>(p) = make_int2(a, b);
}

// the scalar as TIn holds it, repeated over a 32-bit word
template <typename TIn, typename TAcc>
__device__ __forceinline__ uint32_t scalar_word(TAcc s) {
  if constexpr (sizeof(TIn) == 2) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn((float)s)) * 0x00010001u;
  } else {
    return ((uint32_t)(int)s & 0xffu) * 0x01010101u;
  }
}

template <typename TIn, typename TAcc>
__global__ void __launch_bounds__(kWgThreads, 1)
dft_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,    // x [R, N]
                 const __grid_constant__ CUtensorMap map_w1,   // w1^T [F, N]
                 const __grid_constant__ CUtensorMap map_w2,   // w2^T [F, N]
                 const TAcc* __restrict__ s_ptr,               // one scalar
                 TAcc* __restrict__ out,                       // [R, F]
                 int R, int N, int F) {
  constexpr int kKElems = kWgKBytes / sizeof(TIn);   // K values a stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      ((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWgStages * kWgStageBytes);
  uint64_t* empty = full + kWgStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int row0 = blockIdx.y * kWgRows, col0 = blockIdx.x * kWgCols;
  const int nkb = (N + kKElems - 1) / kKElems;

  if (tid == 0) {
    for (int i = 0; i < kWgStages; ++i) {
      hopper::mbar_init(full + i, 1);      // the producer's expect_tx arrival
      hopper::mbar_init(empty + i, 256);   // every consumer thread
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every TMA load ------------------------
    hopper::reg_dealloc<40>();
    if (tid == 256) {
      for (int kb = 0; kb < nkb; ++kb) {
        const int st = kb % kWgStages;
        hopper::mbar_wait(empty + st, ((kb / kWgStages) & 1) ^ 1);
        hopper::mbar_expect_tx(full + st, kWgStageBytes);
        uint8_t* base = smem + st * kWgStageBytes;
        hopper::tma_load_2d(base, &map_x, full + st, kb * kKElems, row0);
        hopper::tma_load_2d(base + kWgXBytes, &map_w1, full + st, kb * kKElems, col0);
        hopper::tma_load_2d(base + kWgXBytes + kWgWBytes, &map_w2, full + st,
                            kb * kKElems, col0);
      }
    }
  } else {
    // ---- consumers: 128 rows a warpgroup, two accumulators of 64 x 128 -----
    hopper::reg_alloc<232>();
    const int t = tid % 128;
    const uint32_t sbits = scalar_word<TIn, TAcc>(*s_ptr);
    TAcc acc[2][64];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[m][i] = (TAcc)0;

    // x + s on this warpgroup's 128 rows (16 KB) of a stage, in place
    auto add_stage = [&](int st) {
      uint4* p = reinterpret_cast<uint4*>(smem + st * kWgStageBytes + wg * (kWgXBytes / 2));
#pragma unroll
      for (int i = 0; i < kWgXBytes / 2 / 16 / 128; ++i) {
        uint4 v = p[t + i * 128];
        v.x = add_word<TIn>(v.x, sbits);
        v.y = add_word<TIn>(v.y, sbits);
        v.z = add_word<TIn>(v.z, sbits);
        v.w = add_word<TIn>(v.w, sbits);
        p[t + i * 128] = v;
      }
      hopper::fence_proxy_async();
      hopper::named_barrier<128>(1 + wg);
    };

    hopper::mbar_wait(full + 0, 0);
    add_stage(0);
    for (int kb = 0; kb < nkb; ++kb) {
      const int st = kb % kWgStages;
      const uint8_t* base = smem + st * kWgStageBytes;
      const uint64_t da = hopper::wgmma_desc_k128(base + wg * (kWgXBytes / 2));
      const uint64_t db1 = hopper::wgmma_desc_k128(base + kWgXBytes);
      const uint64_t db2 = hopper::wgmma_desc_k128(base + kWgXBytes + kWgWBytes);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 64; ++i) hopper::keep(acc[m][i]);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWgKBytes / 32; ++ks) {   // 32 bytes of K a product
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          // 64 rows are 8 KB: 512 in the descriptor's 16-byte units
          const uint64_t a = da + 2 * ks + m * 512;
          hopper::wgmma_m64n128(acc[m], a, db1 + 2 * ks);
          hopper::wgmma_m64n128(acc[m], a, db2 + 2 * ks);
        }
      }
      hopper::wgmma_commit();
      if (kb + 1 < nkb) {   // the next stage's add, under this stage's products
        const int nx = (kb + 1) % kWgStages;
        hopper::mbar_wait(full + nx, ((kb + 1) / kWgStages) & 1);
        add_stage(nx);
      }
      hopper::wgmma_wait0();
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 64; ++i) hopper::keep(acc[m][i]);
      hopper::mbar_arrive(empty + st);
    }

    // fragment of m64n128: thread t holds rows 16 (t / 32) + (t % 32) / 4 and
    // + 8, columns 8 j + 2 (t % 4) and + 1
    const int col_t = col0 + 2 * (t % 4);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int row = row0 + wg * 128 + m * 64 + 16 * (t / 32) + (t % 32) / 4;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = col_t + 8 * j;
        if (col >= F) continue;
        if (row < R) store2(out + (size_t)row * F + col, acc[m][4 * j], acc[m][4 * j + 1]);
        if (row + 8 < R)
          store2(out + (size_t)(row + 8) * F + col, acc[m][4 * j + 2], acc[m][4 * j + 3]);
      }
    }
  }
}

// wt[m][f][n] = w_m[n][f] for w_1 and w_2 (blockIdx.z): 32 x 32 tiles through
// shared memory, so that reads and writes both run along rows
template <typename T>
__global__ void __launch_bounds__(256)
k_major_kernel(const T* __restrict__ w1, const T* __restrict__ w2, T* __restrict__ wt,
               int N, int F) {
  __shared__ T tile[32][33];
  const T* w = blockIdx.z ? w2 : w1;
  T* o = wt + (size_t)blockIdx.z * N * F;
  const int f0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int n = n0 + r, f = f0 + threadIdx.x;
    if (n < N && f < F) tile[r][threadIdx.x] = w[(size_t)n * F + f];
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int f = f0 + r, n = n0 + threadIdx.x;
    if (n < N && f < F) o[(size_t)f * N + n] = tile[threadIdx.x][r];
  }
}

using hopper::kErrTensorMap;
using hopper::make_map;
static_assert(kWgKBytes == 128, "hopper::make_map reads tiles of 128 bytes of K");

template <typename TIn, typename TAcc>
int launch_wgmma(const void* x, const void* w1t, const void* w2t, const void* s, void* out,
                 int R, int N, int F, cudaStream_t stream) {
  const CUtensorMapDataType type = sizeof(TIn) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                    : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap map_x, map_w1, map_w2;
  if (!make_map(&map_x, type, sizeof(TIn), x, R, N, kWgRows) ||
      !make_map(&map_w1, type, sizeof(TIn), w1t, F, N, kWgCols) ||
      !make_map(&map_w2, type, sizeof(TIn), w2t, F, N, kWgCols))
    return kErrTensorMap;
  const dim3 grid((F + kWgCols - 1) / kWgCols, (R + kWgRows - 1) / kWgRows);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  auto kernel = dft_wgmma_kernel<TIn, TAcc>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmemBytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kWgThreads, kWgSmemBytes, stream>>>(
      map_x, map_w1, map_w2, (const TAcc*)s, (TAcc*)out, R, N, F);
  return (int)cudaGetLastError();
}

}  // namespace

// wt [2, F, N] = the transposes of w1 and w2 [N, F] of 1- or 2-byte elements.
extern "C" int att_dft_k_major(const void* w1, const void* w2, void* wt, int N, int F,
                               int elem_bytes, void* stream) {
  if (N < 1 || F < 1 || (elem_bytes != 1 && elem_bytes != 2))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((F + 31) / 32, (N + 31) / 32, 2), block(32, 8);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  if (elem_bytes == 1)
    k_major_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)w1, (const uint8_t*)w2, (uint8_t*)wt, N, F);
  else
    k_major_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint16_t*)w1, (const uint16_t*)w2, (uint16_t*)wt, N, F);
  return (int)cudaGetLastError();
}

// dtype: 0 f32 x f32 -> f32 with w1, w2 [N, F]; 1 bf16 x bf16 -> f32 and
// 2 int8 x int8 -> int32 with w1, w2 given K-major, as their [F, N]
// transposes.  s points at one f32 (dtype 0, 1) or int32 (dtype 2) in
// device memory.  Returns a cudaError_t, or -1 when the TMA tensor maps of
// dtype 1 or 2 could not be encoded.
extern "C" int att_dft_matmul(const void* x, const void* w1, const void* w2,
                              const void* s, void* out, int R, int N, int F,
                              int dtype, void* stream) {
  if (R < 1 || N < 64 || N % 64 != 0 || F < 16 || F % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)x | (uintptr_t)w1 | (uintptr_t)w2 | (uintptr_t)out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_f32(x, w1, w2, s, out, R, N, F, st);
    case 1: return launch_wgmma<__nv_bfloat16, float>(x, w1, w2, s, out, R, N, F, st);
    case 2: return launch_wgmma<int8_t, int>(x, w1, w2, s, out, R, N, F, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
