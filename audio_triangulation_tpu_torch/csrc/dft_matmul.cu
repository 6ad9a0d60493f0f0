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
// What bounds it on an H100.  f32: operations.  The tool asks how fp32
// products run on this card, and every fp32 DFT of the package's main path
// runs as a split-fp32 product on the tensor cores, so this one does too:
// three TF32 products (3 x 137 GFLOP at R = 65,536, N = 1,024, F = 512
// against 495 TFLOP/s, 0.83 ms), which the 67 TFLOP/s of the fp32 CUDA
// cores (2.05 ms) cannot match.  In bf16 and int8 the tensor cores
// (989 TFLOP/s, 1,979 TOP/s) bring the operations down to the time of the
// bytes: x is read once and the 4-byte output, as large as x in bf16 and
// twice x in int8, is written once, and each SM must be fed its operand
// tiles from L2 fast enough.
//
// f32: dft_split_kernel.  w1 and w2 are split once a call into TF32 hi and
// lo parts and stored K-major ([4, F, N]: split_pack_kernel; that time is
// the call's).  A block of three warpgroups owns 192 rows x 128 columns,
// 64 rows a warpgroup; thread 0 keeps two 88 KB stages filled by TMA (32
// f32 values of K a stage: the x tile and the four w tiles, under the
// 128-byte swizzle, ragged edges zero-filled).  Each thread reads the
// m16n8k8 A fragment of its rows from the x tile, adds s in f32 and splits
// x + s into TF32 parts in registers (two integer instructions a part), and
// its warpgroup issues wgmma m64n128k8 with A from registers, three per
// matrix and step of 8 (lo hi, hi lo, hi hi; lo lo, 2^-22 of a product, is
// dropped), into one accumulator for both matrices.  The next step's
// fragments are formed while the step before multiplies.  The tensor cores
// add with truncation, so the accumulator goes into fp32 registers (round
// to nearest) every 16 steps (96 products) and is cleared; that second set
// of 64 registers is why a warpgroup owns 64 rows, not bf16's 128.  What
// bounds the design: each SM pulls 88 KB from L2 per stage of 4.7 M
// multiply-adds, the four w tiles 64 KB of it (4.7 TB/s over the card at
// the TF32 rate); a stage is refilled once every warpgroup has finished its
// products, and the tensor cores drain at every flush.
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
// Dropped from the f32 mode's first design: a shared-memory SGEMM on the
// fp32 CUDA cores (128 x 64 tiles, 8 x 4 outputs a thread), 3.12 ms at the
// tool's size, slower than two cuBLAS SGEMMs.
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

// ---------------------------------------------------------------------------
// f32 as a split-fp32 product on wgmma

constexpr int kSpWGs = 3;                       // warpgroups, 64 rows each
constexpr int kSpRows = 64 * kSpWGs;            // rows of a block's tile
constexpr int kSpCols = 128;                    // columns of a block's tile
constexpr int kSpThreads = 128 * kSpWGs;
constexpr int kSpK = 32;                        // values of K a stage: one 128-byte row
constexpr int kSpStages = 2;
constexpr int kSpFlushStages = 4;               // sums into fp32 registers every 16 steps
constexpr int kSpXBytes = kSpRows * 128;        // 24 KB
constexpr int kSpWBytes = kSpCols * 128;        // 16 KB: w1 hi, w1 lo, w2 hi, w2 lo
constexpr int kSpStageBytes = kSpXBytes + 4 * kSpWBytes;
constexpr int kSpSmemBytes = kSpStages * kSpStageBytes + 1024 /* alignment */ + 64;
static_assert(kSpSmemBytes <= 232448, "fits an SM's shared memory");
static_assert(kSpXBytes % 1024 == 0 && kSpWBytes % 1024 == 0,
              "swizzled tiles start on 1,024-byte boundaries");

// Thread t of warpgroup wg holds the m16n8k8 A fragment of rows 16 warp + g
// and + 8 (g = lane / 4) at K values 8 q + lane % 4 and + 4 of a stage: in the
// 128-byte swizzle the 16-byte chunk c of row r lies at chunk c ^ (r % 8), and
// r % 8 = g, so the four loads of a warp hit 32 banks.
__global__ void __launch_bounds__(kSpThreads, 1)
dft_split_kernel(const __grid_constant__ CUtensorMap map_x,    // x [R, N]
                 const __grid_constant__ CUtensorMap map_w,    // [4 F, N] split, K-major
                 const float* __restrict__ s_ptr,              // one scalar
                 float* __restrict__ out,                      // [R, F]
                 int R, int N, int F) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      ((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kSpStages * kSpStageBytes);
  uint64_t* empty = full + kSpStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128, t = tid % 128;
  const int warp = t / 32, g = (t % 32) / 4, tq = t % 4;
  const int row0 = blockIdx.y * kSpRows, col0 = blockIdx.x * kSpCols;
  const int nkb = N / kSpK;

  if (tid == 0) {
    for (int i = 0; i < kSpStages; ++i) {
      hopper::mbar_init(full + i, 1);               // the expect_tx arrival
      hopper::mbar_init(empty + i, kSpThreads);     // every thread
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // stage kb: the x tile and the four w tiles, by thread 0
  auto issue = [&](int kb) {
    const int st = kb % kSpStages;
    uint8_t* base = smem + st * kSpStageBytes;
    hopper::mbar_expect_tx(full + st, kSpStageBytes);
    hopper::tma_load_2d(base, &map_x, full + st, kb * kSpK, row0);
    for (int m = 0; m < 4; ++m)
      hopper::tma_load_2d(base + kSpXBytes + m * kSpWBytes, &map_w, full + st, kb * kSpK,
                          m * F + col0);
  };
  if (tid == 0) {
    issue(0);
    if (nkb > 1) issue(1);
  }

  const float s = *s_ptr;
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;
  uint32_t ah[2][4], al[2][4];   // two steps' fragments: one multiplies, one is formed
  const int xrow = (wg * 64 + warp * 16 + g) * 128 + 4 * tq;   // bytes into an x tile

  for (int kb = 0; kb < nkb; ++kb) {
    const int st = kb % kSpStages;
    // a copy that never lands is a fault of the tensor map or the card: stop
    // the kernel with an error where waiting on would hang it
    if (!hopper::mbar_wait_bounded(full + st, (kb / kSpStages) & 1)) __trap();
    const uint8_t* base = smem + st * kSpStageBytes;
    const uint8_t* xt = base + xrow;
    uint64_t dw[4];   // w1 hi, w1 lo, w2 hi, w2 lo
#pragma unroll
    for (int m = 0; m < 4; ++m) dw[m] = hopper::wgmma_desc_k128(base + kSpXBytes + m * kSpWBytes);
#pragma unroll
    for (int q = 0; q < kSpK / 8; ++q) {
      const int p = q & 1;
      hopper::wgmma_wait<1>();   // the products of two steps back have read set p
      if (q == 1 && kb > 0) {
        // every product of stage kb - 1 is done: its buffers may be refilled
        hopper::mbar_arrive(empty + (kb - 1) % kSpStages);
        if (tid == 0 && kb + 1 < nkb) {
          hopper::mbar_wait(empty + (kb - 1) % kSpStages, ((kb - 1) / kSpStages) & 1);
          issue(kb + 1);
        }
      }
      const int c0 = ((2 * q) ^ g) * 16, c1 = ((2 * q + 1) ^ g) * 16;
      const float v[4] = {*reinterpret_cast<const float*>(xt + c0),
                          *reinterpret_cast<const float*>(xt + 1024 + c0),
                          *reinterpret_cast<const float*>(xt + c1),
                          *reinterpret_cast<const float*>(xt + 1024 + c1)};
#pragma unroll
      for (int i = 0; i < 4; ++i) hopper::tf32_split(v[i] + s, ah[p][i], al[p][i]);
      hopper::wgmma_fence();   // the fragments just written, before their products
#pragma unroll
      for (int m = 0; m < 2; ++m) {   // small terms first
        hopper::wgmma_m64n128_tf32(acc, al[p], dw[2 * m] + 2 * q);
        hopper::wgmma_m64n128_tf32(acc, ah[p], dw[2 * m + 1] + 2 * q);
        hopper::wgmma_m64n128_tf32(acc, ah[p], dw[2 * m] + 2 * q);
      }
      hopper::wgmma_commit();
    }
    if ((kb + 1) % kSpFlushStages == 0 || kb + 1 == nkb) {
      // the tensor cores add with truncation: their sums go into fp32
      // registers (round to nearest) every kSpFlushStages stages
      hopper::wgmma_wait0();
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        hopper::keep(acc[i]);
        sum[i] += acc[i];
        acc[i] = 0.f;
      }
    }
  }

  // fragment of m64n128: thread t holds rows 16 (t / 32) + (t % 32) / 4 and
  // + 8, columns 8 j + 2 (t % 4) and + 1
  const int row = row0 + wg * 64 + 16 * warp + g;
  const int col_t = col0 + 2 * tq;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = col_t + 8 * j;
    if (col >= F) continue;
    if (row < R) store2(out + (size_t)row * F + col, sum[4 * j], sum[4 * j + 1]);
    if (row + 8 < R) store2(out + (size_t)(row + 8) * F + col, sum[4 * j + 2], sum[4 * j + 3]);
  }
}

// wpk [4, F, N]: the TF32 hi and lo parts of w1 and of w2 [N, F], each
// transposed (blockIdx.z picks the matrix), as k_major_kernel does
__global__ void __launch_bounds__(256)
split_pack_kernel(const float* __restrict__ w1, const float* __restrict__ w2,
                  uint32_t* __restrict__ wpk, int N, int F) {
  __shared__ float tile[32][33];
  const float* w = blockIdx.z ? w2 : w1;
  uint32_t* hi = wpk + (size_t)(2 * blockIdx.z) * N * F;
  uint32_t* lo = hi + (size_t)N * F;
  const int f0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int n = n0 + r, f = f0 + threadIdx.x;
    if (n < N && f < F) tile[r][threadIdx.x] = w[(size_t)n * F + f];
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int f = f0 + r, n = n0 + threadIdx.x;
    if (n < N && f < F) {
      uint32_t h, l;
      hopper::tf32_split(tile[threadIdx.x][r], h, l);
      hi[(size_t)f * N + n] = h;
      lo[(size_t)f * N + n] = l;
    }
  }
}

int launch_split(const void* x, const void* wpk, const void* s, void* out, int R, int N,
                 int F, cudaStream_t stream) {
  CUtensorMap map_x, map_w;
  if (!hopper::make_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, R, N, kSpRows) ||
      !hopper::make_map(&map_w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, wpk, 4 * F, N, kSpCols))
    return hopper::kErrTensorMap;
  const dim3 grid((F + kSpCols - 1) / kSpCols, (R + kSpRows - 1) / kSpRows);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dft_split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSpSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dft_split_kernel<<<grid, kSpThreads, kSpSmemBytes, stream>>>(
      map_x, map_w, (const float*)s, (float*)out, R, N, F);
  return (int)cudaGetLastError();
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

// wpk [4, F, N] f32 = the TF32 hi and lo parts of w1, then of w2 [N, F] f32,
// each transposed so that K runs fastest: the operand of dtype 0.
extern "C" int att_dft_split_pack(const void* w1, const void* w2, void* wpk, int N, int F,
                                  void* stream) {
  if (N < 1 || F < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((F + 31) / 32, (N + 31) / 32, 2), block(32, 8);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  split_pack_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)w1, (const float*)w2, (uint32_t*)wpk, N, F);
  return (int)cudaGetLastError();
}

// dtype: 0 f32 x f32 -> f32 with w1 the packed [4, F, N] split copies of
// att_dft_split_pack (w2 is not read); 1 bf16 x bf16 -> f32 and 2 int8 x
// int8 -> int32 with w1, w2 given K-major, as their [F, N] transposes.  s
// points at one f32 (dtype 0, 1) or int32 (dtype 2) in device memory.
// Returns a cudaError_t, or -1 when the TMA tensor maps could not be
// encoded.
extern "C" int att_dft_matmul(const void* x, const void* w1, const void* w2,
                              const void* s, void* out, int R, int N, int F,
                              int dtype, void* stream) {
  if (R < 1 || N < 64 || N % 64 != 0 || F < 16 || F % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)x | (uintptr_t)w1 | (uintptr_t)w2 | (uintptr_t)out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_split(x, w1, s, out, R, N, F, st);
    case 1: return launch_wgmma<__nv_bfloat16, float>(x, w1, w2, s, out, R, N, F, st);
    case 2: return launch_wgmma<int8_t, int>(x, w1, w2, s, out, R, N, F, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
