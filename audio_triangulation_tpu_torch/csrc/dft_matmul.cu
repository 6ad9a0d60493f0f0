// The DFT-shaped pair of products  out = (x + s) @ w1 + (x + s) @ w2  in
// three type sets: f32 x f32 -> f32, bf16 x bf16 -> f32, int8 x int8 -> int32.
//
// Replaces tools/int8_microbench.py::_kernel, the TPU microbenchmark of the
// fused GCC kernel's matmul shape ([rows, N] @ [N, F], twice, for the cos and
// the -sin matrix) in each operand type.  x is [R, N], w1 and w2 are [N, F],
// s is ONE scalar read from device memory (a chained loop feeds it from the
// last output without the host) and added to x in x's own type before the
// products: a bf16 add rounded to bf16, an int8 add that wraps as two's
// complement.  Both products are formed here, each in its own accumulators,
// and added at the end, as the TPU kernel's two dots are.
//
// What bounds it on an H100: operations.  At R = 65,536, N = 1,024, F = 512
// it is 137 GFLOP against 0.4 GB of operands, far above the card's
// operations-per-byte ridge in every type.  This is the plain shared-memory
// tiling on the CUDA cores: a block of 256 threads owns 128 rows x 64
// columns, a thread 8 rows x 4 columns of both products (64 accumulators),
// and K advances 16 staged 32-bit words a step: 16 values in f32 and bf16
// (bf16 is widened to f32 when staged, products and sums are fp32 FMAs), 64
// values in int8, four K-neighbours packed in a word for __dp4a with int32
// accumulation.  x is staged transposed (K-major), so a thread's 8 rows are
// two 16-byte loads; 4 shared loads feed 64 multiply-adds.  The next step's
// global loads are issued into registers before the current step is
// computed.  The tensor cores (wgmma; 989 TFLOP/s bf16, 1,979 TOP/s int8
// against the 67 TFLOP/s of this path) are a later change.  Dropped from the
// TPU kernel: the rows-per-grid-step tiling, the VMEM block specs, and the
// scalar passed through a VMEM block (Mosaic could not extract an int8
// scalar).
//
// Shapes it takes: N a multiple of 64, F a multiple of 16 (whole 16-byte
// loads in every type); any R.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;             // rows of a block's tile
constexpr int kBN = 64;              // columns of a block's tile
constexpr int kTM = 8;               // rows a thread owns
constexpr int kTN = 4;               // columns a thread owns
constexpr int kDepth = 16;           // 32-bit words of K staged per step
constexpr int kXsStride = kBM + 4;   // staged x row (K-major), padded
static_assert((kBM / kTM) * (kBN / kTN) == kThreads && kTN == 4 && kTM == 8,
              "one thread per 8 x 4 patch");

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits(int v) { return (uint32_t)v; }

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// The scalar as TIn would hold it, ready for add_s: f32 bits, bf16 bits in
// the low half, or the int8 value repeated in all four bytes.
template <typename TIn, typename TAcc>
__device__ __forceinline__ uint32_t scalar_bits(TAcc s) {
  if constexpr (sizeof(TIn) == 4) {
    return __float_as_uint((float)s);
  } else if constexpr (sizeof(TIn) == 2) {
    return bf16_bits((float)s);
  } else {
    return ((uint32_t)(int)s & 0xffu) * 0x01010101u;
  }
}

// Staged words of one 32-bit word of x after adding s in TIn: one f32, two
// bf16 values widened to f32 (low half first), or four int8 packed.
template <typename TIn>
__device__ __forceinline__ void add_s(uint32_t raw, uint32_t sbits, uint32_t* out) {
  if constexpr (sizeof(TIn) == 4) {
    out[0] = __float_as_uint(__uint_as_float(raw) + __uint_as_float(sbits));
  } else if constexpr (sizeof(TIn) == 2) {
    // bf16 + bf16 rounded to bf16: the fp32 sum of two bf16 values rounds
    // to the same bf16 as their exact sum does
    const float sv = __uint_as_float(sbits << 16);
    out[0] = bf16_bits(__uint_as_float(raw << 16) + sv) << 16;
    out[1] = bf16_bits(__uint_as_float(raw & 0xffff0000u) + sv) << 16;
  } else {
    out[0] = __vadd4(raw, sbits);   // per-byte add, wrapping
  }
}

template <typename TIn, typename TAcc>
__device__ __forceinline__ TAcc mac(uint32_t a, uint32_t b, TAcc acc) {
  if constexpr (sizeof(TIn) == 1) {
    return __dp4a((int)a, (int)b, acc);
  } else {
    return fmaf(__uint_as_float(a), __uint_as_float(b), acc);
  }
}

template <typename TIn, typename TAcc>
__global__ void __launch_bounds__(kThreads, 2)
dft_matmul_kernel(const TIn* __restrict__ x,     // [R, N]
                  const TIn* __restrict__ w1,    // [N, F]
                  const TIn* __restrict__ w2,    // [N, F]
                  const TAcc* __restrict__ s_ptr,  // one scalar
                  TAcc* __restrict__ out,        // [R, F]
                  int R, int N, int F) {
  constexpr int kPack = sizeof(TIn) == 1 ? 4 : 1;   // K values per staged word
  constexpr int kKC = kDepth * kPack;               // K values per step
  constexpr int kVec = 16 / sizeof(TIn);            // values per 16-byte load
  constexpr int kWordsPerVec = kVec / kPack;        // staged words per load
  constexpr int kXVecsPerRow = kKC / kVec;
  constexpr int kXVecs = kBM * kXVecsPerRow / kThreads;        // per thread
  constexpr int kWVecsPerRow = kBN / kVec;
  constexpr int kWVecsPerMat = kKC * kWVecsPerRow;
  constexpr int kWVecs = 2 * kWVecsPerMat / kThreads;          // per thread
  static_assert(kBM * kXVecsPerRow % kThreads == 0 && 2 * kWVecsPerMat % kThreads == 0,
                "whole loads per thread");

  __shared__ __align__(16) uint32_t xs[kDepth * kXsStride];   // [word of K][row]
  __shared__ __align__(16) uint32_t ws[2][kDepth * kBN];      // [matrix][word of K][col]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBN;
  const int ty = tid / (kBN / kTN), tx = tid % (kBN / kTN);
  const uint32_t sbits = scalar_bits<TIn, TAcc>(*s_ptr);

  TAcc acc1[kTM][kTN], acc2[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc1[i][j] = acc2[i][j] = (TAcc)0;

  uint4 xr[kXVecs], wr[kWVecs];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kXVecs; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kXVecsPerRow, q = e % kXVecsPerRow;
      xr[i] = row0 + r < R
                  ? __ldg(reinterpret_cast<const uint4*>(
                        x + (size_t)(row0 + r) * N + k0 + q * kVec))
                  : zero;
    }
#pragma unroll
    for (int i = 0; i < kWVecs; ++i) {
      const int e = tid + i * kThreads;
      const TIn* wm = e / kWVecsPerMat ? w2 : w1;
      const int e2 = e % kWVecsPerMat;
      const int k = e2 / kWVecsPerRow, c = e2 % kWVecsPerRow;
      wr[i] = col0 + c * kVec < F
                  ? __ldg(reinterpret_cast<const uint4*>(
                        wm + (size_t)(k0 + k) * F + col0 + c * kVec))
                  : zero;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < kXVecs; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kXVecsPerRow, q = e % kXVecsPerRow;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t o[2];
        add_s<TIn>(word(xr[i], j), sbits, o);
        constexpr int kPer = kWordsPerVec / 4;   // staged words per loaded word
#pragma unroll
        for (int h = 0; h < kPer; ++h)
          xs[(q * kWordsPerVec + j * kPer + h) * kXsStride + r] = o[h];
      }
    }
#pragma unroll
    for (int i = 0; i < kWVecs; ++i) {
      const int e = tid + i * kThreads;
      uint32_t* wm = ws[e / kWVecsPerMat];
      const int e2 = e % kWVecsPerMat;
      const int k = e2 / kWVecsPerRow, c = e2 % kWVecsPerRow;
      if constexpr (sizeof(TIn) == 4) {
        *reinterpret_cast<uint4*>(wm + k * kBN + c * 4) = wr[i];
      } else if constexpr (sizeof(TIn) == 2) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t v = word(wr[i], j);
          wm[k * kBN + c * 8 + 2 * j] = v << 16;
          wm[k * kBN + c * 8 + 2 * j + 1] = v & 0xffff0000u;
        }
      } else {
        // row k of 64: byte k % 4 of the words of depth k / 4
        uint8_t* wb = reinterpret_cast<uint8_t*>(wm);
#pragma unroll
        for (int j = 0; j < 16; ++j)
          wb[((k / 4) * kBN + c * 16 + j) * 4 + (k % 4)] =
              (uint8_t)(word(wr[i], j / 4) >> (8 * (j % 4)));
      }
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < N; k0 += kKC) {
    stage();
    __syncthreads();
    if (k0 + kKC < N) fetch(k0 + kKC);
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      const uint4 xa0 = *reinterpret_cast<const uint4*>(xs + d * kXsStride + ty * kTM);
      const uint4 xa1 = *reinterpret_cast<const uint4*>(xs + d * kXsStride + ty * kTM + 4);
      const uint4 b1 = *reinterpret_cast<const uint4*>(ws[0] + d * kBN + tx * kTN);
      const uint4 b2 = *reinterpret_cast<const uint4*>(ws[1] + d * kBN + tx * kTN);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const uint32_t a = i < 4 ? word(xa0, i) : word(xa1, i - 4);
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          acc1[i][j] = mac<TIn, TAcc>(a, word(b1, j), acc1[i][j]);
          acc2[i][j] = mac<TIn, TAcc>(a, word(b2, j), acc2[i][j]);
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

template <typename TIn, typename TAcc>
int launch(const void* x, const void* w1, const void* w2, const void* s, void* out,
           int R, int N, int F, void* stream) {
  const dim3 grid((F + kBN - 1) / kBN, (R + kBM - 1) / kBM);
  if (grid.y > 65535u) return (int)cudaErrorInvalidValue;
  dft_matmul_kernel<TIn, TAcc><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const TIn*)x, (const TIn*)w1, (const TIn*)w2, (const TAcc*)s, (TAcc*)out,
      R, N, F);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 f32 x f32 -> f32, 1 bf16 x bf16 -> f32, 2 int8 x int8 -> int32;
// s points at one f32 (dtype 0, 1) or int32 (dtype 2) in device memory.
extern "C" int att_dft_matmul(const void* x, const void* w1, const void* w2,
                              const void* s, void* out, int R, int N, int F,
                              int dtype, void* stream) {
  if (R < 1 || N < 64 || N % 64 != 0 || F < 16 || F % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if ((((uintptr_t)x | (uintptr_t)w1 | (uintptr_t)w2 | (uintptr_t)out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch<float, float>(x, w1, w2, s, out, R, N, F, stream);
    case 1: return launch<__nv_bfloat16, float>(x, w1, w2, s, out, R, N, F, stream);
    case 2: return launch<int8_t, int>(x, w1, w2, s, out, R, N, F, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
