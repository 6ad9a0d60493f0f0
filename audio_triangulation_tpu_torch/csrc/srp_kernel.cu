// SRP scoring with the grid argmax in one pass: the [B, G] scores are never
// stored.
//
// Replaces audio_triangulation_tpu/ops/pallas/srp_kernel.py::_kernel
// (srp_argmax).  For correlograms A [B, K]
// (K = pairs x lags, flattened) and any matrix W [K, G]:
//
//   scores[b, g] = sum_k A[b, k] W[k, g]        (fp32 sums)
//   val[b] = max over g < num_cells, cell[b] = the first g that reaches it
//
// With bf16 set both operands are rounded to bf16 as they are staged and
// the products are summed in fp32 (a product of two bf16 values is exact in
// fp32), which is what a bf16 matrix unit with fp32 accumulation computes.
//
// What bounds it on an H100: operations, B x K x G fp32 FMAs on the CUDA
// cores (93 G at B = 16,384, K = 558, G = 10,201) against 37 MB of
// correlograms and 23 MB of matrix.  W is a general matrix here, as in the
// TPU kernel, not a one-hot to gather by.  The TPU kernel's sequential grid
// axis over G tiles, with its running (max, cell) in scratch memory,
// becomes a loop inside the block: a block owns 128 frames and walks the
// grid 128 cells at a time, so no reduction crosses blocks.  Each tile is a
// shared-memory SGEMM (depth 8 a step, each thread 8 x 8 outputs, the next
// step's operands fetched into registers while the current one is
// multiplied), then every frame's tile maximum is reduced over the 16
// threads that share the frame.  A later tile replaces the running maximum
// only when strictly greater, and inside a tile the smallest cell wins a
// tie, so the first maximum wins overall.
//
// Dropped from the TPU kernel: the padding of B to a batch tile and of G to
// a grid tile (the ragged edges are masked here) and the 128-lane outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileB = 128;   // frames per block
constexpr int kTileG = 128;   // cells per step of the grid loop
constexpr int kDepth = 8;     // k per staged step
constexpr int kPerThread = 8; // each thread: 8 frames x 8 cells
constexpr int kLoads = kTileB * kDepth / kThreads;  // staged values per thread and operand
static_assert(kTileB == kTileG, "one staging pattern for both operands");
static_assert(kLoads == 4, "a thread stages 4 values of each operand");

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kThreads)
srp_argmax_kernel(const float* __restrict__ a,   // [B, K]
                  const float* __restrict__ w,   // [K, G]
                  float* __restrict__ val_out,   // [B]
                  int* __restrict__ cell_out,    // [B]
                  int B, int K, int G, int num_cells, int bf16) {
  __shared__ __align__(16) float a_s[kDepth][kTileB];
  __shared__ __align__(16) float w_s[kDepth][kTileG];

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // cells 4 tx .. 4 tx + 3 and 64 + 4 tx .. + 3
  const int ty = tid / 16;   // frames 4 ty .. 4 ty + 3 and 64 + 4 ty .. + 3
  const int b0 = blockIdx.x * kTileB;

  // staging: A values (frame tid / 2, k 4 (tid % 2) ..), W values
  // (k tid / 32, cells 4 (tid % 32) ..)
  const int a_row = tid / 2, a_k = 4 * (tid % 2);
  const int w_k = tid / 32, w_col = 4 * (tid % 32);
  const bool a_ok = b0 + a_row < B;
  const float* a_ptr = a + (size_t)(b0 + (a_ok ? a_row : 0)) * K;

  float run_val[kPerThread];
  int run_cell[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    run_val[i] = -INFINITY;
    run_cell[i] = 0;
  }

  const int gmax = min(G, num_cells);
  for (int g0 = 0; g0 < gmax; g0 += kTileG) {
    float acc[kPerThread][kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) acc[i][j] = 0.f;

    float ra[kLoads], rw[kLoads];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int k = k0 + a_k + i;
        float v = (a_ok && k < K) ? __ldg(a_ptr + k) : 0.f;
        ra[i] = bf16 ? round_bf16(v) : v;
        const int kw = k0 + w_k, g = g0 + w_col + i;
        v = (kw < K && g < G) ? __ldg(w + (size_t)kw * G + g) : 0.f;
        rw[i] = bf16 ? round_bf16(v) : v;
      }
    };
    fetch(0);
    for (int k0 = 0; k0 < K; k0 += kDepth) {
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        a_s[a_k + i][a_row] = ra[i];
      }
      *reinterpret_cast<float4*>(&w_s[w_k][w_col]) = make_float4(rw[0], rw[1], rw[2], rw[3]);
      __syncthreads();
      if (k0 + kDepth < K) fetch(k0 + kDepth);
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&a_s[kk][4 * ty]);
        const float4 a1 = *reinterpret_cast<const float4*>(&a_s[kk][64 + 4 * ty]);
        const float4 w0 = *reinterpret_cast<const float4*>(&w_s[kk][4 * tx]);
        const float4 w1 = *reinterpret_cast<const float4*>(&w_s[kk][64 + 4 * tx]);
        const float av[kPerThread] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float wv[kPerThread] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < kPerThread; ++i)
#pragma unroll
          for (int j = 0; j < kPerThread; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // this tile's maximum per frame: over the thread's 8 cells in ascending
    // order, then over the 16 threads of the frame (smallest cell on a tie)
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      float best = -INFINITY;
      int cell = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int g = g0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
        if (g < gmax && acc[i][j] > best) {
          best = acc[i][j];
          cell = g;
        }
      }
      for (int off = 8; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, off);
        const int oc = __shfl_xor_sync(0xffffffffu, cell, off);
        if (ov > best || (ov == best && oc < cell)) {
          best = ov;
          cell = oc;
        }
      }
      if (best > run_val[i]) {   // strictly greater: the earliest tile wins
        run_val[i] = best;
        run_cell[i] = cell;
      }
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int row = b0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
      if (row < B) {
        val_out[row] = run_val[i];
        cell_out[row] = run_cell[i];
      }
    }
  }
}

}  // namespace

extern "C" int att_srp_argmax(const void* a, const void* w, void* val_out,
                              void* cell_out, int B, int K, int G,
                              int num_cells, int bf16, void* stream) {
  if (B < 1 || K < 1 || G < 1 || num_cells < 1) return (int)cudaErrorInvalidValue;
  const int grid = (B + kTileB - 1) / kTileB;
  srp_argmax_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)w, (float*)val_out, (int*)cell_out, B, K, G,
      num_cells, bf16);
  return (int)cudaGetLastError();
}
