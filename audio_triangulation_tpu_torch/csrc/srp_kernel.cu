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
// Both modes multiply on the tensor cores (mma.sync) and sum in fp32.
//   f32 mode: a split-fp32 product.  Every operand is split as it leaves
//   shared memory, a = a_hi + a_lo and w = w_hi + w_lo with each part
//   rounded to TF32, and a step of 8 values of K adds a_lo w_hi, then
//   a_hi w_lo, then a_hi w_hi to the accumulator: three TF32 products, the
//   small terms first.  What is dropped, a_lo w_lo, is 2^-22 of a product.
//   bf16 mode: both operands are rounded to bf16 as they leave shared
//   memory and go through one bf16 product a step of 16 values of K (a
//   product of two bf16 values is exact in fp32).
// W is a general matrix in both, as in the TPU kernel: nothing looks for a
// one-hot, and w_lo is multiplied even where it is zero.
//
// What bounds it on an H100: operations.  B x K x G = 16,384 x 558 x 10,201
// is 186.5 GFLOP: three times that at the TF32 rate in f32 mode, once at the
// bf16 rate in bf16 mode, against 37 MB of correlograms and 23 MB of
// matrix.  Through mma.sync the limit is the instructions around each
// product (fragment loads, the split's two converts and a subtract per
// value) as much as the tensor pipe, so the design spends registers on
// reuse: a warp owns 64 frames x 64 cells (4 x 8 mma tiles, 128
// accumulators), an A fragment is split once for 8 tiles and a W fragment
// once for 4, and the three products of a step run in passes over 8
// accumulators so that no mma waits for the one before it.
//
// The TPU kernel's sequential grid axis over G tiles, with its running
// (max, cell) in scratch memory, becomes a loop inside the block: a block
// of 8 warps (2 over the frames, 4 over the cells) owns 128 frames and
// walks the grid 256 cells at a time, so no reduction crosses blocks.  The
// (G tile, K step) pairs form one sequence of steps fed by a ring of three
// cp.async stages (a 128 x 32 tile of A, a 32 x 256 tile of W), so the
// loads run on across tile borders.  Copies are 4 bytes wide with zero
// fill: rows of A and W are multiples of 4 bytes and of nothing more (2,232
// and 40,804 bytes here), and the same copies pad the ragged edges of B, K
// and G.  Every cell's sum is taken over the same K steps by the same
// instructions, whichever tile it lies in, so equal columns of W give
// bit-equal scores.  After a tile's last K step each thread reduces its
// fragment per frame (ascending cells, strictly greater wins), the four
// threads that share a frame shuffle (smallest cell on a tie), the four
// warps that share the frames meet in shared memory, and one thread per
// frame keeps the running (max, cell), replaced only when strictly greater:
// the first maximum wins overall.
//
// Dropped from the TPU kernel: the padding of B to a batch tile and of G to
// a grid tile (the ragged edges are masked here) and the 128-lane outputs.

#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileB = 128;   // frames per block
constexpr int kTileG = 256;   // cells per step of the grid loop
constexpr int kTileK = 32;    // k per staged step
constexpr int kStages = 3;
constexpr int kWarpsG = 4;             // warps side by side over the cells
constexpr int kMT = 4, kNT = 8;        // mma tiles a warp: 64 frames x 64 cells

// Staged rows, in floats, padded so that a fragment load hits every bank
// once.  TF32 fragments read A at (frame lane / 4, k lane % 4) and W at
// (k lane % 4, cell lane / 4): strides of 4 and 8 over a multiple of 32.
// bf16 fragments read pairs of k, 8 bytes of A a lane and W at k 2 (lane %
// 4): strides of 8 and 4 over a multiple of 32.
template <bool kBf16>
__host__ __device__ constexpr int a_stride() { return kTileK + (kBf16 ? 8 : 4); }
template <bool kBf16>
__host__ __device__ constexpr int w_stride() { return kTileG + (kBf16 ? 4 : 8); }
template <bool kBf16>
__host__ __device__ constexpr int stage_floats() {
  return kTileB * a_stride<kBf16>() + kTileK * w_stride<kBf16>();
}
template <bool kBf16>
__host__ __device__ constexpr int smem_bytes() { return kStages * stage_floats<kBf16>() * 4; }

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
srp_argmax_kernel(const float* __restrict__ a,   // [B, K]
                  const float* __restrict__ w,   // [K, G]
                  float* __restrict__ val_out,   // [B]
                  int* __restrict__ cell_out,    // [B]
                  int B, int K, int G, int num_cells) {
  constexpr int kAStride = a_stride<kBf16>();
  constexpr int kWStride = w_stride<kBf16>();
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_val[kWarpsG][kTileB];
  __shared__ uint8_t red_cell[kWarpsG][kTileB];   // cell - g0

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g_ = lane / 4, t_ = lane % 4;   // the fragment's row and column index
  const int wm = warp / kWarpsG, wn = warp % kWarpsG;
  const int b0 = blockIdx.x * kTileB;
  const int gmax = min(G, num_cells);
  const int n_k = (K + kTileK - 1) / kTileK;
  const int total = ((gmax + kTileG - 1) / kTileG) * n_k;

  // stage one (G tile, K step): A rows tid / 32 + 8 i at k tid % 32, every W
  // row at cell tid
  auto issue = [&](int stage, int g0, int k0) {
    float* as = smem + stage * stage_floats<kBf16>();
    float* ws = as + kTileB * kAStride;
    const int ka = k0 + lane;
#pragma unroll
    for (int i = 0; i < kTileB / 8; ++i) {
      const int r = warp + 8 * i;
      const bool ok = ka < K && b0 + r < B;
      hopper::cp_async4(as + r * kAStride + lane,
                        a + (ok ? (size_t)(b0 + r) * K + ka : 0), ok);
    }
    const int gg = g0 + tid;
#pragma unroll 8
    for (int kr = 0; kr < kTileK; ++kr) {
      const bool ok = gg < G && k0 + kr < K;
      hopper::cp_async4(ws + kr * kWStride + tid,
                        w + (ok ? (size_t)(k0 + kr) * G + gg : 0), ok);
    }
  };

  float acc[kMT][kNT][4];
  auto clear = [&]() {
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  };
  clear();

  auto compute = [&](int stage) {
    const float* as = smem + stage * stage_floats<kBf16>() + (wm * 64 + g_) * kAStride;
    const float* ws = smem + stage * stage_floats<kBf16>() + kTileB * kAStride +
                      wn * 64 + g_;
    if constexpr (kBf16) {
#pragma unroll
      for (int kk = 0; kk < kTileK; kk += 16) {
        uint32_t af[kMT][4];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const float* p = as + i * 16 * kAStride + kk + 2 * t_;
          const float2 v0 = *reinterpret_cast<const float2*>(p);
          const float2 v1 = *reinterpret_cast<const float2*>(p + 8 * kAStride);
          const float2 v2 = *reinterpret_cast<const float2*>(p + 8);
          const float2 v3 = *reinterpret_cast<const float2*>(p + 8 * kAStride + 8);
          af[i][0] = hopper::pack_bf16(v0.x, v0.y);
          af[i][1] = hopper::pack_bf16(v1.x, v1.y);
          af[i][2] = hopper::pack_bf16(v2.x, v2.y);
          af[i][3] = hopper::pack_bf16(v3.x, v3.y);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float* q = ws + (kk + 2 * t_) * kWStride + 8 * j;
          const uint32_t bf[2] = {
              hopper::pack_bf16(q[0], q[kWStride]),
              hopper::pack_bf16(q[8 * kWStride], q[9 * kWStride])};
#pragma unroll
          for (int i = 0; i < kMT; ++i) hopper::mma_bf16(acc[i][j], af[i], bf);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kTileK; kk += 8) {
        uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const float* p = as + i * 16 * kAStride + kk + t_;
          hopper::tf32_split(p[0], ah[i][0], al[i][0]);
          hopper::tf32_split(p[8 * kAStride], ah[i][1], al[i][1]);
          hopper::tf32_split(p[4], ah[i][2], al[i][2]);
          hopper::tf32_split(p[8 * kAStride + 4], ah[i][3], al[i][3]);
        }
        // two columns of mma tiles at a time; small terms first; each pass
        // touches 8 accumulators once, so that no mma waits for the one
        // before it
#pragma unroll
        for (int j0 = 0; j0 < kNT; j0 += 2) {
          uint32_t bh[2][2], bl[2][2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float* q = ws + (kk + t_) * kWStride + 8 * (j0 + j);
            hopper::tf32_split(q[0], bh[j][0], bl[j][0]);
            hopper::tf32_split(q[4 * kWStride], bh[j][1], bl[j][1]);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < kMT; ++i) hopper::mma_tf32(acc[i][j0 + j], al[i], bh[j]);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < kMT; ++i) hopper::mma_tf32(acc[i][j0 + j], ah[i], bl[j]);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < kMT; ++i) hopper::mma_tf32(acc[i][j0 + j], ah[i], bh[j]);
        }
      }
    }
  };

  float run_val = -INFINITY;   // of frame b0 + tid, in threads 0..127
  int run_cell = 0;

  // this tile's maximum per frame: over the thread's 16 cells in ascending
  // order, over the 4 threads of the frame (smallest cell on a tie), over
  // the 4 warps in ascending cells, then against the running maximum
  auto reduce_tile = [&](int g0) {
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float best = -INFINITY;
        int cell = 0x7fffffff;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int g = g0 + wn * 64 + 8 * j + 2 * t_ + c;
            const float v = acc[i][j][2 * h + c];
            if (g < gmax && v > best) {
              best = v;
              cell = g;
            }
          }
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, best, off);
          const int oc = __shfl_xor_sync(0xffffffffu, cell, off);
          if (ov > best || (ov == best && oc < cell)) {
            best = ov;
            cell = oc;
          }
        }
        if (t_ == 0) {
          const int r = wm * 64 + i * 16 + h * 8 + g_;
          red_val[wn][r] = best;
          red_cell[wn][r] = (uint8_t)(cell - g0);   // unused where best is -inf
        }
      }
    }
    __syncthreads();
    if (tid < kTileB) {
#pragma unroll
      for (int q = 0; q < kWarpsG; ++q) {
        if (red_val[q][tid] > run_val) {   // strictly greater: the earliest wins
          run_val = red_val[q][tid];
          run_cell = g0 + red_cell[q][tid];
        }
      }
    }
    // the next writes of red_* come after the next step's __syncthreads
  };

  // the ring: step s is computed while steps s + 1 and s + 2 are in flight
  int ig0 = 0, ik = 0, issued = 0;   // the next step to issue
  auto issue_next = [&]() {
    if (issued < total) {
      issue(issued % kStages, ig0, ik * kTileK);
      ++issued;
      if (++ik == n_k) {
        ik = 0;
        ig0 += kTileG;
      }
    }
    hopper::cp_async_commit();   // an empty group keeps the count in step
  };
  for (int i = 0; i < kStages - 1; ++i) issue_next();
  int g0 = 0, kt = 0;
  for (int s = 0; s < total; ++s) {
    hopper::cp_async_wait<kStages - 2>();
    __syncthreads();   // step s has landed; step s - 1's stage is free
    issue_next();
    compute(s % kStages);
    if (++kt == n_k) {
      reduce_tile(g0);
      clear();
      kt = 0;
      g0 += kTileG;
    }
  }

  if (tid < kTileB && b0 + tid < B) {
    val_out[b0 + tid] = run_val;
    cell_out[b0 + tid] = run_cell;
  }
}

template <bool kBf16>
int launch(const void* a, const void* w, void* val_out, void* cell_out, int B, int K,
           int G, int num_cells, cudaStream_t stream) {
  auto kernel = srp_argmax_kernel<kBf16>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<kBf16>());
  if (err != cudaSuccess) return (int)err;
  kernel<<<(B + kTileB - 1) / kTileB, kThreads, smem_bytes<kBf16>(), stream>>>(
      (const float*)a, (const float*)w, (float*)val_out, (int*)cell_out, B, K, G,
      num_cells);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int att_srp_argmax(const void* a, const void* w, void* val_out,
                              void* cell_out, int B, int K, int G,
                              int num_cells, int bf16, void* stream) {
  if (B < 1 || K < 1 || G < 1 || num_cells < 1) return (int)cudaErrorInvalidValue;
  return bf16 ? launch<true>(a, w, val_out, cell_out, B, K, G, num_cells,
                             (cudaStream_t)stream)
              : launch<false>(a, w, val_out, cell_out, B, K, G, num_cells,
                              (cudaStream_t)stream);
}
