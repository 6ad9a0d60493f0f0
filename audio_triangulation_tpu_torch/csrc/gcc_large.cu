// Large-array GCC: per-pair cross-power and +-K lag synthesis from whitened
// spectra, for arrays with too many pairs for the fused kernel (64 mics ->
// 2,016 pairs).
//
// Replaces audio_triangulation_tpu/ops/pallas/gcc_large.py::_kernel
// (xcorr_large and, with the peak stage, xcorr_large_peaks).  Per (frame, pair):
//
//   rr[f] = re_i re_j + im_i im_j,  jj[f] = re_i im_j - im_i re_j
//   corr[l] = sum_f rr[f] sync[f, l] + jj[f] syns[f, l]
//   optional peaks on the raw correlogram (first-max argmax, parabolic
//   sub-sample, PSR with guard 3), then the Gaussian taper on the output
//
// The spectra arrive conditioned, transformed, band-weighted and whitened
// per mic (plain torch in the wrapper, as the TPU kernel's wrapper did it in
// XLA).  In the bf16 mode the spectra and synthesis matrices arrive rounded
// to bf16 (carried as f32) and the kernel rounds rr and jj, as the TPU
// kernel did; all sums are fp32.
//
// What bounds it on an H100: operations.  Every (pair, bin, lag) costs two
// fp32 FMAs on the CUDA cores (1.23 G a frame at 2,016 pairs, 2,049 bins,
// 149 lags) against 1 MB of spectra in and 1.2 MB of correlograms out.
// One frame's spectra exceed a block's shared memory, so a block takes one
// frame and 64 pairs and walks the bin axis in chunks of 16: the chunk of
// the two synthesis matrices and the 64 pairs' cross-power are staged in
// shared memory (the spectra come from L2, where the frame's other 31
// blocks read them too), then each warp owns 8 pairs and each lane 5 lags,
// so 5 + 8 shared loads feed 80 FMAs.  Each chunk is summed on its own and
// then added to the total, which keeps rounding at N / 16 + 16 terms.  The
// raw rows wait in shared memory for the peak stage.
//
// Dropped from the TPU kernel: the one-hot mic-selection matmuls (mics are
// indexed directly), the padding of lags to 128 and of pairs to a chunk,
// the batch tile, and the packed 128-lane aux output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;                 // pairs a warp synthesises
constexpr int kTileP = kWarps * kRowsPerWarp;   // pairs per block
constexpr int kLagsPerLane = 5;
constexpr int kLagBlock = 32 * kLagsPerLane;    // lags per synthesis block
constexpr int kFChunk = 16;                     // bins staged per step
constexpr int kXpPerThread = kTileP * kFChunk / kThreads;
static_assert(kTileP * kFChunk % kThreads == 0, "whole staged items per thread");
static_assert(kThreads % kFChunk == 0, "a thread stages one bin column");
constexpr size_t kMaxSmem = 227 * 1024;

size_t smem_bytes(int l) {
  return sizeof(float2) * ((size_t)kFChunk * kLagBlock + (size_t)kTileP * kFChunk)
         + sizeof(float) * (size_t)kTileP * l;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kThreads, 2)
gcc_large_kernel(const float* __restrict__ re,     // [B, M, F]
                 const float* __restrict__ im,     // [B, M, F]
                 const int* __restrict__ pairs,    // [P, 2]
                 const float* __restrict__ sync,   // [F, L]
                 const float* __restrict__ syns,   // [F, L]
                 float* __restrict__ corr_out,     // [B, P, L]
                 int* __restrict__ shift_out,      // [B, P] (peaks only)
                 float* __restrict__ tdoa_out,
                 float* __restrict__ peak_out,
                 float* __restrict__ psr_out,
                 int M, int F, int P, int L, int tiles, int bf16,
                 int with_peaks, int taper, float taper_denom) {
  extern __shared__ float2 smem2[];
  float2* syn = smem2;                           // [kFChunk][kLagBlock]
  float2* xp = syn + kFChunk * kLagBlock;        // [kTileP][kFChunk]
  float* rowbuf = reinterpret_cast<float*>(xp + kTileP * kFChunk);  // [kTileP][L]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x % tiles) * kTileP;
  const float* re_b = re + (size_t)b * M * F;
  const float* im_b = im + (size_t)b * M * F;

  // the (pair, bin column) items this thread stages: rows tid / 16 + 16 i
  const int sf = tid % kFChunk;
  int off_i[kXpPerThread], off_j[kXpPerThread];   // M * F fits an int
  bool have[kXpPerThread];
#pragma unroll
  for (int i = 0; i < kXpPerThread; ++i) {
    const int p = p0 + tid / kFChunk + i * (kThreads / kFChunk);
    have[i] = p < P;
    off_i[i] = have[i] ? __ldg(pairs + 2 * p) * F : 0;
    off_j[i] = have[i] ? __ldg(pairs + 2 * p + 1) * F : 0;
  }

  for (int l0 = 0; l0 < L; l0 += kLagBlock) {
    float acc[kRowsPerWarp][kLagsPerLane];
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k)
#pragma unroll
      for (int j = 0; j < kLagsPerLane; ++j) acc[k][j] = 0.f;

    for (int fb = 0; fb < F; fb += kFChunk) {
      for (int e = tid; e < kFChunk * kLagBlock; e += kThreads) {
        const int f = fb + e / kLagBlock, l = l0 + e % kLagBlock;
        const bool ok = f < F && l < L;
        syn[e] = ok ? make_float2(__ldg(sync + (size_t)f * L + l),
                                  __ldg(syns + (size_t)f * L + l))
                    : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < kXpPerThread; ++i) {
        const int f = fb + sf;
        float rr = 0.f, jj = 0.f;
        if (have[i] && f < F) {
          const float ri = __ldg(re_b + off_i[i] + f), ii = __ldg(im_b + off_i[i] + f);
          const float rj = __ldg(re_b + off_j[i] + f), ij = __ldg(im_b + off_j[i] + f);
          rr = ri * rj + ii * ij;
          jj = ri * ij - ii * rj;
          if (bf16) {
            rr = round_bf16(rr);
            jj = round_bf16(jj);
          }
        }
        xp[(tid / kFChunk + i * (kThreads / kFChunk)) * kFChunk + sf] = make_float2(rr, jj);
      }
      __syncthreads();

      // two-level sum: this chunk on its own, then into the total
      float part[kRowsPerWarp][kLagsPerLane];
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k)
#pragma unroll
        for (int j = 0; j < kLagsPerLane; ++j) part[k][j] = 0.f;
      const int fmax = min(kFChunk, F - fb);
      for (int ff = 0; ff < fmax; ++ff) {
        float2 cs[kLagsPerLane];
#pragma unroll
        for (int j = 0; j < kLagsPerLane; ++j) cs[j] = syn[ff * kLagBlock + lane + 32 * j];
#pragma unroll
        for (int k = 0; k < kRowsPerWarp; ++k) {
          const float2 x = xp[(warp * kRowsPerWarp + k) * kFChunk + ff];
#pragma unroll
          for (int j = 0; j < kLagsPerLane; ++j)
            part[k][j] = fmaf(x.x, cs[j].x, fmaf(x.y, cs[j].y, part[k][j]));
        }
      }
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k)
#pragma unroll
        for (int j = 0; j < kLagsPerLane; ++j) acc[k][j] += part[k][j];
      __syncthreads();
    }

#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      float* rb = rowbuf + (size_t)(warp * kRowsPerWarp + k) * L;
#pragma unroll
      for (int j = 0; j < kLagsPerLane; ++j) {
        const int l = l0 + lane + 32 * j;
        if (l < L) rb[l] = acc[k][j];
      }
    }
  }
  __syncwarp();

  // ---- output and peaks: each warp on the rows it synthesised ------------
  const int K = (L - 1) / 2;
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int p = p0 + warp * kRowsPerWarp + k;
    if (p >= P) break;
    const size_t grow = (size_t)b * P + p;
    const float* c = rowbuf + (size_t)(warp * kRowsPerWarp + k) * L;
    float* out = corr_out + grow * L;
    if (!with_peaks) {
      for (int l = lane; l < L; l += 32) out[l] = c[l];
      continue;
    }
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

    for (int l = lane; l < L; l += 32) {
      const float d = (float)(l - idx);
      out[l] = taper ? c[l] * expf(-(d * d) / taper_denom) : c[l];
    }
    if (lane == 0) {
      shift_out[grow] = idx - K;
      tdoa_out[grow] = (float)(idx - K) + delta;
      peak_out[grow] = v0;
      psr_out[grow] = fabsf(v0) / fmaxf(fabsf(side), 1e-20f);
    }
  }
}

}  // namespace

// Whether the kernel takes L lags: a block's 64 raw rows must fit its
// shared memory.
extern "C" int att_gcc_large_fits(int l) {
  return l >= 1 && smem_bytes(l) <= kMaxSmem;
}

extern "C" int att_gcc_large(const void* re, const void* im, const void* pairs,
                             const void* sync, const void* syns, void* corr_out,
                             void* shift_out, void* tdoa_out, void* peak_out,
                             void* psr_out, int B, int M, int F, int P, int L,
                             int bf16, int with_peaks, int taper,
                             float taper_denom, void* stream) {
  if (B < 1 || P < 1 || F < 1 || !att_gcc_large_fits(L))
    return (int)cudaErrorInvalidValue;
  const int tiles = (P + kTileP - 1) / kTileP;
  if ((long long)B * tiles > 0x7fffffffLL || (long long)M * F > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(
      gcc_large_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gcc_large_kernel<<<B * tiles, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)re, (const float*)im, (const int*)pairs, (const float*)sync,
      (const float*)syns, (float*)corr_out, (int*)shift_out, (float*)tdoa_out,
      (float*)peak_out, (float*)psr_out, M, F, P, L, tiles, bf16, with_peaks,
      taper, taper_denom);
  return (int)cudaGetLastError();
}
