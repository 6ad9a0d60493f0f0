// Fused GCC(-PHAT) for a batch of raw frames, in one pass per block of frames.
//
// Replaces audio_triangulation_tpu/ops/pallas/gcc_kernel.py::_gcc_kernel in
// its base mode (rows 1 and 2 of the port's kernel table: with and without
// the in-kernel peak stage).  Per frame [M, N]:
//
//   mean removal, x (window * gain)            -> samples staged in shared memory
//   Re/Im DFT against the host-built cos / -sin matrices (interleaved
//   [N, Fp/2] float4 of two bins), fp32 FMA, summed in two levels
//   PHAT: per mic (M >= 3) or per pair (M = 2), rsqrt(re^2 + im^2 + eps^2)
//   per-pair cross-power, lag synthesis against sync / syns [F, L]
//   optional peaks: first-max argmax, parabolic sub-sample (interior peaks,
//   |den| > 1e-20, delta clipped to +-0.5), PSR (guard 3, floor 1e-20) on the
//   raw correlogram, then the Gaussian taper exp(-d^2 / taper_denom)
//
// What bounds it on an H100: the DFT is N*F*M*2 multiply-adds per frame
// (8.4 MFLOP at N = 1024, F = 513, M = 4), all in fp32 on the CUDA cores;
// TF32 tensor cores keep about three digits, which PHAT whitening would
// amplify on weak bins.  So the issue rate of fp32 FMAs is the bound, and
// the design keeps loads off that path: a block holds up to 16
// (frame, mic) rows, each thread owns 4 rows x 2 bins, so two 16-byte
// shared-memory loads (coefficients staged once per block, samples) feed
// 16 FMAs; the next chunk's global loads are issued into registers before
// the current chunk is computed, hiding their latency.  The spectra and
// cross-power never leave shared memory; only the frames (16 KB per 4-mic
// frame) come in and the correlograms go out.  The DFT sums each 16-sample chunk
// before adding it to the total, which keeps it within 2e-5 of a float64
// evaluation where one 1,024-term fp32 sum (cuBLAS) drifts to 1.4e-4.
//
// Dropped from the TPU kernel, because they existed for Mosaic or the MXU:
// the Nyquist fold (all F = L/2 + 1 bins are carried), the 128-lane padding
// of the lag axis, the one-hot neighbour sums (direct indexing here) and
// sub-tile emission order.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// DFT: a pass covers kDftRows (frame, mic) rows x kBinsPerPass bins; each
// thread owns kRowsPerThread rows x 2 bins
constexpr int kRowsPerThread = 4;
constexpr int kRowGroups = 4;
constexpr int kDftRows = kRowGroups * kRowsPerThread;
constexpr int kBinLanes = kThreads / kRowGroups;
constexpr int kBinsPerPass = 2 * kBinLanes;
constexpr int kNChunk = 16;       // samples staged per DFT step
constexpr int kXsStride = kDftRows + 4;  // staged sample row, padded (floats)
constexpr int kWPerThread = kNChunk * kBinLanes / kThreads;  // staged float4s
static_assert(kDftRows * kNChunk == kThreads, "one staged sample per thread");
static_assert(kNChunk * kBinLanes % kThreads == 0, "whole float4s per thread");
constexpr int kFChunk = 16;       // synthesis-matrix bins staged per step
constexpr int kLagBlock = 128;    // lags per synthesis block
constexpr int kLagsPerLane = kLagBlock / 32;
constexpr int kRowsPerWarp = 4;   // (frame, pair) rows a warp synthesises together
constexpr int kRowsPerPass = kWarps * kRowsPerWarp;
constexpr size_t kMaxSmem = 227 * 1024;

// Floats of dynamic shared memory for tb frames per block, in layout order
// (16-byte and 8-byte aligned regions first).
size_t smem_floats(int tb, int m, int f, int l) {
  const size_t rows = (size_t)tb * m;
  return (size_t)kNChunk * kXsStride           // staged samples [n][row]
         + 4 * (size_t)kNChunk * kBinLanes     // staged coefficients [n][pair]
         + 2 * (size_t)kFChunk * kLagBlock     // staged synthesis (cos, sin)
         + 2 * rows * f                        // spectra (re, im)
         + rows                                // per-row mean
         + (size_t)kRowsPerPass * l;           // raw correlogram rows of a pass
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float4 fma4(float a, float4 c, float4 acc) {
  return make_float4(fmaf(a, c.x, acc.x), fmaf(a, c.y, acc.y),
                     fmaf(a, c.z, acc.z), fmaf(a, c.w, acc.w));
}

__global__ void __launch_bounds__(kThreads)
gcc_kernel(const float* __restrict__ frames,   // [B, M, N]
           const float* __restrict__ win,      // [N] window * gain
           const float4* __restrict__ w,       // [N, Fp / 2] (cos, -sin) of 2 bins
           const float* __restrict__ sync,     // [F, L]
           const float* __restrict__ syns,     // [F, L]
           const int* __restrict__ pairs,      // [P, 2]
           float* __restrict__ corr_out,       // [B, P, L]
           int* __restrict__ shift_out,        // [B, P] (peaks only)
           float* __restrict__ tdoa_out,
           float* __restrict__ peak_out,
           float* __restrict__ psr_out,
           int B, int M, int N, int F, int Fp, int P, int L, int TB,
           int phat, int per_mic, float eps2, float taper_denom, int with_peaks) {
  extern __shared__ float4 smem4[];
  const int b0 = blockIdx.x * TB;
  const int tb = min(TB, B - b0);
  const int R = tb * M;    // (frame, mic) rows of this block
  const int RP = tb * P;   // (frame, pair) rows of this block
  const size_t rows_max = (size_t)TB * M;
  float* xs = reinterpret_cast<float*>(smem4);
  float4* ws = smem4 + kNChunk * kXsStride / 4;
  float2* syn = reinterpret_cast<float2*>(ws + kNChunk * kBinLanes);
  float2* spec = syn + kFChunk * kLagBlock;
  float* mean = reinterpret_cast<float*>(spec + rows_max * F);
  float* rowbuf = mean + rows_max;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* x0 = frames + (size_t)b0 * M * N;

  // ---- 1. per-row mean -------------------------------------------------
  for (int r = warp; r < R; r += kWarps) {
    const float* xr = x0 + (size_t)r * N;
    float s = 0.f;
    for (int n = lane; n < N; n += 32) s += xr[n];
    s = warp_sum(s);
    if (lane == 0) mean[r] = s / (float)N;
  }
  __syncthreads();

  // ---- 2. DFT ----------------------------------------------------------
  const int rg = tid / kBinLanes;   // this thread's row group
  const int bl = tid % kBinLanes;   // and bin pair
  const size_t wstride = (size_t)Fp / 2;
  for (int r0 = 0; r0 < R; r0 += kDftRows) {
    for (int f0 = 0; f0 < F; f0 += kBinsPerPass) {
      const int f = f0 + 2 * bl;    // bins f and f + 1
      // per row: (re f, im f, re f+1, im f+1)
      float4 acc[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      // the next chunk's samples and coefficients are loaded into registers
      // before the current chunk is computed, so their latency overlaps it
      float xr, wv;
      float4 wr[kWPerThread];
      auto fetch = [&](int n0) {
        const int r = tid / kNChunk, n = n0 + tid % kNChunk;
        const bool ok = r0 + r < R && n < N;
        xr = ok ? x0[(size_t)(r0 + r) * N + n] : 0.f;
        wv = ok ? win[n] : 0.f;
#pragma unroll
        for (int i = 0; i < kWPerThread; ++i) {
          const int e = tid + i * kThreads;
          const int nn = n0 + e / kBinLanes, fe = f0 + 2 * (e % kBinLanes);
          wr[i] = (nn < N && fe < Fp) ? __ldg(w + (size_t)nn * wstride + fe / 2)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      };
      fetch(0);
      for (int n0 = 0; n0 < N; n0 += kNChunk) {
        {
          const int r = tid / kNChunk;
          xs[(tid % kNChunk) * kXsStride + r] =
              r0 + r < R ? (xr - mean[r0 + r]) * wv : 0.f;
#pragma unroll
          for (int i = 0; i < kWPerThread; ++i) ws[tid + i * kThreads] = wr[i];
        }
        __syncthreads();
        if (n0 + kNChunk < N) fetch(n0 + kNChunk);
        if (f < F) {
          // two-level sum: a partial over this chunk, then into the total,
          // so rounding grows with N / kNChunk + kNChunk terms, not N
          float4 part[kRowsPerThread];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) part[r] = make_float4(0.f, 0.f, 0.f, 0.f);
          const int nmax = min(kNChunk, N - n0);
          for (int nn = 0; nn < nmax; ++nn) {
            const float4 c = ws[nn * kBinLanes + bl];
            const float4 xv = *reinterpret_cast<const float4*>(
                xs + nn * kXsStride + rg * kRowsPerThread);
            part[0] = fma4(xv.x, c, part[0]);
            part[1] = fma4(xv.y, c, part[1]);
            part[2] = fma4(xv.z, c, part[2]);
            part[3] = fma4(xv.w, c, part[3]);
          }
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) {
            acc[r].x += part[r].x;
            acc[r].y += part[r].y;
            acc[r].z += part[r].z;
            acc[r].w += part[r].w;
          }
        }
        __syncthreads();
      }
      if (f < F) {
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const int row = r0 + rg * kRowsPerThread + r;
          if (row >= R) continue;
          float re0 = acc[r].x, im0 = acc[r].y, re1 = acc[r].z, im1 = acc[r].w;
          if (per_mic) {
            const float inv0 = rsqrtf(re0 * re0 + im0 * im0 + eps2);
            const float inv1 = rsqrtf(re1 * re1 + im1 * im1 + eps2);
            re0 *= inv0; im0 *= inv0; re1 *= inv1; im1 *= inv1;
          }
          spec[(size_t)row * F + f] = make_float2(re0, im0);
          if (f + 1 < F) spec[(size_t)row * F + f + 1] = make_float2(re1, im1);
        }
      }
    }
  }
  __syncthreads();

  // ---- 3. cross-power + lag synthesis, then 4. peaks -------------------
  const int K = (L - 1) / 2;
  for (int q0 = 0; q0 < RP; q0 += kRowsPerPass) {
    size_t off_i[kRowsPerWarp], off_j[kRowsPerWarp];
    bool live[kRowsPerWarp];
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const int row = q0 + warp * kRowsPerWarp + k;
      live[k] = row < RP;
      const int t = live[k] ? row / P : 0, p = live[k] ? row % P : 0;
      off_i[k] = ((size_t)t * M + __ldg(pairs + 2 * p)) * F;   // spectra rows
      off_j[k] = ((size_t)t * M + __ldg(pairs + 2 * p + 1)) * F;
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
          syn[e] = ok ? make_float2(sync[(size_t)f * L + l], syns[(size_t)f * L + l])
                      : make_float2(0.f, 0.f);
        }
        __syncthreads();
        const int fmax = min(kFChunk, F - fb);
        for (int ff = 0; ff < fmax; ++ff) {
          const int f = fb + ff;
          float2 cs[kLagsPerLane];
#pragma unroll
          for (int j = 0; j < kLagsPerLane; ++j) cs[j] = syn[ff * kLagBlock + lane + 32 * j];
#pragma unroll
          for (int k = 0; k < kRowsPerWarp; ++k) {
            if (!live[k]) continue;
            const float2 a = spec[off_i[k] + f], b = spec[off_j[k] + f];
            float rr = a.x * b.x + a.y * b.y;
            float jj = a.x * b.y - a.y * b.x;
            if (phat && !per_mic) {
              const float inv = rsqrtf(rr * rr + jj * jj + eps2);
              rr *= inv;
              jj *= inv;
            }
#pragma unroll
            for (int j = 0; j < kLagsPerLane; ++j)
              acc[k][j] = fmaf(rr, cs[j].x, fmaf(jj, cs[j].y, acc[k][j]));
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int k = 0; k < kRowsPerWarp; ++k) {
        if (!live[k]) continue;
        float* rb = rowbuf + (size_t)(warp * kRowsPerWarp + k) * L;
#pragma unroll
        for (int j = 0; j < kLagsPerLane; ++j) {
          const int l = l0 + lane + 32 * j;
          if (l < L) rb[l] = acc[k][j];
        }
      }
    }
    __syncwarp();

    for (int k = 0; k < kRowsPerWarp; ++k) {
      if (!live[k]) continue;
      const int row = q0 + warp * kRowsPerWarp + k;
      const size_t grow = (size_t)b0 * P + row;   // global (frame, pair) row
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
        out[l] = c[l] * expf(-(d * d) / taper_denom);
      }
      if (lane == 0) {
        shift_out[grow] = idx - K;
        tdoa_out[grow] = (float)(idx - K) + delta;
        peak_out[grow] = v0;
        psr_out[grow] = fabsf(v0) / fmaxf(fabsf(side), 1e-20f);
      }
    }
    __syncwarp();
  }
}

}  // namespace

// Frames per block: up to kDftRows (frame, mic) rows, fewer when the
// spectra would not fit shared memory.  Returns 0 when one frame does not fit.
extern "C" int att_gcc_frames_per_block(int m, int f, int l) {
  int tb = m >= kDftRows ? 1 : kDftRows / m;
  while (tb > 0 && smem_floats(tb, m, f, l) * sizeof(float) > kMaxSmem) --tb;
  return tb;
}

extern "C" int att_gcc(const void* frames, const void* win, const void* w,
                       const void* sync, const void* syns, const void* pairs,
                       void* corr_out, void* shift_out, void* tdoa_out,
                       void* peak_out, void* psr_out, int B, int M, int N,
                       int F, int Fp, int P, int L, int phat, int per_mic,
                       float eps, float taper_denom, int with_peaks,
                       void* stream) {
  const int tb = att_gcc_frames_per_block(M, F, L);
  if (tb < 1 || Fp % 2 != 0 || Fp < F) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(tb, M, F, L) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gcc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + tb - 1) / tb;
  gcc_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)frames, (const float*)win, (const float4*)w,
      (const float*)sync, (const float*)syns, (const int*)pairs,
      (float*)corr_out, (int*)shift_out, (float*)tdoa_out, (float*)peak_out,
      (float*)psr_out, B, M, N, F, Fp, P, L, tb, phat, per_mic, eps * eps,
      taper_denom, with_peaks);
  return (int)cudaGetLastError();
}
