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
// What bounds it on an H100: operations.  Every frame is one product
// [P, 2F] x [2F, L] (2,016 x 4,098 x 149: 2.46 GFLOP) against 1 MB of
// spectra in and 1.2 MB of correlograms out, and its left operand does not
// exist in memory: it is formed from the spectra as it is used.  The product
// runs on the tensor cores (wgmma m64n152k8, TF32 operands, fp32 sums) as a
// split-fp32 product: a = a_hi + a_lo and b = b_hi + b_lo, each part a TF32
// value, and every 8 values of K add a_lo b_hi, then a_hi b_lo, then
// a_hi b_hi (what is dropped, a_lo b_lo, is 2^-22 of a product).  In the
// bf16 mode rr and jj are bf16 values, which TF32 holds exactly, and the
// matrices' low parts are zero: the a_hi b_hi product alone is issued.
//
// B, the synthesis matrices, is a constant of a configuration, so the
// wrapper splits it once and stores it K-major (ops/cuda/gcc_large.py::
// pack_synthesis: a row a lag, hi rows then lo rows; along K a step of 8 is
// the rr rows of 4 bins, then their jj rows).  One thread copies a chunk's
// two tiles (152 lags x 32 K values each) by TMA into the 128-byte swizzle
// that wgmma reads; the kernel spends no instruction on B.  A comes from
// registers, in the mma fragment of each warp's 16 rows: a thread forms the
// cross-power of its two rows at one bin (two 8-byte shared loads a row
// from the staged spectra of all M mics; the spectra's rows are no multiple
// of 16 bytes, so they are staged by 4-byte cp.async, not TMA) and splits
// the four values, which then serve all 152 lags of three products.  A
// warpgroup owns 64 rows x 152 lags (76 accumulators a thread).
//
// Every block streams the whole of B from L2 (5.0 MB split, full band), so
// a block is three warpgroups, 192 (pair) rows of one frame: 11 tiles x 256
// frames = 2,816 blocks read 14.1 TB from L2 over a call, 2.1 TB/s at the
// time the call takes; 64 rows a block would read three times that.  B and
// the spectra are staged 16 bins at a time in two stages (48 KB each at 64
// mics); what limits the tile is shared memory, which also holds the
// block's raw rows for the peak stage (192 x 152 floats).  The tensor cores
// add in fp32 with truncation, and K is 4,098, so the accumulators are
// added into those rows (fp32, round to nearest) every 64 steps and
// cleared: the long sum is 9 rounded adds of 192-product partial sums
// (4.2e-06 of scale from float64).  Beyond 152 lags the kernel walks K
// again for each further block of lags; when 192 raw rows do not fit it
// takes 64 rows a block (one warpgroup), up to 456 lags.
//
// What is left (6.6 ms a 256-frame full-band call against 3.9): the block
// waits for a chunk, multiplies and waits for the products, all three
// warpgroups in step, so the tensor cores drain at every chunk; a step's A
// fragments are formed while the steps before it multiply (7.2 ms with all
// four steps formed first).  A third stage, which would let the products of
// one chunk run into the next, does not fit beside the raw rows at 192 rows
// a block.  The same product through mma.sync (12 warps of 32 rows x 80
// lags, B in fragment order through shared memory) took 12.9 ms, bound by
// the shared memory its B fragments cross, and 20.8 ms when its
// accumulators spilled.
//
// Dropped from the TPU kernel: the one-hot mic-selection matmuls (mics are
// indexed directly), the padding of lags to 128 and of pairs to a chunk,
// the batch tile, and the packed 128-lane aux output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kNT = 19;                  // lag tiles (of 8) per lag block
constexpr int kLagBlock = 8 * kNT;       // the wgmma's N: 152 lags
constexpr int kChunkBins = 16;           // bins staged per step: 4 wgmma steps of K = 8
constexpr int kStepsPerChunk = kChunkBins / 4;
constexpr int kSpecStride = kChunkBins + 4;   // staged spectrum row (float2), padded
constexpr int kFlushChunks = 16;         // accumulators flushed every 64 steps
constexpr int kBTileBytes = kLagBlock * 128;  // a part's B tile: 152 rows of 32 K values
static_assert(kBTileBytes % 1024 == 0, "swizzled tiles start on 1,024-byte boundaries");
constexpr size_t kMaxSmem = 227 * 1024;

// a block of wg warpgroups takes 64 wg rows
__host__ __device__ constexpr int rows_per_block(int wg) { return 64 * wg; }

__host__ __device__ inline int lag_blocks(int l) { return (l + kLagBlock - 1) / kLagBlock; }

// B's two tiles (hi, lo), then the chunk's bins of every mic's spectrum,
// rounded up so that the next stage's tiles are aligned too
__host__ __device__ inline size_t stage_bytes(int m) {
  return (2 * (size_t)kBTileBytes + (size_t)m * kSpecStride * sizeof(float2) + 1023) / 1024 * 1024;
}

size_t smem_bytes(int m, int l, int wg) {
  return 1024 /* alignment */ + 2 * stage_bytes(m) + 64 /* barriers */ +
         sizeof(float) * (size_t)rows_per_block(wg) * lag_blocks(l) * kLagBlock;
}

// warpgroups of a block: 3 (192 rows) when its raw rows fit shared memory
// beside the stages, else 1 (64 rows), else 0
int warpgroups(int m, int l) {
  if (l < 1 || m < 1) return 0;
  for (int wg = 3; wg >= 1; wg -= 2)
    if (smem_bytes(m, l, wg) <= kMaxSmem) return wg;
  return 0;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int kWGs, bool kBf16>
__global__ void __launch_bounds__(128 * kWGs, 1)
gcc_large_kernel(const float* __restrict__ re,     // [B, M, F]
                 const float* __restrict__ im,     // [B, M, F]
                 const int* __restrict__ pairs,    // [P, 2]
                 const __grid_constant__ CUtensorMap map_b,   // [2 LB 152, K2] hi rows, lo rows
                 float* __restrict__ corr_out,     // [B, P, L]
                 int* __restrict__ shift_out,      // [B, P] (peaks only)
                 float* __restrict__ tdoa_out,
                 float* __restrict__ peak_out,
                 float* __restrict__ psr_out,
                 int M, int F, int P, int L, int tiles, int with_peaks, int taper,
                 float taper_denom) {
  constexpr int kRows = rows_per_block(kWGs);
  constexpr int kThreads = 128 * kWGs;
  extern __shared__ unsigned char smem_unaligned[];
  unsigned char* smem_raw = reinterpret_cast<unsigned char*>(
      ((uintptr_t)smem_unaligned + 1023) & ~(uintptr_t)1023);
  const int n_lb = lag_blocks(L);
  const int Lp = n_lb * kLagBlock;               // row of the raw-row buffer
  const size_t stage_sz = stage_bytes(M);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + 2 * stage_sz);   // [2]
  float* rowbuf = reinterpret_cast<float*>(smem_raw + 2 * stage_sz + 64);  // [kRows][Lp]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g_ = lane >> 2, t_ = lane & 3;   // the fragment's row and column index
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x % tiles) * kRows;
  const float* re_b = re + (size_t)b * M * F;
  const float* im_b = im + (size_t)b * M * F;
  const int n_chunks = (F + kChunkBins - 1) / kChunkBins;

  if (tid == 0) {
    hopper::mbar_init(full, 1);
    hopper::mbar_init(full + 1, 1);
    hopper::mbar_init_fence();
  }

  // staged-spectrum offsets (float2 units) of the mics of this thread's
  // fragment rows g and g + 8 of its warp's 16; rows past P repeat the last pair
  int off_i[2], off_j[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = min(p0 + warp * 16 + h * 8 + g_, P - 1);
    off_i[h] = __ldg(pairs + 2 * p) * kSpecStride + t_;
    off_j[h] = __ldg(pairs + 2 * p + 1) * kSpecStride + t_;
  }
  __syncthreads();

  // stage chunk c of lag block lb: B's hi and lo tiles by TMA (one thread),
  // the chunk's bins of every mic's spectrum by cp.async, zero past F
  auto issue = [&](int lb, int c, int stage) {
    unsigned char* base = smem_raw + stage * stage_sz;
    if (tid == 0) {
      hopper::mbar_expect_tx(full + stage, 2 * kBTileBytes);
      hopper::tma_load_2d(base, &map_b, full + stage, c * 2 * kChunkBins, lb * kLagBlock);
      hopper::tma_load_2d(base + kBTileBytes, &map_b, full + stage, c * 2 * kChunkBins,
                          (n_lb + lb) * kLagBlock);
    }
    float* sp = reinterpret_cast<float*>(base + 2 * kBTileBytes);
    for (int e = tid; e < M * kChunkBins; e += kThreads) {
      const int m = e / kChunkBins, fo = e % kChunkBins;
      const int f = c * kChunkBins + fo;
      const bool ok = f < F;
      const size_t at = ok ? (size_t)m * F + f : 0;
      float* dst = sp + 2 * (m * kSpecStride + fo);
      hopper::cp_async4(dst, re_b + at, ok);
      hopper::cp_async4(dst + 1, im_b + at, ok);
    }
  };

  float acc[4 * kNT];
  auto clear = [&]() {
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) acc[i] = 0.f;
  };

  // the warpgroup's 64 rows x 32 K values x 152 lags: A from registers (each
  // thread forms the cross-power of its two rows at bin 4 q + t and splits
  // it), three products a step, small terms first
  auto compute = [&](int stage) {
    const unsigned char* base = smem_raw + stage * stage_sz;
    const float2* sp = reinterpret_cast<const float2*>(base + 2 * kBTileBytes);
    const uint64_t b_hi = hopper::wgmma_desc_k128(base);
    const uint64_t b_lo = hopper::wgmma_desc_k128(base + kBTileBytes);
    // A step's fragments are formed while the steps before it multiply:
    // each step has registers of its own, which its products read until the
    // wait below.
    uint32_t ah[kStepsPerChunk][4], al[kStepsPerChunk][4];
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) hopper::keep(acc[i]);
#pragma unroll
    for (int q = 0; q < kStepsPerChunk; ++q) {   // 32 bytes of K a product
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 xi = sp[off_i[h] + 4 * q], xj = sp[off_j[h] + 4 * q];
        float rr = xi.x * xj.x + xi.y * xj.y;
        float jj = xi.x * xj.y - xi.y * xj.x;
        if constexpr (kBf16) {
          ah[q][h] = __float_as_uint(round_bf16(rr));       // exact in TF32
          ah[q][2 + h] = __float_as_uint(round_bf16(jj));
        } else {
          hopper::tf32_split(rr, ah[q][h], al[q][h]);
          hopper::tf32_split(jj, ah[q][2 + h], al[q][2 + h]);
        }
      }
      hopper::wgmma_fence();   // the fragments just written, before their products
      if constexpr (!kBf16) {
        hopper::wgmma_m64n152_tf32(acc, al[q], b_hi + 2 * q);
        hopper::wgmma_m64n152_tf32(acc, ah[q], b_lo + 2 * q);
      }
      hopper::wgmma_m64n152_tf32(acc, ah[q], b_hi + 2 * q);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
#pragma unroll
    for (int i = 0; i < 4 * kNT; ++i) hopper::keep(acc[i]);
  };

  // the accumulators into this thread's own places of the raw rows (stored
  // the first time, added from then on), then cleared: fragment rows g and
  // g + 8 of the warp's 16, lags 8 j + 2 t and + 1
  auto flush = [&](int lb, bool first) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* rb = rowbuf + (size_t)(warp * 16 + h * 8 + g_) * Lp + lb * kLagBlock + 2 * t_;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        float2* at = reinterpret_cast<float2*>(rb + 8 * j);
        float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        if (!first) {
          const float2 o = *at;
          v.x += o.x;
          v.y += o.y;
        }
        *at = v;
      }
    }
    clear();
  };

  int landed = 0;   // chunks waited for: stage landed % 2, phase landed / 2 % 2
  for (int lb = 0; lb < n_lb; ++lb) {
    clear();
    issue(lb, 0, landed & 1);
    hopper::cp_async_commit();
    bool first = true;
    for (int c = 0; c < n_chunks; ++c, ++landed) {
      hopper::cp_async_wait<0>();
      // a copy that never lands is a fault of the tensor map or the card:
      // stop the kernel with an error where waiting on would hang it
      if (!hopper::mbar_wait_bounded(full + (landed & 1), (landed >> 1) & 1)) __trap();
      __syncthreads();   // chunk c has landed; chunk c - 1's stage is free
      if (c + 1 < n_chunks) issue(lb, c + 1, (landed + 1) & 1);
      hopper::cp_async_commit();
      compute(landed & 1);
      if ((c + 1) % kFlushChunks == 0 || c + 1 == n_chunks) {
        flush(lb, first);
        first = false;
      }
    }
    __syncthreads();   // every warp has left the last stage; its rows are whole
  }

  // ---- output and peaks: 16 of the block's rows a warp ---------------------
  const int K = (L - 1) / 2;
  for (int k = 0; k < 16; ++k) {
    const int p = p0 + warp * 16 + k;
    if (p >= P) break;
    const size_t grow = (size_t)b * P + p;
    const float* c = rowbuf + (size_t)(warp * 16 + k) * Lp;
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

template <int kWGs, bool kBf16>
int launch(const void* re, const void* im, const void* pairs, const CUtensorMap& map_b,
           void* corr_out, void* shift_out, void* tdoa_out, void* peak_out,
           void* psr_out, int B, int M, int F, int P, int L, int with_peaks,
           int taper, float taper_denom, cudaStream_t stream) {
  constexpr int kRows = rows_per_block(kWGs);
  const int tiles = (P + kRows - 1) / kRows;
  if ((long long)B * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(M, L, kWGs);
  auto kernel = gcc_large_kernel<kWGs, kBf16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * tiles, 128 * kWGs, smem, stream>>>(
      (const float*)re, (const float*)im, (const int*)pairs, map_b,
      (float*)corr_out, (int*)shift_out, (float*)tdoa_out, (float*)peak_out,
      (float*)psr_out, M, F, P, L, tiles, with_peaks, taper, taper_denom);
  return (int)cudaGetLastError();
}

}  // namespace

// Whether the kernel takes M mics and L lags: the staged spectra of all mics
// and a block's raw rows (64 at least) must fit its shared memory.
extern "C" int att_gcc_large_fits(int m, int l) { return warpgroups(m, l) > 0; }

// syn: the synthesis matrices split and packed K-major by the wrapper
// (pack_synthesis: [2, lag blocks x 152, K] f32: the hi parts' rows, then the
// lo parts'; K = 2 x F padded to whole chunks, a step of 8 being the cos rows
// of 4 bins, then their sin rows), 16-byte aligned.  Returns a cudaError_t,
// or -1 when the TMA tensor map could not be encoded.
extern "C" int att_gcc_large(const void* re, const void* im, const void* pairs,
                             const void* syn, void* corr_out, void* shift_out,
                             void* tdoa_out, void* peak_out, void* psr_out, int B,
                             int M, int F, int P, int L, int bf16, int with_peaks,
                             int taper, float taper_denom, void* stream) {
  const int wg = warpgroups(M, L);
  if (B < 1 || P < 1 || F < 1 || wg < 1 || ((uintptr_t)syn & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)M * F > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int k2 = (F + kChunkBins - 1) / kChunkBins * kChunkBins * 2;
  CUtensorMap map_b;
  if (!hopper::make_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, syn,
                        2 * lag_blocks(L) * kLagBlock, k2, kLagBlock))
    return hopper::kErrTensorMap;
  const cudaStream_t st = (cudaStream_t)stream;
#define ATT_LARGE(WG, BF)                                                           \
  launch<WG, BF>(re, im, pairs, map_b, corr_out, shift_out, tdoa_out, peak_out,     \
                 psr_out, B, M, F, P, L, with_peaks, taper, taper_denom, st)
  if (wg == 3) return bf16 ? ATT_LARGE(3, true) : ATT_LARGE(3, false);
  return bf16 ? ATT_LARGE(1, true) : ATT_LARGE(1, false);
#undef ATT_LARGE
}
