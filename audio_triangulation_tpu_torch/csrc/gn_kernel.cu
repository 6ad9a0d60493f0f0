// Batched damped Gauss-Newton TDOA solve and its position covariance, one
// thread per frame, one launch for the Localizer's whole solver tail.
//
// Replaces audio_triangulation_tpu/ops/pallas/gn_kernel.py::_gn_kernel (row 5
// of the port's kernel table), with its formulas: the source on the
// radius-h sphere around the array center (or the z = h plane), mics at
// z = 0, the analytic Jacobian of the lift, the damped 2x2 normal equations
// solved in closed form with the |det| > 1e-20 guard, then the residual rms.
// The epilogue adds what the reference computes after the kernel,
// ops/solver.py::solution_covariance: sigma^2 (J^T J + damping I)^-1 at the
// solution with sigma^2 = max(rms, 1e-4)^2 P / max(P - 2, 1) and the
// determinant floored at 1e-20.  That function forms J^T J as gd^T Q gd with
// Q = S^T S the pair-selection product; summed pair by pair it is
// sum_p (g_j - g_i)(g_j - g_i)^T, which the final pass here walks anyway.
//
// What bounds it on an H100: not bytes (P + 2 floats in, 7 out a frame) and
// not operations (under 2 kFLOP a frame at 6 pairs), but the latency of
// each frame's serial chain: per iteration the lift (a square root and a
// reciprocal), then each mic's distance (a square root and a reciprocal),
// then the pair sums, then one reciprocal for the 2x2 solve.  The design:
//  - each mic's distance and its two gradient terms once per iteration,
//    held in registers (the array size M is a template parameter, so the
//    pair loop indexes registers); a pair is a difference of two mics'
//    terms.  The M square roots and reciprocals are independent, so they
//    overlap in the special-function pipe;
//  - the pairs are the array's canonical list (i < j in order,
//    geometry.mic_pairs), walked by two unrolled loops: no pair table;
//  - 64-thread blocks, so the main path's 16,384 frames make 256 blocks
//    and every one of the 132 SMs has work (at 256 threads a block, 64
//    blocks left half the card idle).  A few lanes a frame (one a mic) was
//    the other option; at 4 mics each thread already has four independent
//    square roots in flight, and the lanes would put five shuffle
//    reductions on every iteration's chain;
//  - mic coordinates and the solver's constants travel in the launch's
//    parameter block, copied from host memory by the launch itself: no
//    device table, no copy or cast kernel a call.
// Sums run over pairs in the reference's order (i < j), and every multiply
// and add rounds on its own, as gn_reference's tensor ops (the plain
// version in the wrapper) do: on the card its xy is bit-equal to the
// kernel's, its rms within an ulp (torch divides a tensor by a scalar
// through the scalar's reciprocal) and so its cov where sigma is above the
// floor.  The unfused operations lengthen each
// iteration's chain a little; at a few microseconds a call the launch, not
// the chain, is what a caller waits for.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxMics = 11;  // 55 pairs; 12 mics would make 66 > 64

struct GnParams {
  float mx[kMaxMics], my[kMaxMics];
  float c, h, hh, damping;
  int iters, sphere;
};

struct Lift {
  float sx, sy, sz;                    // source point
  float j11, j21, j31, j12, j22, j32;  // d(source) / d(x, y)
};

// Every operation rounds on its own, as the plain version's tensor ops do
// (nvcc would fuse a multiply and an add into one FMA, which rounds once):
// the kernel computes gn_reference's arithmetic bit for bit.
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float rcp(float a) { return __fdiv_rn(1.f, a); }

__device__ __forceinline__ Lift lift(float x, float y, const GnParams& q) {
  Lift o;
  if (q.sphere) {
    const float h = q.h;
    const float nv = __fsqrt_rn(add(add(mul(x, x), mul(y, y)), q.hh));
    const float inv = rcp(nv);
    const float s = mul(h, inv);
    o.sx = mul(x, s);
    o.sy = mul(y, s);
    o.sz = mul(h, s);
    const float vx = mul(x, inv), vy = mul(y, inv), vz = mul(h, inv);
    o.j11 = mul(s, sub(1.f, mul(vx, vx)));
    o.j21 = mul(s, mul(-vy, vx));
    o.j31 = mul(s, mul(-vz, vx));
    o.j12 = mul(s, mul(-vx, vy));
    o.j22 = mul(s, sub(1.f, mul(vy, vy)));
    o.j32 = mul(s, mul(-vz, vy));
  } else {
    o.sx = x;
    o.sy = y;
    o.sz = q.h;
    o.j11 = 1.f; o.j21 = 0.f; o.j31 = 0.f;
    o.j12 = 0.f; o.j22 = 1.f; o.j32 = 0.f;
  }
  return o;
}

// Each mic's distance from the lifted source and its gradient in (x, y).
template <int M>
__device__ __forceinline__ void mic_terms(const Lift& s, const GnParams& q,
                                          float (&d)[M], float (&g1)[M],
                                          float (&g2)[M]) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float dx = sub(s.sx, q.mx[m]), dy = sub(s.sy, q.my[m]);
    const float dz = s.sz;
    d[m] = __fsqrt_rn(add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz)));
    const float ud = rcp(d[m]);
    const float ux = mul(dx, ud), uy = mul(dy, ud), uz = mul(dz, ud);
    g1[m] = add(add(mul(ux, s.j11), mul(uy, s.j21)), mul(uz, s.j31));
    g2[m] = add(add(mul(ux, s.j12), mul(uy, s.j22)), mul(uz, s.j32));
  }
}

// The normal equations' sums over the canonical pairs (i < j): residual
// r = d_j - d_i - target, Jacobian row (g1_j - g1_i, g2_j - g2_i).
struct Sums {
  float a00, a11, a01, b0, b1, ss;
};

template <int M>
__device__ __forceinline__ Sums pair_sums(const float (&d)[M],
                                          const float (&g1)[M],
                                          const float (&g2)[M],
                                          const float* target) {
  Sums o = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int p = 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = i + 1; j < M; ++j, ++p) {
      const float r = sub(sub(d[j], d[i]), target[p]);
      const float ja = sub(g1[j], g1[i]), jb = sub(g2[j], g2[i]);
      o.a00 = add(o.a00, mul(ja, ja));
      o.a11 = add(o.a11, mul(jb, jb));
      o.a01 = add(o.a01, mul(ja, jb));
      o.b0 = add(o.b0, mul(ja, r));
      o.b1 = add(o.b1, mul(jb, r));
      o.ss = add(o.ss, mul(r, r));
    }
  }
  return o;
}

template <int M>
__global__ void __launch_bounds__(kThreads)
gn_kernel(const float* __restrict__ tau,   // [B, P] seconds
          const float* __restrict__ init,  // [B, 2]
          float* __restrict__ xy_out,      // [B, 2]
          float* __restrict__ rms_out,     // [B]
          float* __restrict__ cov_out,     // [B, 2, 2]
          int B, const GnParams q) {
  constexpr int P = M * (M - 1) / 2;
  constexpr int kDof = P > 2 ? P - 2 : 1;
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  float target[P];
#pragma unroll
  for (int p = 0; p < P; ++p) target[p] = mul(tau[(size_t)b * P + p], q.c);
  const float2 xy0 = reinterpret_cast<const float2*>(init)[b];
  float x = xy0.x, y = xy0.y;
  float d[M], g1[M], g2[M];

  for (int it = 0; it < q.iters; ++it) {
    mic_terms<M>(lift(x, y, q), q, d, g1, g2);
    const Sums s = pair_sums<M>(d, g1, g2, target);
    const float a00 = add(s.a00, q.damping), a11 = add(s.a11, q.damping);
    const float det = sub(mul(a00, a11), mul(s.a01, s.a01));
    const float inv_det = rcp(fabsf(det) > 1e-20f ? det : 1e-20f);
    const float nx = sub(x, mul(sub(mul(a11, s.b0), mul(s.a01, s.b1)),
                                inv_det));
    const float ny = sub(y, mul(sub(mul(a00, s.b1), mul(s.a01, s.b0)),
                                inv_det));
    x = nx;
    y = ny;
  }

  // final pass: residual rms and, from the same Jacobian, the covariance
  mic_terms<M>(lift(x, y, q), q, d, g1, g2);
  const Sums s = pair_sums<M>(d, g1, g2, target);
  const float rms = __fsqrt_rn(__fdiv_rn(s.ss, (float)P));
  // comparisons written so that a NaN passes through, as clamp_min does
  const float sigma = rms < 1e-4f ? 1e-4f : rms;
  const float sigma2 = mul(mul(sigma, sigma),
                           __fdiv_rn((float)P, (float)kDof));
  const float a00 = add(s.a00, q.damping), a11 = add(s.a11, q.damping);
  const float det_raw = sub(mul(a00, a11), mul(s.a01, s.a01));
  const float det = det_raw < 1e-20f ? 1e-20f : det_raw;
  reinterpret_cast<float2*>(xy_out)[b] = make_float2(x, y);
  rms_out[b] = rms;
  const float off = mul(sigma2, __fdiv_rn(-s.a01, det));
  reinterpret_cast<float4*>(cov_out)[b] = make_float4(
      mul(sigma2, __fdiv_rn(a11, det)), off, off,
      mul(sigma2, __fdiv_rn(a00, det)));
}

template <int M>
cudaError_t launch(const float* tau, const float* init, float* xy,
                   float* rms, float* cov, int B, const GnParams& q,
                   cudaStream_t stream) {
  const int grid = (B + kThreads - 1) / kThreads;
  gn_kernel<M><<<grid, kThreads, 0, stream>>>(tau, init, xy, rms, cov, B, q);
  return cudaGetLastError();
}

}  // namespace

// mics: host memory, [M, 2] float32 (x, y); the launch copies them into
// its parameter block.  Pairs are the canonical list of the M mics.
extern "C" int att_gn(const void* tau, const void* init, const float* mics,
                      void* xy_out, void* rms_out, void* cov_out, int B,
                      int M, float c, float h, float hh, int iters,
                      float damping, int sphere, void* stream) {
  if (M < 2 || M > kMaxMics) return (int)cudaErrorInvalidValue;
  GnParams q = {};
  for (int m = 0; m < M; ++m) {
    q.mx[m] = mics[2 * m];
    q.my[m] = mics[2 * m + 1];
  }
  q.c = c;
  q.h = h;
  q.hh = hh;
  q.damping = damping;
  q.iters = iters;
  q.sphere = sphere;
  const float* t = (const float*)tau;
  const float* i0 = (const float*)init;
  float* xy = (float*)xy_out;
  float* r = (float*)rms_out;
  float* cv = (float*)cov_out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (M) {
    case 2: return (int)launch<2>(t, i0, xy, r, cv, B, q, s);
    case 3: return (int)launch<3>(t, i0, xy, r, cv, B, q, s);
    case 4: return (int)launch<4>(t, i0, xy, r, cv, B, q, s);
    case 5: return (int)launch<5>(t, i0, xy, r, cv, B, q, s);
    case 6: return (int)launch<6>(t, i0, xy, r, cv, B, q, s);
    case 7: return (int)launch<7>(t, i0, xy, r, cv, B, q, s);
    case 8: return (int)launch<8>(t, i0, xy, r, cv, B, q, s);
    case 9: return (int)launch<9>(t, i0, xy, r, cv, B, q, s);
    case 10: return (int)launch<10>(t, i0, xy, r, cv, B, q, s);
    default: return (int)launch<11>(t, i0, xy, r, cv, B, q, s);
  }
}

extern "C" const char* att_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
