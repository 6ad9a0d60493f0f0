// Batched damped Gauss-Newton TDOA solve, one thread per frame.
//
// Replaces audio_triangulation_tpu/ops/pallas/gn_kernel.py::_gn_kernel (row 5
// of the port's kernel table), with its formulas: the source on the
// radius-h sphere around the array center (or the z = h plane), mics at
// z = 0, the analytic Jacobian of the lift, the damped 2x2 normal equations
// solved in closed form with the |det| > 1e-20 guard, then the residual rms.
//
// What bounds it on an H100: each frame is a short serial program (per
// iteration and pair two distances, a square root and a division each),
// about 1 kFLOP per frame per iteration at 6 pairs; its inputs are P + 2
// floats per frame.  It is latency-bound, not bandwidth-bound, so the design
// gives every frame its own thread, keeps the iterate in registers, and puts
// the mic coordinates and pair list in shared memory once per block.  The
// TPU kernel's lane padding (init 0.01 on padded frames) is replaced by
// masking the ragged edge by index.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

struct Lift {
  float sx, sy, sz;               // source point
  float j11, j21, j31, j12, j22, j32;  // d(source) / d(x, y)
};

__device__ __forceinline__ Lift lift(float x, float y, float h, float hh,
                                     int sphere) {
  Lift o;
  if (sphere) {
    const float nv = sqrtf(x * x + y * y + hh);
    const float inv = 1.f / nv;
    const float s = h * inv;
    o.sx = x * s;
    o.sy = y * s;
    o.sz = h * s;
    const float vx = x * inv, vy = y * inv, vz = h * inv;
    o.j11 = s * (1.f - vx * vx);
    o.j21 = s * (-vy * vx);
    o.j31 = s * (-vz * vx);
    o.j12 = s * (-vx * vy);
    o.j22 = s * (1.f - vy * vy);
    o.j32 = s * (-vz * vy);
  } else {
    o.sx = x;
    o.sy = y;
    o.sz = h;
    o.j11 = 1.f; o.j21 = 0.f; o.j31 = 0.f;
    o.j12 = 0.f; o.j22 = 1.f; o.j32 = 0.f;
  }
  return o;
}

// Distance from the source to mic (mx, my, 0) and its gradient in (x, y).
__device__ __forceinline__ void mic_term(const Lift& s, float mx, float my,
                                         float& d, float& g1, float& g2) {
  const float dx = s.sx - mx, dy = s.sy - my, dz = s.sz;
  d = sqrtf(dx * dx + dy * dy + dz * dz);
  const float ud = 1.f / d;
  const float ux = dx * ud, uy = dy * ud, uz = dz * ud;
  g1 = ux * s.j11 + uy * s.j21 + uz * s.j31;
  g2 = ux * s.j12 + uy * s.j22 + uz * s.j32;
}

__global__ void __launch_bounds__(kThreads)
gn_kernel(const float* __restrict__ tau,    // [B, P] seconds
          const float* __restrict__ init,   // [B, 2]
          const float* __restrict__ mics,   // [M, 2]
          const int* __restrict__ pairs,    // [P, 2]
          float* __restrict__ xy_out,       // [B, 2]
          float* __restrict__ rms_out,      // [B]
          int B, int M, int P, float c, float h, float hh, int iters,
          float damping, int sphere) {
  extern __shared__ float smem[];
  float* mic_s = smem;                      // [M, 2]
  int* pair_s = (int*)(smem + 2 * M);       // [P, 2]
  for (int e = threadIdx.x; e < 2 * M; e += blockDim.x) mic_s[e] = mics[e];
  for (int e = threadIdx.x; e < 2 * P; e += blockDim.x) pair_s[e] = pairs[e];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* t = tau + (size_t)b * P;
  float x = init[2 * b], y = init[2 * b + 1];

  for (int it = 0; it < iters; ++it) {
    const Lift s = lift(x, y, h, hh, sphere);
    float a00 = 0.f, a11 = 0.f, a01 = 0.f, b0 = 0.f, b1 = 0.f;
    for (int p = 0; p < P; ++p) {
      const int i = pair_s[2 * p], j = pair_s[2 * p + 1];
      float di, g1i, g2i, dj, g1j, g2j;
      mic_term(s, mic_s[2 * i], mic_s[2 * i + 1], di, g1i, g2i);
      mic_term(s, mic_s[2 * j], mic_s[2 * j + 1], dj, g1j, g2j);
      const float r = dj - di - t[p] * c;
      const float ja = g1j - g1i, jb = g2j - g2i;
      a00 += ja * ja;
      a11 += jb * jb;
      a01 += ja * jb;
      b0 += ja * r;
      b1 += jb * r;
    }
    a00 += damping;
    a11 += damping;
    const float det = a00 * a11 - a01 * a01;
    const float inv_det = 1.f / (fabsf(det) > 1e-20f ? det : 1e-20f);
    const float nx = x - (a11 * b0 - a01 * b1) * inv_det;
    const float ny = y - (a00 * b1 - a01 * b0) * inv_det;
    x = nx;
    y = ny;
  }

  const Lift s = lift(x, y, h, hh, sphere);
  float ss = 0.f;
  for (int p = 0; p < P; ++p) {
    const int i = pair_s[2 * p], j = pair_s[2 * p + 1];
    float di, dj, g1, g2;
    mic_term(s, mic_s[2 * i], mic_s[2 * i + 1], di, g1, g2);
    mic_term(s, mic_s[2 * j], mic_s[2 * j + 1], dj, g1, g2);
    const float r = dj - di - t[p] * c;
    ss += r * r;
  }
  xy_out[2 * b] = x;
  xy_out[2 * b + 1] = y;
  rms_out[b] = sqrtf(ss / (float)P);
}

}  // namespace

extern "C" int att_gn(const void* tau, const void* init, const void* mics,
                      const void* pairs, void* xy_out, void* rms_out, int B,
                      int M, int P, float c, float h, float hh, int iters,
                      float damping, int sphere, void* stream) {
  const size_t smem = (size_t)(2 * M + 2 * P) * sizeof(float);
  const int grid = (B + kThreads - 1) / kThreads;
  gn_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)tau, (const float*)init, (const float*)mics,
      (const int*)pairs, (float*)xy_out, (float*)rms_out, B, M, P, c, h, hh,
      iters, damping, sphere);
  return (int)cudaGetLastError();
}

extern "C" const char* att_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
