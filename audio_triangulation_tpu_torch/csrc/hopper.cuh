// Thin wrappers over the PTX that the tensor-core kernels of this package
// share: cp.async, mma.sync (TF32 and bf16), flags between blocks, and
// Hopper's mbarrier, TMA tile load and wgmma (bf16 and int8 with both operands K-major in shared
// memory under the 128-byte swizzle; TF32 with A from registers and B under
// the 128- or 64-byte swizzle).  Built for sm_90a only.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace hopper {

// ---- TMA tensor maps (host) --------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the process has already loaded
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return h ? (EncodeTiled)dlsym(h, "cuTensorMapEncodeTiled") : (EncodeTiled) nullptr;
  }();
  return fn;
}

// map of a row-major [rows, cols] matrix read in tiles of box_rows x
// swizzle_bytes (128 or 64) under the swizzle of that width, or with
// swizzle_bytes 0 of box_rows x box_bytes unswizzled; out-of-range elements
// read as zero
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                     const void* base, int rows, int cols, int box_rows,
                     int swizzle_bytes = 128, int box_bytes = 0) {
  const EncodeTiled encode = encode_tiled();
  if (!encode || (swizzle_bytes != 128 && swizzle_bytes != 64 && swizzle_bytes != 0))
    return false;
  if (swizzle_bytes) box_bytes = swizzle_bytes;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(box_bytes / elem_bytes), (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUtensorMapSwizzle swizzle = swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                           : CU_TENSOR_MAP_SWIZZLE_NONE;
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// what an entry point returns when a tensor map could not be made (libcuda's
// cuTensorMapEncodeTiled not found, or it refused the matrix): no cudaError_t
// is negative, and nothing was launched
constexpr int kErrTensorMap = -1;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- cp.async (4 bytes, zero-filled when !ok; 16 bytes) --------------------

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const int n = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}
// 16 bytes, both addresses 16-byte aligned, past L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// 16 bytes of shared memory, 16-byte aligned.  Volatile: the load keeps its
// place among the other volatile statements (mma.sync, other loads), which
// bounds how long its four registers live.
__device__ __forceinline__ void lds128(uint32_t (&v)[4], const void* p) {
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
               : "r"(smem_addr(p)));
}

// ---- mma.sync --------------------------------------------------------------

// x rounded to TF32 (10 mantissa bits, nearest, ties away from zero), as f32
// bits: half a TF32 ulp added to the magnitude, the 13 low bits cleared.
// The same values as cvt.rna.tf32.f32 in two integer instructions, which
// issue faster than the convert (the SRP-argmax kernel's f32 mode: 3.08-3.12
// ms with these, 3.35 ms with cvt, outputs bit-equal; chip_variants.py,
// NVIDIA H100 80GB HBM3, 700.00 W).
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with both parts TF32 values (lo carries the next 11 bits)
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// d += a (16 x 8, row) * b (8 x 8, col), TF32 operands, f32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a (16 x 8, row) * b (8 x 8, col): the product alone, for sums that are
// kept outside the tensor cores (which add with truncation)
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4],
                                              const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 pairs packed low k first
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (lo, hi) rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- mbarrier --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// returns once the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// mbar_wait that gives up: false when the phase has not changed after about a
// second of polling (a copy that never lands would otherwise hang the card)
__device__ __forceinline__ bool mbar_wait_bounded(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  for (uint32_t spins = 0; spins < (1u << 26); ++spins) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return true;
  }
  return false;
}

// ---- TMA -------------------------------------------------------------------

// one tile of a 2-D tensor map into shared memory; `bar` gets its bytes
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// makes shared-memory writes of ordinary threads visible to TMA and wgmma
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// makes global-memory writes of ordinary threads, made visible to this
// thread, visible to its later TMA reads
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// ---- flags between blocks (global memory, GPU scope) ------------------------

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
// waits until *p is nonzero; false when it is not after about seven seconds
// (a flag that is never set would otherwise hang the card)
__device__ __forceinline__ bool wait_flag(const int* p) {
  for (uint32_t spins = 0; spins < (1u << 26); ++spins) {
    if (ld_acquire(p)) return true;
    __nanosleep(100);
  }
  return false;
}

// barrier `id` (1..15) over `kThreads` threads
template <int kThreads>
__device__ __forceinline__ void named_barrier(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kThreads) : "memory");
}

template <int kRegs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ---- wgmma -----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// returns once at most kPending committed groups are still in flight
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Descriptor of a K-major tile whose rows are 128 bytes under the 128-byte
// swizzle (what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B): groups of 8
// rows lie 1,024 bytes apart.  The tile starts on a 1,024-byte boundary; a
// step of 32 bytes along K inside the row adds 2 to the result.
__device__ __forceinline__ uint64_t wgmma_desc_k128(const void* tile) {
  uint64_t d = 0;
  d |= (uint64_t)((smem_addr(tile) & 0x3ffffu) >> 4);
  d |= (uint64_t)1 << 16;            // leading offset: unused under a swizzle
  d |= (uint64_t)(1024 >> 4) << 32;  // stride between 8-row groups
  d |= (uint64_t)1 << 62;            // 128-byte swizzle
  return d;
}

// The same for rows of 64 bytes under the 64-byte swizzle (CU_TENSOR_MAP_
// SWIZZLE_64B): groups of 8 rows lie 512 bytes apart; the tile starts on a
// 512-byte boundary, and a step of 32 bytes along K adds 2.
__device__ __forceinline__ uint64_t wgmma_desc_k64(const void* tile) {
  uint64_t d = 0;
  d |= (uint64_t)((smem_addr(tile) & 0x3ffffu) >> 4);
  d |= (uint64_t)1 << 16;            // leading offset: unused under a swizzle
  d |= (uint64_t)(512 >> 4) << 32;   // stride between 8-row groups
  d |= (uint64_t)2 << 62;            // 64-byte swizzle
  return d;
}

#define ATT_REGS32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31}"

#define ATT_REGS64                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
  "%61, %62, %63}"
#define ATT_F(x) "+f"(x)
#define ATT_R(x) "+r"(x)
#define ATT_8(C, d, i)                                                     \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), \
      C(d[i + 6]), C(d[i + 7])
#define ATT_64(C, d)                                                          \
  ATT_8(C, d, 0), ATT_8(C, d, 8), ATT_8(C, d, 16), ATT_8(C, d, 24),           \
      ATT_8(C, d, 32), ATT_8(C, d, 40), ATT_8(C, d, 48), ATT_8(C, d, 56)

// d [64 x 128, f32] += a [64 x 16] * b [128 x 16]^T, bf16, both from shared
// memory, K-major
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ATT_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : ATT_64(ATT_F, d)
      : "l"(a), "l"(b), "r"(1));
}

// d [64 x 128, int32] += a [64 x 32] * b [128 x 32]^T, int8
__device__ __forceinline__ void wgmma_m64n128(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " ATT_REGS64
      ", %64, %65, p;\n"
      "}\n"
      : ATT_64(ATT_R, d)
      : "l"(a), "l"(b), "r"(1));
}

// d [64 x 128, f32] += a [64 x 8] * b [128 x 8]^T, TF32: a from registers (the
// mma.sync m16n8k8 A fragment of the warp's 16 rows), b K-major in shared
// memory under the 128-byte swizzle
__device__ __forceinline__ void wgmma_m64n128_tf32(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " ATT_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : ATT_64(ATT_F, d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d [64 x 64, f32] (+)= a [64 x 8] * b [64 x 8]^T, TF32: a from registers,
// b K-major in shared memory (either swizzle's descriptor); with
// accumulate = 0, d = a * b
__device__ __forceinline__ void wgmma_m64n64_tf32(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t b, int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " ATT_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : ATT_8(ATT_F, d, 0), ATT_8(ATT_F, d, 8), ATT_8(ATT_F, d, 16), ATT_8(ATT_F, d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#define ATT_REGS24                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "      \
  "%16, %17, %18, %19, %20, %21, %22, %23}"

// d [64 x 48, f32] (+)= a [64 x 8] * b [48 x 8]^T, TF32: a from registers,
// b K-major in shared memory (either swizzle's descriptor); with
// accumulate = 0, d = a * b
__device__ __forceinline__ void wgmma_m64n48_tf32(float (&d)[24], const uint32_t (&a)[4],
                                                  uint64_t b, int accumulate = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 " ATT_REGS24
      ", {%24, %25, %26, %27}, %28, p, 1, 1;\n"
      "}\n"
      : ATT_8(ATT_F, d, 0), ATT_8(ATT_F, d, 8), ATT_8(ATT_F, d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

#define ATT_REGS76                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, " \
  "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, " \
  "%61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75}"

// d [64 x 152, f32] += a [64 x 8] * b [152 x 8]^T, TF32: a from registers (the
// mma.sync m16n8k8 A fragment of the warp's 16 rows), b K-major in shared
// memory under the 128-byte swizzle
__device__ __forceinline__ void wgmma_m64n152_tf32(float (&d)[76], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %81, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n152k8.f32.tf32.tf32 " ATT_REGS76
      ", {%76, %77, %78, %79}, %80, p, 1, 1;\n"
      "}\n"
      : ATT_64(ATT_F, d), ATT_8(ATT_F, d, 64), ATT_F(d[72]), ATT_F(d[73]), ATT_F(d[74]),
        ATT_F(d[75])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// keeps the compiler from moving accumulator uses across the async product
__device__ __forceinline__ void keep(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void keep(int& x) { asm volatile("" : "+r"(x)::"memory"); }

}  // namespace hopper
