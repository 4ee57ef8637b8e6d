// Hopper (sm_90a) building blocks of the port's kernels: TMA tensor maps,
// tile loads and stores and 1-D bulk copies, mbarriers, named barriers,
// setmaxnreg, and the bf16 or fp16 wgmma products (both operands from shared
// memory at n64, n128 and n256, either of them transposed; or A from
// registers at n64, n96 and n128) with their descriptors.
//
// Tensor maps are encoded on the host for each call by the driver's
// cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point (cudaGetDriverEntryPoint[ByVersion]): nothing links against
// libcuda, and <cuda.h> is read for its types only. A map is passed to a
// kernel by value as `const __grid_constant__ CUtensorMap`.
//
// Shared-memory tiles are written by TMA with the 128-byte swizzle: a
// row of 128 bytes (64 bf16) per line, lines in groups of 8 (1 KB), each
// 16-byte chunk of line r stored at chunk (c ^ r % 8). Every tile starts
// on a 1 KB boundary, so the descriptors' base offset is 0.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace ptt {
namespace hopper {

// ------------------------------------------------------------------ host

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, or null where it has none
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(f)
               : nullptr;
  }();
  return fn;
}

// A bf16 (or, with `half`, fp16) map of `rank` dims (innermost first), the
// byte strides of dims 1.., a box of `box` elements, 128-byte swizzle;
// elements outside the tensor read as zeros. Returns a cudaError_t code
// (0 on success).
inline int make_map_16(CUtensorMap* map, bool half, const void* base,
                       cuuint32_t rank, const cuuint64_t* dims,
                       const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
  const CUresult r =
      fn(map,
         half ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
         rank, const_cast<void*>(base),
         dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

// make the barriers' initialisation visible to the async (TMA) proxy
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// arrive and announce `bytes` of TMA transactions for the current phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` has completed (a fresh
// barrier counts the phase before it, parity 1, as completed)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// TMA: one tile of `map` at element coordinates (innermost first) into
// shared memory; completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// TMA store: the box of `map` at element coordinates (innermost first)
// from shared memory (written with the map's swizzle; generic writes
// fenced to the async proxy first); elements outside the tensor are not
// written. Stores are committed as a bulk group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's bulk groups still read shared
// memory (a staging buffer may be rewritten), or are not complete
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// a 1-D bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) into shared memory, completion counted in bytes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand tile.
// K-major (rows of 64 K values): sbo = 1024 (the next 8 rows), lbo
// unused (16). MN-major (rows of 64 M/N values, one row per k): sbo =
// 1024 (the next 8 k), lbo = the byte distance to the next 64 M/N
// values. A k16 step advances the start by 32 bytes (K-major) or by 16
// rows, 2048 bytes (MN-major).
__device__ __forceinline__ uint64_t desc_sw128(const void* tile,
                                               uint32_t lbo, uint32_t sbo) {
  const uint32_t a = smem_u32(tile);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;  // layout: 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for register-A fragments, which a product reads until its
// wait
template <int R>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r])::"memory");
}

// The products, 16-bit floats in (T: __nv_bfloat16, the default, or
// __half, which selects the .f16 form), fp32 accumulators. Accumulator
// layout of m64nNk16 (warp w of the warpgroup, lane l): d[4j + 2h + e] is
// row 16w + l/4 + 8h, column 8j + 2(l%4) + e.
//
// d[64 x 128] (+)= A[64 x 16] B[16 x 128], both operands from shared
// memory, A K-major. kTransB 0: B K-major; 1: B N-major. scale_d 0
// ignores d's old value.
template <int kTransB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
#define PTT_WGMMA(TY)                                                        \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %66, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "           \
      "{"                                                                    \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                               \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                             \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                             \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                             \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                             \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                             \
      "%56, %57, %58, %59, %60, %61, %62, %63"                               \
      "}, "                                                                  \
      "%64, %65, p, 1, 1, 0, %67;\n"                                         \
      "}\n"                                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                      \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                      \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                    \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                  \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                  \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                  \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                  \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                  \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                  \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                  \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                  \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                  \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                  \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                   \
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB))
  if constexpr (ptt::kIsHalf<T>)
    PTT_WGMMA("f16");
  else
    PTT_WGMMA("bf16");
#undef PTT_WGMMA
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], as the n128 product
template <int kTransB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
#define PTT_WGMMA(TY)                                                        \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %34, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "            \
      "{"                                                                    \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                               \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                             \
      "%24, %25, %26, %27, %28, %29, %30, %31"                               \
      "}, "                                                                  \
      "%32, %33, p, 1, 1, 0, %35;\n"                                         \
      "}\n"                                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                      \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                      \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                    \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                  \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                  \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                  \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                   \
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB))
  if constexpr (ptt::kIsHalf<T>)
    PTT_WGMMA("f16");
  else
    PTT_WGMMA("bf16");
#undef PTT_WGMMA
}

// d[64 x 256] (+)= A[64 x 16] B[16 x 256], as the n128 product; kTransA
// 0: A K-major; 1: A M-major (the rows of an operand stored k by k, as
// x^T of a row-major x)
template <int kTransB, int kTransA, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                uint64_t db, int scale_d) {
#define PTT_WGMMA(TY)                                                        \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %130, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "           \
      "{"                                                                    \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                               \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                             \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                             \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                             \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                             \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                             \
      "%56, %57, %58, %59, %60, %61, %62, %63, "                             \
      "%64, %65, %66, %67, %68, %69, %70, %71, "                             \
      "%72, %73, %74, %75, %76, %77, %78, %79, "                             \
      "%80, %81, %82, %83, %84, %85, %86, %87, "                             \
      "%88, %89, %90, %91, %92, %93, %94, %95, "                             \
      "%96, %97, %98, %99, %100, %101, %102, %103, "                         \
      "%104, %105, %106, %107, %108, %109, %110, %111, "                     \
      "%112, %113, %114, %115, %116, %117, %118, %119, "                     \
      "%120, %121, %122, %123, %124, %125, %126, %127"                       \
      "}, "                                                                  \
      "%128, %129, p, 1, 1, %131, %132;\n"                                   \
      "}\n"                                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                      \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                      \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                    \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                  \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                  \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                  \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                  \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                  \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                  \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                  \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                  \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                  \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                  \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),                  \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),                  \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),                  \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),                  \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),                  \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),                  \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),                  \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),                  \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),                  \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),                  \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),              \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),              \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),              \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),              \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),              \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),              \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])               \
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransA), "n"(kTransB))
  if constexpr (ptt::kIsHalf<T>)
    PTT_WGMMA("f16");
  else
    PTT_WGMMA("bf16");
#undef PTT_WGMMA
}

// d[64 x N] (+)= A[64 x 16] B[16 x N] with A from registers: thread l
// of warp w holds a[r] = the 16-bit pair (row 16w + l/4 + 8(r % 2),
// columns 2(l%4) + 8(r / 2) + {0, 1}), which is the accumulator layout
// above: columns 16s.. of an fp32 product d0 feed k-step s as
// a[r] = pack(d0[8s + 2r], d0[8s + 2r + 1]). B N-major from shared memory.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db, int scale_d) {
#define PTT_WGMMA(TY)                                                        \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %37, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "            \
      "{"                                                                    \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                               \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                             \
      "%24, %25, %26, %27, %28, %29, %30, %31"                               \
      "}, "                                                                  \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"                             \
      "}\n"                                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                      \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                      \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                    \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                  \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                  \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                  \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))
  if constexpr (ptt::kIsHalf<T>)
    PTT_WGMMA("f16");
  else
    PTT_WGMMA("bf16");
#undef PTT_WGMMA
}

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n96k16_rs(float (&d)[48],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db, int scale_d) {
#define PTT_WGMMA(TY)                                                        \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %53, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n96k16.f32." TY "." TY " "            \
      "{"                                                                    \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                               \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                             \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                             \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                             \
      "%40, %41, %42, %43, %44, %45, %46, %47"                               \
      "}, "                                                                  \
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n"                             \
      "}\n"                                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                      \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                      \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                    \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                  \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                  \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                  \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                  \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                  \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                  \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                  \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])                   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))
  if constexpr (ptt::kIsHalf<T>)
    PTT_WGMMA("f16");
  else
    PTT_WGMMA("bf16");
#undef PTT_WGMMA
}

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db, int scale_d) {
#define PTT_WGMMA(TY)                                                        \
  asm volatile(                                                              \
      "{\n"                                                                  \
      ".reg .pred p;\n"                                                      \
      "setp.ne.b32 p, %69, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "           \
      "{"                                                                    \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                               \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                             \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                             \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                             \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                             \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                             \
      "%56, %57, %58, %59, %60, %61, %62, %63"                               \
      "}, "                                                                  \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"                             \
      "}\n"                                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                      \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                      \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                    \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                  \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                  \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                  \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                  \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                  \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                  \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                  \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                  \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                  \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                  \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))
  if constexpr (ptt::kIsHalf<T>)
    PTT_WGMMA("f16");
  else
    PTT_WGMMA("bf16");
#undef PTT_WGMMA
}

template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  static_assert(N == 64 || N == 96 || N == 128, "n64, n96 or n128");
  if constexpr (N == 64) wgmma_m64n64k16_rs<T>(d, a, db, scale_d);
  if constexpr (N == 96) wgmma_m64n96k16_rs<T>(d, a, db, scale_d);
  if constexpr (N == 128) wgmma_m64n128k16_rs<T>(d, a, db, scale_d);
}

// the registers a thread of this warpgroup may hold, raised or lowered to
// R (all warps of the warpgroup execute it): a producer warpgroup gives
// its registers to the consumers'
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// make this thread's generic-proxy writes to shared memory visible to
// the async proxy (wgmma and TMA reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` (1..15; 0 is __syncthreads) over `count` threads
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

}  // namespace hopper
}  // namespace ptt
