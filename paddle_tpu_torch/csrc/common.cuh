// Shared helpers of the port's CUDA kernels: dtype codes, conversions,
// warp reductions, cp.async, 16-bit tensor-core fragments. Dtype codes
// match _kernels.py: 0 = float32, 1 = bfloat16, 2 = int8 (weights only),
// 3 = float16 (the flash kernels B10-B13 only).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace ptt {

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2, kF16 = 3 };

// a 16-bit float operand type: __nv_bfloat16 or __half
template <typename T>
inline constexpr bool kIsHalf = std::is_same<T, __half>::value;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);  // exact
}
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch .to()
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// two fp32 values rounded to nearest even into a 16-bit pair of type T
// (lo in the low half), as the A fragment of a product or a store
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsHalf<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// elements i and i + 1 of a 16-bit array (4-byte aligned) from fp32
template <typename T>
__device__ __forceinline__ void store2(T* at, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(at) = pack2<T>(lo, hi);
}

// element i of a buffer whose dtype is only known at run time
__device__ __forceinline__ float load_dt(const void* p, int64_t i, int dt) {
  return dt == kF32 ? static_cast<const float*>(p)[i]
                    : __bfloat162float(
                          static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ void store_dt(void* p, int64_t i, int dt,
                                         float v) {
  if (dt == kF32)
    static_cast<float*>(p)[i] = v;
  else
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
}

// Epilogue activations: none, tanh-GELU (the JAX package's gelu), ReLU.
enum Act { kActNone = 0, kGelu = 1, kRelu = 2 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kGelu) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  if (act == kRelu) return fmaxf(v, 0.f);
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Symmetric int8 quantization of one value by a row scale, as the
// PyTorch side's clip(round(x / s), -127, 127): a true division and
// round half to even.
__device__ __forceinline__ int quantize_i8(float x, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(x / s), -127.f), 127.f));
}

// The row scale max(absmax / 127, 1e-8), by a true division.
__device__ __forceinline__ float row_scale(float absmax) {
  return fmaxf(absmax / 127.f, 1e-8f);
}

// 16-byte global -> shared copy, asynchronous (sm_80+). src_bytes 0
// fills the 16 destination bytes with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Tensor-core fragments (sm_80+): four 8x8 b16 matrices from shared memory
// (lane l gives the address of row l % 8 of matrix l / 8), plain or
// transposed, and one bf16 (or fp16: mma16<__half>) m16n8k16 product with
// fp32 accumulators.
__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3,
                                            const void* p) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3,
                                                  const void* p) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ void mma16(float* c, uint32_t a0, uint32_t a1,
                                      uint32_t a2, uint32_t a3, uint32_t b0,
                                      uint32_t b1) {
  if constexpr (kIsHalf<T>) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  } else {
    mma_bf16(c, a0, a1, a2, a3, b0, b1);
  }
}

}  // namespace ptt
