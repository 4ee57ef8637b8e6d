// Shared helpers of the port's CUDA kernels: dtype codes, conversions,
// warp reductions, cp.async. Dtype codes match _kernels.py: 0 = float32,
// 1 = bfloat16, 2 = int8 (weights only).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ptt {

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);  // exact
}
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

}  // namespace ptt
