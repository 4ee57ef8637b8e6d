// Tile machinery of the flash-attention kernels (dense B10 in
// flash_attention.cu, packed varlen B11-B13 in flash_varlen_packed.cu):
// 128-thread blocks, 16-bit tiles (bf16, or fp16 for B10-B13) in shared
// memory brought in by cp.async and read as tensor-core fragments by
// ldmatrix, mma.sync m16n8k16 with fp32 sums, and the f32 tiles of the
// CUDA-core path. The 16-bit helpers take the element type T from their
// tile pointers.
#pragma once

#include "common.cuh"

namespace ptt {
namespace tiles {

using bf16 = __nv_bfloat16;
using f16 = __half;
using ptt::kIsHalf;
using ptt::pack2;

constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------- bf16

template <int D>
struct TileBf16 {
  // elements: rows 16 bytes apart past D, so the 8 rows of an ldmatrix
  // start in distinct banks (D = 64, 96, 128 and 256: row starts 36, 52,
  // 68 and 132 words apart, 8 distinct multiples of 4 modulo 32)
  static constexpr int kPitch = D + 8;
  // A warp keeps a 16 x D fp32 accumulator in registers (D / 2 a thread).
  // At D = 256 that is 128 registers, so a 64-key tile is computed in
  // sub-tiles of kSub keys (16 x kSub scores beside it), and a dk/dv
  // block, which holds two accumulators, owns kCols of the D columns.
  static constexpr int kSub = D > 128 ? 32 : 64;
  static constexpr int kCols = D > 128 ? D / 2 : D;
};

// rows [r0, r0 + R) of head hi (and batch bi) of a 16-bit operand with
// batch, row and head strides sb, ss, sh (elements; the last axis
// contiguous) into a shared tile [R][D + 8], 16 bytes a cp.async. Rows at
// or past `n` are zero-filled and not read.
template <int R, int D, typename T>
__device__ __forceinline__ void load_rows(T* dst, const void* base,
                                          int64_t sb, int64_t ss, int64_t sh,
                                          int bi, int hi, int r0,
                                          int n = 0x7fffffff) {
  constexpr int kChunks = D / 8;
  constexpr int kPitch = TileBf16<D>::kPitch;
  const T* src = static_cast<const T*>(base) + bi * sb + hi * sh;
  for (int c = threadIdx.x; c < R * kChunks; c += kThreads) {
    const int r = c / kChunks, e = (c % kChunks) * 8;
    const bool in = r0 + r < n;
    cp_async16(dst + r * kPitch + e, in ? src + (r0 + r) * ss + e : src,
               in ? 16 : 0);
  }
}

// n int32 or f32 values (n a multiple of 4, 16-byte aligned) into shared
// memory by cp.async
__device__ __forceinline__ void load_words(void* dst, const void* src,
                                           int n) {
  for (int c = threadIdx.x; c < n / 4; c += kThreads)
    cp_async16(static_cast<int*>(dst) + c * 4,
               static_cast<const int*>(src) + c * 4, 16);
}

// x rounded to bf16 (to nearest even) and back: the hi half of a bf16
// pair hi + lo that carries an fp32 probability into a bf16 product
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc[N/8][4] += A (16 rows x D, row-major in shared memory at `a`) times
// B^T, B (N rows x D, row-major at `b`): S = Q K^T and its kin.
template <int N, int D, typename T>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], const T* a,
                                        const T* b) {
  constexpr int kPitch = TileBf16<D>::kPitch;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a0, a1, a2, a3;
    ldmatrix_x4(a0, a1, a2, a3,
                a + (lane & 15) * kPitch + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4(b0, b1, b2, b3,
                  b + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kPitch +
                      kk * 16 + ((lane >> 3) & 1) * 8);
      mma16<T>(acc[2 * np], a0, a1, a2, a3, b0, b1);
      mma16<T>(acc[2 * np + 1], a0, a1, a2, a3, b2, b3);
    }
  }
}

// acc[D/8][4] += X (16 x K, in registers as an fp32 accumulator x[K/8][4])
// times B (K rows x D, row-major at `b`, rows kPitch elements apart): O +=
// P V and its kin; X is rounded to T in pairs.
template <int K, int D, int kPitch = TileBf16<D>::kPitch, typename T>
__device__ __forceinline__ void mma_xb(float (&acc)[D / 8][4],
                                       const float (&x)[K / 8][4],
                                       const T* b) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint32_t a0 = pack2<T>(x[2 * kk][0], x[2 * kk][1]);
    const uint32_t a1 = pack2<T>(x[2 * kk][2], x[2 * kk][3]);
    const uint32_t a2 = pack2<T>(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    const uint32_t a3 = pack2<T>(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(b0, b1, b2, b3,
                        b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                kPitch +
                            np * 16 + (lane >> 4) * 8);
      mma16<T>(acc[2 * np], a0, a1, a2, a3, b0, b1);
      mma16<T>(acc[2 * np + 1], a0, a1, a2, a3, b2, b3);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------- f32

// 32-row tiles, thread (r = tid / 4, qd = tid % 4): scores of row r
// against keys qd*8 .. qd*8+7, and output columns qd, qd+4, ...
constexpr int kT = 32;

template <int D>
struct TileF32 {
  static constexpr int kPitch = D + 1;  // odd: a column walk is conflict-free
};

// rows [r0, r0 + kT) of an f32 operand into a shared tile [kT][D + 1];
// rows at or past `n` are zeros
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const void* base,
                                              int64_t sb, int64_t ss,
                                              int64_t sh, int bi, int hi,
                                              int r0, int n = 0x7fffffff) {
  const float* src = static_cast<const float*>(base) + bi * sb + hi * sh;
  for (int c = threadIdx.x; c < kT * D; c += kThreads) {
    const int r = c / D, e = c % D;
    dst[r * TileF32<D>::kPitch + e] =
        r0 + r < n ? src[(r0 + r) * ss + e] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll 8
  for (int e = 0; e < D; ++e) acc = fmaf(a[e], b[e], acc);
  return acc;
}

}  // namespace tiles
}  // namespace ptt
