// Skinny weight-streaming GEMM with fused epilogue, and a row LayerNorm.
//
// ptt_stream_linear replaces the TPU kernel stream_linear
// (paddle_tpu/nn/functional/stream_linear.py:289, pallas_call at :437):
//     out[M, N] = act(x[M, K] @ w[K, N] + bias) + residual
// with fp32 accumulation, for decode-shaped M (a batch of tokens, <= 64
// rows per block; grid.y covers more). w may be one layer of a contiguous
// [L, K, N] stack: the caller passes the layer's pointer, nothing is
// copied. bias, residual and out each carry their own dtype (float32 or
// bfloat16); the activation is none, tanh-GELU (the JAX package's gelu)
// or ReLU.
//
// The same GEMM with ptt_layer_norm also makes up the grouped layer tail
// that replaces _stream_layer_tail_kernel (stream_linear.py:482,
// pallas_call at :672), via stream_layer_tail in the Python wrapper: the
// TPU kernel phases one sequential grid and keeps h2 in VMEM, but a GPU
// grid has no order and LN2 needs whole rows of h2, so the tail here is
// a fixed sequence of launches (O-proj + bo + h -> h2 in fp32; LN2;
// FFN1 + b1 + GELU; FFN2 + b2 + h2; optionally LN1' and QKV' + bq'). The
// later design is one persistent cooperative kernel with a grid-wide
// sync between the phases, so h2 never leaves the SMs.
//
// Design. A block owns a strip of 32 output columns and walks all of K in
// tiles of 8 KB of W, brought in by cp.async (16-byte coalesced copies)
// through a 4-stage shared-memory ring, with the matching [rows, BK]
// slice of x. Its 256 threads split the strip into 4x4 register tiles and
// split each K tile among k-groups (the fewer the rows, the more
// k-groups), and the k-groups' partial sums meet in shared memory before
// the epilogue. The products run on the CUDA cores in fp32.
//
// Bound: bytes — the W stream (x, bias and residual are tiny beside it).
// QKV of the d2048 model is 25.2 MB of bf16, 7.5 us at 3.35 TB/s; the LM
// head 209.7 MB, 62.6 us. At M = 32 the fp32 FMAs on the CUDA cores
// (about 33.5 TFMA/s on an H100 SXM) take 1.6x the byte time, so this
// kernel cannot reach the byte bound; tensor-core tiles (mma/wgmma),
// TMA and split-K for the narrow N = 2048 projections are later work.
#include "common.cuh"

namespace {

using ptt::load_dt;
using ptt::store_dt;
using ptt::to_f32;

constexpr int kThreads = 256;
constexpr int kBN = 32;  // output columns per block
constexpr int kTN = 4;   // columns per thread
constexpr int kTM = 4;   // rows per thread
constexpr int kColGroups = kBN / kTN;
constexpr int kMaxRows = 64;  // rows per block; grid.y covers the rest
constexpr int kStages = 4;
constexpr int kTileBytes = 8192;  // W bytes per pipeline stage
constexpr int kXPadBytes = 16;    // x row padding in shared memory

enum Act { kNone = 0, kGelu = 1, kRelu = 2 };

struct GemmParams {
  const void* x;
  const void* w;
  const void* bias;
  const void* res;
  void* out;
  int bias_dt, res_dt, out_dt;
  int M, K, N, act;
  int rg_log2;  // log2 of the 4-row groups a block covers
};

template <typename T>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);  // elements per 16 bytes
  static constexpr int kBK = kTileBytes / (kBN * sizeof(T));
  static constexpr int kXPitch = kBK + kXPadBytes / sizeof(T);
};

__device__ __forceinline__ float activate(float v, int act) {
  if (act == kGelu) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
  }
  if (act == kRelu) return fmaxf(v, 0.f);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    stream_linear_kernel(const GemmParams p) {
  using C = Tile<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rgs = 1 << p.rg_log2;
  const int rows_pad = rgs * kTM;
  const int kgroups = kThreads / (kColGroups * rgs);
  const int kpg = C::kBK / kgroups;  // k per group per tile
  const int tid = threadIdx.x;
  const int cg = tid % kColGroups;
  const int rg = (tid / kColGroups) & (rgs - 1);
  const int kg = tid / (kColGroups * rgs);
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kMaxRows;
  const int rows = min(kMaxRows, p.M - m0);
  const int w_stage = kBN * C::kBK;
  const int x_stage = rows_pad * C::kXPitch;
  T* sw = reinterpret_cast<T*>(smem);  // [kStages][kBK][kBN]
  T* sx = sw + kStages * w_stage;      // [kStages][rows_pad][kXPitch]
  const T* w = static_cast<const T*>(p.w);
  const T* x = static_cast<const T*>(p.x);

  auto load_tile = [&](int t, int s) {
    const int k0 = t * C::kBK;
    constexpr int wc = kBN / C::kVec;  // 16-byte chunks per W tile row
    for (int c = tid; c < C::kBK * wc; c += kThreads) {
      const int r = c / wc, cc = (c % wc) * C::kVec;
      const int k = k0 + r, n = n0 + cc;
      const bool ok = k < p.K && n < p.N;
      ptt::cp_async16(sw + s * w_stage + r * kBN + cc,
                      ok ? w + static_cast<int64_t>(k) * p.N + n : w,
                      ok ? 16 : 0);
    }
    constexpr int xc = C::kBK / C::kVec;  // 16-byte chunks per x row
    for (int c = tid; c < rows_pad * xc; c += kThreads) {
      const int r = c / xc, kk = (c % xc) * C::kVec;
      const int k = k0 + kk;
      const bool ok = r < rows && k < p.K;
      ptt::cp_async16(sx + s * x_stage + r * C::kXPitch + kk,
                      ok ? x + static_cast<int64_t>(m0 + r) * p.K + k : x,
                      ok ? 16 : 0);
    }
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int ntiles = (p.K + C::kBK - 1) / C::kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile(s, s);
    ptt::cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    ptt::cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();                    // ... for every thread; and stage
                                        // (t-1) % kStages is free again
    const int nt = t + kStages - 1;
    if (nt < ntiles) load_tile(nt, nt % kStages);
    ptt::cp_async_commit();
    const T* tw = sw + (t % kStages) * w_stage + cg * kTN;
    const T* tx = sx + (t % kStages) * x_stage + rg * kTM * C::kXPitch;
    const int kb = kg * kpg;
#pragma unroll 4
    for (int kk = 0; kk < kpg; ++kk) {
      const int k = kb + kk;
      float wv[kTN], xv[kTM];
#pragma unroll
      for (int j = 0; j < kTN; ++j) wv[j] = to_f32(tw[k * kBN + j]);
#pragma unroll
      for (int i = 0; i < kTM; ++i) xv[i] = to_f32(tx[i * C::kXPitch + k]);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
  }
  ptt::cp_async_wait<0>();
  __syncthreads();

  // k-group partials meet in shared memory (16 KB, over the stage ring)
  float* red = reinterpret_cast<float*>(smem);  // [kgroups][rows_pad][kBN]
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      red[(kg * rows_pad + rg * kTM + i) * kBN + cg * kTN + j] = acc[i][j];
  __syncthreads();
  for (int o = tid; o < rows_pad * kBN; o += kThreads) {
    const int r = o / kBN, c = o % kBN;
    const int n = n0 + c;
    if (r >= rows || n >= p.N) continue;
    float v = 0.f;
    for (int s = 0; s < kgroups; ++s) v += red[(s * rows_pad + r) * kBN + c];
    if (p.bias) v += load_dt(p.bias, n, p.bias_dt);
    v = activate(v, p.act);
    const int64_t idx = static_cast<int64_t>(m0 + r) * p.N + n;
    if (p.res) v += load_dt(p.res, idx, p.res_dt);
    store_dt(p.out, idx, p.out_dt, v);
  }
}

template <typename T>
int launch_gemm(GemmParams p, cudaStream_t stream) {
  using C = Tile<T>;
  const int rows = p.M < kMaxRows ? p.M : kMaxRows;
  int rg_log2 = 0;
  while ((1 << rg_log2) * kTM < rows) ++rg_log2;
  p.rg_log2 = rg_log2;
  const int rows_pad = (1 << rg_log2) * kTM;
  const size_t smem =
      kStages * (kTileBytes + static_cast<size_t>(rows_pad) * C::kXPitch *
                                  sizeof(T));
  const size_t smem_max =
      kStages *
      (kTileBytes + static_cast<size_t>(kMaxRows) * C::kXPitch * sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      stream_linear_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_max));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kMaxRows - 1) / kMaxRows);
  stream_linear_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---- row LayerNorm: (x - mean) * rsqrt(var + eps) * scale + bias ----

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = ptt::warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const float t = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
  return ptt::warp_sum(t);
}

__global__ void __launch_bounds__(256)
    layer_norm_kernel(const void* x, int x_dt, const void* scale, int s_dt,
                      const void* bias, int b_dt, void* out, int out_dt,
                      int D, float eps) {
  __shared__ float red[32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * D;
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    s += load_dt(x, base + i, x_dt);
  const float mean = block_sum(s, red) / D;
  float v = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float c = load_dt(x, base + i, x_dt) - mean;
    v = fmaf(c, c, v);
  }
  const float inv = rsqrtf(block_sum(v, red) / D + eps);  // population var
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float y = (load_dt(x, base + i, x_dt) - mean) * inv *
                        load_dt(scale, i, s_dt) +
                    load_dt(bias, i, b_dt);
    store_dt(out, base + i, out_dt, y);
  }
}

}  // namespace

// Returns the cudaError_t of the launch. x [M, K] and w [K, N] share
// `dtype` and are contiguous and 16-byte aligned, with K and N multiples
// of 8 (bf16) or 4 (float32). bias [N], residual [M, N] and out [M, N]
// may be null (bias, residual) and carry their own dtype codes.
extern "C" int ptt_stream_linear(const void* x, const void* w,
                                 const void* bias, int bias_dt,
                                 const void* residual, int residual_dt,
                                 void* out, int out_dt, int dtype, int M,
                                 int K, int N, int activation, void* stream) {
  if (M == 0 || N == 0) return 0;
  const GemmParams p{x,      w,           bias, residual, out, bias_dt,
                     residual_dt, out_dt, M,    K,        N,   activation,
                     0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32) return launch_gemm<float>(p, st);
  if (dtype == ptt::kBF16) return launch_gemm<__nv_bfloat16>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Returns the cudaError_t of the launch: one block per row of x [M, D].
extern "C" int ptt_layer_norm(const void* x, int x_dt, const void* scale,
                              int scale_dt, const void* bias, int bias_dt,
                              void* out, int out_dt, int M, int D, float eps,
                              void* stream) {
  if (M == 0) return 0;
  layer_norm_kernel<<<M, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_dt, scale, scale_dt, bias, bias_dt, out, out_dt, D, eps);
  return static_cast<int>(cudaGetLastError());
}
