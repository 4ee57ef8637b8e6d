// Skinny weight-streaming GEMM with fused epilogue, and a row LayerNorm.
//
// ptt_stream_linear replaces the TPU kernel stream_linear
// (paddle_tpu/nn/functional/stream_linear.py:289, pallas_call at :437):
//     out[M, N] = act(x[M, K] @ w[K, N] * scale + bias) + residual
// with fp32 accumulation, for decode-shaped M (a batch of tokens, <= 64
// rows per block; grid.y covers more). w may be one layer of a contiguous
// [L, K, N] stack: the caller passes the layer's pointer, nothing is
// copied. w is in x's dtype, or int8 (weight-only quantization): each
// int8 weight converts exactly to fp32 in the inner loop and the
// per-column scale[N] multiplies the fp32 accumulator before bias,
// activation and residual, in the order of the TPU kernel body
// (stream_linear.py:410-414). scale, bias, residual and out each carry
// their own dtype (float32 or bfloat16); the activation is none,
// tanh-GELU (the JAX package's gelu) or ReLU.
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
// Design, bf16 x (stream_gemm_mma; weights bf16 or int8). The products
// run on the tensor cores: mma.sync m16n8k16 with fp32 accumulators over
// the <= 64 rows of a block (at most four m16 groups; a group past M is
// skipped), x fragments by ldmatrix and bf16 W fragments by
// ldmatrix.trans from [k][n] tiles. An int8 weight converts exactly to
// bf16 (|q| <= 127) as its fragment is built from the shared tile, and
// its per-column scale multiplies the fp32 sum. mma.sync rather than
// wgmma because M is at most 64 and usually 32: wgmma's 64-row tile (or,
// operands swapped, an N of M padded to 8 and W^T as the K-major A tile)
// buys nothing when bytes bound every shape, and the m16n8k16 fragments
// let an int8 W tile be widened in registers with no second shared copy.
// A block owns a 64-column tile and one K slice of whole 64-row k-steps:
// 4 warps of 16 columns, a 4-stage cp.async ring of the W tile (8 KB of
// bf16, 4 KB of int8) and the matching x slice. Split-K fills the card:
// the wrapper's stream_plan chooses the split from the shapes and the SM
// count (about two blocks an SM, at most 16 slices of at least two
// k-steps), so O-proj and FFN2 (N = 2048, 32 column tiles) run 256-288
// blocks, each with 32 KB of W in flight. With more than one slice each
// block writes its fp32 partial to a workspace, takes a ticket from its
// column tile's counter after a fence, and the tile's last block sums
// the partials in split order (the same bits whichever block comes
// last), applies scale, bias, activation and residual, stores the
// result and sets the counter back to 0 for the next launch: one launch,
// no memset. With one slice (the LM head: 800 column tiles) the
// epilogue runs from registers.
//
// fp32 x (the CPU-parity dtype) keeps the CUDA-core kernel
// (stream_linear_kernel): a block owns a strip of 32 output columns and
// walks all of K in tiles of BK rows (8 KB of W: 64 rows for f32; an int8
// W tile of the same BK is a quarter of that) through a 4-stage cp.async
// ring, 4x4 register tiles per thread, k-groups whose partial sums meet
// in shared memory, fp32 FMAs.
//
// Bound: bytes — the W stream (x, bias and residual are tiny beside it).
// QKV of the d2048 model is 25.2 MB of bf16, 7.5 us at 3.35 TB/s (int8:
// 12.6 MB, 3.8 us); the LM head 209.7 MB, 62.6 us; a layer's tail (four
// GEMMs) 100.7 MB, 30 us.
#include "common.cuh"

namespace {

using ptt::activate;
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

// the k-group partials' meeting place: [kgroups][rows_pad][kBN] floats,
// kgroups * rows_pad = 128 at every row count
constexpr int kRedBytes = kThreads / kColGroups * kTM * kBN * 4;

struct GemmParams {
  const void* x;
  const void* w;
  const void* scale;
  const void* bias;
  const void* res;
  void* out;
  int scale_dt, bias_dt, res_dt, out_dt;
  int M, K, N, act;
  int rg_log2;  // log2 of the 4-row groups a block covers
};

// x of type TX, w of type TW (TX, or int8)
template <typename TX, typename TW>
struct Tile {
  static constexpr int kXVec = 16 / sizeof(TX);  // elements per 16 bytes
  static constexpr int kWVec = 16 / sizeof(TW);
  static constexpr int kBK = kTileBytes / (kBN * sizeof(TX));
  static constexpr int kWStageBytes = kBK * kBN * sizeof(TW);
  static constexpr int kXPitch = kBK + kXPadBytes / sizeof(TX);
};

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
    stream_linear_kernel(const GemmParams p) {
  using C = Tile<TX, TW>;
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
  TW* sw = reinterpret_cast<TW*>(smem);  // [kStages][kBK][kBN]
  // [kStages][rows_pad][kXPitch]; 16-byte aligned (kWStageBytes is)
  TX* sx = reinterpret_cast<TX*>(smem + kStages * C::kWStageBytes);
  const TW* w = static_cast<const TW*>(p.w);
  const TX* x = static_cast<const TX*>(p.x);

  auto load_tile = [&](int t, int s) {
    const int k0 = t * C::kBK;
    constexpr int wc = kBN / C::kWVec;  // 16-byte chunks per W tile row
    for (int c = tid; c < C::kBK * wc; c += kThreads) {
      const int r = c / wc, cc = (c % wc) * C::kWVec;
      const int k = k0 + r, n = n0 + cc;
      const bool ok = k < p.K && n < p.N;
      ptt::cp_async16(sw + s * w_stage + r * kBN + cc,
                      ok ? w + static_cast<int64_t>(k) * p.N + n : w,
                      ok ? 16 : 0);
    }
    constexpr int xc = C::kBK / C::kXVec;  // 16-byte chunks per x row
    for (int c = tid; c < rows_pad * xc; c += kThreads) {
      const int r = c / xc, kk = (c % xc) * C::kXVec;
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
    const TW* tw = sw + (t % kStages) * w_stage + cg * kTN;
    const TX* tx = sx + (t % kStages) * x_stage + rg * kTM * C::kXPitch;
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

  // k-group partials meet in shared memory (kRedBytes, over the stage
  // ring)
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
    if (p.scale) v *= load_dt(p.scale, n, p.scale_dt);
    if (p.bias) v += load_dt(p.bias, n, p.bias_dt);
    v = activate(v, p.act);
    const int64_t idx = static_cast<int64_t>(m0 + r) * p.N + n;
    if (p.res) v += load_dt(p.res, idx, p.res_dt);
    store_dt(p.out, idx, p.out_dt, v);
  }
}

template <typename TX, typename TW>
size_t gemm_smem(int rows_pad) {
  using C = Tile<TX, TW>;
  const size_t ring =
      kStages * (C::kWStageBytes +
                 static_cast<size_t>(rows_pad) * C::kXPitch * sizeof(TX));
  return ring > kRedBytes ? ring : kRedBytes;
}

template <typename TX, typename TW>
int launch_gemm(GemmParams p, cudaStream_t stream) {
  const int rows = p.M < kMaxRows ? p.M : kMaxRows;
  int rg_log2 = 0;
  while ((1 << rg_log2) * kTM < rows) ++rg_log2;
  p.rg_log2 = rg_log2;
  const int rows_pad = (1 << rg_log2) * kTM;
  cudaError_t err = cudaFuncSetAttribute(
      stream_linear_kernel<TX, TW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(gemm_smem<TX, TW>(kMaxRows)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kMaxRows - 1) / kMaxRows);
  stream_linear_kernel<TX, TW>
      <<<grid, kThreads, gemm_smem<TX, TW>(rows_pad), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------ bf16 x: tensor cores and split-K

constexpr int kMmaBN = 64;            // output columns per block
constexpr int kMmaThreads = kMmaBN * 2;  // a warp for each 16 columns
constexpr int kMmaBK = 64;            // K rows per k-step
constexpr int kMmaRows = 64;          // rows per block; grid.z covers more
constexpr int kXPitchH = kMmaBK + 8;  // bf16 x row in shared memory, 144 B

struct MmaParams {
  const void* x;
  const void* w;
  const void* scale;
  const void* bias;
  const void* res;
  void* out;
  float* ws;      // [split][M][N] fp32 partials (split > 1)
  int* counters;  // a ticket per (row block, column tile), 0 between calls
  int scale_dt, bias_dt, res_dt, out_dt;
  int M, K, N, act;
  int split, steps;  // K slices, and k-steps in each
};

// the W tile [kMmaBK][kWPitch] of TW: 144-byte rows for bf16, 80-byte
// rows for int8 (16 bytes of padding: ldmatrix and byte reads free of
// bank conflicts)
template <typename TW>
struct MmaTile {
  static constexpr int kWPitch = kMmaBN + 16 / static_cast<int>(sizeof(TW));
  static constexpr int kWStage = kMmaBK * kWPitch * sizeof(TW);  // bytes
  static constexpr int kSmemMax =
      kStages * (kWStage + kMmaRows * kXPitchH * 2);
};

// B fragments of the warp's two n8 tiles (columns nb.. nb+15) at k16 step
// ks: bf16 by ldmatrix.trans from the [k][n] tile ...
__device__ __forceinline__ void w_frags(const __nv_bfloat16* ws, int ks,
                                        int nb, uint32_t (&b)[2][2]) {
  const int lane = threadIdx.x % 32;
  const int krow = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int ncol = nb + (lane >> 4) * 8;
  ptt::ldmatrix_x4_trans(b[0][0], b[0][1], b[1][0], b[1][1],
                         ws + krow * MmaTile<__nv_bfloat16>::kWPitch + ncol);
}

__device__ __forceinline__ uint32_t bf16x2(int8_t lo, int8_t hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(lo),
                                           static_cast<float>(hi));  // exact
  return *reinterpret_cast<uint32_t*>(&v);
}

// ... int8 widened to bf16 as the fragment is built: lane l holds k rows
// 2(l%4), +1 (and +8, +9) of column l/4
__device__ __forceinline__ void w_frags(const int8_t* ws, int ks, int nb,
                                        uint32_t (&b)[2][2]) {
  constexpr int P = MmaTile<int8_t>::kWPitch;
  const int lane = threadIdx.x % 32;
  const int k = ks * 16 + (lane & 3) * 2;
#pragma unroll
  for (int nj = 0; nj < 2; ++nj) {
    const int n = nb + nj * 8 + lane / 4;
    b[nj][0] = bf16x2(ws[k * P + n], ws[(k + 1) * P + n]);
    b[nj][1] = bf16x2(ws[(k + 8) * P + n], ws[(k + 9) * P + n]);
  }
}

// scale, bias, activation, residual (stream_linear.py:410-414), then out
__device__ __forceinline__ void finish(const MmaParams& p, int r, int n,
                                       float v) {
  if (p.scale) v *= load_dt(p.scale, n, p.scale_dt);
  if (p.bias) v += load_dt(p.bias, n, p.bias_dt);
  v = activate(v, p.act);
  const int64_t idx = static_cast<int64_t>(r) * p.N + n;
  if (p.res) v += load_dt(p.res, idx, p.res_dt);
  store_dt(p.out, idx, p.out_dt, v);
}

// Block (column tile, K slice, row block).
template <typename TW>
__global__ void __launch_bounds__(kMmaThreads)
    stream_gemm_mma(const MmaParams p) {
  using C = MmaTile<TW>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ticket;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kMmaBN, slice = blockIdx.y;
  const int m0 = blockIdx.z * kMmaRows;
  const int rows = min(kMmaRows, p.M - m0);
  const int groups = (rows + 15) / 16;  // m16 groups with live rows
  const int kt0 = slice * p.steps;
  const int nk = min(p.steps, (p.K + kMmaBK - 1) / kMmaBK - kt0);
  const int x_stage = groups * 16 * kXPitchH;  // elements
  unsigned char* sw = smem;                     // [kStages] W tiles
  __nv_bfloat16* sx =
      reinterpret_cast<__nv_bfloat16*>(smem + kStages * C::kWStage);
  const TW* w = static_cast<const TW*>(p.w);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);

  auto load = [&](int t, int s) {
    const int k0 = (kt0 + t) * kMmaBK;
    constexpr int wv = 16 / static_cast<int>(sizeof(TW));
    constexpr int wc = kMmaBN / wv;  // 16-byte chunks per W row
    TW* dw = reinterpret_cast<TW*>(sw + s * C::kWStage);
    for (int c = tid; c < kMmaBK * wc; c += kMmaThreads) {
      const int r = c / wc, cc = (c % wc) * wv;
      const int k = k0 + r, n = n0 + cc;
      const bool ok = k < p.K && n < p.N;
      ptt::cp_async16(dw + r * C::kWPitch + cc,
                      ok ? w + static_cast<int64_t>(k) * p.N + n : w,
                      ok ? 16 : 0);
    }
    constexpr int xc = kMmaBK / 8;  // 16-byte chunks per x row
    __nv_bfloat16* dx = sx + s * x_stage;
    for (int c = tid; c < groups * 16 * xc; c += kMmaThreads) {
      const int r = c / xc, kk = (c % xc) * 8;
      const int k = k0 + kk;
      const bool ok = r < rows && k < p.K;
      ptt::cp_async16(dx + r * kXPitchH + kk,
                      ok ? x + static_cast<int64_t>(m0 + r) * p.K + k : x,
                      ok ? 16 : 0);
    }
  };

  float acc[4][2][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    ptt::cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    ptt::cp_async_wait<kStages - 2>();  // k-step t has landed
    __syncthreads();  // ... for every thread; the stage of t-1 is free
    const int nt = t + kStages - 1;
    if (nt < nk) load(nt, nt % kStages);
    ptt::cp_async_commit();
    const TW* tw =
        reinterpret_cast<const TW*>(sw + (t % kStages) * C::kWStage);
    const __nv_bfloat16* tx = sx + (t % kStages) * x_stage;
#pragma unroll
    for (int ks = 0; ks < kMmaBK / 16; ++ks) {
      uint32_t b[2][2];
      w_frags(tw, ks, warp * 16, b);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        if (mi >= groups) continue;  // block-uniform
        uint32_t a0, a1, a2, a3;
        ptt::ldmatrix_x4(a0, a1, a2, a3,
                         tx + (mi * 16 + (lane & 15)) * kXPitchH + ks * 16 +
                             (lane >> 4) * 8);
        ptt::mma_bf16(acc[mi][0], a0, a1, a2, a3, b[0][0], b[0][1]);
        ptt::mma_bf16(acc[mi][1], a0, a1, a2, a3, b[1][0], b[1][1]);
      }
    }
  }
  ptt::cp_async_wait<0>();

  // fragment (mi, nj, 2h + e): row 16 mi + l/4 + 8h, column 8 nj + 2(l%4) + e
  const int g8 = lane / 4, t4 = lane % 4;
  if (p.split == 1) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mi * 16 + g8 + h * 8;
          const int n = n0 + warp * 16 + nj * 8 + t4 * 2;
          if (r >= rows || n >= p.N) continue;
          finish(p, m0 + r, n, acc[mi][nj][2 * h]);
          finish(p, m0 + r, n + 1, acc[mi][nj][2 * h + 1]);
        }
    return;
  }
  // this slice's partial; N % 8 == 0, so a column pair is in or out
  float* part = p.ws + static_cast<int64_t>(slice) * p.M * p.N;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mi * 16 + g8 + h * 8;
        const int n = n0 + warp * 16 + nj * 8 + t4 * 2;
        if (r >= rows || n >= p.N) continue;
        *reinterpret_cast<float2*>(
            part + static_cast<int64_t>(m0 + r) * p.N + n) =
            make_float2(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
      }
  __threadfence();
  __syncthreads();
  const int cid = blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) ticket = atomicAdd(p.counters + cid, 1);
  __syncthreads();
  if (ticket != p.split - 1) return;
  __threadfence();  // every partial of the tile is visible

  // the tile's last block: partials summed in split order, 4 columns a
  // thread
  const int quads = min(kMmaBN, p.N - n0) / 4;
  const int64_t plane = static_cast<int64_t>(p.M) * p.N;
  for (int i = tid; i < rows * quads; i += kMmaThreads) {
    const int r = i / quads, c = (i % quads) * 4;
    const int64_t o = static_cast<int64_t>(m0 + r) * p.N + n0 + c;
    float4 v = __ldcg(reinterpret_cast<const float4*>(p.ws + o));
    for (int s = 1; s < p.split; ++s) {
      const float4 q =
          __ldcg(reinterpret_cast<const float4*>(p.ws + s * plane + o));
      v.x += q.x;
      v.y += q.y;
      v.z += q.z;
      v.w += q.w;
    }
    finish(p, m0 + r, n0 + c, v.x);
    finish(p, m0 + r, n0 + c + 1, v.y);
    finish(p, m0 + r, n0 + c + 2, v.z);
    finish(p, m0 + r, n0 + c + 3, v.w);
  }
  if (tid == 0) p.counters[cid] = 0;  // ready for the next launch
}

template <typename TW>
int launch_mma(const MmaParams& p, cudaStream_t stream) {
  using C = MmaTile<TW>;
  const int nk = (p.K + kMmaBK - 1) / kMmaBK;
  const int wv = 16 / static_cast<int>(sizeof(TW));
  if (p.split < 1 || p.steps < 1 || p.split > 65535 ||
      static_cast<int64_t>(p.split - 1) * p.steps >= nk ||
      static_cast<int64_t>(p.split) * p.steps < nk || p.K % 8 ||
      p.N % 8 || p.N % wv || (p.split > 1 && (!p.ws || !p.counters)))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set[64] = {};  // per device, set once
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !attr_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        stream_gemm_mma<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmemMax);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) attr_set[dev] = true;
  }
  const int rows = p.M < kMmaRows ? p.M : kMmaRows;
  const size_t smem =
      kStages * (C::kWStage + static_cast<size_t>((rows + 15) / 16) * 16 *
                                  kXPitchH * 2);
  const dim3 grid((p.N + kMmaBN - 1) / kMmaBN, p.split,
                  (p.M + kMmaRows - 1) / kMmaRows);
  stream_gemm_mma<TW><<<grid, kMmaThreads, smem, stream>>>(p);
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

// Returns the cudaError_t of the launch. x [M, K] (of `dtype`) and w
// [K, N] (of `w_dt`: `dtype`, or int8) are contiguous and 16-byte
// aligned, with K a multiple of 8 (bf16 x) or 4 (float32 x) and N a
// multiple of 16 bytes of w (and of 8 for bf16 x). scale [N], bias [N],
// residual [M, N] may be null and, like out [M, N], carry their own dtype
// codes. bf16 x: `split` K slices of `steps` 64-row k-steps (the
// wrapper's stream_plan); with split > 1, ws holds split * M * N floats
// and counters one int per (row block, column tile), all 0 between
// calls. float32 x ignores ws, counters, split and steps.
extern "C" int ptt_stream_linear(const void* x, const void* w, int w_dt,
                                 const void* scale, int scale_dt,
                                 const void* bias, int bias_dt,
                                 const void* residual, int residual_dt,
                                 void* out, int out_dt, int dtype, int M,
                                 int K, int N, int activation, float* ws,
                                 int* counters, int split, int steps,
                                 void* stream) {
  if (M == 0 || N == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool w8 = w_dt == ptt::kI8;
  if (!w8 && w_dt != dtype) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == ptt::kBF16) {
    const MmaParams p{x,        w,        scale,    bias,   residual,
                      out,      ws,       counters, scale_dt, bias_dt,
                      residual_dt, out_dt, M,       K,      N,
                      activation, split,  steps};
    return w8 ? launch_mma<int8_t>(p, st) : launch_mma<__nv_bfloat16>(p, st);
  }
  const GemmParams p{x,        w,      scale,   bias,        residual,
                     out,      scale_dt, bias_dt, residual_dt, out_dt,
                     M,        K,      N,       activation,  0};
  if (dtype == ptt::kF32)
    return w8 ? launch_gemm<float, int8_t>(p, st)
              : launch_gemm<float, float>(p, st);
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
