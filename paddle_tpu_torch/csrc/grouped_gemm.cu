// Ragged grouped GEMM (MoE expert FFN) and the batched-LoRA delta, two
// entry points over one unit walk.
//
// ptt_grouped_gemm replaces the TPU kernel _grouped_fwd_pallas
// (paddle_tpu/nn/functional/grouped_gemm.py:170, pallas_call at :218);
// ptt_lora_delta replaces _lora_fwd_pallas
// (paddle_tpu/nn/functional/lora.py:99, pallas_call at :152).
// Python wrappers: paddle_tpu_torch/nn/functional/grouped_gemm.py and
// lora.py.
//
// What they compute. The rows of x [T, K] are sorted by group (an expert,
// or an adapter slot): group e owns rows offsets[e] .. offsets[e+1]-1,
// and rows from offsets[E] to T belong to no group.
//   grouped GEMM:  out[r] = act(x[r] @ W[e(r)] + bias[e(r)])   W [E, K, N]
//   LoRA delta:    out[r] = (x[r] @ A[s(r)]) @ B[s(r)]         A [S, K, R],
//                                                              B [S, R, N]
// with fp32 sums (the grouped GEMM's W is in x's dtype; the delta rounds
// A to x's dtype and takes B in fp32, as the TPU kernels do); rows past
// offsets[E] are written as exact zeros. The work map of the TPU kernel
// (grouped_work_map: unit u is row tile tids[u] of kBM rows against
// group gids[u], live rows [lo[u], hi[u])) has t_pad/kBM + 2E + 1 units,
// a number of shapes only, so the grid needs nothing from the host: each
// block decodes its own unit from offsets[] (unit_at, the same integers
// as grouped_work_map; ptt_grouped_work_map writes them out for the
// check). No map is built between launches.
//
// Design. The TPU kernel accumulates o_ref += over the consecutive units
// of an output tile because its 128-row tiles can be split by a group
// boundary. Here a block is one (unit, column strip) and computes only
// the unit's live rows, each of which has exactly one owner: it writes
// each output row once, with no accumulation across blocks and no
// atomics. The first unit of each tile also writes the zero rows of its
// tile from offsets[E] on; every tile has a first unit, and no live row
// lies past offsets[E], so every row is written exactly once.
//
// The grouped GEMM: a 64 x 64 output tile per block, 4 warps of 32 x 32,
// K in steps of 64 bytes through a 4-stage cp.async ring in shared memory
// (x rows outside the unit's live 16-row groups are not loaded). bf16
// runs on the tensor cores (mma.sync m16n8k16 with fp32 accumulators,
// fragments by ldmatrix, W's by ldmatrix.trans from its [K, N] tile);
// m16 row groups without a live row are skipped, so a decode unit of 8
// live rows costs one m16 group. fp32 runs the same tiles on the CUDA
// cores (a 4 x 8 register tile per thread), exact fp32 products. Then
// + bias (fp32), tanh-GELU or ReLU, the output dtype.
//
// The LoRA delta: a block of 512 threads is one (unit, 512-column strip).
// Phase 1, h = x @ A[s] for the unit's live rows, 8 rows at a time: each
// of the 16 warps takes one sixteenth of K, its lanes stride that slice
// and hold a row's R (<= 32) fp32 partial sums, reduced over the warp by
// shuffles; the warps' partials meet in shared memory and are summed in
// warp order into h [64][32]. Phase 2: each thread owns a column n, keeps
// B[s][:, n] in registers and writes h[r] @ B[s][:, n] for the live rows.
// Phase 1 is repeated by every strip of the unit (its reads, x rows and
// A[s], come from L2 after the first strip): wide strips keep the
// repeats few, and many warps per block keep each one short.
//
// Bounds. The grouped GEMM at decode (64 rows over 8 experts) reads every
// active expert's W once: bytes bound it, 8 x 2 x 4 MB = 67 MB per FFN of
// the d1024 MoE model, 20 us at 3.35 TB/s; at prefill (8192 rows) the
// bf16 tensor-core operations do (69 GFLOP, 69 us per FFN at 989
// TFLOP/s). mma.sync from a cp.async ring reaches a fraction of that;
// wgmma with TMA loads and a persistent schedule are the later work. The
// LoRA delta is small against the base GEMM: x, A and B are read once
// (bytes), and its phase 1 is latency bound at decode (K up to 8192
// summed by 32 lanes per row); a delta fused into the base GEMM's
// epilogue is the later design.
#include "common.cuh"

namespace {

using ptt::activate;
using ptt::ldmatrix_x4;
using ptt::ldmatrix_x4_trans;
using ptt::mma_bf16;
using ptt::load_dt;
using ptt::store_dt;

constexpr int kBM = 64;       // rows per unit tile (the wrapper's bm)
constexpr int kBN = 64;       // output columns per grouped-GEMM block
constexpr int kThreads = 128;
constexpr int kStages = 4;
constexpr int kRowBytes = 64;  // bytes of K per tile row and stage

template <typename T>
struct Geo {
  static constexpr int kBK = kRowBytes / sizeof(T);     // 32 bf16, 16 f32
  static constexpr int kVec = 16 / sizeof(T);           // per 16 bytes
  static constexpr int kXPitch = kBK + 16 / sizeof(T);  // 80-byte rows
  static constexpr int kWPitch = kBN + 16 / sizeof(T);  // 144/272 bytes
  static constexpr int kXStage = kBM * kXPitch;         // elements
  static constexpr int kWStage = kBK * kWPitch;
  static constexpr int kSmemBytes =
      kStages * (kXStage + kWStage) * static_cast<int>(sizeof(T));
};

struct GroupedParams {
  const void* x;
  const void* w;
  const void* bias;
  const int* offsets;
  void* out;
  int bias_dt, out_dt;
  int T, K, N, E, nm, act;
};

// Unit u of the work map over offsets[0..E] and nm row tiles, as
// grouped_work_map computes it: per interval i of E real ones and the
// phantom [offsets[E], nm*kBM), tiles t_lo(i) .. t_hi(i) (at least one
// for a real interval); units walk the intervals in order; units past
// the last alias the last tile with an empty mask.
struct Unit {
  int gid, tid, lo, hi;
};

__device__ __forceinline__ Unit unit_at(const int* offsets, int E, int nm,
                                        int u) {
  const int t_pad = nm * kBM;
  int start = 0;
  for (int i = 0; i <= E; ++i) {
    const int a = offsets[i], b = i < E ? offsets[i + 1] : t_pad;
    const int t_lo = a / kBM, t_hi = (b + kBM - 1) / kBM;
    int count = max(t_hi - t_lo, 0);
    if (i < E) count = max(count, 1);
    if (u < start + count) {
      const Unit real{min(i, E - 1), min(max(t_lo + (u - start), 0), nm - 1),
                      a, b};
      return i < E ? real : Unit{E - 1, real.tid, 0, 0};
    }
    start += count;
  }
  return Unit{E - 1, nm - 1, 0, 0};  // past the last unit
}

// The tile's rows past offsets[E], written as zeros by the tile's first
// unit, over columns [n0, n0 + bn).
__device__ __forceinline__ void zero_dead_rows(const int* offsets, int E,
                                               int nm, int u, int T, int N,
                                               int n0, int bn, void* out,
                                               int out_dt) {
  const int tile = unit_at(offsets, E, nm, u).tid;
  if (u > 0 && unit_at(offsets, E, nm, u - 1).tid == tile) return;
  const int t1 = min((tile + 1) * kBM, T);
  const int z0 = max(offsets[E], tile * kBM);
  const int cols = min(bn, N - n0);
  for (int i = threadIdx.x; i < (t1 - z0) * cols; i += blockDim.x) {
    const int r = z0 + i / cols, n = n0 + i % cols;
    store_dt(out, static_cast<int64_t>(r) * N + n, out_dt, 0.f);
  }
}

template <typename T>
__device__ __forceinline__ void load_stage(const GroupedParams& p, T* sx,
                                           T* sw, int kt, int t0, int r0,
                                           int r1, int m_lo, int m_hi,
                                           int n0, int g) {
  using G = Geo<T>;
  const int k0 = kt * G::kBK;
  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w) +
               static_cast<int64_t>(g) * p.K * p.N;
  constexpr int xc = G::kBK / G::kVec;  // 16-byte chunks per x tile row
  for (int c = threadIdx.x; c < (m_hi - m_lo) * xc; c += kThreads) {
    const int lr = m_lo + c / xc, kk = (c % xc) * G::kVec;
    const int r = t0 + lr, k = k0 + kk;
    const bool ok = r >= r0 && r < r1 && k < p.K;
    ptt::cp_async16(sx + lr * G::kXPitch + kk,
                    ok ? x + static_cast<int64_t>(r) * p.K + k : x,
                    ok ? 16 : 0);
  }
  constexpr int wc = kBN / G::kVec;  // 16-byte chunks per W tile row
  for (int c = threadIdx.x; c < G::kBK * wc; c += kThreads) {
    const int kk = c / wc, nn = (c % wc) * G::kVec;
    const int k = k0 + kk, n = n0 + nn;
    const bool ok = k < p.K && n < p.N;
    ptt::cp_async16(sw + kk * G::kWPitch + nn,
                    ok ? w + static_cast<int64_t>(k) * p.N + n : w,
                    ok ? 16 : 0);
  }
}

__device__ __forceinline__ float epilogue(const GroupedParams& p, int g,
                                          int n, float v) {
  if (p.bias != nullptr)
    v += load_dt(p.bias, static_cast<int64_t>(g) * p.N + n, p.bias_dt);
  return activate(v, p.act);
}

// bf16: tensor-core tiles. Warp (wm, wn) owns rows wm*32.. and columns
// wn*32.. of the block's 64 x 64 tile.
__device__ __forceinline__ void compute_tile(
    const __nv_bfloat16* xs, const __nv_bfloat16* ws, int m_lo, int m_hi,
    float (&acc)[2][4][4]) {
  using G = Geo<__nv_bfloat16>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  if (wm * 32 >= m_hi || wm * 32 + 32 <= m_lo) return;  // warp-uniform
#pragma unroll
  for (int ks = 0; ks < G::kBK / 16; ++ks) {
    uint32_t b[4][2];
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int krow = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int ncol = wn * 32 + np * 16 + (lane >> 4) * 8;
      ldmatrix_x4_trans(b[2 * np][0], b[2 * np][1], b[2 * np + 1][0],
                        b[2 * np + 1][1], ws + krow * G::kWPitch + ncol);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int mb = wm * 32 + mi * 16;
      if (mb + 16 <= m_lo || mb >= m_hi) continue;  // warp-uniform
      uint32_t a0, a1, a2, a3;
      ldmatrix_x4(a0, a1, a2, a3,
                  xs + (mb + (lane & 15)) * G::kXPitch + ks * 16 +
                      (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
        mma_bf16(acc[mi][nj], a0, a1, a2, a3, b[nj][0], b[nj][1]);
    }
  }
}

__device__ __forceinline__ void store_tile(const GroupedParams& p,
                                           const float (&acc)[2][4][4],
                                           int g, int t0, int r0, int r1,
                                           int n0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = t0 + wm * 32 + mi * 16 + gq + h * 8;
        if (r < r0 || r >= r1) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + nj * 8 + tq * 2 + e;
          if (n >= p.N) continue;
          store_dt(p.out, static_cast<int64_t>(r) * p.N + n, p.out_dt,
                   epilogue(p, g, n, acc[mi][nj][h * 2 + e]));
        }
      }
}

// fp32: the same tiles on the CUDA cores; thread (rg, cg) owns rows
// rg*4.. and columns cg*8.. of the 64 x 64 tile.
__device__ __forceinline__ void compute_tile(const float* xs,
                                             const float* ws, int m_lo,
                                             int m_hi, float (&acc)[4][8]) {
  using G = Geo<float>;
  const int rg = threadIdx.x / 8, cg = threadIdx.x % 8;
  if (rg * 4 >= m_hi || rg * 4 + 4 <= m_lo) return;
#pragma unroll
  for (int kk = 0; kk < G::kBK; ++kk) {
    const float4 b0 =
        *reinterpret_cast<const float4*>(ws + kk * G::kWPitch + cg * 8);
    const float4 b1 =
        *reinterpret_cast<const float4*>(ws + kk * G::kWPitch + cg * 8 + 4);
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = xs[(rg * 4 + i) * G::kXPitch + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void store_tile(const GroupedParams& p,
                                           const float (&acc)[4][8], int g,
                                           int t0, int r0, int r1, int n0) {
  const int rg = threadIdx.x / 8, cg = threadIdx.x % 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = t0 + rg * 4 + i;
    if (r < r0 || r >= r1) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + cg * 8 + j;
      if (n >= p.N) continue;
      store_dt(p.out, static_cast<int64_t>(r) * p.N + n, p.out_dt,
               epilogue(p, g, n, acc[i][j]));
    }
  }
}

template <typename T>
struct Acc;
template <>
struct Acc<__nv_bfloat16> {
  float v[2][4][4];
};
template <>
struct Acc<float> {
  float v[4][8];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    grouped_gemm_kernel(const GroupedParams p) {
  using G = Geo<T>;
  __shared__ __align__(16) unsigned char smem[G::kSmemBytes];
  T* sx = reinterpret_cast<T*>(smem);            // [kStages][kXStage]
  T* sw = sx + kStages * G::kXStage;             // [kStages][kWStage]
  const int u = blockIdx.y;
  const int n0 = blockIdx.x * kBN;
  zero_dead_rows(p.offsets, p.E, p.nm, u, p.T, p.N, n0, kBN, p.out,
                 p.out_dt);
  const Unit un = unit_at(p.offsets, p.E, p.nm, u);
  const int t0 = un.tid * kBM;
  const int r0 = max(un.lo, t0);
  const int r1 = min(min(un.hi, t0 + kBM), p.T);
  if (r1 <= r0) return;
  const int g = un.gid;
  // the 16-row groups of the tile that hold live rows
  const int m_lo = (r0 - t0) / 16 * 16;
  const int m_hi = min(kBM, (r1 - t0 + 15) / 16 * 16);
  Acc<T> acc{};
  const int nk = (p.K + G::kBK - 1) / G::kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage<T>(p, sx + s * G::kXStage, sw + s * G::kWStage, s, t0, r0,
                    r1, m_lo, m_hi, n0, g);
    ptt::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    ptt::cp_async_wait<kStages - 2>();
    __syncthreads();
    // the stage computed at kt - 1 is free once every thread is here
    const int nt = kt + kStages - 1;
    if (nt < nk)
      load_stage<T>(p, sx + (nt % kStages) * G::kXStage,
                    sw + (nt % kStages) * G::kWStage, nt, t0, r0, r1, m_lo,
                    m_hi, n0, g);
    ptt::cp_async_commit();
    const int s = kt % kStages;
    compute_tile(sx + s * G::kXStage, sw + s * G::kWStage, m_lo, m_hi,
                 acc.v);
  }
  ptt::cp_async_wait<0>();
  store_tile(p, acc.v, g, t0, r0, r1, n0);
}

// ------------------------------------------------------------ LoRA delta

constexpr int kLoraThreads = 512;
constexpr int kLoraBN = kLoraThreads;  // one output column per thread
constexpr int kMaxRank = 32;

struct LoraParams {
  const void* x;
  const void* a;
  const void* b;
  const int* offsets;
  void* out;
  int out_dt;
  int T, K, N, S, R, nm;
};

// a value of A as the TPU kernel multiplies it: rounded to x's dtype
template <typename TX>
__device__ __forceinline__ float as_x_dtype(float v);
template <>
__device__ __forceinline__ float as_x_dtype<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float as_x_dtype<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int kLoraWarps = kLoraThreads / 32;
constexpr int kPassRows = 8;  // live rows per phase-1 pass

template <typename TX, typename TA>
__global__ void __launch_bounds__(kLoraThreads, 1)
    lora_delta_kernel(const LoraParams p) {
  __shared__ float h[kBM][kMaxRank];
  __shared__ float part[kLoraWarps][kPassRows][kMaxRank];
  const int u = blockIdx.y;
  const int n0 = blockIdx.x * kLoraBN;
  zero_dead_rows(p.offsets, p.S, p.nm, u, p.T, p.N, n0, kLoraBN, p.out,
                 p.out_dt);
  const Unit un = unit_at(p.offsets, p.S, p.nm, u);
  const int t0 = un.tid * kBM;
  const int r0 = max(un.lo, t0);
  const int r1 = min(min(un.hi, t0 + kBM), p.T);
  if (r1 <= r0) return;
  const int s = un.gid;
  const TX* x = static_cast<const TX*>(p.x);
  const TA* a = static_cast<const TA*>(p.a) +
                static_cast<int64_t>(s) * p.K * p.R;
  const TA* bs = static_cast<const TA*>(p.b) +
                 static_cast<int64_t>(s) * p.R * p.N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // phase 1: h[r] = x[r] @ A[s]; warp w sums K slice [kb, ke)
  const int slice = (p.K + kLoraThreads - 1) / kLoraThreads * 32;
  const int kb = warp * slice, ke = min(p.K, kb + slice);
  for (int pr = r0; pr < r1; pr += kPassRows) {
    const int nr = min(kPassRows, r1 - pr);
    for (int i = 0; i < nr; ++i) {
      float acc[kMaxRank];
#pragma unroll
      for (int j = 0; j < kMaxRank; ++j) acc[j] = 0.f;
      const TX* xr = x + static_cast<int64_t>(pr + i) * p.K;
#pragma unroll 4
      for (int k = kb + lane; k < ke; k += 32) {
        const float xv = ptt::to_f32(xr[k]);
        const TA* ar = a + static_cast<int64_t>(k) * p.R;
#pragma unroll
        for (int j = 0; j < kMaxRank; ++j)
          if (j < p.R)
            acc[j] = fmaf(xv, as_x_dtype<TX>(ptt::to_f32(ar[j])), acc[j]);
      }
#pragma unroll
      for (int j = 0; j < kMaxRank; ++j)
        if (j < p.R) {
          const float v = ptt::warp_sum(acc[j]);
          if (lane == 0) part[warp][i][j] = v;
        }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nr * p.R; e += kLoraThreads) {
      const int i = e / p.R, j = e % p.R;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kLoraWarps; ++w) v += part[w][i][j];
      h[pr + i - t0][j] = v;
    }
    __syncthreads();
  }
  // phase 2: out[r][n] = h[r] @ B[s][:, n], B in fp32
  const int n = n0 + threadIdx.x;
  if (n >= p.N) return;
  float bv[kMaxRank];
#pragma unroll
  for (int j = 0; j < kMaxRank; ++j)
    bv[j] = j < p.R ? ptt::to_f32(bs[static_cast<int64_t>(j) * p.N + n])
                    : 0.f;
  for (int r = r0; r < r1; ++r) {
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxRank; ++j)
      if (j < p.R) v = fmaf(h[r - t0][j], bv[j], v);
    store_dt(p.out, static_cast<int64_t>(r) * p.N + n, p.out_dt, v);
  }
}

__global__ void work_map_kernel(const int* offsets, int E, int nm, int nwu,
                                int* gids, int* tids, int* lo, int* hi) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= nwu) return;
  const Unit un = unit_at(offsets, E, nm, u);
  gids[u] = un.gid;
  tids[u] = un.tid;
  lo[u] = un.lo;
  hi[u] = un.hi;
}

}  // namespace

// the units the kernels walk (for the check against grouped_work_map)
extern "C" int ptt_grouped_work_map(const int* offsets, int E, int nm,
                                    int bm, int* gids, int* tids, int* lo,
                                    int* hi, void* stream) {
  if (bm != kBM || E < 1 || nm < 1) return cudaErrorInvalidValue;
  const int nwu = nm + 2 * E + 1;
  work_map_kernel<<<(nwu + 127) / 128, 128, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      offsets, E, nm, nwu, gids, tids, lo, hi);
  return cudaGetLastError();
}

extern "C" int ptt_grouped_gemm(const void* x, const void* w,
                                const void* bias, int bias_dt,
                                const int* offsets, void* out, int out_dt,
                                int dtype, int T, int K, int N, int E,
                                int bm, int act, void* stream) {
  const int nm = (T + kBM - 1) / kBM, nwu = nm + 2 * E + 1;
  if (bm != kBM || nwu > 65535 || E < 1 || T < 1)
    return cudaErrorInvalidValue;
  GroupedParams p{x, w, bias, offsets, out, bias_dt, out_dt,
                  T, K, N, E, nm, act};
  const dim3 grid((N + kBN - 1) / kBN, nwu);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16)
    grouped_gemm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(p);
  else if (dtype == ptt::kF32)
    grouped_gemm_kernel<float><<<grid, kThreads, 0, s>>>(p);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

extern "C" int ptt_lora_delta(const void* x, int x_dt, const void* a,
                              int a_dt, const void* b, int b_dt,
                              const int* offsets, void* out, int out_dt,
                              int T, int K, int N, int S, int R, int bm,
                              void* stream) {
  const int nm = (T + kBM - 1) / kBM, nwu = nm + 2 * S + 1;
  if (bm != kBM || nwu > 65535 || S < 1 || T < 1 || R < 1 ||
      R > kMaxRank || a_dt != b_dt)
    return cudaErrorInvalidValue;
  LoraParams p{x, a, b, offsets, out, out_dt, T, K, N, S, R, nm};
  const dim3 grid((N + kLoraBN - 1) / kLoraBN, nwu);
  auto s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_dt == ptt::kBF16 && a_dt == ptt::kBF16)
    lora_delta_kernel<bf16, bf16><<<grid, kLoraThreads, 0, s>>>(p);
  else if (x_dt == ptt::kBF16 && a_dt == ptt::kF32)
    lora_delta_kernel<bf16, float><<<grid, kLoraThreads, 0, s>>>(p);
  else if (x_dt == ptt::kF32 && a_dt == ptt::kBF16)
    lora_delta_kernel<float, bf16><<<grid, kLoraThreads, 0, s>>>(p);
  else if (x_dt == ptt::kF32 && a_dt == ptt::kF32)
    lora_delta_kernel<float, float><<<grid, kLoraThreads, 0, s>>>(p);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
