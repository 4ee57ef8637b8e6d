// Ragged grouped GEMM (MoE expert FFN) forward and backward, its weight
// gradient, and the batched-LoRA delta, over one unit walk.
//
// ptt_grouped_gemm replaces the TPU kernel _grouped_fwd_pallas
// (paddle_tpu/nn/functional/grouped_gemm.py:170, pallas_call at :218),
// also in its backward mode (the TPU backward runs the same kernel over
// the transposed bank, grouped_gemm.py:454); ptt_grouped_dw replaces
// _grouped_dw_pallas (grouped_gemm.py:270, pallas_call at :359);
// ptt_lora_delta replaces _lora_fwd_pallas
// (paddle_tpu/nn/functional/lora.py:99, pallas_call at :152).
// Python wrappers: paddle_tpu_torch/nn/functional/grouped_gemm.py and
// lora.py.
//
// What they compute. The rows of x [T, K] are sorted by group (an expert,
// or an adapter slot): group e owns rows offsets[e] .. offsets[e+1]-1,
// and rows from offsets[E] to T belong to no group.
//   grouped GEMM:  out[r] = act(x[r] @ W[e(r)] + bias[e(r)])   W [E, K, N]
//     backward mode (trans_w): out[r] = x[r] @ B[e(r)]^T, B [E, N, K]
//     the same bank read in place, so dx = dz @ W[e]^T needs no copy
//   weight grad:   dw[e] = sum over e's rows r of x[r]^T dz[r]  [E, K, N]
//   LoRA delta:    out[r] = (x[r] @ A[s(r)]) @ B[s(r)]         A [S, K, R],
//                                                              B [S, R, N]
// with fp32 sums (the grouped GEMM's W and the weight gradient's dz are
// in x's dtype; the delta rounds A to x's dtype and takes B in fp32, as
// the TPU kernels do); rows past offsets[E] are written as exact zeros
// and add nothing to dw. The work map of the TPU kernel
// (grouped_work_map: unit u is row tile tids[u] of kBM rows against
// group gids[u], live rows [lo[u], hi[u])) has t_pad/kBM + 2E + 1 units,
// a number of shapes only, so the grid needs nothing from the host: each
// block decodes its own unit from offsets[] (unit_at, the same integers
// as grouped_work_map; ptt_grouped_work_map writes them out for the
// check). No map is built between launches.
//
// Design. The TPU kernel accumulates o_ref += over the consecutive units
// of an output tile because its 128-row tiles can be split by a group
// boundary. Here each (unit, column strip) computes only the unit's live
// rows, each of which has exactly one owner: each output row is written
// once, with no accumulation across blocks and no atomics. The first unit of each tile also writes the zero rows of its
// tile from offsets[E] on; every tile has a first unit, and no live row
// lies past offsets[E], so every row is written exactly once.
//
// The grouped GEMM in bf16 (grouped_gemm_wgmma): a tile is one (unit,
// 256-column strip), computed with wgmma m64n128k16 (bf16 in, fp32
// accumulators, both operands from shared memory) by two consumer
// warpgroups of 128 columns each, which share the x tile, and one
// producer thread. The producer keeps a 4-stage ring full by TMA
// (128-byte swizzle, full/empty mbarrier pairs): each stage is the x tile
// [64 rows x 64 K] (K-major, a 2-D map over x [T, K], box at row t0 =
// tid * 64) and the bank tile, [64 K x 256 N] N-major from the [E, K, N]
// bank (wgmma's transposed B, four 64-column boxes) or, in the backward
// mode, [256 N x 64 K] K-major from the same bank read as [E, N, K] (one
// box): both from one template, the bank in place. The bank's map is
// rank 3, so a K or N edge reads zeros and never the next expert's rows;
// rows past T read as zeros. Rows of the tile outside the unit's live
// range are loaded, multiplied and dropped at the store. The consumers
// keep one k-step of products in flight (wgmma.wait_group 1) and release
// a stage once its products are done. The kernel is persistent (one
// block an SM: the ring takes 161 KB): a block walks tiles strip-fastest
// (neighbouring blocks share a unit's x tile and an expert's bank), and
// the ring runs on across tiles, so the producer loads the next tile
// while the consumers store this one. Epilogue from registers: + bias
// (fp32, loaded into registers before the tile's products), tanh-GELU or
// ReLU, the output dtype, column pairs stored together. fp32 (the
// CPU-parity dtype) keeps grouped_gemm_kernel: a 64 x 64 tile per block
// on the CUDA cores (a 4 x 8 register tile per thread, exact fp32
// products) over a 4-stage cp.async ring of 64-byte K steps.
//
// The weight gradient: the TPU kernel keeps an expert's [K, bn] block
// resident across the expert's consecutive units. Here a tile is one
// (expert, block of [K, N]) and walks the expert's rows [offsets[e],
// offsets[e+1]) itself: each dw element has exactly one writer, the sum
// runs in one fixed order (deterministic, no atomics), and an expert with
// no rows writes exact zeros. In bf16 (grouped_dw_wgmma) the tile is 128
// x 256, taken by two consumer warpgroups of 64 rows with wgmma
// m64n256k16 (A = x's rows read M-major as x^T, B = dz's rows N-major,
// as the forward's bank tile), fed by one producer thread through a
// 3-stage TMA ring of 64-row stages (2-D maps over x and dz, boxes at any
// row, so a walk starts exactly at the expert's first row); the rows of
// the neighbour in an expert's last stage are zeroed in shared memory in
// both operands before the products read it. The kernel is persistent;
// each block ranks the experts by row count itself and walks their tiles
// heaviest expert first (nothing on the host); a bf16 tile leaves by TMA
// stores from shared memory that overlap the next tile's products (stores
// from registers took a third of the kernel's time). fp32 keeps
// grouped_dw_kernel: a 64 x 64 tile per block on the CUDA cores over a
// 4-stage cp.async ring.
//
// The LoRA delta (lora_delta_mma for bf16, lora_delta_fma for the other
// dtypes and shapes): one thread-block cluster of 8 blocks per unit of
// the work map, so h = x_unit @ A[s] is summed once a unit, in parallel
// over K, and not once per column strip. Block c of the cluster takes K
// slice c (whole 16-wide k-steps) and output columns [c * cols,
// min((c + 1) * cols, N)), none when c * cols >= N (a narrow N). Phase 1:
// with bf16 x and A (K % 8 == 0, R % 16 == 0) the slice runs on the
// tensor cores, mma.sync m16n8k16 with x's live rows as M (16-row tiles)
// and R as N, exact bf16 products, each k-step's 16 summed by the tensor
// cores from zero and added in fp32 (the accumulators truncate; carrying
// the sum in them is what moved B1's scores), x and A rows brought by
// 16-byte cp.async through a 4-stage ring of 128-K chunks, warp w taking
// k-steps w, w + 4, ...; otherwise on the CUDA cores (fp32 products of x
// and A rounded to x's dtype, in K order). The slices meet through
// distributed shared memory: every block sums the 8 partials in rank
// order (the same h everywhere, no atomics), and h stays in fp32, never
// rounded to a bf16. Phase 2: each block writes h @ B[s] over its
// columns with fp32 FMAs, 4 rows x 8 columns an item, B staged in shared
// memory by 16-byte cp.async issued before phase 1 (its latency hides
// under it). A unit with no live rows only writes its tile's rows past
// offsets[S] as zeros and exits at once. One launch a projection.
//
// Bounds. The grouped GEMM at decode (64 rows over 8 experts) reads every
// active expert's W once: bytes bound it, 8 x 2 x 4 MB = 67 MB per FFN of
// the d1024 MoE model, 20 us at 3.35 TB/s; at prefill (8192 rows) the
// bf16 tensor-core operations do (69 GFLOP, 69 us per FFN at 989
// TFLOP/s), and so they do for the training step's backward mode and
// weight gradient (69 GFLOP each per FFN at 8192 rows). A 64-row unit
// reuses each bank tile only 64 times, so at prefill the bank tiles'
// reads from L2 (about 1 GB per FFN) rather than the tensor cores may set
// the pace; 128-row tiles of one expert, or TMA multicast of a bank tile
// across a cluster of two units, are the later work. The weight
// gradient's 128 x 256 tile reads x and dz about 0.77 GB from L2 per FFN
// at the rung (a 64 x 64 tile read about 2 GB). The LoRA delta is small against the base GEMM: x, A and B are
// read once (bytes, about 1.3 MB a d2048 projection at T 8, 0.4 us at
// 3.35 TB/s), so a launch is a chain of latencies (the offsets, the
// slices, the cluster's exchange, the stores); a delta fused into the
// base GEMM's epilogue is the later design.
#include <cooperative_groups.h>

#include "common.cuh"
#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

using ptt::activate;
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
  // a W stage: [kBK][kWPitch] of a [K, N] bank, or (trans_w) [kBN]
  // rows of kXPitch of an [N, K] one
  static constexpr int kWStage =
      kBK * kWPitch > kBN * kXPitch ? kBK * kWPitch : kBN * kXPitch;
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
// unit, over columns [n0, min(n0 + bn, N)); nothing when n0 >= N or the
// tile holds no such row.
// Threads [0, nthreads) of the block take part.
__device__ __forceinline__ void zero_dead_rows(const int* offsets, int E,
                                               int nm, int u, int T, int N,
                                               int n0, int bn, void* out,
                                               int out_dt,
                                               int nthreads = blockDim.x) {
  const int tile = unit_at(offsets, E, nm, u).tid;
  if (u > 0 && unit_at(offsets, E, nm, u - 1).tid == tile) return;
  const int t1 = min((tile + 1) * kBM, T);
  const int z0 = max(offsets[E], tile * kBM);
  const int cols = min(bn, N - n0);
  if (cols <= 0 || t1 <= z0) return;
  for (int i = threadIdx.x; i < (t1 - z0) * cols; i += nthreads) {
    const int r = z0 + i / cols, n = n0 + i % cols;
    store_dt(out, static_cast<int64_t>(r) * N + n, out_dt, 0.f);
  }
}

template <typename T, bool kTrans>
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
  if (kTrans) {
    // W^T tile: output column n's row of the [N, K] bank, kBK long
    for (int c = threadIdx.x; c < kBN * xc; c += kThreads) {
      const int nn = c / xc, kk = (c % xc) * G::kVec;
      const int k = k0 + kk, n = n0 + nn;
      const bool ok = k < p.K && n < p.N;
      ptt::cp_async16(sw + nn * G::kXPitch + kk,
                      ok ? w + static_cast<int64_t>(n) * p.K + k : w,
                      ok ? 16 : 0);
    }
    return;
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

// fp32 on the CUDA cores: thread (rg, cg) owns rows rg*4.. and columns
// cg*8.. of the block's 64 x 64 tile.
template <bool kTrans>
__device__ __forceinline__ void compute_tile(const float* xs,
                                             const float* ws, int m_lo,
                                             int m_hi, float (&acc)[4][8]) {
  using G = Geo<float>;
  const int rg = threadIdx.x / 8, cg = threadIdx.x % 8;
  if (rg * 4 >= m_hi || rg * 4 + 4 <= m_lo) return;
#pragma unroll
  for (int kk = 0; kk < G::kBK; ++kk) {
    float bv[8];
    if (kTrans) {
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = ws[(cg * 8 + j) * G::kXPitch + kk];
    } else {
      const float4 b0 =
          *reinterpret_cast<const float4*>(ws + kk * G::kWPitch + cg * 8);
      const float4 b1 = *reinterpret_cast<const float4*>(
          ws + kk * G::kWPitch + cg * 8 + 4);
      bv[0] = b0.x, bv[1] = b0.y, bv[2] = b0.z, bv[3] = b0.w;
      bv[4] = b1.x, bv[5] = b1.y, bv[6] = b1.z, bv[7] = b1.w;
    }
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

// fp32: the CUDA-core kernel
template <bool kTrans>
__global__ void __launch_bounds__(kThreads)
    grouped_gemm_kernel(const GroupedParams p) {
  using G = Geo<float>;
  __shared__ __align__(16) unsigned char smem[G::kSmemBytes];
  float* sx = reinterpret_cast<float*>(smem);    // [kStages][kXStage]
  float* sw = sx + kStages * G::kXStage;         // [kStages][kWStage]
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
  float acc[4][8] = {};
  const int nk = (p.K + G::kBK - 1) / G::kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage<float, kTrans>(p, sx + s * G::kXStage, sw + s * G::kWStage,
                                s, t0, r0, r1, m_lo, m_hi, n0, g);
    ptt::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    ptt::cp_async_wait<kStages - 2>();
    __syncthreads();
    // the stage computed at kt - 1 is free once every thread is here
    const int nt = kt + kStages - 1;
    if (nt < nk)
      load_stage<float, kTrans>(p, sx + (nt % kStages) * G::kXStage,
                                sw + (nt % kStages) * G::kWStage, nt, t0, r0,
                                r1, m_lo, m_hi, n0, g);
    ptt::cp_async_commit();
    const int s = kt % kStages;
    compute_tile<kTrans>(sx + s * G::kXStage, sw + s * G::kWStage, m_lo,
                         m_hi, acc);
  }
  ptt::cp_async_wait<0>();
  store_tile(p, acc, g, t0, r0, r1, n0);
}

// ------------------------------------------- bf16: wgmma over a TMA ring

namespace hp = ptt::hopper;

constexpr int kWgGroups = 2;    // consumer warpgroups, 128 columns each
constexpr int kWgBN = 128 * kWgGroups;  // output columns per block
constexpr int kWgBK = 64;       // K per stage: one 128-byte swizzled row
constexpr int kWgStages = 4;
constexpr int kWgConsumers = 128 * kWgGroups;
constexpr int kWgThreads = kWgConsumers + 32;  // + the producer warp
constexpr int kATile = kBM * kWgBK * 2;        // 8 KB
constexpr int kBSub = kWgBK * 128 * 2;         // 16 KB: one group's
constexpr int kBTile = kBSub * kWgGroups;
constexpr int kWgSmem =
    kWgStages * (kATile + kBTile) + 2 * kWgStages * 8 + 1024;  // + align

// (row r, columns n, n + 1) of the output from their biased sums: the
// activation, then the output dtype
__device__ __forceinline__ void store_pair(const GroupedParams& p, int r,
                                           int n, float v0, float v1) {
  v0 = activate(v0, p.act);
  v1 = activate(v1, p.act);
  const int64_t i = static_cast<int64_t>(r) * p.N + n;  // even: N % 8 == 0
  if (p.out_dt == ptt::kBF16)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out) +
                                       i) = __floats2bfloat162_rn(v0, v1);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(p.out) + i) =
        make_float2(v0, v1);
}

// A persistent block walks tiles t = blockIdx.x, + gridDim.x, ... of
// (unit t / strips, column strip t % strips). kTrans 0: bank map [E, K, N]
// (dims N, K, E), B tiles N-major; 1: the bank read as [E, N, K] (dims
// K, N, E), B tiles K-major. x map [T, K] (dims K, T). The producer and
// the consumers walk the same tiles and k-steps; `it` counts k-steps over
// the walk, so the ring's stages and phases run on across tiles and the
// producer loads the next tile's first stages during an epilogue.
template <bool kTrans>
__global__ void __launch_bounds__(kWgThreads)
    grouped_gemm_wgmma(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const GroupedParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sa = smem;                       // [stages][64 rows][64 K]
  unsigned char* sb = smem + kWgStages * kATile;  // [stages] bank tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(sb + kWgStages * kBTile);
  uint64_t* empty = full + kWgStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kWgConsumers);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();
  const int strips = (p.N + kWgBN - 1) / kWgBN;
  const int tiles = strips * (p.nm + 2 * p.E + 1);
  const int nk = (p.K + kWgBK - 1) / kWgBK;
  const bool producer = threadIdx.x >= kWgConsumers;
  if (producer && threadIdx.x != kWgConsumers) return;  // idle lanes
  // consumers: warpgroup c owns columns n0 + 128c ..
  const int c = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int u = t / strips;
    const int n0 = (t % strips) * kWgBN;
    if (!producer)
      zero_dead_rows(p.offsets, p.E, p.nm, u, p.T, p.N, n0, kWgBN, p.out,
                     p.out_dt, kWgConsumers);
    const Unit un = unit_at(p.offsets, p.E, p.nm, u);
    const int t0 = un.tid * kBM;
    const int r0 = max(un.lo, t0);
    const int r1 = min(min(un.hi, t0 + kBM), p.T);
    if (r1 <= r0) continue;  // the same for every thread
    const int g = un.gid;

    if (producer) {
      // one thread keeps the ring full
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kWgStages;
        hp::mbar_wait(&empty[s], ((it / kWgStages) & 1) ^ 1);
        hp::mbar_arrive_expect_tx(&full[s], kATile + kBTile);
        const int k0 = kt * kWgBK;
        hp::tma_load_2d(sa + s * kATile, &xmap, &full[s], k0, t0);
        unsigned char* b = sb + s * kBTile;
        if (kTrans) {
          hp::tma_load_3d(b, &wmap, &full[s], k0, n0, g);
        } else {
#pragma unroll
          for (int q = 0; q < kWgBN / 64; ++q)  // 64-column boxes
            hp::tma_load_3d(b + q * (kBSub / 2), &wmap, &full[s],
                            n0 + 64 * q, k0, g);
        }
      }
      continue;
    }

    // consumers: the bias of the thread's 32 columns (n0 + 128c + 8j +
    // 2(l%4) + e) comes in first, its loads overlapping the products;
    // one k-step's products in flight, each stage released once its
    // products are done
    float bias[32];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + c * 128 + j * 8 + (lane % 4) * 2 + e;
        bias[2 * j + e] =
            p.bias != nullptr && n < p.N
                ? load_dt(p.bias, static_cast<int64_t>(g) * p.N + n,
                          p.bias_dt)
                : 0.f;
      }
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kWgStages;
      hp::mbar_wait(&full[s], (it / kWgStages) & 1);
      const unsigned char* a = sa + s * kATile;
      const unsigned char* b = sb + s * kBTile + c * kBSub;
      hp::fence_operands(acc);
      hp::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWgBK / 16; ++ks) {
        const uint64_t da = hp::desc_sw128(a + ks * 32, 16, 1024);
        const uint64_t db =
            kTrans ? hp::desc_sw128(b + ks * 32, 16, 1024)
                   : hp::desc_sw128(b + ks * 16 * 128, kBSub / 2, 1024);
        hp::wgmma_m64n128k16<kTrans ? 0 : 1>(acc, da, db, 1);
      }
      hp::wgmma_commit();
      hp::wgmma_wait<1>();
      hp::fence_operands(acc);
      if (kt > 0) hp::mbar_arrive(&empty[(it - 1) % kWgStages]);
    }
    hp::wgmma_wait<0>();
    hp::fence_operands(acc);
    hp::mbar_arrive(&empty[(it - 1) % kWgStages]);

    // epilogue: warp w of the group holds rows 16w + l/4 (+8), columns
    // 8j + 2(l%4) (+1) of its 128
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = t0 + warp * 16 + lane / 4 + h * 8;
      if (r < r0 || r >= r1) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = n0 + c * 128 + j * 8 + (lane % 4) * 2;
        if (n < p.N)
          store_pair(p, r, n, acc[4 * j + 2 * h] + bias[2 * j],
                     acc[4 * j + 2 * h + 1] + bias[2 * j + 1]);
      }
    }
  }
}

// The maps of one call and its launch.
template <bool kTrans>
int launch_wgmma(const GroupedParams& p, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  const cuuint64_t K = p.K, N = p.N, T = p.T, E = p.E;
  const cuuint64_t xdims[2] = {K, T}, xstrides[1] = {K * 2};
  const cuuint32_t xbox[2] = {kWgBK, kBM};
  int err = hp::make_map_bf16(&xmap, p.x, 2, xdims, xstrides, xbox);
  if (err) return err;
  if (kTrans) {
    const cuuint64_t dims[3] = {K, N, E}, strides[2] = {K * 2, N * K * 2};
    const cuuint32_t box[3] = {kWgBK, kWgBN, 1};
    err = hp::make_map_bf16(&wmap, p.w, 3, dims, strides, box);
  } else {
    const cuuint64_t dims[3] = {N, K, E}, strides[2] = {N * 2, K * N * 2};
    const cuuint32_t box[3] = {64, kWgBK, 1};
    err = hp::make_map_bf16(&wmap, p.w, 3, dims, strides, box);
  }
  if (err) return err;
  static int sms[64] = {};  // per device: SM count once the attribute is set
  int dev = 0;
  cudaGetDevice(&dev);
  int n_sm = dev < 64 ? sms[dev] : 0;
  if (n_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        grouped_gemm_wgmma<kTrans>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (dev < 64) sms[dev] = n_sm;
  }
  // one block an SM (the ring takes 161 KB), never more than the tiles
  const int tiles = (p.N + kWgBN - 1) / kWgBN * (p.nm + 2 * p.E + 1);
  grouped_gemm_wgmma<kTrans>
      <<<tiles < n_sm ? tiles : n_sm, kWgThreads, kWgSmem, stream>>>(
          xmap, wmap, p);
  return cudaGetLastError();
}

// ------------------------------------------------------- weight gradient

struct DwParams {
  const void* x;
  const void* dz;
  const int* offsets;
  void* out;
  int out_dt;
  int T, K, N;
};

// fp32 on the CUDA cores: a block is one (expert, 64 x 64 tile of [K,
// N]); a stage is 16 rows of x's [r, m0:m0+64] and of dz's [r, n0:n0+64],
// rows past r1 zero-filled; thread (rg, cg) owns m rows rg*4.. and n
// columns cg*8..
constexpr int kDwF32Rows = Geo<float>::kBK;      // 16
constexpr int kDwF32Pitch = Geo<float>::kWPitch;  // 68 floats

__device__ __forceinline__ void load_dw_stage(const DwParams& p, float* sx,
                                              float* sd, int r, int r1,
                                              int m0, int n0) {
  const float* x = static_cast<const float*>(p.x);
  const float* dz = static_cast<const float*>(p.dz);
  constexpr int rc = kBN / 4;  // 16-byte chunks per tile row
  for (int c = threadIdx.x; c < kDwF32Rows * rc; c += kThreads) {
    const int rr = c / rc, cc = (c % rc) * 4;
    const int row = r + rr, m = m0 + cc, n = n0 + cc;
    const bool live = row < r1;
    const bool okx = live && m < p.K, okd = live && n < p.N;
    ptt::cp_async16(sx + rr * kDwF32Pitch + cc,
                    okx ? x + static_cast<int64_t>(row) * p.K + m : x,
                    okx ? 16 : 0);
    ptt::cp_async16(sd + rr * kDwF32Pitch + cc,
                    okd ? dz + static_cast<int64_t>(row) * p.N + n : dz,
                    okd ? 16 : 0);
  }
}

__device__ __forceinline__ void dw_tile(const float* xs, const float* ds,
                                        float (&acc)[4][8]) {
  const int rg = threadIdx.x / 8, cg = threadIdx.x % 8;
#pragma unroll
  for (int kk = 0; kk < kDwF32Rows; ++kk) {
    const float4 a =
        *reinterpret_cast<const float4*>(xs + kk * kDwF32Pitch + rg * 4);
    const float4 b0 =
        *reinterpret_cast<const float4*>(ds + kk * kDwF32Pitch + cg * 8);
    const float4 b1 = *reinterpret_cast<const float4*>(
        ds + kk * kDwF32Pitch + cg * 8 + 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Block (n tile, m tile, expert e): dw[e][m0:m0+64][n0:n0+64] over e's
// rows, in row order through the 4-stage ring; the only writer of its
// tile.
__global__ void __launch_bounds__(kThreads)
    grouped_dw_kernel(const DwParams p) {
  constexpr int kStage = kDwF32Rows * kDwF32Pitch;
  __shared__ __align__(16) float sx[kStages][kStage];
  __shared__ __align__(16) float sd[kStages][kStage];
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBN, n0 = blockIdx.x * kBN;
  const int r1 = min(p.offsets[e + 1], p.T);
  const int r0 = min(p.offsets[e], r1);
  const int nk = (r1 - r0 + kDwF32Rows - 1) / kDwF32Rows;
  float acc[4][8] = {};
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_dw_stage(p, sx[s], sd[s], r0 + s * kDwF32Rows, r1, m0, n0);
    ptt::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    ptt::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nt = kt + kStages - 1;
    if (nt < nk)
      load_dw_stage(p, sx[nt % kStages], sd[nt % kStages],
                    r0 + nt * kDwF32Rows, r1, m0, n0);
    ptt::cp_async_commit();
    dw_tile(sx[kt % kStages], sd[kt % kStages], acc);
  }
  ptt::cp_async_wait<0>();
  const int64_t base = static_cast<int64_t>(e) * p.K * p.N;
  const int rg = threadIdx.x / 8, cg = threadIdx.x % 8;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = m0 + rg * 4 + i, n = n0 + cg * 8 + j;
      if (m < p.K && n < p.N)
        store_dt(p.out, base + static_cast<int64_t>(m) * p.N + n, p.out_dt,
                 acc[i][j]);
    }
}

// bf16: wgmma over a TMA ring. A tile is one (expert, 128 x 256 block of
// [K, N]), numbered e * mt * nt + m tile * nt + n tile; the walk takes
// the experts by row count, the heaviest first (ties by index), and an
// expert's tiles in order (the wrapper's dw_tile_order renders it in
// PyTorch).
constexpr int kDwBM = 128;           // K rows of a tile: 64 a warpgroup
constexpr int kDwBN = 256;           // N columns
constexpr int kDwRows = 64;          // x and dz rows a stage (wgmma's k)
constexpr int kDwStages = 3;
constexpr int kDwBox = kDwRows * 128;  // 8 KB: 64 rows x 64 columns
constexpr int kDwXTile = (kDwBM / 64) * kDwBox;  // 16 KB
constexpr int kDwDTile = (kDwBN / 64) * kDwBox;  // 32 KB
constexpr int kDwStage = kDwXTile + kDwDTile;    // 48 KB
// a warpgroup's bf16 output tile, 64 x 256, staged for the TMA store
constexpr int kDwStaging = 64 * kDwBN * 2;       // 32 KB
constexpr int kDwSmem = kDwStages * kDwStage + 2 * kDwStaging +
                        2 * kDwStages * 8 + 1024;  // + align
constexpr int kDwMaxExperts = 1024;  // the walk's expert order, in smem

// order[r] = the expert of rank r: by row count offsets[e+1] - offsets[e],
// the largest first, ties by index. The block's threads rank one expert
// each (E^2 compares of L1-resident offsets); the caller syncs after.
__device__ __forceinline__ void dw_expert_order(const int* offsets, int E,
                                                int* order) {
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int c = offsets[e + 1] - offsets[e];
    int rank = 0;
    for (int f = 0; f < E; ++f) {
      const int cf = offsets[f + 1] - offsets[f];
      rank += cf > c || (cf == c && f < e);
    }
    order[rank] = e;
  }
}

// tile t of the walk over `per` tiles an expert
__device__ __forceinline__ int dw_tile_at(const int* order, int per, int t) {
  return order[t / per] * per + t % per;
}

// Block b walks tiles b, b + gridDim.x, ... of the walk. Stage kt of a
// tile holds rows r = offsets[e] + 64 kt .. + 63 of x [T, K] at columns
// m0 .. m0 + 127 (two 64-column boxes, one a consumer warpgroup) and of
// dz [T, N] at n0 .. n0 + 255 (four boxes). Rows at or past the expert's
// end r1 (the next expert's, or TMA's zeros past T) appear only in its
// last stage: the consumers zero those rows in both operands (a row is
// one 128-byte line of a box under the swizzle), fence the writes to the
// async proxy and meet at a named barrier before any product reads the
// stage, and skip the k16 steps that lie wholly past r1. Warpgroup c
// computes dw rows m0 + 64c .. by wgmma m64n256k16: A = the x box read
// M-major (x^T), B = the dz boxes N-major; fp32 accumulators in registers,
// one fixed row order, one writer per element. A bf16 dw tile leaves
// through shared memory: each warpgroup writes its 64 x 256 block there in
// the output map's swizzled layout and one of its threads issues TMA
// stores (a rank-3 map over [E, K, N], so rows past K and columns past N
// are not written), which run on while the next tile's products do; the
// buffer is rewritten once the stores have read it. f32 (the parity
// dtype) stores from registers.
__global__ void __launch_bounds__(kWgThreads, 1)
    grouped_dw_wgmma(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap dmap,
                     const __grid_constant__ CUtensorMap omap,
                     const DwParams p, int E) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int order[kDwMaxExperts];
  unsigned char* smem =
      smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* staging = smem + kDwStages * kDwStage;  // [2] groups
  uint64_t* full =
      reinterpret_cast<uint64_t*>(staging + 2 * kDwStaging);
  uint64_t* empty = full + kDwStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kWgConsumers);
    }
    hp::fence_barrier_init();
  }
  dw_expert_order(p.offsets, E, order);
  __syncthreads();
  const int nt = (p.N + kDwBN - 1) / kDwBN;
  const int per = (p.K + kDwBM - 1) / kDwBM * nt;
  const int n_tiles = E * per;
  const bool producer = threadIdx.x >= kWgConsumers;
  if (producer && threadIdx.x != kWgConsumers) return;  // idle lanes
  const int c = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int id = dw_tile_at(order, per, t);
    const int e = id / per;
    const int m0 = id % per / nt * kDwBM, n0 = id % nt * kDwBN;
    const int r1 = min(p.offsets[e + 1], p.T);
    const int r0 = min(p.offsets[e], r1);
    const int nk = (r1 - r0 + kDwRows - 1) / kDwRows;

    if (producer) {
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kDwStages;
        hp::mbar_wait(&empty[s], ((it / kDwStages) & 1) ^ 1);
        hp::mbar_arrive_expect_tx(&full[s], kDwStage);
        unsigned char* st = smem + s * kDwStage;
        const int r = r0 + kt * kDwRows;
#pragma unroll
        for (int q = 0; q < kDwBM / 64; ++q)
          hp::tma_load_2d(st + q * kDwBox, &xmap, &full[s], m0 + 64 * q, r);
#pragma unroll
        for (int q = 0; q < kDwBN / 64; ++q)
          hp::tma_load_2d(st + kDwXTile + q * kDwBox, &dmap, &full[s],
                          n0 + 64 * q, r);
      }
      continue;
    }

    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kDwStages;
      hp::mbar_wait(&full[s], (it / kDwStages) & 1);
      unsigned char* st = smem + s * kDwStage;
      const int live = min(kDwRows, r1 - r0 - kt * kDwRows);
      if (live < kDwRows) {
        // the expert's last stage: lines live.. of all six boxes to zero
        const int dead = (kDwRows - live) * 8;  // 16-byte chunks a box
        for (int i = threadIdx.x; i < dead * (kDwStage / kDwBox);
             i += kWgConsumers) {
          const int box = i / dead, ch = i % dead;
          *reinterpret_cast<uint4*>(st + box * kDwBox + live * 128 +
                                    ch * 16) = make_uint4(0, 0, 0, 0);
        }
        hp::fence_proxy_async();
        hp::bar_sync(1, kWgConsumers);
      }
      const unsigned char* a = st + c * kDwBox;
      const unsigned char* b = st + kDwXTile;
      hp::fence_operands(acc);
      hp::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kDwRows / 16; ++ks)
        if (ks * 16 < live)  // k16 steps wholly past r1 are skipped
          hp::wgmma_m64n256k16<1, 1>(
              acc, hp::desc_sw128(a + ks * 2048, kDwBox, 1024),
              hp::desc_sw128(b + ks * 2048, kDwBox, 1024), 1);
      hp::wgmma_commit();
      hp::wgmma_wait<1>();
      hp::fence_operands(acc);
      if (kt > 0) hp::mbar_arrive(&empty[(it - 1) % kDwStages]);
    }
    if (nk > 0) {
      hp::wgmma_wait<0>();
      hp::fence_operands(acc);
      hp::mbar_arrive(&empty[(it - 1) % kDwStages]);
    }

    // epilogue: warp w holds dw rows m0 + 64c + 16w + l/4 (+8), columns
    // n0 + 8j + 2(l%4) (+1); an expert with no rows writes +0.0
    if (p.out_dt == ptt::kBF16) {
      unsigned char* stg = staging + c * kDwStaging;  // [4 boxes][64][64]
      const bool issuer = threadIdx.x % 128 == 0;
      if (issuer) hp::bulk_wait_read<0>();  // the last tile's stores read it
      hp::bar_sync(2 + c, 128);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + lane / 4 + h * 8;
#pragma unroll
        for (int j = 0; j < 32; ++j)
          *reinterpret_cast<__nv_bfloat162*>(
              stg + j / 8 * kDwBox + r * 128 + ((j % 8) ^ (r % 8)) * 16 +
              (lane % 4) * 4) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                    acc[4 * j + 2 * h + 1]);
      }
      hp::fence_proxy_async();
      hp::bar_sync(2 + c, 128);
      if (issuer) {
#pragma unroll
        for (int q = 0; q < kDwBN / 64; ++q)
          hp::tma_store_3d(&omap, stg + q * kDwBox, n0 + 64 * q,
                           m0 + 64 * c, e);
        hp::bulk_commit();
      }
      continue;
    }
    const int64_t base = static_cast<int64_t>(e) * p.K * p.N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + c * 64 + warp * 16 + lane / 4 + h * 8;
      if (m >= p.K) continue;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int n = n0 + j * 8 + (lane % 4) * 2;
        if (n >= p.N) continue;
        const int64_t i = base + static_cast<int64_t>(m) * p.N + n;
        const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + i) =
            make_float2(v0, v1);
      }
    }
  }
  // the stores have finished before the block leaves
  if (threadIdx.x < kWgConsumers && threadIdx.x % 128 == 0)
    hp::bulk_wait<0>();
}

int launch_dw_wgmma(const DwParams& p, int E, cudaStream_t stream) {
  CUtensorMap xmap, dmap;
  const cuuint64_t K = p.K, N = p.N, T = p.T;
  const cuuint32_t box[2] = {64, kDwRows};
  const cuuint64_t xdims[2] = {K, T}, xstrides[1] = {K * 2};
  int err = hp::make_map_bf16(&xmap, p.x, 2, xdims, xstrides, box);
  if (err) return err;
  const cuuint64_t ddims[2] = {N, T}, dstrides[1] = {N * 2};
  err = hp::make_map_bf16(&dmap, p.dz, 2, ddims, dstrides, box);
  if (err) return err;
  // dw [E, K, N] for the bf16 stores (dims N, K, E; boxes 64 x 64 x 1)
  CUtensorMap omap = dmap;  // unused by an f32 output
  if (p.out_dt == ptt::kBF16) {
    const cuuint64_t odims[3] = {N, K, static_cast<cuuint64_t>(E)};
    const cuuint64_t ostrides[2] = {N * 2, K * N * 2};
    const cuuint32_t obox[3] = {64, 64, 1};
    err = hp::make_map_bf16(&omap, p.out, 3, odims, ostrides, obox);
    if (err) return err;
  }
  static int sms[64] = {};  // per device: SM count once the attribute is set
  int dev = 0;
  cudaGetDevice(&dev);
  int n_sm = dev < 64 ? sms[dev] : 0;
  if (n_sm == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        grouped_dw_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kDwSmem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (dev < 64) sms[dev] = n_sm;
  }
  const int n_tiles = E * ((p.K + kDwBM - 1) / kDwBM) *
                      ((p.N + kDwBN - 1) / kDwBN);
  // one block an SM (ring and staging take 209 KB), never more than the
  // tiles
  grouped_dw_wgmma<<<n_tiles < n_sm ? n_tiles : n_sm, kWgThreads, kDwSmem,
                     stream>>>(xmap, dmap, omap, p, E);
  return cudaGetLastError();
}

// ------------------------------------------------------------ LoRA delta

constexpr int kLoraC = 8;          // blocks a cluster: one live unit
constexpr int kLoraThreads = 128;  // 4 warps
constexpr int kLoraCols = 1024;    // B columns a block stages at a time
constexpr int kMaxRank = 32;
// the tensor-core phase 1: K chunks of 8 k-steps, x rows and A rows in a
// 4-stage cp.async ring (three chunks in flight)
constexpr int kLoraStages = 4;
constexpr int kLoraKC = 128;
constexpr int kLoraXP = kLoraKC + 8;   // elements an x row (272 bytes)
constexpr int kLoraAP = kMaxRank + 8;  // elements an A row (80 bytes)
constexpr int kLoraStage = (kBM * kLoraXP + kLoraKC * kLoraAP) * 2;
// the CUDA-core phase 1: K chunks of 64 as float
constexpr int kLoraFC = 64;
constexpr int kLoraFStage =
    (kBM * (kLoraFC + 1) + kLoraFC * kMaxRank) * 4;
constexpr int kLoraH = kBM * kMaxRank * 4;  // bytes of h [64][32] f32

struct LoraParams {
  const void* x;
  const void* a;
  const void* b;
  const int* offsets;
  void* out;
  int out_dt;
  int T, K, N, S, R, nm;
  int cols;            // output columns a block of the cluster owns
  int b_vec, out_vec;  // B rows, out rows: 16-byte aligned vectors
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

// Phase 1 on the tensor cores (bf16 x and A; K % 8 == 0, R % 16 == 0):
// the block's partial x[r0, r1) @ A[s] over k-steps [ks0, ks1) into
// s_part [64][kMaxRank]. Warp w takes k-steps w, w + 4, ... of each
// chunk, all row and rank tiles: mma.sync m16n8k16 (x's rows as M, R as
// N), exact bf16 products, each k-step's 16 summed by the tensor cores
// from zero and added to the warp's sums by an fp32 add; the warps' sums
// meet in warp order.
__device__ __forceinline__ void lora_h_mma(const LoraParams& p, int s,
                                           int r0, int r1, int ks0,
                                           int ks1, unsigned char* stage,
                                           float* s_part) {
  using bf16 = __nv_bfloat16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, t4 = lane & 3;
  const int nr = r1 - r0, n_mt = (nr + 15) / 16, R = p.R;
  const int kend = min(p.K, ks1 * 16);
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* a = static_cast<const bf16*>(p.a) +
                  static_cast<int64_t>(s) * p.K * R;
  const int n_chunks = (ks1 - ks0 + 7) / 8;
  auto load = [&](int ci) {
    bf16* sx = reinterpret_cast<bf16*>(stage + (ci % kLoraStages) *
                                                   kLoraStage);
    bf16* sa = sx + kBM * kLoraXP;
    const int k0 = (ks0 + ci * 8) * 16;
    for (int c = threadIdx.x; c < n_mt * 16 * (kLoraKC / 8);
         c += kLoraThreads) {
      const int i = c / (kLoraKC / 8), e = (c % (kLoraKC / 8)) * 8;
      const bool in = r0 + i < r1 && k0 + e < kend;
      ptt::cp_async16(sx + i * kLoraXP + e,
                      in ? x + static_cast<int64_t>(r0 + i) * p.K + k0 + e
                         : x,
                      in ? 16 : 0);
    }
    for (int c = threadIdx.x; c < kLoraKC * (R / 8); c += kLoraThreads) {
      const int k = c / (R / 8), e = (c % (R / 8)) * 8;
      const bool in = k0 + k < kend;
      ptt::cp_async16(sa + k * kLoraAP + e,
                      in ? a + static_cast<int64_t>(k0 + k) * R + e : a,
                      in ? 16 : 0);
    }
  };
  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) ptt::tiles::zero(acc[mt]);
  for (int ci = 0; ci < kLoraStages - 1; ++ci) {
    if (ci < n_chunks) load(ci);
    ptt::cp_async_commit();
  }
  for (int ci = 0; ci < n_chunks; ++ci) {
    if (ci + kLoraStages - 1 < n_chunks) load(ci + kLoraStages - 1);
    ptt::cp_async_commit();
    ptt::cp_async_wait<kLoraStages - 1>();
    __syncthreads();
    const bf16* sx = reinterpret_cast<const bf16*>(
        stage + (ci % kLoraStages) * kLoraStage);
    const bf16* sa = sx + kBM * kLoraXP;
    const int steps = min(8, ks1 - ks0 - ci * 8);
    for (int st = warp; st < steps; st += 4) {
      uint32_t b[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        if (np * 16 < R)
          ptt::ldmatrix_x4_trans(
              b[np][0], b[np][1], b[np][2], b[np][3],
              sa + (st * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kLoraAP +
                  np * 16 + 8 * (lane >> 4));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (mt >= n_mt) break;
        uint32_t a0, a1, a2, a3;
        ptt::ldmatrix_x4(a0, a1, a2, a3,
                         sx + (mt * 16 + (lane & 15)) * kLoraXP + st * 16 +
                             8 * (lane >> 4));
#pragma unroll
        for (int np = 0; np < 2; ++np)
          if (np * 16 < R) {
            // the k-step's products from zero, added in fp32: the tensor
            // cores truncate as they accumulate
            float t[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
            ptt::mma_bf16(t[0], a0, a1, a2, a3, b[np][0], b[np][1]);
            ptt::mma_bf16(t[1], a0, a1, a2, a3, b[np][2], b[np][3]);
#pragma unroll
            for (int q = 0; q < 8; ++q)
              acc[mt][2 * np + q / 4][q % 4] += t[q / 4][q % 4];
          }
      }
    }
    __syncthreads();  // the stage is refilled from the next chunk on
  }
  ptt::cp_async_wait<0>();
  // the warps' sums [4][64][kMaxRank] over the ring, then in warp order
  float* s_w = reinterpret_cast<float*>(stage);
  float* wrow = s_w + warp * kBM * kMaxRank;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      if (mt < n_mt && nt * 8 < R)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          wrow[(mt * 16 + gq + 8 * (c >> 1)) * kMaxRank + nt * 8 + 2 * t4 +
               (c & 1)] = acc[mt][nt][c];
  __syncthreads();
  for (int e = threadIdx.x; e < nr * R; e += kLoraThreads) {
    const int i = e / R, j = e % R;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) v += s_w[(w * kBM + i) * kMaxRank + j];
    s_part[i * kMaxRank + j] = v;
  }
}

// Phase 1 on the CUDA cores (f32 x or A, or shapes the tensor-core form
// does not take): each thread sums its (row, rank) outputs of the block's
// K slice [k_lo, k_hi) in K order, fp32 products of x and A rounded to
// x's dtype, over chunks of 64 K staged as float.
template <typename TX, typename TA>
__device__ __forceinline__ void lora_h_fma(const LoraParams& p, int s,
                                           int r0, int r1, int k_lo,
                                           int k_hi, unsigned char* stage,
                                           float* s_part) {
  constexpr int kPer = kBM * kMaxRank / kLoraThreads;  // outputs a thread
  const int nr = r1 - r0, R = p.R;
  const TX* x = static_cast<const TX*>(p.x);
  const TA* a = static_cast<const TA*>(p.a) +
                static_cast<int64_t>(s) * p.K * R;
  float* sxf = reinterpret_cast<float*>(stage);     // [64][kLoraFC + 1]
  float* saf = sxf + kBM * (kLoraFC + 1);           // [kLoraFC][kMaxRank]
  float acc[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) acc[q] = 0.f;
  for (int k0 = k_lo; k0 < k_hi; k0 += kLoraFC) {
    const int kn = min(kLoraFC, k_hi - k0);
    __syncthreads();
    for (int c = threadIdx.x; c < nr * kn; c += kLoraThreads) {
      const int i = c / kn, k = c % kn;
      sxf[i * (kLoraFC + 1) + k] =
          ptt::to_f32(x[static_cast<int64_t>(r0 + i) * p.K + k0 + k]);
    }
    for (int c = threadIdx.x; c < kn * R; c += kLoraThreads)
      saf[(c / R) * kMaxRank + c % R] = as_x_dtype<TX>(
          ptt::to_f32(a[static_cast<int64_t>(k0) * R + c]));
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int e = threadIdx.x + q * kLoraThreads;
      if (e < nr * R) {
        const float* xr = sxf + (e / R) * (kLoraFC + 1);
        const float* ac = saf + e % R;
        for (int k = 0; k < kn; ++k)
          acc[q] = fmaf(xr[k], ac[k * kMaxRank], acc[q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = threadIdx.x + q * kLoraThreads;
    if (e < nr * R) s_part[(e / R) * kMaxRank + e % R] = acc[q];
  }
}

// One cluster of kLoraC blocks per unit of the work map; block c (its
// rank) owns output columns [c * cols, (c + 1) * cols) and K slice c of
// cdiv(K, 16) k-steps. A unit with no live rows writes its tile's rows
// past offsets[S] as zeros (over each block's columns) and exits. A live
// unit: each block issues its first B chunk, sums its K slice of
// x_unit @ A[s] (phase 1), the slices meet through distributed shared
// memory, summed by every block in rank order (the same h in all, no
// atomics), and each block writes h @ B[s] over its columns with fp32
// FMAs, B read in 16-byte vectors from shared memory (phase 2).
template <typename TX, typename TA, bool kMma>
__device__ __forceinline__ void lora_delta_body(const LoraParams& p) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStageBytes = kMma ? kLoraStages * kLoraStage : kLoraFStage;
  unsigned char* stage = smem;
  float* s_part = reinterpret_cast<float*>(smem + kStageBytes);
  float* s_h = s_part + kBM * kMaxRank;
  TA* s_b = reinterpret_cast<TA*>(s_h + kBM * kMaxRank);  // [R][kLoraCols]
  const int rank = blockIdx.x, u = blockIdx.y, R = p.R;
  const int n_lo = rank * p.cols, n_hi = min(p.N, n_lo + p.cols);
  zero_dead_rows(p.offsets, p.S, p.nm, u, p.T, p.N, n_lo, p.cols, p.out,
                 p.out_dt);
  const Unit un = unit_at(p.offsets, p.S, p.nm, u);
  const int t0 = un.tid * kBM;
  const int r0 = max(un.lo, t0);
  const int r1 = min(min(un.hi, t0 + kBM), p.T);
  if (r1 <= r0) return;  // the whole cluster: one unit
  const int s = un.gid, nr = r1 - r0;
  const TA* bs = static_cast<const TA*>(p.b) +
                 static_cast<int64_t>(s) * R * p.N;
  constexpr int kVec = 16 / sizeof(TA);  // B columns a 16-byte copy
  // B columns [n0, n0 + cols) into s_b
  auto load_b = [&](int n0) {
    const int cols = min(kLoraCols, n_hi - n0);
    if (p.b_vec) {
      for (int c = threadIdx.x; c < R * (cols / kVec); c += kLoraThreads) {
        const int j = c / (cols / kVec), e = (c % (cols / kVec)) * kVec;
        ptt::cp_async16(s_b + j * kLoraCols + e,
                        bs + static_cast<int64_t>(j) * p.N + n0 + e, 16);
      }
    } else {
      for (int c = threadIdx.x; c < R * cols; c += kLoraThreads) {
        const int j = c / cols, e = c % cols;
        s_b[j * kLoraCols + e] = bs[static_cast<int64_t>(j) * p.N + n0 + e];
      }
    }
  };
  if (n_lo < n_hi) load_b(n_lo);  // in flight beside phase 1
  ptt::cp_async_commit();

  const int KS = (p.K + 15) / 16;
  const int ks0 = rank * KS / kLoraC, ks1 = (rank + 1) * KS / kLoraC;
  if constexpr (kMma)
    lora_h_mma(p, s, r0, r1, ks0, ks1, stage, s_part);
  else
    lora_h_fma<TX, TA>(p, s, r0, r1, min(p.K, ks0 * 16),
                       min(p.K, ks1 * 16), stage, s_part);

  // h = the blocks' slices summed in rank order, read from each block's
  // shared memory
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int e = threadIdx.x; e < nr * R; e += kLoraThreads) {
    const int i = e / R, j = e % R;
    float v = 0.f;
#pragma unroll
    for (int c = 0; c < kLoraC; ++c)
      v += cluster.map_shared_rank(s_part, c)[i * kMaxRank + j];
    s_h[i * kMaxRank + j] = v;
  }
  cluster.sync();  // no block leaves while its slice is read
  ptt::cp_async_wait<0>();
  __syncthreads();

  // phase 2: out[r][n] = h[r] @ B[s][:, n], 4 rows x 8 columns an item
  for (int n0 = n_lo; n0 < n_hi; n0 += kLoraCols) {
    if (n0 != n_lo) {
      __syncthreads();
      load_b(n0);
      ptt::cp_async_commit();
      ptt::cp_async_wait<0>();
      __syncthreads();
    }
    const int cols = min(kLoraCols, n_hi - n0);
    const int n_groups = (cols + 7) / 8, n_items = (nr + 3) / 4 * n_groups;
    for (int it = threadIdx.x; it < n_items; it += kLoraThreads) {
      const int rc = it / n_groups, cg8 = (it % n_groups) * 8;
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
      for (int j = 0; j < R; ++j) {
        float bv[8];
        const TA* brow = s_b + j * kLoraCols + cg8;
        if constexpr (sizeof(TA) == 2) {
          const uint4 w = *reinterpret_cast<const uint4*>(brow);
          const __nv_bfloat162* h2 =
              reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h2[e]);
            bv[2 * e] = f.x;
            bv[2 * e + 1] = f.y;
          }
        } else {
          const float4 w0 = *reinterpret_cast<const float4*>(brow);
          const float4 w1 = *reinterpret_cast<const float4*>(brow + 4);
          bv[0] = w0.x, bv[1] = w0.y, bv[2] = w0.z, bv[3] = w0.w;
          bv[4] = w1.x, bv[5] = w1.y, bv[6] = w1.z, bv[7] = w1.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float hv = s_h[min(rc * 4 + i, nr - 1) * kMaxRank + j];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(hv, bv[e], acc[i][e]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + rc * 4 + i;
        if (r >= r1) break;
        const int64_t o = static_cast<int64_t>(r) * p.N + n0 + cg8;
        if (p.out_vec && cg8 + 8 <= cols) {
          float* dst = static_cast<float*>(p.out) + o;
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          *reinterpret_cast<float4*>(dst + 4) =
              make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (cg8 + e < cols) store_dt(p.out, o + e, p.out_dt, acc[i][e]);
        }
      }
    }
  }
}

// phase 1 on the tensor cores (bf16 x and A) or on the CUDA cores
__global__ void __launch_bounds__(kLoraThreads)
    lora_delta_mma(const LoraParams p) {
  lora_delta_body<__nv_bfloat16, __nv_bfloat16, true>(p);
}

template <typename TX, typename TA>
__global__ void __launch_bounds__(kLoraThreads)
    lora_delta_fma(const LoraParams p) {
  lora_delta_body<TX, TA, false>(p);
}

template <typename TA>
cudaError_t launch_lora(void (*kernel)(LoraParams), bool mma,
                        const LoraParams& p, int nwu, cudaStream_t s) {
  const int smem = (mma ? kLoraStages * kLoraStage : kLoraFStage) +
                   2 * kLoraH +
                   p.R * kLoraCols * static_cast<int>(sizeof(TA));
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kLoraC, nwu);
  cfg.blockDim = dim3(kLoraThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kLoraC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, p);
}

// B15's walk written out (for the check against dw_tile_order)
__global__ void dw_tiles_kernel(const int* offsets, int E, int per,
                                int* tiles) {
  __shared__ int order[kDwMaxExperts];
  dw_expert_order(offsets, E, order);
  __syncthreads();
  for (int t = threadIdx.x; t < E * per; t += blockDim.x)
    tiles[t] = dw_tile_at(order, per, t);
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

// trans_w 0: w is the [E, K, N] bank; 1: w is read as [E, N, K] (the
// forward bank of a [T, N] -> [T, K] product, for dx = dz @ W[e]^T)
extern "C" int ptt_grouped_gemm(const void* x, const void* w,
                                const void* bias, int bias_dt,
                                const int* offsets, void* out, int out_dt,
                                int dtype, int T, int K, int N, int E,
                                int bm, int act, int trans_w,
                                void* stream) {
  const int nm = (T + kBM - 1) / kBM, nwu = nm + 2 * E + 1;
  if (bm != kBM || nwu > 65535 || E < 1 || T < 1)
    return cudaErrorInvalidValue;
  GroupedParams p{x, w, bias, offsets, out, bias_dt, out_dt,
                  T, K, N, E, nm, act};
  const dim3 grid((N + kBN - 1) / kBN, nwu);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16) {
    if (K % 8 || N % 8) return cudaErrorInvalidValue;  // 16-byte strides
    return trans_w ? launch_wgmma<true>(p, s) : launch_wgmma<false>(p, s);
  }
  if (dtype == ptt::kF32 && !trans_w)
    grouped_gemm_kernel<false><<<grid, kThreads, 0, s>>>(p);
  else if (dtype == ptt::kF32)
    grouped_gemm_kernel<true><<<grid, kThreads, 0, s>>>(p);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// the tiles B15's bf16 kernel walks, in order: E * cdiv(K, 128) *
// cdiv(N, 256) ids into `tiles`
extern "C" int ptt_grouped_dw_tiles(const int* offsets, int E, int K, int N,
                                    int* tiles, void* stream) {
  if (E < 1 || E > kDwMaxExperts || K < 1 || N < 1)
    return cudaErrorInvalidValue;
  const int per = (K + kDwBM - 1) / kDwBM * ((N + kDwBN - 1) / kDwBN);
  dw_tiles_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      offsets, E, per, tiles);
  return cudaGetLastError();
}

// dw [E, K, N] (out_dt) = per expert x[seg]^T @ dz[seg]; x [T, K] and dz
// [T, N] in dtype
extern "C" int ptt_grouped_dw(const void* x, const void* dz,
                              const int* offsets, void* out, int out_dt,
                              int dtype, int T, int K, int N, int E,
                              void* stream) {
  const int mt = (K + kBN - 1) / kBN;
  if (E < 1 || E > 65535 || mt > 65535 || T < 0)
    return cudaErrorInvalidValue;
  DwParams p{x, dz, offsets, out, out_dt, T, K, N};
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16) {
    if (K % 8 || N % 8 || T < 1 || E > kDwMaxExperts)
      return cudaErrorInvalidValue;  // 16-byte strides; a map needs rows
    return launch_dw_wgmma(p, E, s);
  }
  if (dtype != ptt::kF32) return cudaErrorInvalidValue;
  grouped_dw_kernel<<<dim3((N + kBN - 1) / kBN, mt, E), kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

// out [T, N] (out_dt) = per slot (x[seg] @ A[s]) @ B[s]; x [T, K] in x_dt,
// A [S, K, R] and B [S, R, N] in one bank dtype, R <= 32; rows past
// offsets[S] are written as zeros. Pointers 16-byte aligned.
extern "C" int ptt_lora_delta(const void* x, int x_dt, const void* a,
                              int a_dt, const void* b, int b_dt,
                              const int* offsets, void* out, int out_dt,
                              int T, int K, int N, int S, int R, int bm,
                              void* stream) {
  const int nm = (T + kBM - 1) / kBM, nwu = nm + 2 * S + 1;
  if (bm != kBM || nwu > 65535 || S < 1 || T < 1 || R < 1 ||
      R > kMaxRank || a_dt != b_dt || K < 1 || N < 1)
    return cudaErrorInvalidValue;
  // each block's columns: a multiple of 8 (whole 16-byte B vectors)
  const int cols = ((N + kLoraC - 1) / kLoraC + 7) / 8 * 8;
  auto aligned = [](const void* v) {
    return reinterpret_cast<uintptr_t>(v) % 16 == 0;
  };
  const int b_item = a_dt == ptt::kBF16 ? 2 : 4;
  const int b_vec = aligned(b) && N * b_item % 16 == 0;
  const int out_vec = out_dt == ptt::kF32 && aligned(out) && N % 4 == 0;
  LoraParams p{x,  a,  b, offsets, out, out_dt, T,   K,
               N,  S,  R, nm,      cols, b_vec, out_vec};
  auto s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_dt == ptt::kBF16 && a_dt == ptt::kBF16 && K % 8 == 0 &&
      R % 16 == 0 && aligned(x) && aligned(a))
    return launch_lora<bf16>(lora_delta_mma, true, p, nwu, s);
  if (x_dt == ptt::kBF16 && a_dt == ptt::kBF16)
    return launch_lora<bf16>(lora_delta_fma<bf16, bf16>, false, p, nwu, s);
  if (x_dt == ptt::kBF16 && a_dt == ptt::kF32)
    return launch_lora<float>(lora_delta_fma<bf16, float>, false, p, nwu,
                              s);
  if (x_dt == ptt::kF32 && a_dt == ptt::kBF16)
    return launch_lora<bf16>(lora_delta_fma<float, bf16>, false, p, nwu, s);
  if (x_dt == ptt::kF32 && a_dt == ptt::kF32)
    return launch_lora<float>(lora_delta_fma<float, float>, false, p, nwu,
                              s);
  return cudaErrorInvalidValue;
}
