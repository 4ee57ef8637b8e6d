// Paged prefill attention: a prompt chunk's queries over the paged pool.
//
// Replaces the TPU kernel _paged_fwd_pallas
// (paddle_tpu/nn/functional/flash_varlen.py:906, pallas_call at :1022),
// reached through paged_prefill_attention (:1104).
// Python wrapper: paddle_tpu_torch/nn/functional/flash_varlen.py.
//
// What it computes. q [b, c, n_q, d] holds the chunk's queries at
// positions start[b] .. start[b]+c-1 (heads kv-major: head = kv*g + j).
// Query t of row b attends every key at position <= start[b] + t below
// the table's span pp*page_size, read in place from the page-major pool
// [P, n_kv, page_size, d] through block_tables[b] (absolute page ids):
// the cached prefix, pages other rows share, and the chunk's own K/V,
// which the caller wrote before this launch on the same stream. A table
// id outside [0, P) names no page: nothing is read there and its keys
// are not attended. Scores, softmax and accumulation are fp32; the
// output is in q's dtype. A query with nothing to attend gets zeros.
//
// Bound. A chunk of c queries per kv head does 4*d*c flops per key for
// the 4*d bytes of its bf16 K and V rows, read once: c flops a byte, 256
// at c = 256, just under the card's bf16 balance (~295). At the serving
// rung (b 1, c 256 at start 1792, 16 heads of 128) the K/V bytes bound it
// at 0.0056 ms and the tensor cores' operations (4.03 GFLOP) at 0.0041
// ms: a kernel that reaches either must run its products on the tensor
// cores, keep the page loads in flight while it computes, and occupy
// every SM, though the chunk gives only 4 q tiles x 16 heads.
//
// Design, bf16 at head_dim 64, 96, 128 and 256 (paged_prefill_mma). The TPU
// kernel runs one sequential grid step per batch row and double-buffers
// whole pages of all heads through VMEM. Here a block of 4 warps owns a q
// tile of 64 query vectors (64/g chunk rows times the g query heads of one
// kv head, so the g heads share every K/V tile) and one of n_split slices of
// the tile's key range, cut in whole key tiles of kN = 64 positions (32 at
// d256). The key range stops at the tile's last query position (causal early
// exit). Per key tile the block looks its rows up in the block table once,
// two tiles ahead (up to 64 threads, one row each: the row's element offset
// in the pool, -1 for a position past the range or on an id outside the
// pool; the table is read before the tile in hand is computed and the
// offsets stored after), and copies the rows with 16-byte cp.async into a
// 2-stage ring, so tile j+1's pages land while tile j is computed; a row
// whose id names no page is zero-filled and never read. A page's kv-head
// slice is page_size*d contiguous elements, so any page size works: a tile
// is 4 pages of 16, 8 of 8, or half a page of 128 keys. Each warp computes
// S = QK^T for its 16 vectors from q's and k's raw bf16 values on the tensor
// cores (mma.sync m16n8k16, ldmatrix fragments, fp32 sums; flash_tiles.cuh)
// and applies the scale to the fp32 scores (base 2: scale * log2 e), so
// q*scale is never rounded. Tiles wholly below a warp's first query position
// and on whole pages skip the mask; the others mask per key. The online
// softmax keeps (m, l) in fp32, and P V takes p as a bf16 pair (hi + lo: p
// is rounded to 2^-17, not to bf16), from the same V fragments.
//
// Filling the card. With n_split > 1 (the wrapper's prefill_grid: as
// many key slices as keep two blocks on every SM, at most 16, each at
// least 2 key tiles of the widest walk) each block writes its fp32
// partial (m, l and the unnormalised output of its 64 vectors) to a
// workspace, takes a ticket from the q tile's counter, and the last of
// the tile's blocks merges the n_split partials in split order by
// log-sum-exp and writes the output: one launch, and the same result
// from run to run whichever block comes last. At the rung: 4 q tiles x
// 16 heads x 4 slices = 256 blocks on 132 SMs.
//
// float32 pools, and bf16 at another head_dim <= 256, keep the CUDA-core
// kernel (paged_prefill_kernel): one block per (64 query vectors, kv
// head, row), 32-key tiles converted to fp32 in shared memory, products
// on the CUDA cores in fp32, no split.
#include "flash_tiles.cuh"

namespace {

using ptt::from_f32;
using ptt::to_f32;

constexpr int kThreads = 256;
constexpr int kQV = 64;    // query vectors (row, head) per block
constexpr int kBK = 32;    // key positions per tile
constexpr int kPerThread = kQV * 16 / kThreads;  // query vectors a thread owns

struct Params {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* tables;
  const int* start;
  void* out;
  int c, n_q, n_kv, g, d, ps, pp, num_pages, rows;
  float scale;
};

__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int d) {
  return sizeof(int64_t) * kBK +
         sizeof(float) * (static_cast<size_t>(kQV) * (d + 1) +
                          static_cast<size_t>(kBK) * (d + 1) +
                          static_cast<size_t>(kBK) * d + kQV * (kBK + 1));
}

// DC: output columns a thread owns, ceil(d / 16) rounded up to a power of 2
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
    paged_prefill_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = p.d, dp = d + 1;
  int64_t* koff = reinterpret_cast<int64_t*>(smem_raw);  // [kBK], -1: none
  float* Qs = reinterpret_cast<float*>(koff + kBK);      // [kQV][d+1]
  float* Ks = Qs + kQV * dp;                             // [kBK][d+1]
  float* Vs = Ks + kBK * dp;                             // [kBK][d]
  float* Ps = Vs + kBK * d;                              // [kQV][kBK+1]

  const int tid = threadIdx.x;
  const int kv = blockIdx.y, bi = blockIdx.z;
  const int g = p.g, c = p.c;
  const int t0 = blockIdx.x * p.rows;
  const int n_vec = p.rows * g;
  const int st = p.start[bi];
  const int t_last = min(t0 + p.rows, c) - 1;
  const int span = p.pp * p.ps;
  const int key_end = min(span, st + t_last + 1);  // causal early exit
  const int64_t row_stride = static_cast<int64_t>(p.n_q) * d;
  const int64_t head_stride = static_cast<int64_t>(p.ps) * d;
  const int64_t page_stride = head_stride * p.n_kv;
  const T* q = static_cast<const T*>(p.q);
  const T* kp = static_cast<const T*>(p.k_pool);
  const T* vp = static_cast<const T*>(p.v_pool);

  // the q tile, scaled, in fp32; vector v is row t0 + v/g, head kv*g + v%g
  for (int i = tid; i < kQV * d; i += kThreads) {
    const int v = i / d, e = i - v * d;
    const int t = t0 + v / g;
    float x = 0.f;
    if (v < n_vec && t < c)
      x = to_f32(q[(static_cast<int64_t>(bi) * c + t) * row_stride +
                   static_cast<int64_t>(kv * g + v % g) * d + e]) *
          p.scale;
    Qs[v * dp + e] = x;
  }
  const int r = tid >> 4, cg = tid & 15;
  int qpos[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int v = r * kPerThread + i;
    const int t = t0 + v / g;
    qpos[i] = (v < n_vec && t < c) ? st + t : -1;  // -1 attends nothing
  }
  float m[kPerThread], l[kPerThread], acc[kPerThread][DC];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) acc[i][cc] = 0.f;
  }

  for (int kb = 0; kb < key_end; kb += kBK) {
    __syncthreads();  // the previous tile is consumed
    if (tid < kBK) {
      const int pos = kb + tid;
      int64_t off = -1;
      if (pos < key_end) {
        const int page =
            p.tables[static_cast<int64_t>(bi) * p.pp + pos / p.ps];
        if (static_cast<unsigned>(page) < static_cast<unsigned>(p.num_pages))
          off = static_cast<int64_t>(page) * page_stride + kv * head_stride +
                static_cast<int64_t>(pos % p.ps) * d;
      }
      koff[tid] = off;
    }
    __syncthreads();
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int k = i / d, e = i - k * d;
      const int64_t off = koff[k];
      float kx = 0.f, vx = 0.f;
      if (off >= 0) {
        kx = to_f32(kp[off + e]);
        vx = to_f32(vp[off + e]);
      }
      Ks[k * dp + e] = kx;
      Vs[k * d + e] = vx;
    }
    __syncthreads();

    // scores of the thread's 4 query vectors against keys cg and cg+16
    float s[kPerThread][2];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) s[i][0] = s[i][1] = 0.f;
    const float* k0 = Ks + cg * dp;
    const float* k1 = Ks + (cg + 16) * dp;
    const float* qr = Qs + r * kPerThread * dp;
#pragma unroll 4
    for (int e = 0; e < d; ++e) {
      const float a0 = k0[e], a1 = k1[e];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const float qq = qr[i * dp + e];
        s[i][0] = fmaf(qq, a0, s[i][0]);
        s[i][1] = fmaf(qq, a1, s[i][1]);
      }
    }
    // mask, then the online softmax over the 16 threads of each vector
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kk = cg + 16 * j;
        const bool ok = koff[kk] >= 0 && kb + kk <= qpos[i];
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group16_max(mx);
      const float mn = fmaxf(m[i], mx);
      const float mu = mn == -INFINITY ? 0.f : mn;  // nothing seen yet
      const float alpha = expf(m[i] - mu);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float pr = expf(s[i][j] - mu);  // masked: exp(-inf) = 0
        Ps[(r * kPerThread + i) * (kBK + 1) + cg + 16 * j] = pr;
        sum += pr;
      }
      l[i] = l[i] * alpha + group16_sum(sum);
      m[i] = mn;
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) acc[i][cc] *= alpha;
    }
    __syncthreads();
    // acc += P . V over the tile
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float pr[kPerThread];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i)
        pr[i] = Ps[(r * kPerThread + i) * (kBK + 1) + k];
      const float* vrow = Vs + k * d;
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const int col = cg + 16 * cc;
        const float vv = col < d ? vrow[col] : 0.f;
#pragma unroll
        for (int i = 0; i < kPerThread; ++i)
          acc[i][cc] = fmaf(pr[i], vv, acc[i][cc]);
      }
    }
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int v = r * kPerThread + i;
    const int t = t0 + v / g;
    if (v >= n_vec || t >= c) continue;
    T* orow = out + (static_cast<int64_t>(bi) * c + t) * row_stride +
              static_cast<int64_t>(kv * g + v % g) * d;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      const int col = cg + 16 * cc;
      if (col < d)
        orow[col] = from_f32<T>(l[i] > 0.f ? acc[i][cc] / l[i] : 0.f);
    }
  }
}

template <typename T, int DC>
int launch(const Params& p, int b, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.d);
  static size_t smem_set = 0;  // the opt-in this instantiation was given
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel<T, DC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const dim3 grid((p.c + p.rows - 1) / p.rows, p.n_kv, b);
  paged_prefill_kernel<T, DC><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Params& p, int b, cudaStream_t stream) {
  if (p.d <= 32) return launch<T, 2>(p, b, stream);
  if (p.d <= 64) return launch<T, 4>(p, b, stream);
  if (p.d <= 128) return launch<T, 8>(p, b, stream);
  return launch<T, 16>(p, b, stream);
}


// ------------------------------------------------ bf16: tensor cores

namespace tl = ptt::tiles;
using tl::bf16;

constexpr int kMV = 64;       // query vectors a block: 4 warps x 16
constexpr int kMaxSplit = 16;  // key slices of a q tile (prefill_grid)
constexpr float kNegM = -1e30f;  // the running max before any key

template <int D>
struct MmaTile {
  static constexpr int kN = D > 128 ? 32 : 64;  // key positions a tile
  static constexpr int kPitch = tl::TileBf16<D>::kPitch;
  static constexpr size_t kSmem =
      sizeof(bf16) * kPitch * (kMV + 4 * kN)    // Q, then K and V x 2
      + sizeof(int64_t) * 3 * kN                // row offsets, 3 tiles
      + sizeof(int) * 8;                        // holes [3][2], ticket
};

struct MmaParams {
  const bf16* q;
  const bf16* k_pool;
  const bf16* v_pool;
  const int* tables;
  const int* start;
  bf16* out;
  float* ws;  // n_split > 1: partial outputs, then (m, l), then counters
  int c, n_q, n_kv, g, ps, pp, num_pages, rows, q_tiles, n_split;
  float scale;
};

// acc[D/8][4] += P V with P (a warp's 16 x K fp32 probabilities, in the
// accumulator layout) as a bf16 pair hi + lo, hi = bf16(p), lo = p - hi,
// split one k-step at a time; V (K rows x D, row-major at `b`) is read
// once for both products
template <int K, int D>
__device__ __forceinline__ void mma_pv2(float (&acc)[D / 8][4],
                                        const float (&x)[K / 8][4],
                                        const bf16* b) {
  constexpr int kPitch = tl::TileBf16<D>::kPitch;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    float h[8], r[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float v = x[2 * kk + i / 4][i % 4];
      h[i] = tl::bf16_round(v);
      r[i] = v - h[i];
    }
    const uint32_t a0 = ptt::pack2<tl::bf16>(h[0], h[1]);
    const uint32_t a1 = ptt::pack2<tl::bf16>(h[2], h[3]);
    const uint32_t a2 = ptt::pack2<tl::bf16>(h[4], h[5]);
    const uint32_t a3 = ptt::pack2<tl::bf16>(h[6], h[7]);
    const uint32_t c0 = ptt::pack2<tl::bf16>(r[0], r[1]);
    const uint32_t c1 = ptt::pack2<tl::bf16>(r[2], r[3]);
    const uint32_t c2 = ptt::pack2<tl::bf16>(r[4], r[5]);
    const uint32_t c3 = ptt::pack2<tl::bf16>(r[6], r[7]);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b0, b1, b2, b3;
      ptt::ldmatrix_x4_trans(
          b0, b1, b2, b3,
          b + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kPitch +
              np * 16 + (lane >> 4) * 8);
      ptt::mma_bf16(acc[2 * np], a0, a1, a2, a3, b0, b1);
      ptt::mma_bf16(acc[2 * np + 1], a0, a1, a2, a3, b2, b3);
      ptt::mma_bf16(acc[2 * np], c0, c1, c2, c3, b0, b1);
      ptt::mma_bf16(acc[2 * np + 1], c0, c1, c2, c3, b2, b3);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(tl::kThreads)
    paged_prefill_mma(const MmaParams p) {
  constexpr int kN = MmaTile<D>::kN, kPitch = MmaTile<D>::kPitch;
  constexpr int kChunks = D / 8;  // 16-byte copies a row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);            // [kMV][kPitch]
  bf16* sk = sq + kMV * kPitch;                        // [2][kN][kPitch]
  bf16* sv = sk + 2 * kN * kPitch;                     // [2][kN][kPitch]
  int64_t* koff = reinterpret_cast<int64_t*>(sv + 2 * kN * kPitch);
  int* hole = reinterpret_cast<int*>(koff + 3 * kN);   // [3][2]
  int* ticket = hole + 6;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, t4 = lane & 3;
  const int split = blockIdx.x % p.n_split;
  const int tile = p.q_tiles - 1 - blockIdx.x / p.n_split;  // long first
  const int kv = blockIdx.y, bi = blockIdx.z;
  const int g = p.g, c = p.c, t0 = tile * p.rows;
  const int n_vec = min(p.rows, c - t0) * g;  // the tile's real vectors
  const int st = p.start[bi];
  const int key_end = max(0, min(p.pp * p.ps, st + min(t0 + p.rows, c)));
  const int n_kt = (key_end + kN - 1) / kN;
  const int kt0 = split * n_kt / p.n_split;
  const int nt = (split + 1) * n_kt / p.n_split - kt0;
  const int64_t head_stride = static_cast<int64_t>(p.ps) * D;
  const int64_t page_stride = head_stride * p.n_kv;
  const int* table = p.tables + static_cast<int64_t>(bi) * p.pp;

  // thread tid < kN looks up key row tid of a tile: the page id of its
  // position (-1 past the walk), then its pool offset into slot `slot`
  // (-1: not on a page) and whether the tile has such a row ("hole")
  auto fetch = [&](int kt) {
    const int pos = kt * kN + tid;
    return pos < key_end ? table[pos / p.ps] : -1;
  };
  auto store = [&](int kt, int slot, int id) {
    const int pos = kt * kN + tid;
    int64_t off = -1;
    if (static_cast<unsigned>(id) < static_cast<unsigned>(p.num_pages))
      off = id * page_stride + kv * head_stride +
            static_cast<int64_t>(pos % p.ps) * D;
    koff[slot * kN + tid] = off;
    const unsigned any = __ballot_sync(0xffffffffu, off < 0);
    if (lane == 0) hole[slot * 2 + warp] = any != 0u;
  };
  auto load_kv = [&](int slot, int stage) {
    const int64_t* off = koff + slot * kN;
    bf16* dk = sk + stage * kN * kPitch;
    bf16* dv = sv + stage * kN * kPitch;
    for (int i = tid; i < kN * kChunks; i += tl::kThreads) {
      const int r = i / kChunks, e = (i % kChunks) * 8;
      const int64_t o = off[r];
      const bool in = o >= 0;
      ptt::cp_async16(dk + r * kPitch + e, in ? p.k_pool + o + e : p.k_pool,
                      in ? 16 : 0);
      ptt::cp_async16(dv + r * kPitch + e, in ? p.v_pool + o + e : p.v_pool,
                      in ? 16 : 0);
    }
  };

  if (tid < 6) hole[tid] = 0;
  __syncthreads();
  if (tid < kN) {
    if (nt > 0) store(kt0, 0, fetch(kt0));
    if (nt > 1) store(kt0 + 1, 1, fetch(kt0 + 1));
  }
  // the q tile: vector v is row t0 + v/g, head kv*g + v%g
  for (int i = tid; i < kMV * kChunks; i += tl::kThreads) {
    const int v = i / kChunks, e = (i % kChunks) * 8;
    const bool in = v < n_vec;
    const bf16* src =
        p.q + ((static_cast<int64_t>(bi) * c + t0 + v / g) * p.n_q +
               kv * g + v % g) * D + e;
    ptt::cp_async16(sq + v * kPitch + e, in ? src : p.q, in ? 16 : 0);
  }
  __syncthreads();  // slots 0 and 1 are visible
  if (nt > 0) load_kv(0, 0);
  ptt::cp_async_commit();

  // this thread's vectors v0 and v0 + 8; -1: a pad vector, sees nothing
  const int v0 = warp * 16 + gq;
  int qpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    qpos[r] = v0 + 8 * r < n_vec ? st + t0 + (v0 + 8 * r) / g : -1;
  const int qmin = warp * 16 < n_vec ? st + t0 + warp * 16 / g : -1;
  const float sl2 = p.scale * tl::kLog2e;

  float o[D / 8][4];
  tl::zero(o);
  float m[2] = {kNegM, kNegM}, l[2] = {0.f, 0.f};
  for (int j = 0; j < nt; ++j) {
    // tile j+2's page ids, read now and stored after this tile's math
    const int id = j + 2 < nt && tid < kN ? fetch(kt0 + j + 2) : -1;
    if (j + 1 < nt) load_kv((j + 1) % 3, (j + 1) & 1);
    ptt::cp_async_commit();
    ptt::cp_async_wait<1>();
    __syncthreads();  // tile j landed

    const int slot = j % 3, kb = (kt0 + j) * kN;
    const bf16* kt = sk + (j & 1) * kN * kPitch;
    const bf16* vt = sv + (j & 1) * kN * kPitch;
    float s[kN / 8][4];
    tl::zero(s);
    tl::mma_abt<kN, D>(s, sq + warp * 16 * kPitch, kt);
    const bool masked =
        kb + kN - 1 > qmin || hole[slot * 2] || hole[slot * 2 + 1];
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n8 = 0; n8 < kN / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n8][e] * sl2;
        if (masked) {
          const int kk = n8 * 8 + 2 * t4 + (e & 1);
          if (koff[slot * kN + kk] < 0 || kb + kk > qpos[e >> 1])
            x = -INFINITY;
        }
        s[n8][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = tl::quad_max(mx[r]);
      const float alpha = exp2f(m[r] - mx[r]);  // 0 at the first key seen
      m[r] = mx[r];
      l[r] *= alpha;
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8) {
        o[n8][2 * r] *= alpha;
        o[n8][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n8 = 0; n8 < kN / 8; ++n8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n8][e] = exp2f(s[n8][e] - m[e >> 1]);  // masked: 0
        l[e >> 1] += s[n8][e];
      }
    mma_pv2<kN, D>(o, s, vt);
    if (j + 2 < nt && tid < kN) store(kt0 + j + 2, (j + 2) % 3, id);
    __syncthreads();  // the stage and slot are refilled from here on
  }
  ptt::cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = tl::quad_sum(l[r]);

  const int64_t row_stride = static_cast<int64_t>(p.n_q) * D;
  auto out_row = [&](int v) {
    return p.out + (static_cast<int64_t>(bi) * c + t0 + v / g) * row_stride +
           static_cast<int64_t>(kv * g + v % g) * D;
  };
  if (p.n_split == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int v = v0 + 8 * r;
      if (v >= n_vec) continue;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
      bf16* dst = out_row(v);
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8)
        *reinterpret_cast<__nv_bfloat162*>(dst + n8 * 8 + 2 * t4) =
            __floats2bfloat162_rn(o[n8][2 * r] * inv, o[n8][2 * r + 1] * inv);
    }
    return;
  }

  // the partial of (q tile, split): outputs [kMV][D], then (m, l) [kMV]
  const int64_t n_tiles =
      static_cast<int64_t>(p.q_tiles) * p.n_kv * gridDim.z;
  const int64_t tid_all =
      (static_cast<int64_t>(bi) * p.n_kv + kv) * p.q_tiles + tile;
  float* part_o = p.ws;
  float* part_ml = p.ws + n_tiles * p.n_split * kMV * D;
  int* counter =
      reinterpret_cast<int*>(part_ml + n_tiles * p.n_split * kMV * 2);
  const int64_t base = tid_all * p.n_split;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int v = v0 + 8 * r;
    float* dst = part_o + ((base + split) * kMV + v) * D;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
      *reinterpret_cast<float2*>(dst + n8 * 8 + 2 * t4) =
          make_float2(o[n8][2 * r], o[n8][2 * r + 1]);
    if (t4 == 0)
      *reinterpret_cast<float2*>(part_ml + ((base + split) * kMV + v) * 2) =
          make_float2(m[r], l[r]);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *ticket = atomicAdd(counter + tid_all, 1);
  __syncthreads();
  if (*ticket != p.n_split - 1) return;
  __threadfence();  // every partial of the tile is visible

  // the last block: per vector the weights exp2(m_s - M) / L of each
  // split, then the outputs summed in split order
  float* w = reinterpret_cast<float*>(sk);  // [kMaxSplit][kMV]
  if (tid < kMV) {
    float mm = kNegM, ll = 0.f;
    for (int s2 = 0; s2 < p.n_split; ++s2)
      mm = fmaxf(mm, __ldcg(part_ml + ((base + s2) * kMV + tid) * 2));
    for (int s2 = 0; s2 < p.n_split; ++s2) {
      const float2 ml =
          __ldcg(reinterpret_cast<const float2*>(part_ml) +
                 (base + s2) * kMV + tid);
      const float f = exp2f(ml.x - mm);
      w[s2 * kMV + tid] = f;
      ll += ml.y * f;
    }
    const float inv = ll > 0.f ? 1.f / ll : 0.f;
    for (int s2 = 0; s2 < p.n_split; ++s2) w[s2 * kMV + tid] *= inv;
  }
  __syncthreads();
  for (int i = tid; i < n_vec * (D / 4); i += tl::kThreads) {
    const int v = i / (D / 4), e = (i % (D / 4)) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s2 = 0; s2 < p.n_split; ++s2) {
      const float f = w[s2 * kMV + v];
      const float4 x = __ldcg(reinterpret_cast<const float4*>(
          part_o + ((base + s2) * kMV + v) * D + e));
      acc.x += f * x.x;
      acc.y += f * x.y;
      acc.z += f * x.z;
      acc.w += f * x.w;
    }
    bf16* dst = out_row(v) + e;
    reinterpret_cast<__nv_bfloat162*>(dst)[0] =
        __floats2bfloat162_rn(acc.x, acc.y);
    reinterpret_cast<__nv_bfloat162*>(dst)[1] =
        __floats2bfloat162_rn(acc.z, acc.w);
  }
  if (tid == 0) counter[tid_all] = 0;  // the workspace's next use
}

template <int D>
int launch_mma(const MmaParams& p, int b, cudaStream_t stream) {
  constexpr size_t smem = MmaTile<D>::kSmem;
  const cudaError_t e = cudaFuncSetAttribute(
      paged_prefill_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(p.q_tiles * p.n_split, p.n_kv, b);
  paged_prefill_mma<D><<<grid, tl::kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch. Shapes: q/out [b, c, n_q, d],
// pools [num_pages, n_kv, page_size, d] (all of `dtype`, contiguous),
// block_tables [b, pages_per_seq] and start [b] int32, on the device.
// n_q = n_kv * g with g <= 8, d <= 256. bf16 at d 64, 96, 128 or 256
// runs paged_prefill_mma with n_split key slices a q tile (1 to 16);
// n_split > 1 needs `ws`, f32 [tiles * n_split * 64 * (d + 2)] then int32
// [tiles] counters, tiles = ceil(c / (64 / g)) * n_kv * b (the counters
// are zeroed here). Every other case runs paged_prefill_kernel and takes
// n_split 1.
extern "C" int ptt_paged_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const int* block_tables, const int* start, void* out, void* ws,
    int dtype, int b, int c, int n_q, int n_kv, int d, int page_size,
    int pages_per_seq, int num_pages, int n_split, float scale,
    void* stream) {
  if (b == 0 || c == 0) return 0;
  if (n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv > 8 || n_q == 0 || d <= 0 ||
      d > 256 || page_size <= 0 || pages_per_seq <= 0 || num_pages <= 0 ||
      n_split < 1 || n_split > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = n_q / n_kv;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16 && (d == 64 || d == 96 || d == 128 || d == 256)) {
    const int rows = kMV / g, q_tiles = (c + rows - 1) / rows;
    MmaParams p{static_cast<const bf16*>(q),
                static_cast<const bf16*>(k_pool),
                static_cast<const bf16*>(v_pool),
                block_tables, start, static_cast<bf16*>(out),
                static_cast<float*>(ws), c, n_q, n_kv, g, page_size,
                pages_per_seq, num_pages, rows, q_tiles, n_split, scale};
    if (n_split > 1) {
      if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      const size_t tiles = static_cast<size_t>(q_tiles) * n_kv * b;
      const cudaError_t e = cudaMemsetAsync(
          p.ws + tiles * n_split * kMV * (d + 2), 0, tiles * sizeof(int),
          st);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    if (d == 64) return launch_mma<64>(p, b, st);
    if (d == 96) return launch_mma<96>(p, b, st);
    if (d == 128) return launch_mma<128>(p, b, st);
    return launch_mma<256>(p, b, st);
  }
  if (n_split != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,         k_pool,        v_pool,    block_tables,
                 start,     out,           c,         n_q,
                 n_kv,      g,             d,         page_size,
                 pages_per_seq, num_pages, kQV / g,   scale};
  if (dtype == ptt::kF32) return dispatch_d<float>(p, b, st);
  if (dtype == ptt::kBF16) return dispatch_d<__nv_bfloat16>(p, b, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
