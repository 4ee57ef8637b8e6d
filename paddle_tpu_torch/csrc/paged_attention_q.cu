// Fused KV append + paged GQA decode attention over an int8 KV pool.
//
// Replaces the TPU kernel paged_decode_attention_inplace_q
// (paddle_tpu/nn/functional/paged_attention.py:957, pallas_call at
// :1257). Python wrapper and plain version:
// paddle_tpu_torch/nn/functional/paged_attention.py.
//
// The pool holds int8 token rows [pages, n_kv, page_size, d] and f32
// per-(token, head) scales in planes [n_kv, pages * page_size]: page p's
// slot s at column p * page_size + s. Per batch row r and kv head h:
//   - q is quantized per (row, q head): qs = max(absmax / 127, 1e-8),
//     qq = clip(rint(q / qs), -127, 127);
//   - cached token t (t < seq_lens[r], through block_tables[r] +
//     pool_base, in the layer region) has logit
//     int32(qq . kq[t]) * (qs * d^-0.5) * k_scale[t];
//   - the current token joins unquantized from the operands: logit
//     (qq * qs) . new_k * d^-0.5, value new_v;
//   - an fp32 softmax over both; the output is
//     sum_t w_t * v_scale[t] * vq[t] + w_cur * new_v;
//   - the append: new_k/new_v[r, h] quantized per row into slot
//     seq_lens[r] % page_size of page block_tables[r, seq_lens[r] /
//     page_size] + pool_base, their scales into the planes; skipped for
//     a full table or a page outside the region [0, pool_pages).
// The TPU kernel also re-quantizes the softmax weights per chunk to run
// P.V on the int8 MXU; that tactic belongs to the TPU's chunk size and
// is not carried over (P.V keeps fp32 weights here).
//
// Design. The TPU kernel streams the whole layer region through one
// ordered grid and masks it with a one-owner-per-page map, which is wrong
// for pages shared between rows. Here each block walks its own row's
// table, so a shared page is read by every row that maps it.
//
// bf16 q (paged_decode_q_mma, the serving path): one block of 4 warps per
// (row, kv head), or per (row, kv head, split) when b * n_kv leaves the
// card short of blocks (the wrapper's decode_q_plan). A row's tokens go in
// tiles of 16; warp w takes the block's tiles w, w + 4, ... through a ring
// of 3 tiles of its own: lanes 0-15 copy the tile's 16 K rows, lanes 16-31
// its V rows (16-byte cp.async into rows padded to 16 + a multiple of 32
// bytes, so ldmatrix and the V reads meet no bank conflict), each lane
// one scale of its side (4-byte cp.async); page ids are read one tile
// ahead of the copies. Tokens past the length or on a page outside the
// region are never copied: their scores and weights are selected away,
// never multiplied, since a scale nobody wrote may be NaN.
//   S = qq K^T on the int8 tensor cores, mma.sync m16n8k32 s8 x s8 -> s32
//   (the g <= 8 query heads as M, the tile's 16 tokens as two n8 tiles):
//   exact integer dots, so each logit keeps the contract above.
//   Softmax once a tile: a quad shuffle for the max, one rescale of the
//   accumulators, one exp a score.
//   P V on the bf16 tensor cores, m16n8k16 with fp32 sums: the weights
//   p * v_scale split into three bf16 parts hi + mid + lo (within 2^-27
//   of each weight; a pair hi + lo, within 2^-18, moved bf16 outputs by a
//   rounding step often enough to meet the limit), two products a tile:
//   hi in A's rows 0-7 and mid in rows 8-15, then lo in rows 0-7, the
//   rows added at the end. V's int8 values (exact in bf16) come from
//   shared memory, each word holding 4 dims of one token, widened by byte
//   permutes; a thread's n8 column j of dim group G is dim 32 G + 4 gq +
//   j, so a thread ends with 8 contiguous dims of its head per group.
// The warps' states merge through shared memory; a split writes its state
// to the workspace and the last split of a (row, head), by an atomic
// ticket, merges them in split order: one launch a call. Only split 0
// appends, with warps 0 and 1; no block reads that slot.
// float32 q (paged_decode_q_kernel): the CUDA-core kernel, 4 warps taking
// interleaved runs of 4 tokens, fp32 dots (exact integers: |products| <=
// 127^2 and d <= 256 keep every partial sum below 2^24) and per-warp
// online softmax states merged at the end.
//
// Bound: bytes. Each block reads its row's int8 K and V rows once
// (2 * len * d bytes per kv head) plus 8 bytes of scales per token, half
// the bytes of the bf16 pool; 4 operations a K/V byte pair per query head
// are far below the tensor cores' balance.
#include "flash_tiles.cuh"

namespace {

using ptt::from_f32;
using ptt::load_dt;
using ptt::to_f32;

constexpr int kWarps = 4;
constexpr int kUnroll = 4;  // K/V rows a warp keeps in flight

struct Params {
  const void* q;
  const void* new_k;
  const void* new_v;
  int8_t* kq;
  float* ks;
  int8_t* vq;
  float* vs;
  const int* seq_lens;
  const int* tables;
  void* out;
  int dt, n_kv, g, d, ps, pp, pool_base, pool_pages;
  int64_t plane_cols;
  float scale;
  float* ws;    // bf16, n_split > 1: the splits' partials, then counters
  int n_split;  // bf16: blocks a (row, kv head)
};

template <int N>
struct alignas(N) I8Pack {
  int8_t v[N];
};

// bytes [lane*EPL, lane*EPL + EPL) of a d-long int8 row, as float
template <int EPL>
__device__ __forceinline__ void load_i8(const int8_t* row, int lane, int d,
                                        bool full, float (&v)[EPL]) {
  const int e0 = lane * EPL;
  if (full) {
    const I8Pack<EPL> pk = *reinterpret_cast<const I8Pack<EPL>*>(row + e0);
#pragma unroll
    for (int e = 0; e < EPL; ++e) v[e] = to_f32(pk.v[e]);
  } else {
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      v[e] = (e0 + e < d) ? to_f32(row[e0 + e]) : 0.f;
  }
}

// elements [lane*EPL, lane*EPL + EPL) of a float row of dtype code dt
template <int EPL>
__device__ __forceinline__ void load_f(const void* row, int64_t off,
                                       int lane, int d, int dt,
                                       float (&v)[EPL]) {
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int i = lane * EPL + e;
    v[e] = i < d ? load_dt(row, off + i, dt) : 0.f;
  }
}

// quantize one float row (this lane's part) and store it as int8 at
// `dst`; returns the row's scale
template <int EPL>
__device__ __forceinline__ float quantize_row(const float (&x)[EPL],
                                              int lane, int d, int8_t* dst) {
  float amax = 0.f;
#pragma unroll
  for (int e = 0; e < EPL; ++e) amax = fmaxf(amax, fabsf(x[e]));
  const float s = ptt::row_scale(ptt::warp_max(amax));
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int i = lane * EPL + e;
    if (i < d) dst[i] = static_cast<int8_t>(ptt::quantize_i8(x[e], s));
  }
  return s;
}

// one token (logit s_g per query head, value row v * vscale) into the
// warp's online softmax
template <int EPL, int G>
__device__ __forceinline__ void fold(const float (&s)[G], const float (&v)[EPL],
                                     float vscale, int g, float (&m)[G],
                                     float (&l)[G], float (&acc)[G][EPL]) {
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (gi < g) {
      const float mn = fmaxf(m[gi], s[gi]);
      const float alpha = expf(m[gi] - mn);  // m = -inf before any token
      const float pr = expf(s[gi] - mn);
      l[gi] = l[gi] * alpha + pr;
      const float pv = pr * vscale;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[gi][e] = fmaf(pv, v[e], acc[gi][e] * alpha);
      m[gi] = mn;
    }
  }
}

// float32 q: one block per (row, kv head) on the CUDA cores
template <int EPL, int G>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_q_kernel(const Params p) {
  const int h = blockIdx.x, row = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = p.g, d = p.d, ps = p.ps, n_kv = p.n_kv;
  const int n_q = n_kv * g;
  const bool full = (d == 32 * EPL);
  const int len = p.seq_lens[row];
  const int cap = p.pp * ps;
  const int n_tok = len < cap ? len : cap;  // pool tokens attended
  const int* trow = p.tables + static_cast<int64_t>(row) * p.pp;
  const int64_t head_stride = static_cast<int64_t>(ps) * d;
  const int64_t page_stride = head_stride * n_kv;
  const int64_t cur = (static_cast<int64_t>(row) * n_kv + h) * d;
  const unsigned region = static_cast<unsigned>(p.pool_pages);
  const float* ks = p.ks + h * p.plane_cols;
  const float* vs = p.vs + h * p.plane_cols;

  // the append, quantized (skipped for a full table or a page outside
  // the region); nobody reads this slot here
  if (warp < 2 && len < cap &&
      static_cast<unsigned>(trow[len / ps]) < region) {
    const int64_t page = trow[len / ps] + p.pool_base;
    const int64_t dst = page * page_stride + h * head_stride +
                        static_cast<int64_t>(len % ps) * d;
    float x[EPL];
    load_f<EPL>(warp == 0 ? p.new_k : p.new_v, cur, lane, d, p.dt, x);
    const float s = quantize_row<EPL>(x, lane, d,
                                      (warp == 0 ? p.kq : p.vq) + dst);
    if (lane == 0) (warp == 0 ? p.ks : p.vs)[h * p.plane_cols +
                                            page * ps + len % ps] = s;
  }

  // q, quantized per query head: qq (exact small integers, as float)
  // and its scale
  float qq[G][EPL], qs[G], qss[G];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (gi < g) {
      float x[EPL];
      load_f<EPL>(p.q, (static_cast<int64_t>(row) * n_q + h * g + gi) * d,
                  lane, d, p.dt, x);
      float amax = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) amax = fmaxf(amax, fabsf(x[e]));
      qs[gi] = ptt::row_scale(ptt::warp_max(amax));
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        qq[gi][e] = static_cast<float>(ptt::quantize_i8(x[e], qs[gi]));
      qss[gi] = qs[gi] * p.scale;
    } else {
      qs[gi] = qss[gi] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) qq[gi][e] = 0.f;
    }
  }
  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = -INFINITY;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[gi][e] = 0.f;
  }

  for (int t0 = warp * kUnroll; t0 < n_tok; t0 += kWarps * kUnroll) {
    float kr[kUnroll][EPL], vr[kUnroll][EPL], ksc[kUnroll], vsc[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      const int page = t < n_tok ? trow[t / ps] : -1;
      ok[u] = static_cast<unsigned>(page) < region;
      if (ok[u]) {
        const int64_t pg = page + p.pool_base;
        const int64_t off =
            pg * page_stride + h * head_stride + static_cast<int64_t>(t % ps) * d;
        load_i8<EPL>(p.kq + off, lane, d, full, kr[u]);
        load_i8<EPL>(p.vq + off, lane, d, full, vr[u]);
        ksc[u] = ks[pg * ps + t % ps];
        vsc[u] = vs[pg * ps + t % ps];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
      float s[G];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float dot = 0.f;  // an exact integer: see the header
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qq[gi][e], kr[u][e], dot);
        dot = ptt::warp_sum(dot);
        s[gi] = __fmul_rn(__fmul_rn(dot, qss[gi]), ksc[u]);
      }
      fold<EPL, G>(s, vr[u], vsc[u], g, m, l, acc);
    }
  }
  if (warp == 0) {  // the current token, from the operands
    float kr[EPL], vr[EPL], s[G];
    load_f<EPL>(p.new_k, cur, lane, d, p.dt, kr);
    load_f<EPL>(p.new_v, cur, lane, d, p.dt, vr);
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) dot = fmaf(qq[gi][e] * qs[gi], kr[e], dot);
      s[gi] = ptt::warp_sum(dot) * p.scale;
    }
    fold<EPL, G>(s, vr, 1.f, g, m, l, acc);
  }

  // merge the warps' softmax states
  __shared__ float s_m[kWarps][G], s_l[kWarps][G];
  __shared__ float s_acc[kWarps][G][32 * EPL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (lane == 0) {
      s_m[warp][gi] = m[gi];
      s_l[warp][gi] = l[gi];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) s_acc[warp][gi][lane * EPL + e] = acc[gi][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g * d; i += blockDim.x) {
    const int gi = i / d, e = i % d;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][gi]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(s_m[w][gi] - mx);  // a warp with no token: 0
      den = fmaf(s_l[w][gi], f, den);
      num = fmaf(s_acc[w][gi][e], f, num);
    }
    ptt::store_dt(p.out, (static_cast<int64_t>(row) * n_q + h * g + gi) * d + e,
                  p.dt, num / den);
  }
}


// ---------------------------------------------------------------- bf16

namespace mma {

constexpr int kTile = 16;      // tokens a tile
constexpr int kStages = 3;     // tiles in a warp's ring

template <int NG>
struct Ring {
  static constexpr int kDP = 32 * NG;      // head_dim padded to k32 steps
  static constexpr int kPitch = kDP + 16;  // bytes a token row
  // a stage: K rows, V rows, then 16 k and 16 v scales
  static constexpr int kStage = 2 * kTile * kPitch + 2 * kTile * 4;
  static constexpr int kWarpBytes = kStages * kStage;
  static constexpr int kAccPitch = kDP + 4;  // floats, the warps' merge
  static constexpr size_t kSmem =
      kWarps * kWarpBytes + 8 * kDP                  // rings, qq [8][kDP]
      + sizeof(float) * (3 * 8 + 2 * kDP)            // qs, qss, cur, nk, nv
      + sizeof(int) * (kWarps * kStages + 4);        // valid masks, ticket
  static_assert(sizeof(float) * kWarps * 8 * (2 + kAccPitch) <=
                    kWarps * kWarpBytes,
                "the warps' states must fit over the rings");
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// c += A B, int8 m16n8k32 with int32 sums: A rows 0-7 (a0, a2) hold the
// query heads, rows 8-15 are zero
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a2,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// byte j of a word of 4 int8 (pre-xored with 0x80808080), as float: the
// biased byte under the exponent of 2^23, less 2^23 + 128; exact
__device__ __forceinline__ float i8_at(uint32_t biased, int j) {
  return __uint_as_float(__byte_perm(biased, 0x4B00u, 0x5440u | j)) -
         8388736.f;
}

// two small integers held exactly in float, as a bf16 pair (lo, hi): their
// upper halves
__device__ __forceinline__ uint32_t bf16x2_of(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int NG>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_q_mma(const Params p) {
  using R = Ring<NG>;
  constexpr int kDP = R::kDP, kPitch = R::kPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int split = blockIdx.x % p.n_split, h = blockIdx.x / p.n_split;
  const int row = blockIdx.y;
  const int g = p.g, d = p.d, ps = p.ps, n_kv = p.n_kv, n_q = n_kv * g;
  unsigned char* ring = smem + warp * R::kWarpBytes;
  int8_t* s_qq = reinterpret_cast<int8_t*>(smem + kWarps * R::kWarpBytes);
  float* s_qs = reinterpret_cast<float*>(s_qq + 8 * kDP);  // [8]
  float* s_qss = s_qs + 8;
  float* s_cur = s_qss + 8;  // the current token's logit
  float* s_nk = s_cur + 8;   // the current token's k and v [kDP], as float
  float* s_nv = s_nk + kDP;
  int* s_valid = reinterpret_cast<int*>(s_nv + kDP) + warp * kStages;
  int* ticket = reinterpret_cast<int*>(s_nv + kDP) + kWarps * kStages;

  const int len = p.seq_lens[row];
  const int cap = p.pp * ps;
  const int n_tok = len < cap ? len : cap;  // pool tokens attended
  const int* trow = p.tables + static_cast<int64_t>(row) * p.pp;
  const int64_t head_stride = static_cast<int64_t>(ps) * d;
  const int64_t page_stride = head_stride * n_kv;
  const int64_t cur = (static_cast<int64_t>(row) * n_kv + h) * d;
  const unsigned region = static_cast<unsigned>(p.pool_pages);
  const int64_t plane0 = static_cast<int64_t>(h) * p.plane_cols;

  // the block's tiles [t_lo, t_hi); warp w takes t_lo + w + 4 j
  const int n_tiles = (n_tok + kTile - 1) / kTile;
  const int t_lo = split * n_tiles / p.n_split;
  const int t_hi = (split + 1) * n_tiles / p.n_split;
  const int nj = t_hi - t_lo > warp ? (t_hi - t_lo - warp + kWarps - 1) / kWarps
                                    : 0;
  const bool vec16 = d % 16 == 0;  // rows 16-byte aligned
  const int side = lane >> 4, r = lane & 15;

  // the page id of this lane's token of the warp's tile j (-1: none)
  auto fetch = [&](int j) {
    const int tok = (t_lo + warp + kWarps * j) * kTile + r;
    return j < nj && tok < n_tok ? trow[tok / ps] : -1;
  };
  // tile j into stage j % kStages: lane r copies token r's K row (lanes
  // 0-15) or V row (16-31) and its scale; a token off the region is not
  // copied and its bit in the stage's mask stays 0
  auto issue = [&](int j, int id) {
    unsigned char* st = ring + (j % kStages) * R::kStage;
    const bool ok = static_cast<unsigned>(id) < region;
    const unsigned m = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) s_valid[j % kStages] = static_cast<int>(m & 0xffffu);
    if (!ok) return;
    const int tok = (t_lo + warp + kWarps * j) * kTile + r;
    const int64_t pg = id + static_cast<int64_t>(p.pool_base);
    const int8_t* src = (side ? p.vq : p.kq) + pg * page_stride +
                        h * head_stride + static_cast<int64_t>(tok % ps) * d;
    int8_t* dst = reinterpret_cast<int8_t*>(st) + (side * kTile + r) * kPitch;
    if (vec16) {
#pragma unroll
      for (int c = 0; c < kDP / 16; ++c) {
        const bool in = c * 16 < d;  // the k tail of the last step: zeros
        ptt::cp_async16(dst + c * 16, in ? src + c * 16 : src, in ? 16 : 0);
      }
    } else {
      for (int e = 0; e < kDP; ++e) dst[e] = e < d ? src[e] : 0;
    }
    float* sc = reinterpret_cast<float*>(st + 2 * kTile * kPitch) +
                side * kTile + r;
    cp_async4(sc, (side ? p.vs : p.ks) + plane0 + pg * ps + tok % ps);
  };

  int id0 = fetch(0), id1 = fetch(1);
  issue(0, id0);
  ptt::cp_async_commit();
  issue(1, id1);
  ptt::cp_async_commit();
  int id_next = fetch(2);

  // the current token's k (warp 0) and v (warp 1) into shared memory, and
  // their append, quantized (split 0; skipped for a full table or a page
  // outside the region); nobody reads this slot here
  if (warp < 2) {
    float x[NG];
    load_f<NG>(warp == 0 ? p.new_k : p.new_v, cur, lane, d, p.dt, x);
#pragma unroll
    for (int e = 0; e < NG; ++e) (warp == 0 ? s_nk : s_nv)[lane * NG + e] = x[e];
    if (split == 0 && len < cap &&
        static_cast<unsigned>(trow[len / ps]) < region) {
      const int64_t page = trow[len / ps] + p.pool_base;
      const int64_t dst = page * page_stride + h * head_stride +
                          static_cast<int64_t>(len % ps) * d;
      const float s = quantize_row<NG>(x, lane, d,
                                       (warp == 0 ? p.kq : p.vq) + dst);
      if (lane == 0)
        (warp == 0 ? p.ks : p.vs)[plane0 + page * ps + len % ps] = s;
    }
  }
  // q quantized per head into shared memory (rows g..7 and the tail past
  // d zero)
  for (int gi = warp; gi < 8; gi += kWarps) {
    float qs = 0.f, x[NG] = {};
    if (gi < g) {
      load_f<NG>(p.q, (static_cast<int64_t>(row) * n_q + h * g + gi) * d,
                 lane, d, p.dt, x);
      float amax = 0.f;
#pragma unroll
      for (int e = 0; e < NG; ++e) amax = fmaxf(amax, fabsf(x[e]));
      qs = ptt::row_scale(ptt::warp_max(amax));
    }
#pragma unroll
    for (int e = 0; e < NG; ++e) {
      const int i = lane * NG + e;
      s_qq[gi * kDP + i] = static_cast<int8_t>(
          gi < g && i < d ? ptt::quantize_i8(x[e], qs) : 0);
    }
    if (lane == 0) {
      s_qs[gi] = qs;
      s_qss[gi] = qs * p.scale;
    }
  }
  __syncthreads();
  uint32_t qa[NG][2];  // A fragments of qq: row gq, bytes 4 t4 (+16)
#pragma unroll
  for (int kk = 0; kk < NG; ++kk) {
    const int8_t* q8 = s_qq + gq * kDP + kk * 32 + 4 * t4;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(q8);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(q8 + 16);
  }
  const float qss = s_qss[gq];

  // head gq's state: max, this thread's part of the sum, and the
  // accumulators: acc[G][j] c0/c1 dims 32G + 8 t4 + j (+4), hi and lo
  // products; c2/c3 the mid products of the same dims
  float m = -INFINITY, l = 0.f;
  float acc[NG][4][4];
#pragma unroll
  for (int G = 0; G < NG; ++G)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[G][j][c] = 0.f;

  for (int j = 0; j < nj; ++j) {
    if (j + 2 < nj) issue(j + 2, id_next);
    ptt::cp_async_commit();
    id_next = fetch(j + 3);
    ptt::cp_async_wait<2>();
    __syncwarp();
    const unsigned valid = static_cast<unsigned>(s_valid[j % kStages]);
    if (valid != 0u) {
      const unsigned char* st = ring + (j % kStages) * R::kStage;
      const int8_t* sk = reinterpret_cast<const int8_t*>(st);
      const int8_t* sv = sk + kTile * kPitch;
      const float* sks = reinterpret_cast<const float*>(st + 2 * kTile * kPitch);
      const float* svs = sks + kTile;
      int c[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
      for (int kk = 0; kk < NG; ++kk) {
        uint32_t b0, b1, b2, b3;
        ptt::ldmatrix_x4(b0, b1, b2, b3,
                         sk + ((lane & 7) + 8 * (lane >> 4)) * kPitch +
                             kk * 32 + 16 * ((lane >> 3) & 1));
        mma_s8(c[0], qa[kk][0], qa[kk][1], b0, b1);
        mma_s8(c[1], qa[kk][0], qa[kk][1], b2, b3);
      }
      // logits of tokens 8 nt + 2 t4 + e; masked: -inf
      float x[2][2], mt = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int tk = nt * 8 + 2 * t4 + e;
          const bool ok = (valid >> tk) & 1u;
          x[nt][e] = ok ? __fmul_rn(__fmul_rn(static_cast<float>(c[nt][e]),
                                              qss),
                                    sks[tk])
                        : -INFINITY;
          mt = fmaxf(mt, x[nt][e]);
        }
      const float mn = fmaxf(m, quad_max(mt));  // finite: a valid token
      const float alpha = expf(m - mn);         // m = -inf first: 0
      m = mn;
      l *= alpha;
#pragma unroll
      for (int G = 0; G < NG; ++G)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[G][jj][cc] *= alpha;
      // weights p * v_scale as bf16 hi + mid + lo: the A fragments of P V
      float hi[2][2], mid[2][2], lo[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int tk = nt * 8 + 2 * t4 + e;
          const bool ok = (valid >> tk) & 1u;
          const float pr = ok ? expf(x[nt][e] - mn) : 0.f;
          l += pr;
          const float w = ok ? pr * svs[tk] : 0.f;  // a select: vs may be NaN
          hi[nt][e] = ptt::tiles::bf16_round(w);
          const float r1 = w - hi[nt][e];
          mid[nt][e] = ptt::tiles::bf16_round(r1);
          lo[nt][e] = r1 - mid[nt][e];
        }
      const uint32_t a0 = ptt::tiles::pack_bf16(hi[0][0], hi[0][1]);
      const uint32_t a1 = ptt::tiles::pack_bf16(mid[0][0], mid[0][1]);
      const uint32_t a2 = ptt::tiles::pack_bf16(hi[1][0], hi[1][1]);
      const uint32_t a3 = ptt::tiles::pack_bf16(mid[1][0], mid[1][1]);
      const uint32_t l0 = ptt::tiles::pack_bf16(lo[0][0], lo[0][1]);
      const uint32_t l2 = ptt::tiles::pack_bf16(lo[1][0], lo[1][1]);
#pragma unroll
      for (int G = 0; G < NG; ++G) {
        // V words: 4 dims (32G + 4 gq ..) of tokens 2 t4, 2 t4 + 1, 2 t4 + 8,
        // 2 t4 + 9
        const int8_t* vw = sv + G * 32 + 4 * gq;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(
                               vw + (2 * t4) * kPitch) ^ 0x80808080u;
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
                               vw + (2 * t4 + 1) * kPitch) ^ 0x80808080u;
        const uint32_t w2 = *reinterpret_cast<const uint32_t*>(
                               vw + (2 * t4 + 8) * kPitch) ^ 0x80808080u;
        const uint32_t w3 = *reinterpret_cast<const uint32_t*>(
                               vw + (2 * t4 + 9) * kPitch) ^ 0x80808080u;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const uint32_t b0 = bf16x2_of(i8_at(w0, jj), i8_at(w1, jj));
          const uint32_t b1 = bf16x2_of(i8_at(w2, jj), i8_at(w3, jj));
          ptt::mma_bf16(acc[G][jj], a0, a1, a2, a3, b0, b1);
          ptt::mma_bf16(acc[G][jj], l0, 0u, l2, 0u, b0, b1);
        }
      }
    }
    __syncwarp();  // the stage is refilled from the next tile on
  }
  ptt::cp_async_wait<0>();
  l = quad_sum(l);

  // the warps' states over the rings: s_m, s_l [kWarps][8], s_acc
  // [kWarps][8][kAccPitch]
  __syncthreads();
  float* s_m = reinterpret_cast<float*>(smem);
  float* s_l = s_m + kWarps * 8;
  float* s_acc = s_l + kWarps * 8;
  if (t4 == 0) {
    s_m[warp * 8 + gq] = m;
    s_l[warp * 8 + gq] = l;
  }
  float* arow = s_acc + (warp * 8 + gq) * R::kAccPitch + 8 * t4;
#pragma unroll
  for (int G = 0; G < NG; ++G)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      arow[G * 32 + jj] = acc[G][jj][0] + acc[G][jj][2];
      arow[G * 32 + 4 + jj] = acc[G][jj][1] + acc[G][jj][3];
    }
  // the current token's logit per head, from the operands
  for (int gi = warp; gi < g; gi += kWarps) {
    float dot = 0.f;
    for (int e = lane; e < d; e += 32)
      dot = fmaf(static_cast<float>(s_qq[gi * kDP + e]) * s_qs[gi], s_nk[e],
                 dot);
    dot = ptt::warp_sum(dot);
    if (lane == 0) s_cur[gi] = dot * p.scale;
  }
  __syncthreads();

  const int64_t out0 = (static_cast<int64_t>(row) * n_q + h * g) * d;
  if (p.n_split == 1) {
    for (int i = tid; i < g * d; i += kWarps * 32) {
      const int gi = i / d, e = i % d;
      float mx = s_cur[gi];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w * 8 + gi]);
      float den = expf(s_cur[gi] - mx);
      float num = den * s_nv[e];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(s_m[w * 8 + gi] - mx);  // no token: 0
        den = fmaf(s_l[w * 8 + gi], f, den);
        num = fmaf(s_acc[(w * 8 + gi) * R::kAccPitch + e], f, num);
      }
      ptt::store_dt(p.out, out0 + i, p.dt, num / den);
    }
    return;
  }

  // a split: its state to the workspace (partials [rows * n_kv][n_split]
  // [g][d], then (m, l) pairs, then a counter a (row, head))
  const int64_t rh = static_cast<int64_t>(row) * n_kv + h;
  const int64_t n_rh = static_cast<int64_t>(gridDim.y) * n_kv;
  float* part = p.ws;
  float* part_ml = p.ws + n_rh * p.n_split * g * d;
  int* counter = reinterpret_cast<int*>(part_ml + n_rh * p.n_split * g * 2);
  const int64_t base = (rh * p.n_split + split) * g;
  for (int i = tid; i < g * d; i += kWarps * 32) {
    const int gi = i / d, e = i % d;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w * 8 + gi]);
    float sum = 0.f, num = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(s_m[w * 8 + gi] - mx);
        sum = fmaf(s_l[w * 8 + gi], f, sum);
        num = fmaf(s_acc[(w * 8 + gi) * R::kAccPitch + e], f, num);
      }
    }
    part[(base + gi) * d + e] = num;
    if (e == 0) {
      part_ml[(base + gi) * 2] = mx;
      part_ml[(base + gi) * 2 + 1] = sum;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *ticket = atomicAdd(counter + rh, 1);
  __syncthreads();
  if (*ticket != p.n_split - 1) return;
  __threadfence();  // every split's state is visible
  const int64_t base0 = rh * p.n_split * g;
  for (int i = tid; i < g * d; i += kWarps * 32) {
    const int gi = i / d, e = i % d;
    float mx = s_cur[gi];
    for (int s2 = 0; s2 < p.n_split; ++s2)
      mx = fmaxf(mx, __ldcg(part_ml + (base0 + s2 * g + gi) * 2));
    float den = expf(s_cur[gi] - mx);
    float num = den * s_nv[e];
#pragma unroll 4
    for (int s2 = 0; s2 < p.n_split; ++s2) {
      const float* ml = part_ml + (base0 + s2 * g + gi) * 2;
      const float f = expf(__ldcg(ml) - mx);  // a split with no token: 0
      den = fmaf(__ldcg(ml + 1), f, den);
      num = fmaf(__ldcg(part + (base0 + s2 * g + gi) * d + e), f, num);
    }
    ptt::store_dt(p.out, out0 + i, p.dt, num / den);
  }
  if (tid == 0) counter[rh] = 0;
}

template <int NG>
int launch_mma(const Params& p, int b, cudaStream_t stream) {
  constexpr size_t smem = Ring<NG>::kSmem;
  const cudaError_t e = cudaFuncSetAttribute(
      paged_decode_q_mma<NG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(p.n_kv * p.n_split, b);
  paged_decode_q_mma<NG><<<grid, kWarps * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma

template <int EPL, int G>
int launch(const Params& p, int b, cudaStream_t stream) {
  const dim3 grid(p.n_kv, b);
  paged_decode_q_kernel<EPL, G><<<grid, kWarps * 32, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int EPL>
int dispatch_g(const Params& p, int b, cudaStream_t stream) {
  if (p.g <= 1) return launch<EPL, 1>(p, b, stream);
  if (p.g <= 2) return launch<EPL, 2>(p, b, stream);
  if (p.g <= 4) return launch<EPL, 4>(p, b, stream);
  return launch<EPL, 8>(p, b, stream);
}

int dispatch_mma(const Params& p, int b, cudaStream_t stream) {
  switch ((p.d + 31) / 32) {
    case 1: return mma::launch_mma<1>(p, b, stream);
    case 2: return mma::launch_mma<2>(p, b, stream);
    case 3: return mma::launch_mma<3>(p, b, stream);
    case 4: return mma::launch_mma<4>(p, b, stream);
    case 5: return mma::launch_mma<5>(p, b, stream);
    case 6: return mma::launch_mma<6>(p, b, stream);
    case 7: return mma::launch_mma<7>(p, b, stream);
    default: return mma::launch_mma<8>(p, b, stream);
  }
}

}  // namespace

// Returns the cudaError_t of the launch. Shapes: q/out [b, n_q, d] and
// new_k/new_v [b, n_kv, d] of dtype code `dtype` (float32 or bfloat16);
// kq_pool/vq_pool [pages, n_kv, page_size, d] int8; ks_plane/vs_plane
// [n_kv, plane_cols] float32 with plane_cols = pages * page_size;
// seq_lens [b] and block_tables [b, pages_per_seq] int32; all contiguous.
// n_q = n_kv * g with g <= 8, d <= 256, b <= 65535. The layer region is
// pool pages [pool_base, pool_base + pool_pages); the caller checks it
// lies in the pool. bfloat16 takes n_split (1 to 16) blocks a (row, kv
// head); n_split > 1 needs `ws`: f32 [b * n_kv * n_split * g * (d + 2)]
// then int32 [b * n_kv] counters (zeroed here). float32 takes n_split 1.
extern "C" int ptt_paged_decode_attention_q(
    const void* q, const void* new_k, const void* new_v, void* kq_pool,
    void* ks_plane, void* vq_pool, void* vs_plane, const int* seq_lens,
    const int* block_tables, void* out, void* ws, int dtype, int b, int n_q,
    int n_kv, int d, int page_size, int pages_per_seq, int pool_base,
    int pool_pages, int plane_cols, int n_split, float scale, void* stream) {
  if (b == 0) return 0;
  if (n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv > 8 || d <= 0 || d > 256 ||
      pool_base < 0 || pool_pages <= 0 || b > 65535 || n_split < 1 ||
      n_split > 16 || (dtype != ptt::kF32 && dtype != ptt::kBF16) ||
      (dtype == ptt::kF32 && n_split != 1) ||
      (n_split > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,
                 new_k,
                 new_v,
                 static_cast<int8_t*>(kq_pool),
                 static_cast<float*>(ks_plane),
                 static_cast<int8_t*>(vq_pool),
                 static_cast<float*>(vs_plane),
                 seq_lens,
                 block_tables,
                 out,
                 dtype,
                 n_kv,
                 n_q / n_kv,
                 d,
                 page_size,
                 pages_per_seq,
                 pool_base,
                 pool_pages,
                 plane_cols,
                 scale,
                 static_cast<float*>(ws),
                 n_split};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kBF16) {
    if (n_split > 1) {
      const size_t rows = static_cast<size_t>(b) * n_kv;
      const cudaError_t e = cudaMemsetAsync(
          p.ws + rows * n_split * (n_q / n_kv) * (d + 2), 0,
          rows * sizeof(int), st);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    return dispatch_mma(p, b, st);
  }
  const int epl = (d + 31) / 32;
  if (epl <= 1) return dispatch_g<1>(p, b, st);
  if (epl <= 2) return dispatch_g<2>(p, b, st);
  if (epl <= 4) return dispatch_g<4>(p, b, st);
  return dispatch_g<8>(p, b, st);
}
