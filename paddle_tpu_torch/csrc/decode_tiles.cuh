// Tile machinery of the paged decode kernels with tensor-core scores: B1
// (paged_attention.cu, paged_decode_mma: a bf16 pool, its append and the
// current token), B8 (paged_backends.cu, fused_paged_mma: a bf16 pool,
// absolute page ids, no current token) and B6 (paged_attention_q.cu,
// paged_decode_q_mma: an int8 pool).
//
// A block of 4 warps serves one (batch row, kv head), or one (row, kv
// head, split) of a row's 16-token tiles. Warp w walks the block's tiles
// w, w + 4, ... through a ring of tiles of its own: the tile's 16 K rows
// and 16 V rows go by 16-byte cp.async (a row a lane, issue_tile; or
// whole rows a warp instruction, issue_tile_rows) into rows padded by 16
// bytes (so the 8 rows of an ldmatrix, or of a column read, start in
// distinct banks). The page ids are read one tile ahead of the copies. A token past the row's length or on a page
// outside the layer region is never read from the pool: its bit in the
// stage's mask stays 0 and its score and weight are selected away. The
// softmax runs once a tile (tile_max, tile_weights); P V takes the weights
// as three bf16 parts, and the block's end (finish) merges the warps' states with
// the current token (B8 has none: a logit of kNoToken) and, when the row
// is split, the splits' states in split order, the last split by an
// atomic ticket. bf16_tile is the tile body of the bf16 pools (B1, B8).
#pragma once

#include "flash_tiles.cuh"

namespace ptt {
namespace decode {

constexpr int kWarps = 4;
constexpr int kTile = 16;    // tokens a tile
constexpr int kStages = 3;   // tiles in a warp's ring
constexpr float kNoToken = -1e30f;  // finish's logit of no current token

// A warp's ring: kStages stages, each the tile's 16 K rows, its 16 V rows
// (kRowBytes of data, then 16 bytes of padding) and kExtra bytes more.
template <int kRowBytes, int kExtra>
struct Ring {
  static constexpr int kPitch = kRowBytes + 16;  // bytes a token row
  static constexpr int kStage = 2 * kTile * kPitch + kExtra;
  static constexpr int kWarpBytes = kStages * kStage;
};

// The block's tiles [t_lo, t_lo + n) of a row's n_tok tokens, split
// `split` of n_split; a warp's count nj of them.
struct Walk {
  int t_lo, nj;
};

__device__ __forceinline__ Walk walk(int n_tok, int split, int n_split,
                                     int warp) {
  const int n_tiles = (n_tok + kTile - 1) / kTile;
  const int t_lo = split * n_tiles / n_split;
  const int t_hi = (split + 1) * n_tiles / n_split;
  const int nj = t_hi - t_lo > warp
                     ? (t_hi - t_lo - warp + kWarps - 1) / kWarps
                     : 0;
  return Walk{t_lo, nj};
}

// token r (lane % 16) of the warp's tile j
__device__ __forceinline__ int tile_token(const Walk& w, int warp, int j,
                                          int r) {
  return (w.t_lo + warp + kWarps * j) * kTile + r;
}

// the page id of that token (-1: none)
__device__ __forceinline__ int page_of(const int* trow, const Walk& w,
                                       int n_tok, int ps, int warp, int j,
                                       int r) {
  const int tok = tile_token(w, warp, j, r);
  return j < w.nj && tok < n_tok ? trow[tok / ps] : -1;
}

// A pool side's layout: [pages, n_kv, ps, d] elements of kElem bytes;
// the layer region is pages [pool_base, pool_base + region).
struct Pool {
  int64_t page_stride, head_stride;
  int d, ps, pool_base;
  unsigned region;
};

// Tile j into its stage `st`, a row a lane: lane r copies token r's K row
// (lanes 0-15) or V row (16-31) from page `id`, head h, its tail past
// the row's bytes zero-filled. A token on no page of the region is not
// read and its row is left as it was. Lane 0 writes the stage's mask of
// tokens in. Returns this lane's token's slot (page * ps + token % ps,
// for B6's scales), or -1 when it is not in.
template <int kRowBytes, int kElem>
__device__ __forceinline__ int64_t issue_tile(unsigned char* st, int* valid,
                                              int id, int tok, int h,
                                              const Pool& pl,
                                              const void* k_pool,
                                              const void* v_pool, int lane) {
  const bool ok = static_cast<unsigned>(id) < pl.region;
  const unsigned m = __ballot_sync(0xffffffffu, ok);
  if (lane == 0) *valid = static_cast<int>(m & 0xffffu);
  if (!ok) return -1;
  const int side = lane >> 4, r = lane & 15;
  const int bytes = pl.d * kElem;
  unsigned char* dst = st + (side * kTile + r) * (kRowBytes + 16);
  const unsigned char* src = static_cast<const unsigned char*>(
      side ? v_pool : k_pool);
  const int64_t pg = id + static_cast<int64_t>(pl.pool_base);
  src += (pg * pl.page_stride + h * pl.head_stride +
          static_cast<int64_t>(tok % pl.ps) * pl.d) * kElem;
  if (bytes % 16 == 0) {
#pragma unroll
    for (int c = 0; c < kRowBytes / 16; ++c) {
      const bool in = c * 16 < bytes;  // past the row: zeros
      cp_async16(dst + c * 16, in ? src + c * 16 : src, in ? 16 : 0);
    }
  } else {
    for (int e = 0; e < kRowBytes; ++e) dst[e] = e < bytes ? src[e] : 0;
  }
  return pg * pl.ps + tok % pl.ps;
}

// Tile j into its stage `st`, coalesced: the tile's 32 rows (16 K rows,
// then 16 V rows) of kRowBytes each (the head's whole row, no tail) go as
// 16-byte chunks, lane l copying chunks l, l + 32, ... of the 32 rows in
// order, so a warp's copy covers whole rows with consecutive lanes on
// consecutive bytes. Row i is token tok0 + i % 16, whose page id lane i %
// 16 holds (`id`, one a lane, read one tile ahead). A token on no page of
// the region is not read: its rows are zero-filled (a bf16 row in shared
// memory must not hold a NaN the products would meet). Lane 0 writes the
// stage's mask of tokens in.
template <int kRowBytes, int kElem>
__device__ __forceinline__ void issue_tile_rows(unsigned char* st,
                                                int* valid, int id, int tok0,
                                                int h, const Pool& pl,
                                                const void* k_pool,
                                                const void* v_pool,
                                                int lane) {
  constexpr int kChunks = kRowBytes / 16;  // a row's 16-byte chunks
  const unsigned m =
      __ballot_sync(0xffffffffu, static_cast<unsigned>(id) < pl.region) &
      0xffffu;
  if (lane == 0) *valid = static_cast<int>(m);
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane + 32 * i, row = c / kChunks, e = c % kChunks;
    const int r = row & 15;
    const int rid = __shfl_sync(0xffffffffu, id, r);
    const bool in = (m >> r) & 1u;
    const unsigned char* src =
        static_cast<const unsigned char*>(row < 16 ? k_pool : v_pool);
    if (in)
      src += ((rid + static_cast<int64_t>(pl.pool_base)) * pl.page_stride +
              h * pl.head_stride +
              static_cast<int64_t>((tok0 + r) % pl.ps) * pl.d) *
                 kElem +
             16 * e;
    cp_async16(st + row * (kRowBytes + 16) + 16 * e, src, in ? 16 : 0);
  }
}

// One tile's step of the online softmax of head gq, in two parts with
// the caller's rescale of its accumulators between them (the order B6
// has always run): tile_max takes this thread's scores x of tokens 8 nt +
// 2 t4 + e (-inf where masked; at least one token of the tile is in),
// moves the max m and rescales the sum l, and returns the factor alpha
// the accumulators are rescaled by; tile_weights then adds this thread's
// weights p = exp(x - m) (0 where masked) to l and returns the A
// fragments of P V for the weights weight(p, token) (0 where masked: a
// select, never a product, so a masked factor may be NaN), each split into
// three bf16 parts hi + mid + lo (within 2^-27 of the weight): hi in A's
// rows 0-7 and mid in rows 8-15 (a0-a3), then lo in rows 0-7 (l0, l2)
// for a second product; the rows are added at the end.
__device__ __forceinline__ float tile_max(const float (&x)[2][2], float& m,
                                          float& l) {
  float mt = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) mt = fmaxf(mt, x[nt][e]);
  const float mn = fmaxf(m, tiles::quad_max(mt));  // finite: a token is in
  const float alpha = expf(m - mn);                // m = -inf first: 0
  m = mn;
  l *= alpha;
  return alpha;
}

struct PV {
  uint32_t a0, a1, a2, a3, l0, l2;
};

template <typename Weight>
__device__ __forceinline__ PV tile_weights(const float (&x)[2][2],
                                           unsigned valid, int t4, float m,
                                           float& l, Weight weight) {
  float hi[2][2], mid[2][2], lo[2][2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int tk = nt * 8 + 2 * t4 + e;
      const bool ok = (valid >> tk) & 1u;
      const float pr = ok ? expf(x[nt][e] - m) : 0.f;
      l += pr;
      const float w = ok ? weight(pr, tk) : 0.f;
      hi[nt][e] = tiles::bf16_round(w);
      const float r1 = w - hi[nt][e];
      mid[nt][e] = tiles::bf16_round(r1);
      lo[nt][e] = r1 - mid[nt][e];
    }
  return PV{ptt::pack2<tiles::bf16>(hi[0][0], hi[0][1]),
            ptt::pack2<tiles::bf16>(mid[0][0], mid[0][1]),
            ptt::pack2<tiles::bf16>(hi[1][0], hi[1][1]),
            ptt::pack2<tiles::bf16>(mid[1][0], mid[1][1]),
            ptt::pack2<tiles::bf16>(lo[0][0], lo[0][1]),
            ptt::pack2<tiles::bf16>(lo[1][0], lo[1][1])};
}

// bf16 pools (B1, B8): rows of head_dim 32 NG. The block's shared memory:
// the warps' rings, q's 8 rows, the current token's logits [8], k and v
// [kD] as float, the stages' masks and the ticket.
template <int NG>
struct BfRing : Ring<64 * NG, 0> {
  using Base = Ring<64 * NG, 0>;
  static constexpr int kD = 32 * NG;
  static constexpr int kPitchE = Base::kPitch / 2;  // elements a token row
  static constexpr int kQPitch = kD + 8;            // elements a q row
  static constexpr int kAccPitch = kD + 4;          // floats, the merge
  static constexpr size_t kSmem =
      kWarps * Base::kWarpBytes + 2 * 8 * kQPitch     // rings, q [8][kQPitch]
      + sizeof(float) * (8 + 2 * kD)                  // cur, nk, nv
      + sizeof(int) * (kWarps * kStages + 4);         // valid masks, ticket
  static_assert(sizeof(float) * kWarps * 8 * (2 + kAccPitch) <=
                    kWarps * Base::kWarpBytes,
                "the warps' states must fit over the rings");
};

// One tile of a bf16 pool (B1, B8) into head gq's state: its stage `sk`
// (16 K rows, then 16 V rows, kPitchE elements apart), the mask `valid`
// of its tokens in (not 0), q's row gq from shared memory (`qrow`: its
// elements 2 t4, + 1 of each k16 step).
//   S = q K^T on the bf16 tensor cores, mma.sync m16n8k16 (the g <= 8
//   query heads as M; the tile's 16 tokens as two n8 tiles, K by
//   ldmatrix), each k-step's products summed from zero and added to the
//   scores by an fp32 add, then the scale (the accumulators truncate as
//   they accumulate, and a score's error is its weight's relative error).
//   Softmax once a tile (tile_max, the rescale, tile_weights).
//   P V on the bf16 tensor cores with the weights as three bf16 parts,
//   V by ldmatrix.trans: acc[n] c0/c1 dims 8 n + 2 t4 (+1), hi and lo
//   products; c2/c3 the mid products of the same dims.
template <int NG>
__device__ __forceinline__ void bf16_tile(const __nv_bfloat16* qrow,
                                          const __nv_bfloat16* sk,
                                          unsigned valid, float scale,
                                          float& m, float& l,
                                          float (&acc)[4 * NG][4]) {
  using bf16 = __nv_bfloat16;
  constexpr int kPitchE = BfRing<NG>::kPitchE;
  const int lane = threadIdx.x & 31, t4 = lane & 3;
  const bf16* sv = sk + kTile * kPitchE;
  float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  // fully unrolled up to d128; two k-steps at a time past it (fully
  // unrolled, every k-step's products stay live, and d192 and d224
  // spilled)
#pragma unroll (NG <= 4 ? 2 * NG : 2)
  for (int kk = 0; kk < 2 * NG; ++kk) {
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(qrow + kk * 16);
    const uint32_t a2 =
        *reinterpret_cast<const uint32_t*>(qrow + kk * 16 + 8);
    uint32_t b0, b1, b2, b3;
    ldmatrix_x4(b0, b1, b2, b3,
                sk + ((lane & 7) + 8 * (lane >> 4)) * kPitchE + kk * 16 +
                    8 * ((lane >> 3) & 1));
    // the k-step's products from zero, added to the scores in fp32
    float t[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    mma_bf16(t[0], a0, 0u, a2, 0u, b0, b1);
    mma_bf16(t[1], a0, 0u, a2, 0u, b2, b3);
#pragma unroll
    for (int q = 0; q < 8; ++q) c[q / 4][q % 4] += t[q / 4][q % 4];
  }
  // logits of tokens 8 nt + 2 t4 + e; masked: -inf
  float x[2][2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int tk = nt * 8 + 2 * t4 + e;
      x[nt][e] = (valid >> tk) & 1u ? c[nt][e] * scale : -INFINITY;
    }
  const float alpha = tile_max(x, m, l);
#pragma unroll
  for (int n = 0; n < 4 * NG; ++n)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[n][cc] *= alpha;
  const PV f =
      tile_weights(x, valid, t4, m, l, [](float pr, int) { return pr; });
#pragma unroll
  for (int np = 0; np < 2 * NG; ++np) {
    uint32_t b0, b1, b2, b3;
    ldmatrix_x4_trans(b0, b1, b2, b3,
                      sv + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kPitchE +
                          np * 16 + 8 * (lane >> 4));
    mma_bf16(acc[2 * np], f.a0, f.a1, f.a2, f.a3, b0, b1);
    mma_bf16(acc[2 * np], f.l0, 0u, f.l2, 0u, b0, b1);
    mma_bf16(acc[2 * np + 1], f.a0, f.a1, f.a2, f.a3, b2, b3);
    mma_bf16(acc[2 * np + 1], f.l0, 0u, f.l2, 0u, b2, b3);
  }
}

// The output rows of a block and, when rows are split, its workspace.
struct Finish {
  void* out;
  int dt;
  int64_t out0;  // element of (row, head h * g) in out
  int g, d;
  int n_split, split;
  float* ws;     // n_split > 1: partials, (m, l) pairs, then counters
  int64_t rh;    // row * n_kv + h
};

// The block's end, after the walk and a __syncthreads: the warps' states
// s_m, s_l [kWarps][8] and s_acc [kWarps][8][acc_pitch] with the current
// token (logits s_cur [g], value s_nv [d]) into the output; or, with
// n_split > 1, the block's state into the workspace (partials [rows *
// n_kv][n_split][g][d], then (m, l) pairs, then a counter a (row, head))
// and the last split of the (row, head), by an atomic ticket, merging
// them in split order. The counter is left at 0. A kernel with no current
// token (B8) passes logits kNoToken and a value of zeros: that token's
// weight expf(kNoToken - mx) is exactly 0 beside any attended token, and
// a row that attends nothing (every warp's m -inf, mx = kNoToken) gets
// num 0 over den 1, exactly 0, where an m of -inf alone would make
// expf(-inf + inf) a NaN.
__device__ __forceinline__ void finish(const float* s_m, const float* s_l,
                                       const float* s_acc, int acc_pitch,
                                       const float* s_cur,
                                       const float* s_nv, int* ticket,
                                       const Finish& f) {
  const int tid = threadIdx.x, g = f.g, d = f.d;
  if (f.n_split == 1) {
    for (int i = tid; i < g * d; i += kWarps * 32) {
      const int gi = i / d, e = i % d;
      float mx = s_cur[gi];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w * 8 + gi]);
      float den = expf(s_cur[gi] - mx);
      float num = den * s_nv[e];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float fw = expf(s_m[w * 8 + gi] - mx);  // no token: 0
        den = fmaf(s_l[w * 8 + gi], fw, den);
        num = fmaf(s_acc[(w * 8 + gi) * acc_pitch + e], fw, num);
      }
      store_dt(f.out, f.out0 + i, f.dt, num / den);
    }
    return;
  }

  const int64_t n_rh = static_cast<int64_t>(gridDim.y) * (gridDim.x /
                                                          f.n_split);
  float* part = f.ws;
  float* part_ml = f.ws + n_rh * f.n_split * g * d;
  int* counter = reinterpret_cast<int*>(part_ml + n_rh * f.n_split * g * 2);
  const int64_t base = (f.rh * f.n_split + f.split) * g;
  for (int i = tid; i < g * d; i += kWarps * 32) {
    const int gi = i / d, e = i % d;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w * 8 + gi]);
    float sum = 0.f, num = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float fw = expf(s_m[w * 8 + gi] - mx);
        sum = fmaf(s_l[w * 8 + gi], fw, sum);
        num = fmaf(s_acc[(w * 8 + gi) * acc_pitch + e], fw, num);
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
  if (tid == 0) *ticket = atomicAdd(counter + f.rh, 1);
  __syncthreads();
  if (*ticket != f.n_split - 1) return;
  __threadfence();  // every split's state is visible
  const int64_t base0 = f.rh * f.n_split * g;
  for (int i = tid; i < g * d; i += kWarps * 32) {
    const int gi = i / d, e = i % d;
    float mx = s_cur[gi];
    for (int s2 = 0; s2 < f.n_split; ++s2)
      mx = fmaxf(mx, __ldcg(part_ml + (base0 + s2 * g + gi) * 2));
    float den = expf(s_cur[gi] - mx);
    float num = den * s_nv[e];
#pragma unroll 4
    for (int s2 = 0; s2 < f.n_split; ++s2) {
      const float* ml = part_ml + (base0 + s2 * g + gi) * 2;
      const float fw = expf(__ldcg(ml) - mx);  // a split with no token: 0
      den = fmaf(__ldcg(ml + 1), fw, den);
      num = fmaf(__ldcg(part + (base0 + s2 * g + gi) * d + e), fw, num);
    }
    store_dt(f.out, f.out0 + i, f.dt, num / den);
  }
  if (tid == 0) counter[f.rh] = 0;
}

}  // namespace decode
}  // namespace ptt
