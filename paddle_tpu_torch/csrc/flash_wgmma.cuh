// The Hopper mainloops of flash attention in bf16 or fp16 at head_dim 64,
// 96 and 128: forward, dq and dk/dv, each templated on a walk and on the
// operands' 16-bit type T (__nv_bfloat16 or __half: the wgmma form, the
// rounding of P and dS into the A fragments and of the stored outputs;
// the statistics and sums are fp32 in both).
//
// The kernels of flash_varlen_packed.cu (B11-B13: varlen_fwd_wgmma,
// varlen_bwd_dq_wgmma, varlen_bwd_dkv_wgmma) and of flash_attention.cu
// (B10: flash_fwd_wgmma, flash_bwd_dq_wgmma, flash_bwd_dkv_wgmma) are thin
// __global__ shells around fwd_wgmma, bwd_dq_wgmma and bwd_dkv_wgmma
// below. What differs between them is the walk: which 128-row tile a block
// owns, which tiles it visits, which tile pairs need the mask, where the
// rows live and how the mask is taken. The varlen walk reads a block map
// built on the device (flash_varlen_packed.cu); the dense walk works the
// same answers out from the block index and (b, sq, sk, causal)
// (flash_attention.cu).
//
// A walk W of kernel K (kFwd, kDq or kDkv) offers:
//   W::Params       the kernel's parameters, with fields out, dk, dv, lse,
//                   delta, scale
//   W(p)            the block's walk, from blockIdx
//   w.r0, w.n       the owned tile's first row (q rows for kFwd and kDq,
//                   keys for kDkv) and the walk's steps: 128-key tiles
//                   (kFwd), 64-key sub-tiles (kDq), 64-row q sub-tiles
//                   (kDkv)
//   w.first(s)      the first key (q row for kDkv) of step s
//   w.interior(s)   no (query, key) pair of step s's tile pair is masked:
//                   the mask pass is skipped
//   w.tma(dst, map, bar, col, row)   one box of an operand's map at
//                   column col and row `row` of the block's head
//   W::kKeyMeta, w.load_keys(dst, k0, n, bar)   bytes a key and the bulk
//                   copies of n keys' mask metadata into a k stage
//   W::kQStats, w.load_qstats(dst, r0, bar)     bytes a q row and the bulk
//                   copies of 64 rows' lse, delta (and mask metadata)
//   w.rows(row)     this thread's two rows (row, row + 8) of the owned axis
//   w.template mask<N>(sc, rows, meta, col0)    scores of the pairs not
//                   visible to -inf, for a 64 x N accumulator whose
//                   columns start at col0 (meta: the stage's metadata)
//   w.rows_out(), w.template out_at<D>(row)   rows stored, and a row's
//                   offset in the contiguous output
//   W::kTmaStore, w.tma_store(map, src, col, row)   whether the forward
//                   stores out through shared memory by TMA, and one box
//                   of that store
//   w.stat(plane, row), w.store_lse(row, v)   a row's lse or delta (0 for
//                   a row that has none), and the forward's store of its
//                   lse
//   W::kProducerRegs  the producer warpgroup's registers under setmaxnreg
//                   (24 or 32; the consumers take 240 or 232)
//   W::kMultiTile, w.next()   whether a block takes several tiles one
//                   after the other, and the move to the next (r0, n, and
//                   where it lives), false when there is none
//
// The design (PRs 11 and 12, here shared): 384 threads, a producer
// warpgroup that gives its registers to two consumer warpgroups by
// setmaxnreg (24 / 240, or 32 / 232), TMA rings of 128-byte-swizzled 64-column boxes
// with full/empty mbarriers, wgmma products with P and dS fed from
// registers, and the mask as a -inf pass on boundary tiles only.
#pragma once

#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace ptt {
namespace flash {

namespace hp = ptt::hopper;
using ptt::tiles::bf16;
using ptt::tiles::kLn2;
using ptt::tiles::kLog2e;
using ptt::pack2;
using ptt::store2;
using ptt::tiles::quad_max;
using ptt::tiles::quad_sum;

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

constexpr float kNeg = -1e30f;      // lse of a row that sees no key
constexpr float kNegSafe = -5e29f;  // the lse floor in the backward

// ---------------------------------------------------------------- forward

constexpr int kFwdM = 128;            // query rows of a tile: 64 a warpgroup
constexpr int kFwdN = 128;            // keys of a tile
constexpr int kKStages = 3;           // k ring
constexpr int kVStages = 2;           // v ring
constexpr int kFwdConsumers = 256;    // two warpgroups
constexpr int kFwdThreads = kFwdConsumers + 128;  // + the producer's
constexpr int kFwdBox = 128 * 128;    // 16 KB: 128 rows x 64 columns

template <int D, class W>
struct FwdSmem {
  static constexpr int kBoxes = (D + 63) / 64;  // 64-column boxes a tile
  static constexpr int kTile = kBoxes * kFwdBox;
  // q, the k ring, the v ring, out's staging (a TMA store), the k tiles'
  // key metadata and interior flags, then the barriers
  static constexpr int kV = (1 + kKStages) * kTile;
  static constexpr int kO = kV + kVStages * kTile;
  static constexpr int kMeta = kO + (W::kTmaStore ? kTile : 0);
  static constexpr int kFlags = kMeta + kKStages * W::kKeyMeta * kFwdN;
  static constexpr int kBars = kFlags + 16;
  static constexpr int kBytes =
      kBars + (2 + 2 * kKStages + 2 * kVStages) * 8 + 1024;  // + align
};

// setmaxnreg's split of a block's registers (168 a thread at launch, 384
// threads): the producer warpgroup keeps P (a walk's kProducerRegs), the
// two consumer warpgroups take what it gives up, 240 or 232
__host__ __device__ constexpr int consumer_regs(int producer) {
  return producer == 24 ? 240 : 232;
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, ftz; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the 1 KB-aligned start of a kernel's dynamic shared memory
__device__ __forceinline__ unsigned char* smem_1k(unsigned char* raw) {
  return raw + ((1024 - (hp::smem_u32(raw) & 1023)) & 1023);
}

// Forward: a block owns 128-row q tiles of one head, one after the other
// (one for the varlen walk, a few for the dense one: w.next()), two
// consumer warpgroups of 64 rows, and walks each tile's 128-key tiles. A
// producer warpgroup (one thread issues; its registers go to the consumers
// by setmaxnreg) loads a tile's q once the consumers' last S of the tile
// before has read it, and keeps a k ring and a v ring full across the
// tiles: 128-byte swizzle, 64-column boxes; rows past the operand and
// columns past D read as zeros; a k stage also holds its keys' mask
// metadata (the walk's) and whether the tile pair is interior. A
// warpgroup's iteration s issues S(s) = Q K(s)^T (wgmma m64n128k16, q and
// k K-major in shared memory) and then O += P(s-1) V(s-1) (wgmma
// m64nDk16, P from registers: the previous S accumulator rounded to T in
// pairs is the A fragment; v N-major), takes its softmax of S(s) while
// the P V product runs (masked scores are -inf on boundary tiles; base 2,
// f32 statistics), then rescales O. A k stage is released once S is done,
// a v stage once its P V product is, so each ring refills early (into the
// next tile's keys while this tile ends). At D 96 the second box's columns
// 96..127 are TMA's zeros, and the products run at k 96 and n 96. A row
// that sees no key gets out 0 and lse kNeg. The epilogue writes out from
// registers, or (W::kTmaStore) rounds each warpgroup's 64 x D rows into
// shared memory and stores them by TMA through `omap` (64-row boxes; rows
// past the operand are not written) while the next tile starts.
template <int D, class W, typename T>
__device__ __forceinline__ void fwd_wgmma(const CUtensorMap* qmap,
                                          const CUtensorMap* kmap,
                                          const CUtensorMap* vmap,
                                          const CUtensorMap* omap,
                                          const typename W::Params& p) {
  using L = FwdSmem<D, W>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_1k(smem_raw);
  unsigned char* sq = smem;
  unsigned char* sk = sq + L::kTile;                    // [k stages] tiles
  unsigned char* sv = smem + L::kV;                     // [v stages] tiles
  unsigned char* so = smem + L::kO;                     // out's staging
  int* meta = reinterpret_cast<int*>(smem + L::kMeta);  // [k st][2][128]
  int* flags = reinterpret_cast<int*>(smem + L::kFlags);  // [k stages]
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* qempty = qfull + 1;
  uint64_t* kfull = qempty + 1;
  uint64_t* kempty = kfull + kKStages;
  uint64_t* vfull = kempty + kKStages;
  uint64_t* vempty = vfull + kVStages;
  if (threadIdx.x == 0) {
    hp::mbar_init(qfull, 1);
    hp::mbar_init(qempty, kFwdConsumers);
    for (int s = 0; s < kKStages; ++s) {
      hp::mbar_init(&kfull[s], 1);
      hp::mbar_init(&kempty[s], kFwdConsumers);
    }
    for (int s = 0; s < kVStages; ++s) {
      hp::mbar_init(&vfull[s], 1);
      hp::mbar_init(&vempty[s], kFwdConsumers);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();
  W w(p);

  if (threadIdx.x >= kFwdConsumers) {
    hp::reg_dealloc<W::kProducerRegs>();
    if (threadIdx.x != kFwdConsumers) return;
    // k and v tiles and q tiles loaded so far: the rings' positions
    int kc = 0, vc = 0, tc = 0;
    do {
      const int q0 = w.r0, kl = w.n;
      if (kl == 0) continue;
      // the consumers' last S of the tile before has read q
      if (tc > 0) hp::mbar_wait(qempty, (tc - 1) & 1);
      hp::mbar_arrive_expect_tx(qfull, L::kTile);
#pragma unroll
      for (int b = 0; b < L::kBoxes; ++b)
        w.tma(sq + b * kFwdBox, qmap, qfull, 64 * b, q0);
      // k tile s, then v tile s - 1: v is read a step after k
      for (int s = 0; s <= kl; ++s) {
        if (s < kl) {
          const int st = kc % kKStages, k0 = w.first(s);
          hp::mbar_wait(&kempty[st], ((kc / kKStages) & 1) ^ 1);
          // released by the arrive below, read after the consumers' wait
          flags[st] = w.interior(s);
          hp::mbar_arrive_expect_tx(&kfull[st],
                                    L::kTile + W::kKeyMeta * kFwdN);
#pragma unroll
          for (int b = 0; b < L::kBoxes; ++b)
            w.tma(sk + st * L::kTile + b * kFwdBox, kmap, &kfull[st],
                  64 * b, k0);
          w.load_keys(meta + st * 2 * kFwdN, k0, kFwdN, &kfull[st]);
          ++kc;
        }
        if (s > 0) {
          const int sv1 = vc % kVStages, k0 = w.first(s - 1);
          hp::mbar_wait(&vempty[sv1], ((vc / kVStages) & 1) ^ 1);
          hp::mbar_arrive_expect_tx(&vfull[sv1], L::kTile);
#pragma unroll
          for (int b = 0; b < L::kBoxes; ++b)
            w.tma(sv + sv1 * L::kTile + b * kFwdBox, vmap, &vfull[sv1],
                  64 * b, k0);
          ++vc;
        }
      }
      ++tc;
    } while (W::kMultiTile && w.next());
    return;
  }
  hp::reg_alloc<consumer_regs(W::kProducerRegs)>();

  // consumers: warpgroup c owns rows q0 + 64c .. of each tile; this thread
  // rows row0 and row0 + 8, key columns 8j + 2t (+1) of each key tile
  const int c = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float sl2 = p.scale * kLog2e;
  const unsigned char* qa = sq + c * 64 * 128;  // this group's 64 rows
  int kc = 0, vc = 0, tc = 0;
  do {
    const int q0 = w.r0, kl = w.n;
    const int row0 = q0 + c * 64 + warp * 16 + g;
    const auto rows = w.rows(row0);
    float o[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
    float sc[64];
    uint32_t pa[kFwdN / 16][4];
    if (kl > 0) hp::mbar_wait(qfull, tc & 1);
    // iteration s: S(s) for s < kl, P(s-1) V(s-1) for s > 0
    for (int s = 0; s <= kl; ++s) {
      const int st = kc % kKStages, sv1 = vc % kVStages;
      hp::fence_operands(sc);
      hp::fence_operands(o);
      if (s < kl) {
        hp::mbar_wait(&kfull[st], (kc / kKStages) & 1);
        hp::wgmma_fence();
        const unsigned char* kt = sk + st * L::kTile;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int off = kk / 4 * kFwdBox + (kk % 4) * 32;
          hp::wgmma_m64n128k16<0, T>(sc, hp::desc_sw128(qa + off, 16, 1024),
                                     hp::desc_sw128(kt + off, 16, 1024),
                                     kk > 0);
        }
        hp::wgmma_commit();
      }
      if (s > 0) {
        hp::mbar_wait(&vfull[sv1], (vc / kVStages) & 1);
        hp::wgmma_fence();
        const unsigned char* vt = sv + sv1 * L::kTile;
#pragma unroll
        for (int kk = 0; kk < kFwdN / 16; ++kk)
          hp::wgmma_rs<D, T>(o, pa[kk],
                             hp::desc_sw128(vt + kk * 2048, kFwdBox, 1024),
                             1);
        hp::wgmma_commit();
      }

      float alpha[2] = {1.f, 1.f}, rs[2] = {0.f, 0.f};
      if (s < kl) {
        if (s > 0)
          hp::wgmma_wait<1>();  // S(s) done; P(s-1) V(s-1) may still run
        else
          hp::wgmma_wait<0>();
        hp::fence_operands(sc);
        if (s == kl - 1) hp::mbar_arrive(qempty);  // q is read
        // a boundary tile: scores of pairs that are not visible to -inf
        if (!flags[st])
          w.template mask<kFwdN>(sc, rows, meta + st * 2 * kFwdN,
                                 w.first(s));
        hp::mbar_arrive(&kempty[st]);  // k, its metadata and flag are read
        ++kc;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int e = 0; e < 64; ++e)
          mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
        float mneg[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // a row that has seen no key keeps m = kNeg: alpha 1, p 0
          const float mn = fmaxf(m[r], quad_max(mx[r]) * sl2);
          alpha[r] = ex2(m[r] - mn);  // 0 once a key is seen
          m[r] = mn;
          mneg[r] = -mn;
        }
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          const int r = (e >> 1) & 1;
          sc[e] = ex2(fmaf(sc[e], sl2, mneg[r]));  // -inf: 0
          rs[r] += sc[e];
        }
      }
      if (s > 0) {
        hp::wgmma_wait<0>();
        hp::fence_operands(o);
        hp::mbar_arrive(&vempty[sv1]);
        ++vc;
      }
      if (s < kl) {
#pragma unroll
        for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
        for (int e = 0; e < 64; e += 2)
          pa[e / 8][(e % 8) / 2] = pack2<T>(sc[e], sc[e + 1]);
      }
    }
    if (kl > 0) ++tc;

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    }
    if constexpr (W::kTmaStore) {
      // row r of this group's rows, 16-byte chunk j of box b at chunk
      // j ^ (r % 8) of line r (the maps' 128-byte swizzle)
      unsigned char* stg = so + c * 64 * 128;
      const bool issuer = threadIdx.x % 128 == 0;
      if (issuer) hp::bulk_wait_read<0>();  // the last tile's store read it
      hp::bar_sync(1 + c, 128);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = warp * 16 + g + r * 8;
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
          store2<T>(reinterpret_cast<T*>(stg + jj / 8 * kFwdBox + rr * 128 +
                                         ((jj % 8) ^ (rr % 8)) * 16 + 4 * t),
                    o[4 * jj + 2 * r] * inv[r],
                    o[4 * jj + 2 * r + 1] * inv[r]);
      }
      hp::fence_proxy_async();
      hp::bar_sync(1 + c, 128);
      if (issuer) {
#pragma unroll
        for (int b = 0; b < L::kBoxes; ++b)
          w.tma_store(omap, stg + b * kFwdBox, 64 * b, q0 + c * 64);
        hp::bulk_commit();
      }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + r * 8;
        if (row >= w.rows_out()) continue;
        T* out = static_cast<T*>(p.out) + w.template out_at<D>(row);
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj)
          store2<T>(out + jj * 8 + 2 * t, o[4 * jj + 2 * r] * inv[r],
                    o[4 * jj + 2 * r + 1] * inv[r]);
      }
    }
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        w.store_lse(row0 + r * 8,
                    l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : kNeg);
    }
  } while (W::kMultiTile && w.next());
  if constexpr (W::kTmaStore) {
    // shared memory is read by the last store before the block exits
    if (threadIdx.x % 128 == 0) hp::bulk_wait_read<0>();
  }
}

// --------------------------------------------------------------- backward

// Both backward kernels own a 128-row tile (q rows for dq, keys for dk/dv:
// 64 a consumer warpgroup) and take each step of their walk as a 64-row
// sub-tile, which a ring of 64-row TMA boxes brings in. A 128-row operand
// is stored as [half][64-column box][64 rows], so half c is warpgroup c's
// A operand.
constexpr int kBwdSub = 64;               // rows of a sub-tile
constexpr int kBwdBox = kBwdSub * 128;    // 8 KB: 64 rows x 64 columns
constexpr int kBwdMeta = 2 * kBwdSub * 4;  // room for 64 keys' metadata
constexpr int kDqKStages = 4;             // dq: k ring (held to dQ's product)
constexpr int kDqVStages = 3;             // dq: v ring
constexpr int kDkvStages = 4;             // dk/dv: q + dO ring
constexpr int kDkvStats = 4 * kBwdSub * 4;  // room for 64 rows' statistics

template <int D>
struct BwdTile {
  static constexpr int kBoxes = (D + 63) / 64;
  static constexpr int kSub = kBoxes * kBwdBox;  // a 64-row sub-tile
};

template <int D>
struct DqSmem {
  static constexpr int kSub = BwdTile<D>::kSub;
  // q and dO (128 rows each), the k ring, the v ring, the k sub-tiles'
  // key metadata, their interior flags, then the barriers
  static constexpr int kDo = 2 * kSub;
  static constexpr int kK = 4 * kSub;
  static constexpr int kV = kK + kDqKStages * kSub;
  static constexpr int kMeta = kV + kDqVStages * kSub;
  static constexpr int kFlags = kMeta + kDqKStages * kBwdMeta;
  static constexpr int kBars = kFlags + 64;
  static constexpr int kBytes =
      kBars + (2 + 2 * kDqKStages + 2 * kDqVStages) * 8 + 1024;  // + align
};

template <int D>
struct DkvSmem {
  static constexpr int kSub = BwdTile<D>::kSub;
  // k and v (128 rows each), the ring of q and dO sub-tiles, the stages'
  // per-row statistics [lse, delta, metadata][64] and interior flags, then
  // the barriers
  static constexpr int kV = 2 * kSub;
  static constexpr int kRing = 4 * kSub;
  static constexpr int kStats = kRing + kDkvStages * 2 * kSub;
  static constexpr int kFlags = kStats + kDkvStages * kDkvStats;
  static constexpr int kBars = kFlags + 64;
  static constexpr int kBytes =
      kBars + (2 + 2 * kDkvStages) * 8 + 1024;  // + align
};

// rows r0 .. r0 + 127 of the block's head into a 128-row operand
// [half][box][64 rows] (64-row boxes)
template <int D, class W>
__device__ __forceinline__ void tma_rows128(const W& w, unsigned char* dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int r0) {
  constexpr int kB = BwdTile<D>::kBoxes;
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int b = 0; b < kB; ++b)
      w.tma(dst + (c * kB + b) * kBwdBox, map, bar, 64 * b, r0 + 64 * c);
}

// a 64-row sub-tile from row r0 into [box][64 rows]
template <int D, class W>
__device__ __forceinline__ void tma_rows64(const W& w, unsigned char* dst,
                                           const CUtensorMap* map,
                                           uint64_t* bar, int r0) {
#pragma unroll
  for (int b = 0; b < BwdTile<D>::kBoxes; ++b)
    w.tma(dst + b * kBwdBox, map, bar, 64 * b, r0);
}

// acc[64 x 64] = A (64 rows, K-major over D, a [box][64 rows] operand) B^T
// (B a 64-row sub-tile, K-major over D): S = Q K^T and its kin, D / 16
// k-steps of m64n64k16
template <int D, typename T>
__device__ __forceinline__ void wgmma_abt64(float (&acc)[32],
                                            const unsigned char* a,
                                            const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = kk / 4 * kBwdBox + (kk % 4) * 32;
    hp::wgmma_m64n64k16<0, T>(acc, hp::desc_sw128(a + off, 16, 1024),
                              hp::desc_sw128(b + off, 16, 1024), kk > 0);
  }
}

// acc[64 x D] += X (64 x 64, register fragments x[4][4]) B (a 64-row
// sub-tile read N-major: rows are k, columns D): dQ += dS K, dV += P^T dO,
// dK += dS^T Q. At D 96 the second box's columns 96.. are TMA's zeros and
// the product runs at n96.
template <int D, typename T>
__device__ __forceinline__ void wgmma_xb64(float (&acc)[D / 2],
                                           const uint32_t (&x)[4][4],
                                           const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hp::wgmma_rs<D, T>(acc, x[kk],
                       hp::desc_sw128(b + kk * 2048, kBwdBox, 1024), 1);
}

// a consumer's 64 x D accumulator (rows r0 + 16w + g + 8h, columns 8j + 2t
// + e), times `mul`, as T rows of the walk's contiguous output; rows at
// or past w.rows_out() are not stored
template <int D, class W, typename T>
__device__ __forceinline__ void store_acc(const W& w, void* dst, int r0,
                                          const float (&acc)[D / 2],
                                          float mul) {
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + g + 8 * h;
    if (row >= w.rows_out()) continue;
    T* out = static_cast<T*>(dst) + w.template out_at<D>(row);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2<T>(out + j * 8 + 2 * t, acc[4 * j + 2 * h] * mul,
                acc[4 * j + 2 * h + 1] * mul);
  }
}

// dq: a block owns 128-row q tiles of one head, one after the other (two
// consumer warpgroups of 64 rows), and walks each tile's 64-key
// sub-tiles. A producer warpgroup (one thread issues; its registers go to
// the consumers) loads a tile's q and dO once the consumers' last S and dP
// of the tile before have read them, and keeps a k ring and a v ring full
// across the tiles; a k stage also carries its keys' mask metadata (the
// walk's) and the tile pair's interior flag. A warpgroup's iteration s
// issues S(s) = Q K(s)^T and dP(s) = dO V(s)^T (wgmma m64n64k16, all
// operands K-major in shared memory), then dQ += dS(s-1) K(s-1) (m64nDk16,
// dS from registers as 16-bit pairs, k N-major), and forms dS(s) = P (dP -
// delta), P = exp(S - lse) on visible pairs, while that product runs: on a
// boundary tile the scores of pairs that are not visible go to -inf first,
// an interior tile skips that pass (folded into the exponent loop of every
// tile, it made a first design much slower). A v stage is released once dP
// is done, a k stage once its dQ product is. Rows without lse and delta
// take 0 for both: they are not stored.
template <int D, class W, typename T>
__device__ __forceinline__ void bwd_dq_wgmma(const CUtensorMap* qmap,
                                             const CUtensorMap* kmap,
                                             const CUtensorMap* vmap,
                                             const CUtensorMap* dmap,
                                             const typename W::Params& p) {
  using L = DqSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_1k(smem_raw);
  unsigned char* sq = smem;
  unsigned char* sdo = smem + L::kDo;
  unsigned char* sk = smem + L::kK;                     // [k stages] subs
  unsigned char* sv = smem + L::kV;                     // [v stages] subs
  int* meta = reinterpret_cast<int*>(smem + L::kMeta);  // [k st][2][64]
  int* flags = reinterpret_cast<int*>(smem + L::kFlags);  // [k stages]
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* qempty = qfull + 1;
  uint64_t* kfull = qempty + 1;
  uint64_t* kempty = kfull + kDqKStages;
  uint64_t* vfull = kempty + kDqKStages;
  uint64_t* vempty = vfull + kDqVStages;
  if (threadIdx.x == 0) {
    hp::mbar_init(qfull, 1);
    hp::mbar_init(qempty, kFwdConsumers);
    for (int s = 0; s < kDqKStages; ++s) {
      hp::mbar_init(&kfull[s], 1);
      hp::mbar_init(&kempty[s], kFwdConsumers);
    }
    for (int s = 0; s < kDqVStages; ++s) {
      hp::mbar_init(&vfull[s], 1);
      hp::mbar_init(&vempty[s], kFwdConsumers);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();
  W w(p);

  if (threadIdx.x >= kFwdConsumers) {
    hp::reg_dealloc<W::kProducerRegs>();
    if (threadIdx.x != kFwdConsumers) return;
    int kc = 0, tc = 0;  // k and v sub-tiles loaded, q tiles loaded
    do {
      const int q0 = w.r0, n = w.n;
      if (n == 0) continue;
      // the consumers' last S and dP of the tile before have read q, dO
      if (tc > 0) hp::mbar_wait(qempty, (tc - 1) & 1);
      hp::mbar_arrive_expect_tx(qfull, 4 * L::kSub);
      tma_rows128<D>(w, sq, qmap, qfull, q0);
      tma_rows128<D>(w, sdo, dmap, qfull, q0);
      for (int s = 0; s < n; ++s, ++kc) {
        const int kst = kc % kDqKStages, vst = kc % kDqVStages;
        const int k0 = w.first(s);
        hp::mbar_wait(&kempty[kst], ((kc / kDqKStages) & 1) ^ 1);
        // released by the arrive below, read after the consumers' wait
        flags[kst] = w.interior(s);
        hp::mbar_arrive_expect_tx(&kfull[kst],
                                  L::kSub + W::kKeyMeta * kBwdSub);
        tma_rows64<D>(w, sk + kst * L::kSub, kmap, &kfull[kst], k0);
        w.load_keys(meta + kst * 2 * kBwdSub, k0, kBwdSub, &kfull[kst]);
        hp::mbar_wait(&vempty[vst], ((kc / kDqVStages) & 1) ^ 1);
        hp::mbar_arrive_expect_tx(&vfull[vst], L::kSub);
        tma_rows64<D>(w, sv + vst * L::kSub, vmap, &vfull[vst], k0);
      }
      ++tc;
    } while (W::kMultiTile && w.next());
    return;
  }
  hp::reg_alloc<consumer_regs(W::kProducerRegs)>();

  // consumers: warpgroup c owns rows q0 + 64c .. of each tile; this thread
  // rows row0 and row0 + 8, key columns 8j + 2t (+1) of each sub-tile
  const int c = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const float sl2 = p.scale * kLog2e;
  const unsigned char* qa = sq + c * L::kSub;  // this group's 64 rows
  const unsigned char* da = sdo + c * L::kSub;
  int kc = 0, tc = 0;  // sub-tiles and q tiles taken so far
  do {
    const int q0 = w.r0, n = w.n;
    const int row0 = q0 + c * 64 + warp * 16 + g;
    const auto rows = w.rows(row0);
    float nl2[2], dl[2];  // -lse (floored) in base 2, delta
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      nl2[h] = -fmaxf(w.stat(p.lse, row0 + h * 8), kNegSafe) * kLog2e;
      dl[h] = w.stat(p.delta, row0 + h * 8);
    }
    float dq[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dq[e] = 0.f;
    float sc[32], dp[32];
    uint32_t dsa[4][4];
    if (n > 0) hp::mbar_wait(qfull, tc & 1);
    // iteration s: S(s), dP(s) for s < n; dQ += dS(s-1) K(s-1) for s > 0
    for (int s = 0; s <= n; ++s) {
      const int kst = kc % kDqKStages, vst = kc % kDqVStages;
      const int kst1 = (kc + kDqKStages - 1) % kDqKStages;
      hp::fence_operands(sc);
      hp::fence_operands(dp);
      hp::fence_operands(dq);
      if (s < n) {
        hp::mbar_wait(&kfull[kst], (kc / kDqKStages) & 1);
        hp::mbar_wait(&vfull[vst], (kc / kDqVStages) & 1);
        hp::wgmma_fence();
        wgmma_abt64<D, T>(sc, qa, sk + kst * L::kSub);
        wgmma_abt64<D, T>(dp, da, sv + vst * L::kSub);
        hp::wgmma_commit();
      }
      if (s > 0) {
        hp::wgmma_fence();
        wgmma_xb64<D, T>(dq, dsa, sk + kst1 * L::kSub);
        hp::wgmma_commit();
      }
      if (s < n) {
        if (s > 0)
          hp::wgmma_wait<1>();  // S(s), dP(s) done; dQ's product may run
        else
          hp::wgmma_wait<0>();
        hp::fence_operands(sc);
        hp::fence_operands(dp);
        hp::mbar_arrive(&vempty[vst]);
        if (s == n - 1) hp::mbar_arrive(qempty);  // q and dO are read
        // a boundary tile: scores of pairs that are not visible to -inf
        if (!flags[kst])
          w.template mask<kBwdSub>(sc, rows, meta + kst * 2 * kBwdSub,
                                   w.first(s));
        // dS = P (dP - delta) in sc, P = exp(S - lse) (-inf: 0)
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int h = (e >> 1) & 1;
          sc[e] = ex2(fmaf(sc[e], sl2, nl2[h])) * (dp[e] - dl[h]);
        }
      }
      if (s > 0) {
        hp::wgmma_wait<0>();
        hp::fence_operands(dq);
        hp::fence_operands(dsa);
        hp::mbar_arrive(&kempty[kst1]);  // K(s-1) read by its dQ product
      }
      if (s < n) {
#pragma unroll
        for (int e = 0; e < 32; e += 2)
          dsa[e / 8][(e % 8) / 2] = pack2<T>(sc[e], sc[e + 1]);
        ++kc;
      }
    }
    if (n > 0) ++tc;
    store_acc<D, W, T>(w, p.out, q0 + c * 64, dq, p.scale);
  } while (W::kMultiTile && w.next());
}

// dk/dv: a block owns 128-key tiles of one head, one after the other (two
// consumer warpgroups of 64 keys), and walks each tile's 64-row q
// sub-tiles. The producer warpgroup loads a tile's k and v once the
// consumers' last S^T and dP^T of the tile before have read them, and
// keeps one ring full across the tiles: a stage holds 64 rows of q and of
// dO, those rows' statistics (lse, delta and the walk's mask metadata, by
// bulk copies) and the tile pair's interior flag. A warpgroup's iteration
// issues S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16), forms P^T on
// visible pairs (the mask pass on boundary tiles only, as in dq) and
// issues dV += P^T dO (m64nDk16, P^T from registers, dO N-major), forms
// dS^T = P^T (dP^T - delta) while that product runs and issues dK += dS^T
// Q. The next iteration's S^T and dP^T queue behind those products; a
// stage is released once they are done. A tile with no step stores zeros.
template <int D, class W, typename T>
__device__ __forceinline__ void bwd_dkv_wgmma(const CUtensorMap* qmap,
                                              const CUtensorMap* kmap,
                                              const CUtensorMap* vmap,
                                              const CUtensorMap* dmap,
                                              const typename W::Params& p) {
  using L = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_1k(smem_raw);
  unsigned char* sk = smem;
  unsigned char* sv = smem + L::kV;
  unsigned char* ring = smem + L::kRing;  // [stage][q, dO][sub-tile]
  float* stats = reinterpret_cast<float*>(smem + L::kStats);  // [st][4][64]
  int* flags = reinterpret_cast<int*>(smem + L::kFlags);      // [stages]
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* kvempty = kvfull + 1;
  uint64_t* full = kvempty + 1;
  uint64_t* empty = full + kDkvStages;
  if (threadIdx.x == 0) {
    hp::mbar_init(kvfull, 1);
    hp::mbar_init(kvempty, kFwdConsumers);
    for (int s = 0; s < kDkvStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kFwdConsumers);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();
  W w(p);

  if (threadIdx.x >= kFwdConsumers) {
    hp::reg_dealloc<W::kProducerRegs>();
    if (threadIdx.x != kFwdConsumers) return;
    int rc = 0, tc = 0;  // ring stages and k tiles loaded so far
    do {
      const int k0 = w.r0, n = w.n;
      if (n == 0) continue;
      // the consumers' last S^T and dP^T of the tile before have read k, v
      if (tc > 0) hp::mbar_wait(kvempty, (tc - 1) & 1);
      hp::mbar_arrive_expect_tx(kvfull, 4 * L::kSub);
      tma_rows128<D>(w, sk, kmap, kvfull, k0);
      tma_rows128<D>(w, sv, vmap, kvfull, k0);
      for (int s = 0; s < n; ++s, ++rc) {
        const int st = rc % kDkvStages, r0 = w.first(s);
        hp::mbar_wait(&empty[st], ((rc / kDkvStages) & 1) ^ 1);
        flags[st] = w.interior(s);
        unsigned char* stage = ring + st * 2 * L::kSub;
        hp::mbar_arrive_expect_tx(&full[st],
                                  2 * L::kSub + W::kQStats * kBwdSub);
        tma_rows64<D>(w, stage, qmap, &full[st], r0);
        tma_rows64<D>(w, stage + L::kSub, dmap, &full[st], r0);
        w.load_qstats(stats + st * 4 * kBwdSub, r0, &full[st]);
      }
      ++tc;
    } while (W::kMultiTile && w.next());
    return;
  }
  hp::reg_alloc<consumer_regs(W::kProducerRegs)>();

  // consumers: warpgroup c owns keys k0 + 64c .. of each tile; this thread
  // keys key0 and key0 + 8, q columns 8j + 2t (+1) of each sub-tile
  const int c = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const float sl2 = p.scale * kLog2e;
  const unsigned char* ka = sk + c * L::kSub;  // this group's 64 keys
  const unsigned char* va = sv + c * L::kSub;
  int rc = 0, tc = 0;  // ring stages and k tiles taken so far
  do {
    const int k0 = w.r0, n = w.n;
    const int key0 = k0 + c * 64 + warp * 16 + g;
    const auto rows = w.rows(key0);
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) dk[e] = dv[e] = 0.f;
    float sc[32], dp[32];
    uint32_t pa[4][4], dsa[4][4];
    if (n > 0) hp::mbar_wait(kvfull, tc & 1);
    for (int s = 0; s < n; ++s, ++rc) {
      const int st = rc % kDkvStages;
      const unsigned char* qt = ring + st * 2 * L::kSub;
      const unsigned char* dot = qt + L::kSub;
      hp::fence_operands(sc);
      hp::fence_operands(dp);
      hp::mbar_wait(&full[st], (rc / kDkvStages) & 1);
      hp::wgmma_fence();
      wgmma_abt64<D, T>(sc, ka, qt);   // S^T
      wgmma_abt64<D, T>(dp, va, dot);  // dP^T
      hp::wgmma_commit();
      hp::wgmma_wait<0>();  // also the products of iteration s - 1
      hp::fence_operands(sc);
      hp::fence_operands(dp);
      hp::fence_operands(dk);
      hp::fence_operands(dv);
      hp::fence_operands(pa);
      hp::fence_operands(dsa);
      if (s > 0)
        hp::mbar_arrive(&empty[(rc + kDkvStages - 1) % kDkvStages]);
      if (s == n - 1) hp::mbar_arrive(kvempty);  // k and v are read
      const float* stage = stats + st * 4 * kBwdSub;
      // a boundary tile: scores of pairs that are not visible to -inf
      if (!flags[st])
        w.template mask<kBwdSub>(
            sc, rows, reinterpret_cast<const int*>(stage + 2 * kBwdSub),
            w.first(s));
      // this thread's q columns of the stage: 8jj + 2t (+1)
      const float* sst = stage + 2 * t;
      // P^T = exp(S^T - lse) (-inf: 0), rounded to T fragments
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 l2 = *reinterpret_cast<const float2*>(sst + 8 * jj);
        const float nl0 = -fmaxf(l2.x, kNegSafe) * kLog2e;
        const float nl1 = -fmaxf(l2.y, kNegSafe) * kLog2e;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          sc[4 * jj + cc] =
              ex2(fmaf(sc[4 * jj + cc], sl2, cc & 1 ? nl1 : nl0));
      }
#pragma unroll
      for (int e = 0; e < 32; e += 2)
        pa[e / 8][(e % 8) / 2] = pack2<T>(sc[e], sc[e + 1]);
      hp::wgmma_fence();
      wgmma_xb64<D, T>(dv, pa, dot);  // dV's product runs while dS^T is formed
      hp::wgmma_commit();
      // dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(sst + kBwdSub + 8 * jj);
#pragma unroll
        for (int cc = 0; cc < 4; cc += 2) {
          const int e = 4 * jj + cc;
          dsa[e / 8][(e % 8) / 2] = pack2<T>(sc[e] * (dp[e] - d2.x),
                                             sc[e + 1] * (dp[e + 1] - d2.y));
        }
      }
      hp::wgmma_fence();
      wgmma_xb64<D, T>(dk, dsa, qt);
      hp::wgmma_commit();
    }
    hp::wgmma_wait<0>();
    hp::fence_operands(dk);
    hp::fence_operands(dv);
    hp::fence_operands(pa);
    hp::fence_operands(dsa);
    if (n > 0) {
      // the tile's last stage, read by its last products
      hp::mbar_arrive(&empty[(rc + kDkvStages - 1) % kDkvStages]);
      ++tc;
    }
    store_acc<D, W, T>(w, p.dk, k0 + c * 64, dk, p.scale);
    store_acc<D, W, T>(w, p.dv, k0 + c * 64, dv, 1.f);
  } while (W::kMultiTile && w.next());
}

}  // namespace flash
}  // namespace ptt
