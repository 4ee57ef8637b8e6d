// Packed varlen flash attention, forward and backward: three entry points.
//
// Replace the TPU kernels of paddle_tpu/nn/functional/flash_varlen.py:
//   ptt_flash_varlen_fwd      _packed_fwd_pallas (:235, pallas_call :357)
//   ptt_flash_varlen_bwd_dq   _packed_dq_pallas  (:373, pallas_call :487)
//   ptt_flash_varlen_bwd_dkv  _packed_dkv_pallas (:500, pallas_call :632)
// Python wrapper: paddle_tpu_torch/nn/functional/flash_varlen.py.
//
// What they compute, for a packed batch q [tq, h, d], k and v [tk, h, d]
// (read in place through their row and head strides, the last axis
// contiguous) whose segments are cut by cu_seqlens: key κ is visible from
// query ι iff both lie in the same segment and, under `causal`, the
// in-segment position of ι is at least that of κ (top left in each
// segment, as _boundary_mask at :227).
//   fwd  out = softmax over visible keys of (q k^T scale) v   [tq, h, d]
//        lse = log sum over visible keys of exp(s)       [h, tq_pad] f32
//   dq   dq = scale dS k                                     [tq, h, d]
//   dkv  dv = P^T dO, dk = scale dS^T q                      [tk, h, d]
// with P = exp(s - max(lse, -5e29)) on visible pairs and 0 elsewhere,
// dS = P (dO v^T - delta), delta = sum_d out dO [h, tq_pad] f32 from the
// wrapper (a PyTorch reduction). dO and the outputs are contiguous. A
// query that sees no key (a pad row, or a segment whose keys are empty)
// gets out = 0 and lse = -1e30 exactly: the reference multiplies p by the
// mask, so such a row is not the uniform average of its keys that B10's
// finite mask value would give it.
//
// Walk. The wrapper builds the block map (varlen_block_map) on the device
// from cu_seqlens: each q tile visits one interval of k tiles (kstart,
// klen), each k tile one interval of q tiles (qstart2, qlen2), so the work
// is the sum of the segments' tile areas, not tq x tk. A block owns one
// tile of one head and walks its interval with every output tile written
// by its one owner, no atomics (the TPU kernels carry the sums in VMEM
// scratch across a sequential grid axis; here the walk is a loop in the
// block). Blocks take their tiles in `order`, longest interval first, so
// the long walks of a causal pack start first and the short ones fill the
// tail. An interior tile (one segment, wholly causal-visible: the map's
// qslo/qshi/qpos0 and kslo/kshi/kmax) skips the mask, as the reference's
// lax.cond does; a boundary tile compares each pair's (segment, position)
// from the map's per-token qmeta and kmeta [2, t_pad]. Rows past tq and
// keys past tk are zero-filled by predicated cp.async (the Hopper kernels
// read them as TMA's zeros) and never stored; they lie in the phantom
// segment, so no real query or key meets them.
//
// bf16 runs on the tensor cores. At head_dim 64, 96 and 128 all three
// kernels are Hopper's (wgmma fed by TMA rings, a producer warpgroup whose
// registers go to two consumer warpgroups by setmaxnreg) and walk one
// 128 x 128 map. The forward (varlen_fwd_wgmma) owns a 128-row q tile of
// one head and walks 128-key tiles (a 3-stage k ring, a 2-stage v ring);
// S = Q K^T and O += P V are wgmma products (P from registers), the
// softmax of one tile runs beside the P V product of the one before. dq
// (varlen_bwd_dq_wgmma) owns a 128-row q tile and walks its k tiles as
// 64-key sub-tiles: S and dP by wgmma m64n64k16, dQ += dS K with dS from
// registers, dS of one sub-tile formed beside the dQ product of the one
// before. dk/dv (varlen_bwd_dkv_wgmma) owns 128 keys and walks its q tiles
// as 64-row sub-tiles: S^T = K Q^T and dP^T = V dO^T, then dV += P^T dO and
// dK += dS^T Q with P^T and dS^T from registers. At 256 the kernels are
// mma.sync (flash_tiles.cuh: m16n8k16 with fp32 sums, ldmatrix fragments,
// a 2-stage cp.async ring): the forward and dq blocks own 64 query rows
// (warp w rows 16w..) over 64-key tiles walked in 32-key sub-tiles, and a
// dk/dv block owns 64 keys and one half of the head's columns over 32-row
// q tiles (the grid's head axis doubles; each half recomputes S^T and
// dP^T), so a warp's accumulators take no more registers than at 128; P
// and dS pass from one product to the next in registers. f32 runs 32 x 32
// tiles on the CUDA cores with exact fp32 products. The softmax runs in
// base 2 with f32 statistics. The wrapper pads lse and the metadata to a
// multiple of 128 rows, a whole number of every tile.
//
// Bounds (H100 SXM: 989 TFLOP/s dense bf16, 3.35 TB/s). At the rung (h 16,
// d 128, 8 causal segments of 4096, T 32768) there are 1.074 G visible
// pairs a head-sum: the forward does 550 GFLOP (0.556 ms) against 0.161
// ms of bytes, dq 825 GFLOP (0.834 ms) and dk/dv 1.10 TFLOP (1.112 ms):
// operations bound all three. Two backward kernels, each output tile
// written by its one owner with no atomics, recompute S and dP in both:
// 1.93 TFLOP against the 1.38 of one kernel that sums dq by atomics.
#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

using namespace ptt::tiles;
using ptt::cp_async_commit;
using ptt::cp_async_wait;

constexpr float kNeg = -1e30f;      // the reference's _NEG
constexpr float kNegSafe = -5e29f;  // its lse floor in the backward

struct VarlenParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;    // backward: dO, contiguous [tq, h, D]
  void* out;           // forward: out; dq: dq (contiguous [tq, h, D])
  void* dk;            // contiguous [tk, h, D]
  void* dv;
  float* lse;          // [h, tq_pad]: written by the forward, read after
  const float* delta;  // [h, tq_pad]
  int64_t qss, qsh, kss, ksh, vss, vsh;
  // the block map: `order` lists the walked tiles longest walk first;
  // start/len are kstart/klen (forward, dq) or qstart2/qlen2 (dk/dv)
  const int* order;
  const int* start;
  const int* len;
  const int* qslo;
  const int* qshi;
  const int* qpos0;
  const int* kslo;
  const int* kshi;
  const int* kmax;
  const int* qmeta;  // [2, tq_pad]: segment, in-segment position
  const int* kmeta;  // [2, tk_pad]
  int tq, tk, tq_pad, tk_pad, h, causal;
  float scale;
};

// offset of row r of head hi in a contiguous [t, h, D] array
template <int D>
__device__ __forceinline__ int64_t packed_at(const VarlenParams& p, int r,
                                             int hi) {
  return (static_cast<int64_t>(r) * p.h + hi) * D;
}

// q tile i and k tile j of the forward map: one segment, and under causal
// every key at or before every query
__device__ __forceinline__ bool interior(const VarlenParams& p, int i,
                                         int j) {
  return p.qslo[i] == p.qshi[i] && p.kslo[j] == p.kshi[j] &&
         p.qslo[i] == p.kslo[j] && (!p.causal || p.kmax[j] <= p.qpos0[i]);
}

__device__ __forceinline__ bool visible(const VarlenParams& p, int sq,
                                        int pq, int sk, int pk) {
  return sq == sk && (!p.causal || pq >= pk);
}

// ---------------------------------------------------------------- bf16

// rows g and g + 8 below r0 of a warp's 16 x DO accumulator, times
// `mul`, as bf16 columns col0.. of rows of a contiguous [n, h, D] array;
// rows at or past n are not stored
template <int D, int DO = D>
__device__ __forceinline__ void store_rows(const VarlenParams& p, void* dst,
                                           int n, int hi, int r0,
                                           const float (&acc)[DO / 8][4],
                                           const float (&mul)[2],
                                           int col0 = 0) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + r * 8;
    if (row >= n) continue;
    bf16* out = static_cast<bf16*>(dst) + packed_at<D>(p, row, hi) + col0;
#pragma unroll
    for (int nt = 0; nt < DO / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(out + nt * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[nt][2 * r] * mul[r],
                                acc[nt][2 * r + 1] * mul[r]);
  }
}

// k tile j (64 keys of head hi) and its keys' segment and position into
// stage `st` of the ring
template <int D>
__device__ __forceinline__ void load_ktile(const VarlenParams& p, bf16* sk,
                                           bf16* sv, int* skm, int st,
                                           int hi, int j) {
  constexpr int kN = 64, kPitch = TileBf16<D>::kPitch;
  load_rows<kN, D>(sk + st * kN * kPitch, p.k, 0, p.kss, p.ksh, 0, hi,
                   j * kN, p.tk);
  load_rows<kN, D>(sv + st * kN * kPitch, p.v, 0, p.vss, p.vsh, 0, hi,
                   j * kN, p.tk);
  load_words(skm + st * 2 * kN, p.kmeta + j * kN, kN);
  load_words(skm + st * 2 * kN + kN, p.kmeta + p.tk_pad + j * kN, kN);
}

// Visibility of a warp's 16 x N score fragment (rows g, g + 8 with
// segments qs and positions qp; keys nt*8 + 2t + (c & 1) with segments
// ks[] and positions kp[] in shared memory): bit nt*4 + c.
template <int N>
__device__ __forceinline__ uint32_t visible_bits(const VarlenParams& p,
                                                 const int (&qs)[2],
                                                 const int (&qp)[2],
                                                 const int* ks,
                                                 const int* kp) {
  const int t = threadIdx.x % 4;
  uint32_t bits = 0;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kc = nt * 8 + 2 * t + (c & 1), r = c >> 1;
      bits |= static_cast<uint32_t>(visible(p, qs[r], qp[r], ks[kc], kp[kc]))
              << (nt * 4 + c);
    }
  return bits;
}

// Forward at D 256: a block owns 64 query rows of one head and walks its
// k-tile interval with an online softmax over the visible keys.
template <int D>
__global__ void __launch_bounds__(kThreads)
    varlen_fwd_bf16(const VarlenParams p) {
  constexpr int kM = 64, kN = 64, kPitch = TileBf16<D>::kPitch;
  constexpr int kS = TileBf16<D>::kSub;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);                 // [kM][kPitch]
  bf16* sk = sq + kM * kPitch;                              // [2][kN][kPitch]
  bf16* sv = sk + 2 * kN * kPitch;                          // [2][kN][kPitch]
  int* skm = reinterpret_cast<int*>(sv + 2 * kN * kPitch);  // [2][2][kN]
  const int hi = blockIdx.x, i = p.order[blockIdx.y];
  const int q0 = i * kM, ks = p.start[i], kl = p.len[i];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const float sl2 = p.scale * kLog2e;
  int qs[2], qp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qs[r] = p.qmeta[row0 + r * 8];
    qp[r] = p.qmeta[p.tq_pad + row0 + r * 8];
  }

  load_rows<kM, D>(sq, p.q, 0, p.qss, p.qsh, 0, hi, q0, p.tq);
  if (kl > 0) load_ktile<D>(p, sk, sv, skm, 0, hi, ks);
  cp_async_commit();

  float o[D / 8][4];
  zero(o);
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  for (int s = 0; s < kl; ++s) {
    const int j = ks + s, st = s & 1;
    if (s + 1 < kl) load_ktile<D>(p, sk, sv, skm, st ^ 1, hi, j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bool in = interior(p, i, j);
#pragma unroll 1
    for (int sub = 0; sub < kN / kS; ++sub) {
      const int k0 = st * kN + sub * kS;  // the sub-tile's row in the stage
      float sc[kS / 8][4];
      zero(sc);
      mma_abt<kS, D>(sc, sq + warp * 16 * kPitch, sk + k0 * kPitch);
      const uint32_t vis =
          in ? 0xffffffffu
             : visible_bits<kS>(p, qs, qp, skm + st * 2 * kN + sub * kS,
                                skm + st * 2 * kN + kN + sub * kS);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < kS / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float x =
              (vis >> (nt * 4 + c)) & 1u ? sc[nt][c] * sl2 : kNeg;
          sc[nt][c] = x;
          mx[c >> 1] = fmaxf(mx[c >> 1], x);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        const float alpha = exp2f(m[r] - mx[r]);  // 0 once a key is seen
        m[r] = mx[r];
        l[r] *= alpha;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          o[nt][2 * r] *= alpha;
          o[nt][2 * r + 1] *= alpha;
        }
      }
#pragma unroll
      for (int nt = 0; nt < kS / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // masked pairs are 0, also while the row's max is still kNeg
          const float pr = (vis >> (nt * 4 + c)) & 1u
                               ? exp2f(sc[nt][c] - m[c >> 1])
                               : 0.f;
          sc[nt][c] = pr;
          l[c >> 1] += pr;
        }
      mma_xb<kS, D>(o, sc, sv + k0 * kPitch);
    }
    __syncthreads();  // the stage is refilled by the next iteration
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
  store_rows<D>(p, p.out, p.tq, hi, q0 + warp * 16, o, inv);
  if (t == 0) {
    float* lse = p.lse + static_cast<int64_t>(hi) * p.tq_pad;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lse[row0 + r * 8] = l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : kNeg;
  }
}

// ------------------------------------------- bf16 forward: wgmma + TMA

namespace hp = ptt::hopper;

constexpr int kFwdM = 128;            // query rows of a tile: 64 a warpgroup
constexpr int kFwdN = 128;            // keys of a tile
constexpr int kKStages = 3;           // k ring
constexpr int kVStages = 2;           // v ring
constexpr int kFwdConsumers = 256;    // two warpgroups
constexpr int kFwdThreads = kFwdConsumers + 128;  // + the producer's
constexpr int kFwdBox = 128 * 128;    // 16 KB: 128 rows x 64 columns
constexpr int kFwdMeta = 2 * kFwdN * 4;  // a k tile's segments, positions

template <int D>
struct FwdSmem {
  static constexpr int kBoxes = (D + 63) / 64;  // 64-column boxes a tile
  static constexpr int kTile = kBoxes * kFwdBox;
  // q, the k ring, the v ring, the k tiles' key metadata and interior
  // flags, then the barriers
  static constexpr int kV = (1 + kKStages) * kTile;
  static constexpr int kMeta = kV + kVStages * kTile;
  static constexpr int kFlags = kMeta + kKStages * kFwdMeta;
  static constexpr int kBars = kFlags + 16;
  static constexpr int kBytes =
      kBars + (1 + 2 * kKStages + 2 * kVStages) * 8 + 1024;  // + align
};

__device__ __forceinline__ float ex2(float x) {  // 2^x, ftz; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Forward on Hopper: a block owns a 128-row q tile of one head (two
// consumer warpgroups of 64 rows) and walks its k-tile interval (128 keys
// a tile). A producer warpgroup (one thread issues; its registers go to
// the consumers by setmaxnreg) loads the q tile once and keeps a k ring
// and a v ring full: rank-3 TMA maps over the strided [t, h, d] operands,
// 128-byte swizzle, 64-column boxes; rows past tq or tk and columns past D
// read as zeros; a k stage also holds its keys' segments and positions
// (bulk copies) and whether the tile pair is interior. A warpgroup's
// iteration s issues S(s) = Q K(s)^T (wgmma m64n128k16, q and k K-major
// in shared memory) and then O += P(s-1) V(s-1) (wgmma m64nDk16, P from
// registers: the previous S accumulator rounded to bf16 in pairs is the A
// fragment; v N-major), takes its softmax of S(s) while the P V product
// runs (masked scores are -inf on boundary tiles; base 2, f32
// statistics), then rescales O. A k stage is released once S is done, a
// v stage once its P V product is, so each ring refills early. At D 96
// the second box's columns 96..127 are TMA's zeros, and the products run
// at k 96 and n 96.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    varlen_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const VarlenParams p) {
  using L = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sq = smem;
  unsigned char* sk = sq + L::kTile;                    // [k stages] tiles
  unsigned char* sv = smem + L::kV;                     // [v stages] tiles
  int* meta = reinterpret_cast<int*>(smem + L::kMeta);  // [k st][2][128]
  int* flags = reinterpret_cast<int*>(smem + L::kFlags);  // [k stages]
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* kfull = qfull + 1;
  uint64_t* kempty = kfull + kKStages;
  uint64_t* vfull = kempty + kKStages;
  uint64_t* vempty = vfull + kVStages;
  if (threadIdx.x == 0) {
    hp::mbar_init(qfull, 1);
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
  // heads slowest: the blocks in flight share one or two heads' k and v
  const int hi = blockIdx.y, i = p.order[blockIdx.x];
  const int q0 = i * kFwdM, ks = p.start[i], kl = p.len[i];

  if (threadIdx.x >= kFwdConsumers) {
    hp::reg_dealloc<24>();
    if (threadIdx.x != kFwdConsumers || kl == 0) return;
    hp::mbar_arrive_expect_tx(qfull, L::kTile);
#pragma unroll
    for (int b = 0; b < L::kBoxes; ++b)
      hp::tma_load_3d(sq + b * kFwdBox, &qmap, qfull, 64 * b, hi, q0);
    // k tile s, then v tile s - 1: v is read a step after k
    for (int s = 0; s <= kl; ++s) {
      if (s < kl) {
        const int st = s % kKStages, j = ks + s, k0 = j * kFwdN;
        hp::mbar_wait(&kempty[st], ((s / kKStages) & 1) ^ 1);
        // released by the arrive below, read after the consumers' wait
        flags[st] = interior(p, i, j);
        int* m = meta + st * 2 * kFwdN;
        hp::mbar_arrive_expect_tx(&kfull[st], L::kTile + kFwdMeta);
#pragma unroll
        for (int b = 0; b < L::kBoxes; ++b)
          hp::tma_load_3d(sk + st * L::kTile + b * kFwdBox, &kmap,
                          &kfull[st], 64 * b, hi, k0);
        hp::bulk_load(m, p.kmeta + k0, kFwdMeta / 2, &kfull[st]);
        hp::bulk_load(m + kFwdN, p.kmeta + p.tk_pad + k0, kFwdMeta / 2,
                      &kfull[st]);
      }
      if (s > 0) {
        const int sv1 = (s - 1) % kVStages, k0 = (ks + s - 1) * kFwdN;
        hp::mbar_wait(&vempty[sv1], (((s - 1) / kVStages) & 1) ^ 1);
        hp::mbar_arrive_expect_tx(&vfull[sv1], L::kTile);
#pragma unroll
        for (int b = 0; b < L::kBoxes; ++b)
          hp::tma_load_3d(sv + sv1 * L::kTile + b * kFwdBox, &vmap,
                          &vfull[sv1], 64 * b, hi, k0);
      }
    }
    return;
  }
  hp::reg_alloc<240>();

  // consumers: warpgroup c owns rows q0 + 64c ..; this thread rows
  // row0 and row0 + 8, key columns 8j + 2t (+1) of each tile
  const int c = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + c * 64 + warp * 16 + g;
  const float sl2 = p.scale * kLog2e;
  int qs[2], qp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qs[r] = p.qmeta[row0 + r * 8];
    qp[r] = p.qmeta[p.tq_pad + row0 + r * 8];
  }
  float o[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float sc[64];
  uint32_t pa[kFwdN / 16][4];
  const unsigned char* qa = sq + c * 64 * 128;  // this group's 64 rows
  if (kl > 0) hp::mbar_wait(qfull, 0);
  // iteration s: S(s) for s < kl, P(s-1) V(s-1) for s > 0
  for (int s = 0; s <= kl; ++s) {
    const int st = s % kKStages, sv1 = (s + kVStages - 1) % kVStages;
    hp::fence_operands(sc);
    hp::fence_operands(o);
    if (s < kl) {
      hp::mbar_wait(&kfull[st], (s / kKStages) & 1);
      hp::wgmma_fence();
      const unsigned char* kt = sk + st * L::kTile;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = kk / 4 * kFwdBox + (kk % 4) * 32;
        hp::wgmma_m64n128k16<0>(sc, hp::desc_sw128(qa + off, 16, 1024),
                                hp::desc_sw128(kt + off, 16, 1024), kk > 0);
      }
      hp::wgmma_commit();
    }
    if (s > 0) {
      hp::mbar_wait(&vfull[sv1], ((s - 1) / kVStages) & 1);
      hp::wgmma_fence();
      const unsigned char* vt = sv + sv1 * L::kTile;
#pragma unroll
      for (int kk = 0; kk < kFwdN / 16; ++kk)
        hp::wgmma_rs<D>(o, pa[kk],
                        hp::desc_sw128(vt + kk * 2048, kFwdBox, 1024), 1);
      hp::wgmma_commit();
    }

    float alpha[2] = {1.f, 1.f}, rs[2] = {0.f, 0.f};
    if (s < kl) {
      if (s > 0)
        hp::wgmma_wait<1>();  // S(s) done; P(s-1) V(s-1) may still run
      else
        hp::wgmma_wait<0>();
      hp::fence_operands(sc);
      if (!flags[st]) {
        // a boundary tile: scores of pairs that are not visible to -inf
        const int* ksg = meta + st * 2 * kFwdN + 2 * t;
#pragma unroll
        for (int jj = 0; jj < kFwdN / 8; ++jj) {
          const int2 sk2 = *reinterpret_cast<const int2*>(ksg + 8 * jj);
          const int2 pk2 =
              *reinterpret_cast<const int2*>(ksg + kFwdN + 8 * jj);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int r = cc >> 1;
            if (!visible(p, qs[r], qp[r], cc & 1 ? sk2.y : sk2.x,
                         cc & 1 ? pk2.y : pk2.x))
              sc[4 * jj + cc] = -INFINITY;
          }
        }
      }
      hp::mbar_arrive(&kempty[st]);  // k, its metadata and flag are read
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
    }
    if (s < kl) {
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int e = 0; e < 64; e += 2)
        pa[e / 8][(e % 8) / 2] = pack_bf16(sc[e], sc[e + 1]);
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= p.tq) continue;
    bf16* out = static_cast<bf16*>(p.out) + packed_at<D>(p, row, hi);
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(out + jj * 8 + 2 * t) =
          __floats2bfloat162_rn(o[4 * jj + 2 * r] * inv[r],
                                o[4 * jj + 2 * r + 1] * inv[r]);
  }
  if (t == 0) {
    float* lse = p.lse + static_cast<int64_t>(hi) * p.tq_pad;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lse[row0 + r * 8] = l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : kNeg;
  }
}

// ------------------------------------------ bf16 backward: wgmma + TMA

// Both backward kernels walk the forward's 128 x 128 map; a block owns a
// 128-row tile (q rows for dq, keys for dk/dv: 64 a consumer warpgroup)
// and takes each 128-row tile of its walk as two 64-row sub-tiles, which
// a ring of 64-row TMA boxes brings in. A 128-row operand is stored as
// [half][64-column box][64 rows], so half c is warpgroup c's A operand.
constexpr int kBwdSub = 64;               // rows of a sub-tile
constexpr int kBwdBox = kBwdSub * 128;    // 8 KB: 64 rows x 64 columns
constexpr int kBwdMeta = 2 * kBwdSub * 4;  // segments, positions of 64 rows
constexpr int kDqKStages = 4;             // dq: k ring (held to dQ's product)
constexpr int kDqVStages = 3;             // dq: v ring
constexpr int kDkvStages = 4;             // dk/dv: q + dO ring
constexpr int kDkvStats = 4 * kBwdSub * 4;  // lse, delta, segment, position

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
      kBars + (1 + 2 * kDqKStages + 2 * kDqVStages) * 8 + 1024;  // + align
};

template <int D>
struct DkvSmem {
  static constexpr int kSub = BwdTile<D>::kSub;
  // k and v (128 rows each), the ring of q and dO sub-tiles, the stages'
  // per-row statistics and interior flags, then the barriers
  static constexpr int kV = 2 * kSub;
  static constexpr int kRing = 4 * kSub;
  static constexpr int kStats = kRing + kDkvStages * 2 * kSub;
  static constexpr int kFlags = kStats + kDkvStages * kDkvStats;
  static constexpr int kBars = kFlags + 64;
  static constexpr int kBytes =
      kBars + (1 + 2 * kDkvStages) * 8 + 1024;  // + align
};

// the 1 KB-aligned start of a kernel's dynamic shared memory
__device__ __forceinline__ unsigned char* smem_1k(unsigned char* raw) {
  return raw + ((1024 - (hp::smem_u32(raw) & 1023)) & 1023);
}

// rows r0 .. r0 + 127 of head hi of a rank-3 [t, h, D] map (64-row boxes)
// into a 128-row operand [half][box][64 rows]
template <int D>
__device__ __forceinline__ void tma_rows128(unsigned char* dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int hi, int r0) {
  constexpr int kB = BwdTile<D>::kBoxes;
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int b = 0; b < kB; ++b)
      hp::tma_load_3d(dst + (c * kB + b) * kBwdBox, map, bar, 64 * b, hi,
                      r0 + 64 * c);
}

// a 64-row sub-tile from row r0 into [box][64 rows]
template <int D>
__device__ __forceinline__ void tma_rows64(unsigned char* dst,
                                           const CUtensorMap* map,
                                           uint64_t* bar, int hi, int r0) {
#pragma unroll
  for (int b = 0; b < BwdTile<D>::kBoxes; ++b)
    hp::tma_load_3d(dst + b * kBwdBox, map, bar, 64 * b, hi, r0);
}

// acc[64 x 64] = A (64 rows, K-major over D, a [box][64 rows] operand) B^T
// (B a 64-row sub-tile, K-major over D): S = Q K^T and its kin, D / 16
// k-steps of m64n64k16
template <int D>
__device__ __forceinline__ void wgmma_abt64(float (&acc)[32],
                                            const unsigned char* a,
                                            const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = kk / 4 * kBwdBox + (kk % 4) * 32;
    hp::wgmma_m64n64k16<0>(acc, hp::desc_sw128(a + off, 16, 1024),
                           hp::desc_sw128(b + off, 16, 1024), kk > 0);
  }
}

// acc[64 x D] += X (64 x 64, register fragments x[4][4]) B (a 64-row
// sub-tile read N-major: rows are k, columns D): dQ += dS K, dV += P^T dO,
// dK += dS^T Q. At D 96 the second box's columns 96.. are TMA's zeros and
// the product runs at n96.
template <int D>
__device__ __forceinline__ void wgmma_xb64(float (&acc)[D / 2],
                                           const uint32_t (&x)[4][4],
                                           const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hp::wgmma_rs<D>(acc, x[kk], hp::desc_sw128(b + kk * 2048, kBwdBox, 1024),
                    1);
}

// a consumer's 64 x D accumulator (rows r0 + 16w + g + 8h, columns 8j + 2t
// + e), times `mul`, as bf16 rows of a contiguous [n, h, D] array; rows at
// or past n are not stored
template <int D>
__device__ __forceinline__ void store_acc(const VarlenParams& p, void* dst,
                                          int n, int hi, int r0,
                                          const float (&acc)[D / 2],
                                          float mul) {
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + warp * 16 + g + 8 * h;
    if (row >= n) continue;
    bf16* out = static_cast<bf16*>(dst) + packed_at<D>(p, row, hi);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] * mul,
                                acc[4 * j + 2 * h + 1] * mul);
  }
}

// dq on Hopper: a block owns a 128-row q tile of one head (two consumer
// warpgroups of 64 rows) and walks its k-tile interval of the forward map
// in 64-key sub-tiles. A producer warpgroup (one thread issues; its
// registers go to the consumers) loads q and dO once and keeps a k ring
// and a v ring full; a k stage also carries its keys' segments and
// positions (bulk copies) and the tile pair's interior flag. A
// warpgroup's iteration s issues S(s) = Q K(s)^T and dP(s) = dO V(s)^T
// (wgmma m64n64k16, all operands K-major in shared memory), then dQ +=
// dS(s-1) K(s-1) (m64nDk16, dS from registers as bf16 pairs, k N-major),
// and forms dS(s) = P (dP - delta), P = exp(S - lse) on visible pairs,
// while that product runs: on a boundary tile the scores of pairs that are
// not visible go to -inf first, an interior tile skips that pass (folded
// into the exponent loop of every tile, it made a first design much
// slower). A v stage is released once dP is done, a k stage once its dQ
// product is. One block a (tile, head), heads slowest: the blocks in
// flight share one or two heads' k and v. Heads fastest was slower, and
// so was a persistent walk (one block an SM taking the tiles in a static
// round robin, q and dO double-buffered): the hardware's block scheduler
// balances the walks' lengths better than the round robin.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    varlen_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap dmap,
                        const VarlenParams p) {
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
  uint64_t* kfull = qfull + 1;
  uint64_t* kempty = kfull + kDqKStages;
  uint64_t* vfull = kempty + kDqKStages;
  uint64_t* vempty = vfull + kDqVStages;
  if (threadIdx.x == 0) {
    hp::mbar_init(qfull, 1);
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
  // heads slowest: the blocks in flight share one or two heads' k and v
  const int hi = blockIdx.y, i = p.order[blockIdx.x];
  const int q0 = i * kFwdM, ks = p.start[i], n = 2 * p.len[i];

  if (threadIdx.x >= kFwdConsumers) {
    hp::reg_dealloc<24>();
    if (threadIdx.x != kFwdConsumers || n == 0) return;
    hp::mbar_arrive_expect_tx(qfull, 4 * L::kSub);
    tma_rows128<D>(sq, &qmap, qfull, hi, q0);
    tma_rows128<D>(sdo, &dmap, qfull, hi, q0);
    for (int s = 0; s < n; ++s) {
      const int kst = s % kDqKStages, vst = s % kDqVStages;
      const int j = ks + s / 2, k0 = j * kFwdN + (s % 2) * kBwdSub;
      hp::mbar_wait(&kempty[kst], ((s / kDqKStages) & 1) ^ 1);
      // released by the arrive below, read after the consumers' wait
      flags[kst] = interior(p, i, j);
      int* m = meta + kst * 2 * kBwdSub;
      hp::mbar_arrive_expect_tx(&kfull[kst], L::kSub + kBwdMeta);
      tma_rows64<D>(sk + kst * L::kSub, &kmap, &kfull[kst], hi, k0);
      hp::bulk_load(m, p.kmeta + k0, kBwdMeta / 2, &kfull[kst]);
      hp::bulk_load(m + kBwdSub, p.kmeta + p.tk_pad + k0, kBwdMeta / 2,
                    &kfull[kst]);
      hp::mbar_wait(&vempty[vst], ((s / kDqVStages) & 1) ^ 1);
      hp::mbar_arrive_expect_tx(&vfull[vst], L::kSub);
      tma_rows64<D>(sv + vst * L::kSub, &vmap, &vfull[vst], hi, k0);
    }
    return;
  }
  hp::reg_alloc<240>();

  // consumers: warpgroup c owns rows q0 + 64c ..; this thread rows row0
  // and row0 + 8, key columns 8j + 2t (+1) of each sub-tile
  const int c = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + c * 64 + warp * 16 + g;
  const float sl2 = p.scale * kLog2e;
  int qs[2], qp[2];
  float nl2[2], dl[2];  // -lse (floored) in base 2, delta
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h * 8;
    const int64_t at = static_cast<int64_t>(hi) * p.tq_pad + row;
    qs[h] = p.qmeta[row];
    qp[h] = p.qmeta[p.tq_pad + row];
    nl2[h] = -fmaxf(p.lse[at], kNegSafe) * kLog2e;
    dl[h] = p.delta[at];
  }
  float dq[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dq[e] = 0.f;
  float sc[32], dp[32];
  uint32_t dsa[4][4];
  const unsigned char* qa = sq + c * L::kSub;  // this group's 64 rows
  const unsigned char* da = sdo + c * L::kSub;
  if (n > 0) hp::mbar_wait(qfull, 0);
  // iteration s: S(s), dP(s) for s < n; dQ += dS(s-1) K(s-1) for s > 0
  for (int s = 0; s <= n; ++s) {
    const int kst = s % kDqKStages, vst = s % kDqVStages;
    const int kst1 = (s + kDqKStages - 1) % kDqKStages;
    hp::fence_operands(sc);
    hp::fence_operands(dp);
    hp::fence_operands(dq);
    if (s < n) {
      hp::mbar_wait(&kfull[kst], (s / kDqKStages) & 1);
      hp::mbar_wait(&vfull[vst], (s / kDqVStages) & 1);
      hp::wgmma_fence();
      wgmma_abt64<D>(sc, qa, sk + kst * L::kSub);
      wgmma_abt64<D>(dp, da, sv + vst * L::kSub);
      hp::wgmma_commit();
    }
    if (s > 0) {
      hp::wgmma_fence();
      wgmma_xb64<D>(dq, dsa, sk + kst1 * L::kSub);
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
      if (!flags[kst]) {
        // a boundary tile: scores of pairs that are not visible to -inf
        const int* ksg = meta + kst * 2 * kBwdSub + 2 * t;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int2 sk2 = *reinterpret_cast<const int2*>(ksg + 8 * jj);
          const int2 pk2 =
              *reinterpret_cast<const int2*>(ksg + kBwdSub + 8 * jj);
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int h = cc >> 1;
            if (!visible(p, qs[h], qp[h], cc & 1 ? sk2.y : sk2.x,
                         cc & 1 ? pk2.y : pk2.x))
              sc[4 * jj + cc] = -INFINITY;
          }
        }
      }
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
        dsa[e / 8][(e % 8) / 2] = pack_bf16(sc[e], sc[e + 1]);
    }
  }
  store_acc<D>(p, p.out, p.tq, hi, q0 + c * 64, dq, p.scale);
}

// dk/dv on Hopper: a block owns 128 keys of one head (two consumer
// warpgroups of 64 keys) and walks its q-tile interval of the transposed
// map in 64-row sub-tiles. The producer warpgroup loads k and v once and
// keeps one ring full: a stage holds 64 rows of q and of dO and those
// rows' lse, delta, segment and position (bulk copies), and the tile
// pair's interior flag. A warpgroup's iteration issues S^T = K Q^T and
// dP^T = V dO^T (wgmma m64n64k16), forms P^T on visible pairs (the mask
// pass on boundary tiles only, as in dq) and issues dV += P^T dO
// (m64nDk16, P^T from registers, dO N-major), forms dS^T = P^T (dP^T -
// delta) while that product runs and issues dK += dS^T Q. The next
// iteration's S^T and dP^T queue behind those products; a stage is
// released once they are done.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    varlen_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap dmap,
                         const VarlenParams p) {
  using L = DkvSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_1k(smem_raw);
  unsigned char* sk = smem;
  unsigned char* sv = smem + L::kV;
  unsigned char* ring = smem + L::kRing;  // [stage][q, dO][sub-tile]
  float* stats = reinterpret_cast<float*>(smem + L::kStats);  // [st][4][64]
  int* flags = reinterpret_cast<int*>(smem + L::kFlags);      // [stages]
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* full = kvfull + 1;
  uint64_t* empty = full + kDkvStages;
  if (threadIdx.x == 0) {
    hp::mbar_init(kvfull, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kFwdConsumers);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();
  const int hi = blockIdx.y, j = p.order[blockIdx.x];
  const int k0 = j * kFwdN, qs0 = p.start[j], n = 2 * p.len[j];

  if (threadIdx.x >= kFwdConsumers) {
    hp::reg_dealloc<24>();
    if (threadIdx.x != kFwdConsumers || n == 0) return;
    hp::mbar_arrive_expect_tx(kvfull, 4 * L::kSub);
    tma_rows128<D>(sk, &kmap, kvfull, hi, k0);
    tma_rows128<D>(sv, &vmap, kvfull, hi, k0);
    for (int s = 0; s < n; ++s) {
      const int st = s % kDkvStages, tt = qs0 + s / 2;
      const int r0 = tt * kFwdM + (s % 2) * kBwdSub;
      hp::mbar_wait(&empty[st], ((s / kDkvStages) & 1) ^ 1);
      flags[st] = interior(p, tt, j);
      unsigned char* stage = ring + st * 2 * L::kSub;
      float* sst = stats + st * 4 * kBwdSub;
      const int64_t plane = static_cast<int64_t>(hi) * p.tq_pad + r0;
      hp::mbar_arrive_expect_tx(&full[st], 2 * L::kSub + kDkvStats);
      tma_rows64<D>(stage, &qmap, &full[st], hi, r0);
      tma_rows64<D>(stage + L::kSub, &dmap, &full[st], hi, r0);
      hp::bulk_load(sst, p.lse + plane, kBwdSub * 4, &full[st]);
      hp::bulk_load(sst + kBwdSub, p.delta + plane, kBwdSub * 4, &full[st]);
      hp::bulk_load(sst + 2 * kBwdSub, p.qmeta + r0, kBwdSub * 4, &full[st]);
      hp::bulk_load(sst + 3 * kBwdSub, p.qmeta + p.tq_pad + r0, kBwdSub * 4,
                    &full[st]);
    }
    return;
  }
  hp::reg_alloc<240>();

  // consumers: warpgroup c owns keys k0 + 64c ..; this thread keys key0
  // and key0 + 8, q columns 8j + 2t (+1) of each sub-tile
  const int c = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + c * 64 + warp * 16 + g;
  const float sl2 = p.scale * kLog2e;
  int ksg[2], kps[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ksg[h] = p.kmeta[key0 + h * 8];
    kps[h] = p.kmeta[p.tk_pad + key0 + h * 8];
  }
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dk[e] = dv[e] = 0.f;
  float sc[32], dp[32];
  uint32_t pa[4][4], dsa[4][4];
  const unsigned char* ka = sk + c * L::kSub;  // this group's 64 keys
  const unsigned char* va = sv + c * L::kSub;
  if (n > 0) hp::mbar_wait(kvfull, 0);
  for (int s = 0; s < n; ++s) {
    const int st = s % kDkvStages;
    const unsigned char* qt = ring + st * 2 * L::kSub;
    const unsigned char* dot = qt + L::kSub;
    hp::fence_operands(sc);
    hp::fence_operands(dp);
    hp::mbar_wait(&full[st], (s / kDkvStages) & 1);
    hp::wgmma_fence();
    wgmma_abt64<D>(sc, ka, qt);   // S^T
    wgmma_abt64<D>(dp, va, dot);  // dP^T
    hp::wgmma_commit();
    hp::wgmma_wait<0>();  // also the products of iteration s - 1
    hp::fence_operands(sc);
    hp::fence_operands(dp);
    hp::fence_operands(dk);
    hp::fence_operands(dv);
    hp::fence_operands(pa);
    hp::fence_operands(dsa);
    if (s > 0) hp::mbar_arrive(&empty[(s + kDkvStages - 1) % kDkvStages]);
    // this thread's q columns of the stage: 8jj + 2t (+1)
    const float* sst = stats + st * 4 * kBwdSub + 2 * t;
    if (!flags[st]) {
      // a boundary tile: scores of pairs that are not visible to -inf
      const int* qsg = reinterpret_cast<const int*>(sst + 2 * kBwdSub);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int2 sq2 = *reinterpret_cast<const int2*>(qsg + 8 * jj);
        const int2 pq2 =
            *reinterpret_cast<const int2*>(qsg + kBwdSub + 8 * jj);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int h = cc >> 1;
          if (!visible(p, cc & 1 ? sq2.y : sq2.x, cc & 1 ? pq2.y : pq2.x,
                       ksg[h], kps[h]))
            sc[4 * jj + cc] = -INFINITY;
        }
      }
    }
    // P^T = exp(S^T - lse) (-inf: 0), rounded to bf16 fragments
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 l2 = *reinterpret_cast<const float2*>(sst + 8 * jj);
      const float nl0 = -fmaxf(l2.x, kNegSafe) * kLog2e;
      const float nl1 = -fmaxf(l2.y, kNegSafe) * kLog2e;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        sc[4 * jj + cc] = ex2(fmaf(sc[4 * jj + cc], sl2, cc & 1 ? nl1 : nl0));
    }
#pragma unroll
    for (int e = 0; e < 32; e += 2)
      pa[e / 8][(e % 8) / 2] = pack_bf16(sc[e], sc[e + 1]);
    hp::wgmma_fence();
    wgmma_xb64<D>(dv, pa, dot);  // dV's product runs while dS^T is formed
    hp::wgmma_commit();
    // dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 d2 =
          *reinterpret_cast<const float2*>(sst + kBwdSub + 8 * jj);
#pragma unroll
      for (int cc = 0; cc < 4; cc += 2) {
        const int e = 4 * jj + cc;
        dsa[e / 8][(e % 8) / 2] = pack_bf16(sc[e] * (dp[e] - d2.x),
                                            sc[e + 1] * (dp[e + 1] - d2.y));
      }
    }
    hp::wgmma_fence();
    wgmma_xb64<D>(dk, dsa, qt);
    hp::wgmma_commit();
  }
  hp::wgmma_wait<0>();
  hp::fence_operands(dk);
  hp::fence_operands(dv);
  hp::fence_operands(pa);
  hp::fence_operands(dsa);
  store_acc<D>(p, p.dk, p.tk, hi, k0 + c * 64, dk, p.scale);
  store_acc<D>(p, p.dv, p.tk, hi, k0 + c * 64, dv, 1.f);
}

// dq at D 256: a block owns 64 query rows of one head and walks the
// forward map's k-tile interval: S = Q K^T, P = exp(S - lse) on visible
// pairs, dP = dO V^T, dS = P (dP - delta), dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kThreads)
    varlen_bwd_dq_bf16(const VarlenParams p) {
  constexpr int kM = 64, kN = 64, kPitch = TileBf16<D>::kPitch;
  constexpr int kS = TileBf16<D>::kSub;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);                 // [kM][kPitch]
  bf16* sdo = sq + kM * kPitch;                             // [kM][kPitch]
  bf16* sk = sdo + kM * kPitch;                             // [2][kN][kPitch]
  bf16* sv = sk + 2 * kN * kPitch;                          // [2][kN][kPitch]
  int* skm = reinterpret_cast<int*>(sv + 2 * kN * kPitch);  // [2][2][kN]
  const int hi = blockIdx.x, i = p.order[blockIdx.y];
  const int q0 = i * kM, ks = p.start[i], kl = p.len[i];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int row0 = q0 + warp * 16 + g;
  const float sl2 = p.scale * kLog2e;
  int qs[2], qp[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    const int64_t at = static_cast<int64_t>(hi) * p.tq_pad + row;
    qs[r] = p.qmeta[row];
    qp[r] = p.qmeta[p.tq_pad + row];
    lse2[r] = fmaxf(p.lse[at], kNegSafe) * kLog2e;
    dl[r] = p.delta[at];
  }

  const int64_t dss = static_cast<int64_t>(p.h) * D;
  load_rows<kM, D>(sq, p.q, 0, p.qss, p.qsh, 0, hi, q0, p.tq);
  load_rows<kM, D>(sdo, p.dout, 0, dss, D, 0, hi, q0, p.tq);
  if (kl > 0) load_ktile<D>(p, sk, sv, skm, 0, hi, ks);
  cp_async_commit();

  float dq[D / 8][4];
  zero(dq);
  for (int s = 0; s < kl; ++s) {
    const int j = ks + s, st = s & 1;
    if (s + 1 < kl) load_ktile<D>(p, sk, sv, skm, st ^ 1, hi, j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bool in = interior(p, i, j);
#pragma unroll 1
    for (int sub = 0; sub < kN / kS; ++sub) {
      const bf16* kt = sk + (st * kN + sub * kS) * kPitch;
      const bf16* vt = sv + (st * kN + sub * kS) * kPitch;
      float sc[kS / 8][4], dp[kS / 8][4];
      zero(sc);
      zero(dp);
      mma_abt<kS, D>(sc, sq + warp * 16 * kPitch, kt);
      mma_abt<kS, D>(dp, sdo + warp * 16 * kPitch, vt);
      const uint32_t vis =
          in ? 0xffffffffu
             : visible_bits<kS>(p, qs, qp, skm + st * 2 * kN + sub * kS,
                                skm + st * 2 * kN + kN + sub * kS);
#pragma unroll
      for (int nt = 0; nt < kS / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = c >> 1;
          const float pr = (vis >> (nt * 4 + c)) & 1u
                               ? exp2f(sc[nt][c] * sl2 - lse2[r])
                               : 0.f;
          sc[nt][c] = pr * (dp[nt][c] - dl[r]);  // dS
        }
      mma_xb<kS, D>(dq, sc, kt);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  const float mul[2] = {p.scale, p.scale};
  store_rows<D>(p, p.out, p.tq, hi, q0 + warp * 16, dq, mul);
}

// dk/dv at D 256: a block owns 64 keys of one head (warp w keys 16w..)
// and kC of their D columns, and walks the transposed map's interval of
// 32-row q tiles: S^T = K Q^T, P^T on visible pairs, dV += P^T dO, dP^T
// = V dO^T, dS^T = P^T (dP^T - delta), dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(kThreads)
    varlen_bwd_dkv_bf16(const VarlenParams p) {
  constexpr int kM = 32, kN = 64, kPitch = TileBf16<D>::kPitch;
  constexpr int kC = TileBf16<D>::kCols, kHalves = D / kC;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);  // [kN][kPitch]
  bf16* sv = sk + kN * kPitch;               // [kN][kPitch]
  bf16* sq = sv + kN * kPitch;               // [2][kM][kPitch]
  bf16* sdo = sq + 2 * kM * kPitch;          // [2][kM][kPitch]
  // per stage: lse, delta (f32), segment, position (int32) of the q rows
  float* sst = reinterpret_cast<float*>(sdo + 2 * kM * kPitch);  // [2][4][kM]
  const int hi = blockIdx.x / kHalves, col0 = blockIdx.x % kHalves * kC;
  const int j = p.order[blockIdx.y];
  const int k0 = j * kN, qs0 = p.start[j], ql = p.len[j];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  const float sl2 = p.scale * kLog2e;
  const int64_t dss = static_cast<int64_t>(p.h) * D;
  int ks[2], kp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    ks[r] = p.kmeta[key0 + r * 8];
    kp[r] = p.kmeta[p.tk_pad + key0 + r * 8];
  }
  const bool uk = p.kslo[j] == p.kshi[j];

  auto load_qtile = [&](int st, int tt) {
    const int r0 = tt * kM;
    const int64_t plane = static_cast<int64_t>(hi) * p.tq_pad + r0;
    float* stats = sst + st * 4 * kM;
    load_rows<kM, D>(sq + st * kM * kPitch, p.q, 0, p.qss, p.qsh, 0, hi, r0,
                     p.tq);
    load_rows<kM, D>(sdo + st * kM * kPitch, p.dout, 0, dss, D, 0, hi, r0,
                     p.tq);
    load_words(stats, p.lse + plane, kM);
    load_words(stats + kM, p.delta + plane, kM);
    load_words(stats + 2 * kM, p.qmeta + r0, kM);
    load_words(stats + 3 * kM, p.qmeta + p.tq_pad + r0, kM);
  };

  load_rows<kN, D>(sk, p.k, 0, p.kss, p.ksh, 0, hi, k0, p.tk);
  load_rows<kN, D>(sv, p.v, 0, p.vss, p.vsh, 0, hi, k0, p.tk);
  if (ql > 0) load_qtile(0, qs0);
  cp_async_commit();

  float dk[kC / 8][4], dv[kC / 8][4];
  zero(dk);
  zero(dv);
  for (int s = 0; s < ql; ++s) {
    const int tt = qs0 + s, st = s & 1;
    if (s + 1 < ql) load_qtile(st ^ 1, tt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bf16* qt = sq + st * kM * kPitch;
    const bf16* dot = sdo + st * kM * kPitch;
    const float* lt = sst + st * 4 * kM;
    const float* dt = lt + kM;
    const int* qseg = reinterpret_cast<const int*>(lt + 2 * kM);
    const int* qpos = qseg + kM;
    const bool in = uk && p.qslo[tt] == p.qshi[tt] &&
                    p.qslo[tt] == p.kslo[j] &&
                    (!p.causal || p.kmax[j] <= p.qpos0[tt]);
    float sc[kM / 8][4];
    zero(sc);
    mma_abt<kM, D>(sc, sk + warp * 16 * kPitch, qt);  // S^T
#pragma unroll
    for (int nt = 0; nt < kM / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = nt * 8 + 2 * t + (c & 1), r = c >> 1;
        const bool ok =
            in || visible(p, qseg[col], qpos[col], ks[r], kp[r]);
        sc[nt][c] =
            ok ? exp2f(sc[nt][c] * sl2 - fmaxf(lt[col], kNegSafe) * kLog2e)
               : 0.f;  // P^T
      }
    mma_xb<kM, kC, kPitch>(dv, sc, dot + col0);
    float dp[kM / 8][4];
    zero(dp);
    mma_abt<kM, D>(dp, sv + warp * 16 * kPitch, dot);  // dP^T
#pragma unroll
    for (int nt = 0; nt < kM / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sc[nt][c] *= dp[nt][c] - dt[nt * 8 + 2 * t + (c & 1)];  // dS^T
    mma_xb<kM, kC, kPitch>(dk, sc, qt + col0);
    __syncthreads();
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f}, mul[2] = {p.scale, p.scale};
  store_rows<D, kC>(p, p.dk, p.tk, hi, k0 + warp * 16, dk, mul, col0);
  store_rows<D, kC>(p, p.dv, p.tk, hi, k0 + warp * 16, dv, one, col0);
}

// ---------------------------------------------------------------- f32

template <int D>
__device__ __forceinline__ void store_cols_f32(const VarlenParams& p,
                                               void* dst, int n, int hi,
                                               int row,
                                               const float (&acc)[D / 4],
                                               float mul) {
  if (row >= n) return;
  float* out = static_cast<float*>(dst) + packed_at<D>(p, row, hi);
  const int qd = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) out[i * 4 + qd] = acc[i] * mul;
}

// the segment and position of kT tokens from t0 of a [2, t_pad] metadata
// array into sm[0..kT) and sm[kT..2kT)
__device__ __forceinline__ void load_meta_f32(int* sm, const int* meta,
                                              int t_pad, int t0) {
  if (threadIdx.x < kT) {
    sm[threadIdx.x] = meta[t0 + threadIdx.x];
    sm[kT + threadIdx.x] = meta[t_pad + t0 + threadIdx.x];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    varlen_fwd_f32(const VarlenParams p) {
  constexpr int kPitch = TileF32<D>::kPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);  // [kT][kPitch]
  float* sk = sq + kT * kPitch;
  float* sv = sk + kT * kPitch;
  float* sp = sv + kT * kPitch;                        // [kT][kT + 1]
  int* skm = reinterpret_cast<int*>(sp + kT * (kT + 1));  // [2][kT]
  const int hi = blockIdx.x, i = p.order[blockIdx.y];
  const int q0 = i * kT, ks = p.start[i], kl = p.len[i];
  const int r = threadIdx.x / 4, qd = threadIdx.x % 4, row = q0 + r;
  const int qs = p.qmeta[row], qp = p.qmeta[p.tq_pad + row];
  load_rows_f32<D>(sq, p.q, 0, p.qss, p.qsh, 0, hi, q0, p.tq);
  float o[D / 4] = {};
  float m = kNeg, l = 0.f;
  for (int s = 0; s < kl; ++s) {
    const int j = ks + s, k0 = j * kT;
    __syncthreads();
    load_rows_f32<D>(sk, p.k, 0, p.kss, p.ksh, 0, hi, k0, p.tk);
    load_rows_f32<D>(sv, p.v, 0, p.vss, p.vsh, 0, hi, k0, p.tk);
    load_meta_f32(skm, p.kmeta, p.tk_pad, k0);
    __syncthreads();
    const bool in = interior(p, i, j);
    float sc[8], mx = m;
    unsigned vis = 0;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = qd * 8 + e;
      const bool ok = in || visible(p, qs, qp, skm[c], skm[kT + c]);
      sc[e] = ok ? dot_rows<D>(sq + r * kPitch, sk + c * kPitch) * p.scale
                 : kNeg;
      vis |= static_cast<unsigned>(ok) << e;
      mx = fmaxf(mx, sc[e]);
    }
    mx = quad_max(mx);
    const float alpha = expf(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float pr = (vis >> e) & 1u ? expf(sc[e] - m) : 0.f;
      l += pr;
      sp[r * (kT + 1) + qd * 8 + e] = pr;
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < D / 4; ++e) {
      float acc = o[e] * alpha;
      for (int c = 0; c < kT; ++c)
        acc = fmaf(sp[r * (kT + 1) + c], sv[c * kPitch + e * 4 + qd], acc);
      o[e] = acc;
    }
  }
  l = quad_sum(l);
  store_cols_f32<D>(p, p.out, p.tq, hi, row, o, l > 0.f ? 1.f / l : 0.f);
  if (qd == 0)
    p.lse[static_cast<int64_t>(hi) * p.tq_pad + row] =
        l > 0.f ? m + logf(l) : kNeg;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    varlen_bwd_dq_f32(const VarlenParams p) {
  constexpr int kPitch = TileF32<D>::kPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* sdo = sq + kT * kPitch;
  float* sk = sdo + kT * kPitch;
  float* sv = sk + kT * kPitch;
  float* sds = sv + kT * kPitch;                           // [kT][kT + 1]
  int* skm = reinterpret_cast<int*>(sds + kT * (kT + 1));  // [2][kT]
  const int hi = blockIdx.x, i = p.order[blockIdx.y];
  const int q0 = i * kT, ks = p.start[i], kl = p.len[i];
  const int r = threadIdx.x / 4, qd = threadIdx.x % 4, row = q0 + r;
  const int qs = p.qmeta[row], qp = p.qmeta[p.tq_pad + row];
  const int64_t at = static_cast<int64_t>(hi) * p.tq_pad + row;
  const float lse = fmaxf(p.lse[at], kNegSafe), dl = p.delta[at];
  const int64_t dss = static_cast<int64_t>(p.h) * D;
  load_rows_f32<D>(sq, p.q, 0, p.qss, p.qsh, 0, hi, q0, p.tq);
  load_rows_f32<D>(sdo, p.dout, 0, dss, D, 0, hi, q0, p.tq);
  float dq[D / 4] = {};
  for (int s = 0; s < kl; ++s) {
    const int j = ks + s, k0 = j * kT;
    __syncthreads();
    load_rows_f32<D>(sk, p.k, 0, p.kss, p.ksh, 0, hi, k0, p.tk);
    load_rows_f32<D>(sv, p.v, 0, p.vss, p.vsh, 0, hi, k0, p.tk);
    load_meta_f32(skm, p.kmeta, p.tk_pad, k0);
    __syncthreads();
    const bool in = interior(p, i, j);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = qd * 8 + e;
      float ds = 0.f;
      if (in || visible(p, qs, qp, skm[c], skm[kT + c])) {
        const float sc =
            dot_rows<D>(sq + r * kPitch, sk + c * kPitch) * p.scale;
        const float dp = dot_rows<D>(sdo + r * kPitch, sv + c * kPitch);
        ds = expf(sc - lse) * (dp - dl);
      }
      sds[r * (kT + 1) + c] = ds;
    }
    __syncwarp();
    // key by key, one dS a step (the sums in the same order as column by
    // column, with fewer values held: a column-outer loop spilled at D 96)
#pragma unroll 4
    for (int c = 0; c < kT; ++c) {
      const float ds = sds[r * (kT + 1) + c];
      const float* kc = sk + c * kPitch + qd;
#pragma unroll
      for (int e = 0; e < D / 4; ++e) dq[e] = fmaf(ds, kc[e * 4], dq[e]);
    }
  }
  store_cols_f32<D>(p, p.out, p.tq, hi, row, dq, p.scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    varlen_bwd_dkv_f32(const VarlenParams p) {
  constexpr int kPitch = TileF32<D>::kPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sk = reinterpret_cast<float*>(smem);
  float* sv = sk + kT * kPitch;
  float* sq = sv + kT * kPitch;
  float* sdo = sq + kT * kPitch;
  float* sp = sdo + kT * kPitch;    // [kT][kT + 1]: P^T
  float* sds = sp + kT * (kT + 1);  // [kT][kT + 1]: dS^T
  float* slse = sds + kT * (kT + 1);
  float* sdl = slse + kT;
  int* sqm = reinterpret_cast<int*>(sdl + kT);  // [2][kT]
  const int hi = blockIdx.x, j = p.order[blockIdx.y];
  const int k0 = j * kT, qs0 = p.start[j], ql = p.len[j];
  const int kr = threadIdx.x / 4, qd = threadIdx.x % 4, key = k0 + kr;
  const int ks = p.kmeta[key], kp = p.kmeta[p.tk_pad + key];
  const bool uk = p.kslo[j] == p.kshi[j];
  const int64_t dss = static_cast<int64_t>(p.h) * D;
  const float* lse = p.lse + static_cast<int64_t>(hi) * p.tq_pad;
  const float* dlp = p.delta + static_cast<int64_t>(hi) * p.tq_pad;
  load_rows_f32<D>(sk, p.k, 0, p.kss, p.ksh, 0, hi, k0, p.tk);
  load_rows_f32<D>(sv, p.v, 0, p.vss, p.vsh, 0, hi, k0, p.tk);
  float dk[D / 4] = {}, dv[D / 4] = {};
  for (int s = 0; s < ql; ++s) {
    const int tt = qs0 + s, r0 = tt * kT;
    __syncthreads();
    load_rows_f32<D>(sq, p.q, 0, p.qss, p.qsh, 0, hi, r0, p.tq);
    load_rows_f32<D>(sdo, p.dout, 0, dss, D, 0, hi, r0, p.tq);
    load_meta_f32(sqm, p.qmeta, p.tq_pad, r0);
    if (threadIdx.x < kT) {
      slse[threadIdx.x] = fmaxf(lse[r0 + threadIdx.x], kNegSafe);
      sdl[threadIdx.x] = dlp[r0 + threadIdx.x];
    }
    __syncthreads();
    const bool in = uk && p.qslo[tt] == p.qshi[tt] &&
                    p.qslo[tt] == p.kslo[j] &&
                    (!p.causal || p.kmax[j] <= p.qpos0[tt]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = qd * 8 + e;
      float pr = 0.f, ds = 0.f;
      if (in || visible(p, sqm[c], sqm[kT + c], ks, kp)) {
        const float sc =
            dot_rows<D>(sk + kr * kPitch, sq + c * kPitch) * p.scale;
        const float dp = dot_rows<D>(sv + kr * kPitch, sdo + c * kPitch);
        pr = expf(sc - slse[c]);
        ds = pr * (dp - sdl[c]);
      }
      sp[kr * (kT + 1) + c] = pr;
      sds[kr * (kT + 1) + c] = ds;
    }
    __syncwarp();
#pragma unroll
    for (int e = 0; e < D / 4; ++e) {
      float av = dv[e], ak = dk[e];
      for (int c = 0; c < kT; ++c) {
        av = fmaf(sp[kr * (kT + 1) + c], sdo[c * kPitch + e * 4 + qd], av);
        ak = fmaf(sds[kr * (kT + 1) + c], sq[c * kPitch + e * 4 + qd], ak);
      }
      dv[e] = av;
      dk[e] = ak;
    }
  }
  store_cols_f32<D>(p, p.dk, p.tk, hi, key, dk, p.scale);
  store_cols_f32<D>(p, p.dv, p.tk, hi, key, dv, 1.f);
}

// ---------------------------------------------------------------- host

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <int D>
size_t smem_bytes(int which, bool bf) {
  if (bf) {
    const size_t tile = sizeof(bf16) * TileBf16<D>::kPitch;  // one row
    const size_t meta = 2 * 2 * 64 * sizeof(int);            // 2 stages
    if (which == kFwd) return (64 + 4 * 64) * tile + meta;
    if (which == kDq) return (2 * 64 + 4 * 64) * tile + meta;
    return (2 * 64 + 4 * 32) * tile + 2 * 4 * 32 * sizeof(float);
  }
  const size_t tile = sizeof(float) * kT * TileF32<D>::kPitch;
  const size_t sq = sizeof(float) * kT * (kT + 1);
  const size_t meta = 2 * kT * sizeof(int);
  if (which == kFwd) return 3 * tile + sq + meta;
  if (which == kDq) return 4 * tile + sq + meta;
  return 4 * tile + 2 * sq + 2 * kT * sizeof(float) + meta;
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           const VarlenParams& p) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// a rank-3 map over a [t, h, D] bf16 operand with row and head strides ss,
// sh (elements): boxes of 64 columns x 1 head x `rows` rows
int make_rows_map(CUtensorMap* map, const void* base, int t, int h, int d,
                  int64_t ss, int64_t sh, int rows = 128) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(t)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2};
  const cuuint32_t box[3] = {64, 1, static_cast<cuuint32_t>(rows)};
  return hp::make_map_bf16(map, base, 3, dims, strides, box);
}

template <int D>
int launch_fwd_wgmma(const VarlenParams& p, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  int err = make_rows_map(&qmap, p.q, p.tq, p.h, D, p.qss, p.qsh);
  if (!err) err = make_rows_map(&kmap, p.k, p.tk, p.h, D, p.kss, p.ksh);
  if (!err) err = make_rows_map(&vmap, p.v, p.tk, p.h, D, p.vss, p.vsh);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      varlen_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FwdSmem<D>::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  varlen_fwd_wgmma<D><<<dim3(p.tq_pad / kFwdM, p.h), kFwdThreads,
                        FwdSmem<D>::kBytes, stream>>>(qmap, kmap, vmap, p);
  return static_cast<int>(cudaGetLastError());
}

// B12 or B13 on Hopper: one block per (128-row tile, head), heads slowest;
// q, k, v and dO through maps of 64-row boxes
template <int D>
int launch_bwd_wgmma(int which, const VarlenParams& p, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap, dmap;
  const int64_t dss = static_cast<int64_t>(p.h) * D;
  int err = make_rows_map(&qmap, p.q, p.tq, p.h, D, p.qss, p.qsh, kBwdSub);
  if (!err)
    err = make_rows_map(&kmap, p.k, p.tk, p.h, D, p.kss, p.ksh, kBwdSub);
  if (!err)
    err = make_rows_map(&vmap, p.v, p.tk, p.h, D, p.vss, p.vsh, kBwdSub);
  if (!err)
    err = make_rows_map(&dmap, p.dout, p.tq, p.h, D, dss, D, kBwdSub);
  if (err) return err;
  const auto kernel =
      which == kDq ? &varlen_bwd_dq_wgmma<D> : &varlen_bwd_dkv_wgmma<D>;
  const int bytes = which == kDq ? DqSmem<D>::kBytes : DkvSmem<D>::kBytes;
  const int tiles = (which == kDq ? p.tq_pad : p.tk_pad) / kFwdM;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3(tiles, p.h), kFwdThreads, bytes, stream>>>(qmap, kmap, vmap,
                                                            dmap, p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch(int which, int dtype, const VarlenParams& p,
             cudaStream_t stream) {
  const size_t smem = smem_bytes<D>(which, dtype == ptt::kBF16);
  if (dtype != ptt::kBF16) {  // f32: one block per (head, 32-row tile)
    const dim3 grid(p.h, (which == kDkv ? p.tk_pad : p.tq_pad) / kT);
    if (which == kFwd) return launch(varlen_fwd_f32<D>, grid, smem, stream, p);
    if (which == kDq)
      return launch(varlen_bwd_dq_f32<D>, grid, smem, stream, p);
    return launch(varlen_bwd_dkv_f32<D>, grid, smem, stream, p);
  }
  // bf16: wgmma over the 128 x 128 map up to D 128; mma.sync over 64-row
  // tiles at D 256, where a consumer's 64 x 256 fp32 output (128 registers
  // a thread) beside S and P, or its dK beside dV, would not fit
  // setmaxnreg's 240
  if constexpr (D <= 128) {
    return which == kFwd ? launch_fwd_wgmma<D>(p, stream)
                         : launch_bwd_wgmma<D>(which, p, stream);
  } else {
    if (which == kFwd)
      return launch(varlen_fwd_bf16<D>, dim3(p.h, p.tq_pad / 64), smem,
                    stream, p);
    if (which == kDq)
      return launch(varlen_bwd_dq_bf16<D>, dim3(p.h, p.tq_pad / 64), smem,
                    stream, p);
    // one block per (head, kCols columns, 64 keys)
    return launch(varlen_bwd_dkv_bf16<D>,
                  dim3(p.h * (D / TileBf16<D>::kCols), p.tk_pad / 64), smem,
                  stream, p);
  }
}

int run(int which, int dtype, int d, const VarlenParams& p, void* stream) {
  // the wrapper admits head_dim 64, 96, 128 and 256
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return dispatch<64>(which, dtype, p, s);
  if (d == 96) return dispatch<96>(which, dtype, p, s);
  if (d == 128) return dispatch<128>(which, dtype, p, s);
  if (d == 256) return dispatch<256>(which, dtype, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

VarlenParams make_params(const void* q, const void* k, const void* v,
                         const int* const* map, int tq, int tk, int tq_pad,
                         int tk_pad, int h, int64_t qss, int64_t qsh,
                         int64_t kss, int64_t ksh, int64_t vss, int64_t vsh,
                         int causal, float scale) {
  VarlenParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.qss = qss;
  p.qsh = qsh;
  p.kss = kss;
  p.ksh = ksh;
  p.vss = vss;
  p.vsh = vsh;
  p.order = map[0];
  p.start = map[1];
  p.len = map[2];
  p.qslo = map[3];
  p.qshi = map[4];
  p.qpos0 = map[5];
  p.kslo = map[6];
  p.kshi = map[7];
  p.kmax = map[8];
  p.qmeta = map[9];
  p.kmeta = map[10];
  p.tq = tq;
  p.tk = tk;
  p.tq_pad = tq_pad;
  p.tk_pad = tk_pad;
  p.h = h;
  p.causal = causal;
  p.scale = scale;
  return p;
}

}  // namespace

// `map` in every entry point: 11 device pointers to int32 arrays, in this
// order: order, start, len, qslo, qshi, qpos0, kslo, kshi, kmax, qmeta,
// kmeta (start/len: kstart/klen of the forward map for the forward and dq,
// qstart2/qlen2 of the transposed map for dk/dv).
#define PTT_VARLEN_MAP_ARGS                                                 \
  const int *order, const int *start, const int *len, const int *qslo,      \
      const int *qshi, const int *qpos0, const int *kslo, const int *kshi, \
      const int *kmax, const int *qmeta, const int *kmeta
#define PTT_VARLEN_SHAPE_ARGS                                             \
  int dtype, int tq, int tk, int tq_pad, int tk_pad, int h, int d,        \
      int64_t qss, int64_t qsh, int64_t kss, int64_t ksh, int64_t vss,    \
      int64_t vsh, int causal, float scale, void *stream

extern "C" int ptt_flash_varlen_fwd(const void* q, const void* k,
                                    const void* v, void* out, float* lse,
                                    PTT_VARLEN_MAP_ARGS,
                                    PTT_VARLEN_SHAPE_ARGS) {
  const int* map[] = {order, start, len,  qslo,  qshi, qpos0,
                      kslo,  kshi,  kmax, qmeta, kmeta};
  VarlenParams p = make_params(q, k, v, map, tq, tk, tq_pad, tk_pad, h, qss,
                               qsh, kss, ksh, vss, vsh, causal, scale);
  p.out = out;
  p.lse = lse;
  return run(kFwd, dtype, d, p, stream);
}

extern "C" int ptt_flash_varlen_bwd_dq(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* delta,
                                       void* dq, PTT_VARLEN_MAP_ARGS,
                                       PTT_VARLEN_SHAPE_ARGS) {
  const int* map[] = {order, start, len,  qslo,  qshi, qpos0,
                      kslo,  kshi,  kmax, qmeta, kmeta};
  VarlenParams p = make_params(q, k, v, map, tq, tk, tq_pad, tk_pad, h, qss,
                               qsh, kss, ksh, vss, vsh, causal, scale);
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.out = dq;
  return run(kDq, dtype, d, p, stream);
}

extern "C" int ptt_flash_varlen_bwd_dkv(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const float* lse, const float* delta,
                                        void* dk, void* dv,
                                        PTT_VARLEN_MAP_ARGS,
                                        PTT_VARLEN_SHAPE_ARGS) {
  const int* map[] = {order, start, len,  qslo,  qshi, qpos0,
                      kslo,  kshi,  kmax, qmeta, kmeta};
  VarlenParams p = make_params(q, k, v, map, tq, tk, tq_pad, tk_pad, h, qss,
                               qsh, kss, ksh, vss, vsh, causal, scale);
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.dk = dk;
  p.dv = dv;
  return run(kDkv, dtype, d, p, stream);
}
