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
// keys past tk are zero-filled by predicated cp.async and never stored;
// they lie in the phantom segment, so no real query or key meets them.
//
// bf16 runs on the tensor cores (flash_tiles.cuh: mma.sync m16n8k16 with
// fp32 sums, ldmatrix fragments, a 2-stage cp.async ring): the forward and
// dq blocks own 64 query rows (warp w rows 16w..) over 64-key tiles, the
// dk/dv block 64 keys over 32-row q tiles; P and dS pass from one product
// to the next in registers. f32 runs 32 x 32 tiles on the CUDA cores with
// exact fp32 products. The softmax runs in base 2 with f32 statistics.
//
// Bounds (H100 SXM: 989 TFLOP/s dense bf16, 3.35 TB/s). At the rung (h 16,
// d 128, 8 causal segments of 4096, T 32768) there are 1.074 G visible
// pairs a head-sum: the forward does 550 GFLOP (0.556 ms) against 0.161
// ms of bytes, dq 825 GFLOP and dk/dv 1.10 TFLOP: operations bound all
// three. mma.sync from a cp.async ring reaches a fraction of the wgmma
// rate, and boundary tiles pay a per-pair compare; wgmma with TMA loads is
// later work.
#include "flash_tiles.cuh"

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

// rows g and g + 8 below r0 of a warp's 16 x D accumulator, times `mul`,
// as bf16 rows of a contiguous [n, h, D] array; rows at or past n are not
// stored
template <int D>
__device__ __forceinline__ void store_rows(const VarlenParams& p, void* dst,
                                           int n, int hi, int r0,
                                           const float (&acc)[D / 8][4],
                                           const float (&mul)[2]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + r * 8;
    if (row >= n) continue;
    bf16* out = static_cast<bf16*>(dst) + packed_at<D>(p, row, hi);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
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

// Forward: a block owns 64 query rows of one head and walks its k-tile
// interval with an online softmax over the visible keys.
template <int D>
__global__ void __launch_bounds__(kThreads)
    varlen_fwd_bf16(const VarlenParams p) {
  constexpr int kM = 64, kN = 64, kPitch = TileBf16<D>::kPitch;
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

    float sc[kN / 8][4];
    zero(sc);
    mma_abt<kN, D>(sc, sq + warp * 16 * kPitch, sk + st * kN * kPitch);
    const uint32_t vis =
        interior(p, i, j)
            ? 0xffffffffu
            : visible_bits<kN>(p, qs, qp, skm + st * 2 * kN,
                               skm + st * 2 * kN + kN);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float x = (vis >> (nt * 4 + c)) & 1u ? sc[nt][c] * sl2 : kNeg;
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
    for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // masked pairs are 0, also while the row's max is still kNeg
        const float pr =
            (vis >> (nt * 4 + c)) & 1u ? exp2f(sc[nt][c] - m[c >> 1]) : 0.f;
        sc[nt][c] = pr;
        l[c >> 1] += pr;
      }
    mma_xb<kN, D>(o, sc, sv + st * kN * kPitch);
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

// dq: a block owns 64 query rows of one head and walks the forward map's
// k-tile interval: S = Q K^T, P = exp(S - lse) on visible pairs, dP = dO
// V^T, dS = P (dP - delta), dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kThreads)
    varlen_bwd_dq_bf16(const VarlenParams p) {
  constexpr int kM = 64, kN = 64, kPitch = TileBf16<D>::kPitch;
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

    const bf16* kt = sk + st * kN * kPitch;
    const bf16* vt = sv + st * kN * kPitch;
    float sc[kN / 8][4], dp[kN / 8][4];
    zero(sc);
    zero(dp);
    mma_abt<kN, D>(sc, sq + warp * 16 * kPitch, kt);
    mma_abt<kN, D>(dp, sdo + warp * 16 * kPitch, vt);
    const uint32_t vis =
        interior(p, i, j)
            ? 0xffffffffu
            : visible_bits<kN>(p, qs, qp, skm + st * 2 * kN,
                               skm + st * 2 * kN + kN);
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        const float pr = (vis >> (nt * 4 + c)) & 1u
                             ? exp2f(sc[nt][c] * sl2 - lse2[r])
                             : 0.f;
        sc[nt][c] = pr * (dp[nt][c] - dl[r]);  // dS
      }
    mma_xb<kN, D>(dq, sc, kt);
    __syncthreads();
  }
  cp_async_wait<0>();
  const float mul[2] = {p.scale, p.scale};
  store_rows<D>(p, p.out, p.tq, hi, q0 + warp * 16, dq, mul);
}

// dk/dv: a block owns 64 keys of one head (warp w keys 16w..) and walks
// the transposed map's interval of 32-row q tiles: S^T = K Q^T, P^T on
// visible pairs, dV += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T - delta),
// dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(kThreads)
    varlen_bwd_dkv_bf16(const VarlenParams p) {
  constexpr int kM = 32, kN = 64, kPitch = TileBf16<D>::kPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);  // [kN][kPitch]
  bf16* sv = sk + kN * kPitch;               // [kN][kPitch]
  bf16* sq = sv + kN * kPitch;               // [2][kM][kPitch]
  bf16* sdo = sq + 2 * kM * kPitch;          // [2][kM][kPitch]
  // per stage: lse, delta (f32), segment, position (int32) of the q rows
  float* sst = reinterpret_cast<float*>(sdo + 2 * kM * kPitch);  // [2][4][kM]
  const int hi = blockIdx.x, j = p.order[blockIdx.y];
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

  float dk[D / 8][4], dv[D / 8][4];
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
    mma_xb<kM, D>(dv, sc, dot);
    float dp[kM / 8][4];
    zero(dp);
    mma_abt<kM, D>(dp, sv + warp * 16 * kPitch, dot);  // dP^T
#pragma unroll
    for (int nt = 0; nt < kM / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sc[nt][c] *= dp[nt][c] - dt[nt * 8 + 2 * t + (c & 1)];  // dS^T
    mma_xb<kM, D>(dk, sc, qt);
    __syncthreads();
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f}, mul[2] = {p.scale, p.scale};
  store_rows<D>(p, p.dk, p.tk, hi, k0 + warp * 16, dk, mul);
  store_rows<D>(p, p.dv, p.tk, hi, k0 + warp * 16, dv, one);
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
#pragma unroll
    for (int e = 0; e < D / 4; ++e) {
      float acc = dq[e];
      for (int c = 0; c < kT; ++c)
        acc = fmaf(sds[r * (kT + 1) + c], sk[c * kPitch + e * 4 + qd], acc);
      dq[e] = acc;
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

template <int D>
int dispatch(int which, int dtype, const VarlenParams& p,
             cudaStream_t stream) {
  const bool bf = dtype == ptt::kBF16;
  const size_t smem = smem_bytes<D>(which, bf);
  // one block per (head, tile): 64-row tiles in bf16 (the dk/dv walk owns
  // 64 keys), 32 in f32
  const int tile = bf ? 64 : kT;
  if (which == kFwd) {
    const dim3 grid(p.h, p.tq_pad / tile);
    return bf ? launch(varlen_fwd_bf16<D>, grid, smem, stream, p)
              : launch(varlen_fwd_f32<D>, grid, smem, stream, p);
  }
  if (which == kDq) {
    const dim3 grid(p.h, p.tq_pad / tile);
    return bf ? launch(varlen_bwd_dq_bf16<D>, grid, smem, stream, p)
              : launch(varlen_bwd_dq_f32<D>, grid, smem, stream, p);
  }
  const dim3 grid(p.h, p.tk_pad / tile);
  return bf ? launch(varlen_bwd_dkv_bf16<D>, grid, smem, stream, p)
            : launch(varlen_bwd_dkv_f32<D>, grid, smem, stream, p);
}

int run(int which, int dtype, int d, const VarlenParams& p, void* stream) {
  // the wrapper admits head_dim 64, 96 and 128
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return dispatch<64>(which, dtype, p, s);
  if (d == 96) return dispatch<96>(which, dtype, p, s);
  if (d == 128) return dispatch<128>(which, dtype, p, s);
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
