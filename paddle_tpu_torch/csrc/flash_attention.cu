// Dense flash attention, forward and backward: three entry points.
//
// Replace the TPU kernel _pallas_flash (paddle_tpu/nn/functional/
// attention.py:132) and the custom_vjp shell _flash_core (:99-129) around
// the stock Pallas TPU flash attention (experimental/pallas/ops/tpu/
// flash_attention.py of the JAX release), whose three pallas_calls are
// the forward _flash_attention_impl, dk/dv _flash_attention_bwd_dkv and
// dq _flash_attention_bwd_dq. Python wrapper:
// paddle_tpu_torch/nn/functional/attention.py.
//
// What they compute, for q [b, sq, h, d], k and v [b, sk, h, d] read in
// place through their batch, sequence and head strides (the last axis
// contiguous), softmax scale `scale`, optionally causal (key j visible
// from query i iff j <= i, counted from the top left as the TPU kernel
// and the XLA path do):
//   ptt_flash_fwd     out = softmax(q k^T * scale) v   [b, sq, h, d]
//                     lse = log sum_j exp(s_ij)        [b, h, sq] f32
//   ptt_flash_bwd_dq  dq = scale * dS k                [b, sq, h, d]
//   ptt_flash_bwd_dkv dk = scale * dS^T q, dv = P^T dO [b, sk, h, d]
// with P = exp(s - lse) recomputed from the f32 lse, dP = dO v^T, and
// dS = P * (dP - di), where di = sum_d out * dO [b, h, sq] f32 comes from
// the wrapper (a PyTorch reduction, as it is an XLA op beside the TPU
// kernels). dO, out and the gradients are contiguous [b, s, h, d]. The
// mma.sync and f32 kernels give masked scores the stock kernel's finite
// -0.7 * FLT_MAX, the wgmma kernels -inf (as B11-B13): under the top-left
// causal mask every query row sees key 0, so both give the same result;
// tiles wholly above the diagonal are skipped.
//
// Design. The TPU kernels carry the running max, sum and output of a q
// block in VMEM scratch across a sequential grid axis of k blocks. Here
// the loop over k tiles (or q tiles) is inside the block, and every output
// tile has one owner: forward and dq blocks own query rows and walk the k
// tiles up to the diagonal; dk/dv blocks own keys and walk the q tiles
// from the diagonal down. No atomics: every result is the same from run
// to run.
//
// bf16 at head_dim 64, 96 and 128 runs on Hopper's tensor cores through
// the mainloops of the packed varlen kernels (flash_wgmma.cuh, shared with
// B11-B13): flash_fwd_wgmma, flash_bwd_dq_wgmma and flash_bwd_dkv_wgmma
// are 384-thread blocks, a producer warpgroup keeping TMA rings of
// 128-byte-swizzled boxes full and two consumer warpgroups issuing wgmma
// (P and dS from registers), the mask a -inf pass on boundary tiles only.
// They take DenseWalk below, which works out from (block, b, sq, sk,
// causal) what the varlen kernels read from a block map, and read q, k,
// v and dO in place through rank-4 tensor maps over (d, h, s, b). A
// block takes a few 128-row tiles (query rows for the forward and dq,
// keys for dk/dv) one after the other, paired so that every block has
// the same work, at most one block an SM; dq and dk/dv walk 64-row steps;
// the forward stores out by TMA from shared memory. No block map is
// built: host work a launch is the tensor-map encodes and the launch.
//
// At head_dim 256 bf16 runs mma.sync m16n8k16 with fp32 sums, 4 warps of
// 16 rows (or 16 keys in dk/dv), operand fragments by ldmatrix (plain for
// an operand stored k-contiguous, .trans for one stored n-contiguous) from
// tiles that a 2-stage cp.async ring brings into shared memory, rows
// padded by 16 bytes so the 8 rows of an ldmatrix hit distinct banks. A
// product's fp32 accumulator has the register layout of the next
// product's A fragment, so P (and dS) go from one mma to the next in
// registers, packed to bf16 as the TPU kernel casts p to v's type before
// its dot. The softmax runs in base 2 (scores pre-scaled by scale * log2
// e) with f32 statistics. A warp's 16 x 256 fp32 accumulator is 128
// registers a thread: the forward and dq compute each 64-key tile in two
// 32-key sub-tiles (a sub-tile wholly above a warp's rows is skipped,
// exactly: it would add 0), and a dk/dv block owns one half of the head's
// columns for its 64 keys (the grid doubles; each half recomputes S^T and
// dP^T, 1.5x the products). float32 runs the same walk on the CUDA cores
// (32 x 32 tiles, 4 threads a row, exact fp32 products) at 64, 96, 128
// and 256; the tile machinery is flash_tiles.cuh.
//
// Bounds (H100 SXM: 989 TFLOP/s dense bf16, 3.35 TB/s). At the gpt3-1.3b
// rung (b 4, s 1024, h 16, d 128, causal) the forward does 17.2 GFLOP
// (17.4 us) and moves 67.4 MB (20.1 us): bytes bound it, by a little; the
// backward does 42.9 GFLOP (43.4 us) against 134.7 MB (40.2 us), so
// operations do. At s 1024 a causal q tile walks 1-8 key tiles, so each
// tile's start (the q or k/v loads, the ring's fill) and store weigh more
// than in the varlen kernels' long walks: a block's tiles run back to back
// so that the next tile's loads and the last one's store overlap the
// products.
#include <climits>

#include "flash_wgmma.cuh"

namespace {

using namespace ptt::tiles;
using namespace ptt::flash;
using ptt::cp_async16;
using ptt::cp_async_commit;
using ptt::cp_async_wait;
using ptt::tiles::load_rows;

// the stock TPU kernel's DEFAULT_MASK_VALUE: finite, so exp underflows to
// 0 and a max over masked scores stays a number
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

struct Strides {
  int64_t b, s, h;
};

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;  // backward: dO, contiguous [b, sq, h, d]
  float* lse;        // [b, h, sq]: written by the forward, read after
  const float* delta;  // backward: di [b, h, sq]
  void* out;         // forward: out; backward: dq (contiguous)
  void* dk;          // backward (contiguous)
  void* dv;
  Strides qs, ks, vs;
  int b, sq, sk, h, causal;
  int fold;  // fold units a block of the wgmma grid takes (the dispatch's)
  float scale;
};

// offset of row s of head h in batch b of a contiguous [b, s, h, D] array
template <int D>
__device__ __forceinline__ int64_t dense_at(const FlashParams& p, int s_len,
                                            int bi, int s, int hi) {
  return ((static_cast<int64_t>(bi) * s_len + s) * p.h + hi) * D;
}

// ---------------------------------------------- bf16 at D 256: mma.sync

template <int R, int D>
__device__ __forceinline__ void load_rows(bf16* dst, const void* base,
                                          const Strides& st, int bi, int hi,
                                          int r0) {
  load_rows<R, D>(dst, base, st.b, st.s, st.h, bi, hi, r0);
}

// R f32 values of one (batch, head) row of a [b, h, s] plane
template <int R>
__device__ __forceinline__ void load_stats(float* dst, const float* plane,
                                           const FlashParams& p, int bi,
                                           int hi, int r0) {
  load_words(dst, plane + (static_cast<int64_t>(bi) * p.h + hi) * p.sq + r0,
             R);
}

// rows g and g + 8 of a warp's 16 x DO accumulator, times `mul`, as bf16
// columns col0.. of rows of a contiguous [b, s, h, D] array from row r0
template <int D, int DO = D>
__device__ __forceinline__ void store_rows(const FlashParams& p, void* dst,
                                           int s_len, int bi, int hi, int r0,
                                           const float (&acc)[DO / 8][4],
                                           const float (&mul)[2],
                                           int col0 = 0) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  bf16* out = static_cast<bf16*>(dst);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* row = out + dense_at<D>(p, s_len, bi, r0 + g + r * 8, hi) + col0;
#pragma unroll
    for (int nt = 0; nt < DO / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(row + nt * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[nt][2 * r] * mul[r],
                                acc[nt][2 * r + 1] * mul[r]);
  }
}

// Forward: a block owns 64 query rows (warp w rows 16w..) and walks the
// 64-key tiles up to the diagonal with an online softmax.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16(const FlashParams p) {
  constexpr int kM = 64, kN = 64, kPitch = TileBf16<D>::kPitch;
  constexpr int kS = TileBf16<D>::kSub;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);  // [kM][kPitch]
  bf16* sk = sq + kM * kPitch;               // [2][kN][kPitch]
  bf16* sv = sk + 2 * kN * kPitch;           // [2][kN][kPitch]
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kM;  // longest walks first
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kend = p.causal ? min(p.sk, q0 + kM) : p.sk;
  const int nkt = (kend + kN - 1) / kN;
  const float sl2 = p.scale * kLog2e;

  load_rows<kM, D>(sq, p.q, p.qs, bi, hi, q0);
  load_rows<kN, D>(sk, p.k, p.ks, bi, hi, 0);
  load_rows<kN, D>(sv, p.v, p.vs, bi, hi, 0);
  cp_async_commit();

  float o[D / 8][4];
  zero(o);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int j = 0; j < nkt; ++j) {
    const int st = j & 1;
    if (j + 1 < nkt) {
      load_rows<kN, D>(sk + (st ^ 1) * kN * kPitch, p.k, p.ks, bi, hi,
                       (j + 1) * kN);
      load_rows<kN, D>(sv + (st ^ 1) * kN * kPitch, p.v, p.vs, bi, hi,
                       (j + 1) * kN);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

#pragma unroll 1
    for (int sub = 0; sub < kN / kS; ++sub) {
      const int k0 = j * kN + sub * kS, row0 = q0 + warp * 16 + g;
      if (p.causal && k0 > q0 + warp * 16 + 15) continue;  // all masked
      float s[kS / 8][4];
      zero(s);
      mma_abt<kS, D>(s, sq + warp * 16 * kPitch,
                     sk + (st * kN + sub * kS) * kPitch);
      const bool diag = p.causal && k0 + kS - 1 > q0 + warp * 16;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < kS / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = s[nt][c] * sl2;
          if (diag && k0 + nt * 8 + 2 * t + (c & 1) > row0 + (c >> 1) * 8)
            x = kMaskValue;
          s[nt][c] = x;
          mx[c >> 1] = fmaxf(mx[c >> 1], x);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        const float alpha = exp2f(m[r] - mx[r]);  // 0 on the first tile
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
          s[nt][c] = exp2f(s[nt][c] - m[c >> 1]);
          l[c >> 1] += s[nt][c];
        }
      mma_xb<kS, D>(o, s, sv + (st * kN + sub * kS) * kPitch);
    }
    __syncthreads();  // the stage is refilled by the next iteration
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = 1.f / l[r];
  }
  store_rows<D>(p, p.out, p.sq, bi, hi, q0 + warp * 16, o, inv);
  if (t == 0) {
    float* lse = p.lse + (static_cast<int64_t>(bi) * p.h + hi) * p.sq;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lse[q0 + warp * 16 + g + r * 8] = (m[r] + log2f(l[r])) * kLn2;
  }
}

// dq: a block owns 64 query rows and walks the 64-key tiles up to the
// diagonal: S = Q K^T, P = exp(S - lse), dP = dO V^T, dS = P (dP - di),
// dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_bf16(const FlashParams p) {
  constexpr int kM = 64, kN = 64, kPitch = TileBf16<D>::kPitch;
  constexpr int kS = TileBf16<D>::kSub;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);  // [kM][kPitch]
  bf16* sdo = sq + kM * kPitch;              // [kM][kPitch]
  bf16* sk = sdo + kM * kPitch;              // [2][kN][kPitch]
  bf16* sv = sk + 2 * kN * kPitch;           // [2][kN][kPitch]
  float* slse = reinterpret_cast<float*>(sv + 2 * kN * kPitch);  // [kM]
  float* sdi = slse + kM;                                         // [kM]
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kM;
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kend = p.causal ? min(p.sk, q0 + kM) : p.sk;
  const int nkt = (kend + kN - 1) / kN;
  const float sl2 = p.scale * kLog2e;

  load_rows<kM, D>(sq, p.q, p.qs, bi, hi, q0);
  load_rows<kM, D>(sdo, p.dout, static_cast<int64_t>(p.sq) * p.h * D,
                   static_cast<int64_t>(p.h) * D, D, bi, hi, q0);
  load_stats<kM>(slse, p.lse, p, bi, hi, q0);
  load_stats<kM>(sdi, p.delta, p, bi, hi, q0);
  load_rows<kN, D>(sk, p.k, p.ks, bi, hi, 0);
  load_rows<kN, D>(sv, p.v, p.vs, bi, hi, 0);
  cp_async_commit();

  float dq[D / 8][4];
  zero(dq);
  float lse2[2], di[2];
  for (int j = 0; j < nkt; ++j) {
    const int st = j & 1;
    if (j + 1 < nkt) {
      load_rows<kN, D>(sk + (st ^ 1) * kN * kPitch, p.k, p.ks, bi, hi,
                       (j + 1) * kN);
      load_rows<kN, D>(sv + (st ^ 1) * kN * kPitch, p.v, p.vs, bi, hi,
                       (j + 1) * kN);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse2[r] = slse[warp * 16 + g + r * 8] * kLog2e;
        di[r] = sdi[warp * 16 + g + r * 8];
      }
    }
#pragma unroll 1
    for (int sub = 0; sub < kN / kS; ++sub) {
      const int k0 = j * kN + sub * kS, row0 = q0 + warp * 16 + g;
      if (p.causal && k0 > q0 + warp * 16 + 15) continue;  // dS is 0
      const bf16* kt = sk + (st * kN + sub * kS) * kPitch;
      const bf16* vt = sv + (st * kN + sub * kS) * kPitch;
      float s[kS / 8][4], dp[kS / 8][4];
      zero(s);
      zero(dp);
      mma_abt<kS, D>(s, sq + warp * 16 * kPitch, kt);
      mma_abt<kS, D>(dp, sdo + warp * 16 * kPitch, vt);
      const bool diag = p.causal && k0 + kS - 1 > q0 + warp * 16;
#pragma unroll
      for (int nt = 0; nt < kS / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = c >> 1;
          float pr = exp2f(s[nt][c] * sl2 - lse2[r]);
          if (diag && k0 + nt * 8 + 2 * t + (c & 1) > row0 + r * 8) pr = 0.f;
          s[nt][c] = pr * (dp[nt][c] - di[r]);  // dS
        }
      mma_xb<kS, D>(dq, s, kt);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  const float mul[2] = {p.scale, p.scale};
  store_rows<D>(p, p.out, p.sq, bi, hi, q0 + warp * 16, dq, mul);
}

// dk/dv: a block owns 64 keys (warp w keys 16w..) and kC of their D
// columns, and walks the 32-row q tiles from the diagonal on: S^T = K Q^T,
// P^T = exp(S^T - lse), dV += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T -
// di), dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_bf16(const FlashParams p) {
  constexpr int kM = 32, kN = 64, kPitch = TileBf16<D>::kPitch;
  constexpr int kC = TileBf16<D>::kCols, kHalves = D / kC;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);  // [kN][kPitch]
  bf16* sv = sk + kN * kPitch;               // [kN][kPitch]
  bf16* sq = sv + kN * kPitch;               // [2][kM][kPitch]
  bf16* sdo = sq + 2 * kM * kPitch;          // [2][kM][kPitch]
  float* slse = reinterpret_cast<float*>(sdo + 2 * kM * kPitch);  // [2][kM]
  float* sdi = slse + 2 * kM;                                      // [2][kM]
  // low key tiles have the longest walks
  const int k0 = blockIdx.x / kHalves * kN, col0 = blockIdx.x % kHalves * kC;
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int qbeg = p.causal ? k0 : 0;
  const int nqt = qbeg < p.sq ? (p.sq - qbeg) / kM : 0;
  const float sl2 = p.scale * kLog2e;
  const int64_t dss = static_cast<int64_t>(p.h) * D;
  const int64_t dsb = static_cast<int64_t>(p.sq) * dss;

  load_rows<kN, D>(sk, p.k, p.ks, bi, hi, k0);
  load_rows<kN, D>(sv, p.v, p.vs, bi, hi, k0);
  if (nqt > 0) {
    load_rows<kM, D>(sq, p.q, p.qs, bi, hi, qbeg);
    load_rows<kM, D>(sdo, p.dout, dsb, dss, D, bi, hi, qbeg);
    load_stats<kM>(slse, p.lse, p, bi, hi, qbeg);
    load_stats<kM>(sdi, p.delta, p, bi, hi, qbeg);
  }
  cp_async_commit();

  float dk[kC / 8][4], dv[kC / 8][4];
  zero(dk);
  zero(dv);
  const int key0 = k0 + warp * 16 + g;  // keys key0 and key0 + 8
  for (int i = 0; i < nqt; ++i) {
    const int st = i & 1, r0 = qbeg + i * kM;
    if (i + 1 < nqt) {
      const int nst = st ^ 1;
      load_rows<kM, D>(sq + nst * kM * kPitch, p.q, p.qs, bi, hi, r0 + kM);
      load_rows<kM, D>(sdo + nst * kM * kPitch, p.dout, dsb, dss, D, bi, hi,
                       r0 + kM);
      load_stats<kM>(slse + nst * kM, p.lse, p, bi, hi, r0 + kM);
      load_stats<kM>(sdi + nst * kM, p.delta, p, bi, hi, r0 + kM);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const bf16* qt = sq + st * kM * kPitch;
    const bf16* dot = sdo + st * kM * kPitch;
    const float* lt = slse + st * kM;
    const float* dt = sdi + st * kM;
    float s[kM / 8][4];
    zero(s);
    mma_abt<kM, D>(s, sk + warp * 16 * kPitch, qt);  // S^T
    const bool diag = p.causal && r0 < k0 + warp * 16 + 15;
#pragma unroll
    for (int nt = 0; nt < kM / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rr = nt * 8 + 2 * t + (c & 1);
        float pr = exp2f(s[nt][c] * sl2 - lt[rr] * kLog2e);
        if (diag && r0 + rr < key0 + (c >> 1) * 8) pr = 0.f;
        s[nt][c] = pr;  // P^T
      }
    mma_xb<kM, kC, kPitch>(dv, s, dot + col0);
    float dp[kM / 8][4];
    zero(dp);
    mma_abt<kM, D>(dp, sv + warp * 16 * kPitch, dot);  // dP^T
#pragma unroll
    for (int nt = 0; nt < kM / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[nt][c] *= dp[nt][c] - dt[nt * 8 + 2 * t + (c & 1)];  // dS^T
    mma_xb<kM, kC, kPitch>(dk, s, qt + col0);
    __syncthreads();
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f}, mul[2] = {p.scale, p.scale};
  store_rows<D, kC>(p, p.dk, p.sk, bi, hi, k0 + warp * 16, dk, mul, col0);
  store_rows<D, kC>(p, p.dv, p.sk, bi, hi, k0 + warp * 16, dv, one, col0);
}

// ------------------------------------------- bf16 on Hopper: wgmma + TMA

// The dense walk of the Hopper kernels (flash_wgmma.cuh): what the varlen
// kernels read from a block map, worked out from the block index and (b,
// sq, sk, causal). Tiles of 128 rows (q rows for the forward and dq, keys
// for dk/dv) pair into fold units, tiles nt - 1 - f and f of one (batch,
// head), whose causal walks add up to the same length in every unit. A
// forward or dq block takes the tiles of `fold` units one after the other,
// so the dispatch gives each of at most one block an SM the same work and
// a block's tiles overlap their loads and epilogues with their neighbours'
// products; a dk/dv block takes one tile, the longest causal walks first. Units are ordered by head,
// then by f, then by batch. Under causal (top left) q
// tile i visits key tiles 0 .. min(i, nk - 1) and k tile j the q rows from
// 128 j on; without it every tile. dq and dk/dv walk in 64-row steps that
// stop at sk or sq (lengths are multiples of 64), so no step lies past its
// operand; the forward's last k tile may be half past sk, and its keys
// past sk are masked (TMA reads them as zeros, whose score 0 would count).
// A tile pair is interior when it lies wholly below the diagonal and, in
// the forward, its keys wholly before sk. Rows of a block past sq (or keys
// past sk) read zeros, have no lse or delta and are never stored. Rank-4
// maps over (d, h, s, b) with the operands' own strides: rows past s read
// as zeros, never as the next batch's rows; the forward stores out by TMA
// (rows past sq not written); lse and delta are [b, h, sq].
template <int K>
struct DenseWalk {
  using Params = FlashParams;
  static constexpr int kKeyMeta = 0;  // the mask needs no key metadata
  static constexpr int kQStats = 8;   // a row's lse and delta
  static constexpr bool kTmaStore = true;
  // dq's producer walking several tiles needs more than 24 registers; its
  // consumers fit 232 (the forward's 240 serve it better, and its producer
  // fits 24). dk/dv's consumers need 240 beside their accumulators, so its
  // producer keeps 24 and a block takes one tile: blocks (h, tile, b), the
  // lowest k tiles, the longest causal walks, first.
  static constexpr bool kMultiTile = K != kDkv;
  static constexpr int kProducerRegs = K == kDq ? 32 : 24;
  const FlashParams& p;
  // The current tile: slot pos % 2 of fold unit pos / 2, unit (h, f, b)
  // in that order (several tiles a block), its head hi and batch bi. The
  // producer reads hi and bi; the consumers of several tiles work them out
  // from pos in the epilogue, so they do not hold them through the walk.
  int pos = 0, hi = 0, bi = 0, r0 = 0, n = 0;

  __device__ __forceinline__ explicit DenseWalk(const FlashParams& params)
      : p(params) {
    if (kMultiTile) {
      pos = 2 * static_cast<int>(blockIdx.x) * p.fold - 1;
      next();
    } else {
      const int nt = tiles(), t = blockIdx.x / p.b % nt;
      hi = blockIdx.x / (p.b * nt);
      bi = blockIdx.x % p.b;
      set_tile(t);
    }
  }
  // 128-row tiles of the owned axis, and fold units a (batch, head)
  __device__ __forceinline__ int tiles() const {
    return ((K == kDkv ? p.sk : p.sq) + kFwdM - 1) / kFwdM;
  }
  __device__ __forceinline__ int folds() const { return (tiles() + 1) / 2; }
  __device__ __forceinline__ int fold_of(int at) const {
    return at / 2 / p.b % folds();
  }
  __device__ __forceinline__ int head() const {
    return kMultiTile ? pos / 2 / (p.b * folds()) : hi;
  }
  __device__ __forceinline__ int batch() const {
    return kMultiTile ? pos / 2 % p.b : bi;
  }
  // tile t's first row and steps
  __device__ __forceinline__ void set_tile(int t) {
    r0 = t * kFwdM;
    if (K == kDkv) {
      n = max(p.sq / kBwdSub - q_first(), 0);
    } else {
      const int seen = p.causal ? min(r0 + kFwdM, p.sk) : p.sk;  // keys
      const int step = K == kFwd ? kFwdN : kBwdSub;
      n = (seen + step - 1) / step;
    }
  }
  // the block's next tile: of fold unit f, tile nt - 1 - f, then f (the
  // middle unit of an odd nt has one tile)
  __device__ __forceinline__ bool next() {
    const int nt = tiles();
    ++pos;
    if (pos % 2 && 2 * fold_of(pos) == nt - 1) ++pos;
    if (pos / 2 >= min((static_cast<int>(blockIdx.x) + 1) * p.fold,
                       folds() * p.b * p.h))
      return false;
    const int f = fold_of(pos);
    hi = head();
    bi = batch();
    set_tile(pos % 2 ? f : nt - 1 - f);
    return true;
  }
  // dk/dv: the first q sub-tile that sees a key of the tile
  __device__ __forceinline__ int q_first() const {
    return p.causal ? r0 / kBwdSub : 0;
  }
  __device__ __forceinline__ int first(int s) const {
    return K == kFwd ? s * kFwdN
                     : ((K == kDkv ? q_first() : 0) + s) * kBwdSub;
  }
  // no pair of step s is masked: the forward's key tile s lies below the
  // diagonal and before sk; dq's 64 keys lie below the diagonal; dk/dv's
  // q sub-tiles from the third on lie below its keys
  __device__ __forceinline__ bool interior(int s) const {
    if (K == kFwd)
      return (!p.causal || s < r0 / kFwdN) && (s + 1) * kFwdN <= p.sk;
    if (K == kDq) return !p.causal || s < r0 / kBwdSub;
    return !p.causal || s >= 2;
  }
  __device__ __forceinline__ void tma(void* dst, const CUtensorMap* map,
                                      uint64_t* bar, int col, int row) const {
    hp::tma_load_4d(dst, map, bar, col, hi, row, bi);
  }
  __device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                            const void* src, int col,
                                            int row) const {
    hp::tma_store_4d(map, src, col, head(), row, batch());
  }
  __device__ __forceinline__ void load_keys(int*, int, int, uint64_t*) const {
  }
  __device__ __forceinline__ void load_qstats(float* dst, int row,
                                              uint64_t* bar) const {
    const int64_t at = (static_cast<int64_t>(bi) * p.h + hi) * p.sq + row;
    hp::bulk_load(dst, p.lse + at, kBwdSub * 4, bar);
    hp::bulk_load(dst + kBwdSub, p.delta + at, kBwdSub * 4, bar);
  }
  // key kappa is visible from query iota iff kappa < sk and, under causal,
  // kappa <= iota. The forward's and dq's rows are queries and their
  // columns keys: a row sees the columns up to a bound; dk/dv's rows are
  // keys and their columns queries: a row sees the columns from a bound
  // (INT_MAX for a key past sk). Rows holds the first of a thread's two
  // rows; the bounds are worked out in the mask pass, on boundary tiles.
  struct Rows {
    int row;
  };
  __device__ __forceinline__ Rows rows(int row) const { return Rows{row}; }
  __device__ __forceinline__ int bound(int x) const {
    if (K == kDkv) return x >= p.sk ? INT_MAX : p.causal ? x : 0;
    return p.causal ? min(x, p.sk - 1) : p.sk - 1;
  }
  template <int N>
  __device__ __forceinline__ void mask(float (&sc)[N / 2], const Rows& r,
                                       const int*, int col0) const {
    const int c0 = col0 + 2 * (threadIdx.x % 4);
    // the bounds from column c0 of the thread's rows r.row and r.row + 8
    const int b0 = bound(r.row) - c0, b1 = bound(r.row + 8) - c0;
#pragma unroll
    for (int jj = 0; jj < N / 8; ++jj)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int x = 8 * jj + (cc & 1), b = cc >> 1 ? b1 : b0;
        if (K == kDkv ? x < b : x > b) sc[4 * jj + cc] = -INFINITY;
      }
  }
  __device__ __forceinline__ int rows_out() const {
    return K == kDkv ? p.sk : p.sq;
  }
  template <int D>
  __device__ __forceinline__ int64_t out_at(int row) const {
    return dense_at<D>(p, rows_out(), batch(), row, head());
  }
  // lse and delta are [b, h, sq]: rows past sq have none
  __device__ __forceinline__ int64_t stat_at(int row) const {
    return (static_cast<int64_t>(batch()) * p.h + head()) * p.sq + row;
  }
  __device__ __forceinline__ float stat(const float* plane, int row) const {
    return row < p.sq ? plane[stat_at(row)] : 0.f;
  }
  __device__ __forceinline__ void store_lse(int row, float v) const {
    if (row < p.sq) p.lse[stat_at(row)] = v;
  }
};

// the forward (flash_wgmma.cuh fwd_wgmma): a block per (128-row q tile,
// batch, head)
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap omap,
                    const __grid_constant__ FlashParams p) {
  fwd_wgmma<D, DenseWalk<kFwd>>(&qmap, &kmap, &vmap, &omap, p);
}

// dq (bwd_dq_wgmma): a block per (128-row q tile, batch, head)
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       const __grid_constant__ CUtensorMap dmap,
                       const __grid_constant__ FlashParams p) {
  bwd_dq_wgmma<D, DenseWalk<kDq>>(&qmap, &kmap, &vmap, &dmap, p);
}

// dk/dv (bwd_dkv_wgmma): a block per (128 keys, batch, head)
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap dmap,
                        const __grid_constant__ FlashParams p) {
  bwd_dkv_wgmma<D, DenseWalk<kDkv>>(&qmap, &kmap, &vmap, &dmap, p);
}

// ---------------------------------------------------------------- f32

template <int D>
__device__ __forceinline__ void store_cols_f32(const FlashParams& p,
                                               void* dst, int s_len, int bi,
                                               int hi, int row,
                                               const float (&acc)[D / 4],
                                               float mul) {
  float* out = static_cast<float*>(dst) + dense_at<D>(p, s_len, bi, row, hi);
  const int qd = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) out[i * 4 + qd] = acc[i] * mul;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const FlashParams p) {
  constexpr int kPitch = TileF32<D>::kPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);  // [kT][kPitch]
  float* sk = sq + kT * kPitch;
  float* sv = sk + kT * kPitch;
  float* sp = sv + kT * kPitch;  // [kT][kT + 1]
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kT;
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int r = threadIdx.x / 4, qd = threadIdx.x % 4, row = q0 + r;
  const int kend = p.causal ? min(p.sk, q0 + kT) : p.sk;
  load_rows_f32<D>(sq, p.q, p.qs.b, p.qs.s, p.qs.h, bi, hi, q0);
  float o[D / 4] = {};
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < kend; k0 += kT) {
    __syncthreads();
    load_rows_f32<D>(sk, p.k, p.ks.b, p.ks.s, p.ks.h, bi, hi, k0);
    load_rows_f32<D>(sv, p.v, p.vs.b, p.vs.s, p.vs.h, bi, hi, k0);
    __syncthreads();
    float s[8], mx = m;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = qd * 8 + i;
      s[i] = dot_rows<D>(sq + r * kPitch, sk + c * kPitch) * p.scale;
      if (p.causal && k0 + c > row) s[i] = kMaskValue;
      mx = fmaxf(mx, s[i]);
    }
    mx = quad_max(mx);
    const float alpha = expf(m - mx);
    m = mx;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float e = expf(s[i] - m);
      l += e;
      sp[r * (kT + 1) + qd * 8 + i] = e;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      float acc = o[i] * alpha;
      for (int c = 0; c < kT; ++c)
        acc = fmaf(sp[r * (kT + 1) + c], sv[c * kPitch + i * 4 + qd], acc);
      o[i] = acc;
    }
  }
  l = quad_sum(l);
  store_cols_f32<D>(p, p.out, p.sq, bi, hi, row, o, 1.f / l);
  if (qd == 0)
    p.lse[(static_cast<int64_t>(bi) * p.h + hi) * p.sq + row] = m + logf(l);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32(const FlashParams p) {
  constexpr int kPitch = TileF32<D>::kPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* sdo = sq + kT * kPitch;
  float* sk = sdo + kT * kPitch;
  float* sv = sk + kT * kPitch;
  float* sds = sv + kT * kPitch;  // [kT][kT + 1]
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kT;
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int r = threadIdx.x / 4, qd = threadIdx.x % 4, row = q0 + r;
  const int kend = p.causal ? min(p.sk, q0 + kT) : p.sk;
  const int64_t plane = (static_cast<int64_t>(bi) * p.h + hi) * p.sq + row;
  const float lse = p.lse[plane], di = p.delta[plane];
  load_rows_f32<D>(sq, p.q, p.qs.b, p.qs.s, p.qs.h, bi, hi, q0);
  load_rows_f32<D>(sdo, p.dout, static_cast<int64_t>(p.sq) * p.h * D,
                   static_cast<int64_t>(p.h) * D, D, bi, hi, q0);
  float dq[D / 4] = {};
  for (int k0 = 0; k0 < kend; k0 += kT) {
    __syncthreads();
    load_rows_f32<D>(sk, p.k, p.ks.b, p.ks.s, p.ks.h, bi, hi, k0);
    load_rows_f32<D>(sv, p.v, p.vs.b, p.vs.s, p.vs.h, bi, hi, k0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = qd * 8 + i;
      const float s = dot_rows<D>(sq + r * kPitch, sk + c * kPitch) * p.scale;
      const float pr = p.causal && k0 + c > row ? 0.f : expf(s - lse);
      const float dp = dot_rows<D>(sdo + r * kPitch, sv + c * kPitch);
      sds[r * (kT + 1) + c] = pr * (dp - di);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      float acc = dq[i];
      for (int c = 0; c < kT; ++c)
        acc = fmaf(sds[r * (kT + 1) + c], sk[c * kPitch + i * 4 + qd], acc);
      dq[i] = acc;
    }
  }
  store_cols_f32<D>(p, p.out, p.sq, bi, hi, row, dq, p.scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_f32(const FlashParams p) {
  constexpr int kPitch = TileF32<D>::kPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sk = reinterpret_cast<float*>(smem);
  float* sv = sk + kT * kPitch;
  float* sq = sv + kT * kPitch;
  float* sdo = sq + kT * kPitch;
  float* sp = sdo + kT * kPitch;    // [kT][kT + 1]: P^T
  float* sds = sp + kT * (kT + 1);  // [kT][kT + 1]: dS^T
  float* slse = sds + kT * (kT + 1);
  float* sdi = slse + kT;
  const int k0 = blockIdx.x * kT;
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int kr = threadIdx.x / 4, qd = threadIdx.x % 4, key = k0 + kr;
  const int64_t dss = static_cast<int64_t>(p.h) * D;
  const int64_t dsb = static_cast<int64_t>(p.sq) * dss;
  const float* lse = p.lse + (static_cast<int64_t>(bi) * p.h + hi) * p.sq;
  const float* dip = p.delta + (static_cast<int64_t>(bi) * p.h + hi) * p.sq;
  load_rows_f32<D>(sk, p.k, p.ks.b, p.ks.s, p.ks.h, bi, hi, k0);
  load_rows_f32<D>(sv, p.v, p.vs.b, p.vs.s, p.vs.h, bi, hi, k0);
  float dk[D / 4] = {}, dv[D / 4] = {};
  for (int r0 = p.causal ? k0 : 0; r0 < p.sq; r0 += kT) {
    __syncthreads();
    load_rows_f32<D>(sq, p.q, p.qs.b, p.qs.s, p.qs.h, bi, hi, r0);
    load_rows_f32<D>(sdo, p.dout, dsb, dss, D, bi, hi, r0);
    if (threadIdx.x < kT) {
      slse[threadIdx.x] = lse[r0 + threadIdx.x];
      sdi[threadIdx.x] = dip[r0 + threadIdx.x];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = qd * 8 + i;
      const float s = dot_rows<D>(sk + kr * kPitch, sq + c * kPitch) * p.scale;
      const float pr =
          p.causal && r0 + c < key ? 0.f : expf(s - slse[c]);
      const float dp = dot_rows<D>(sv + kr * kPitch, sdo + c * kPitch);
      sp[kr * (kT + 1) + c] = pr;
      sds[kr * (kT + 1) + c] = pr * (dp - sdi[c]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      float av = dv[i], ak = dk[i];
      for (int c = 0; c < kT; ++c) {
        av = fmaf(sp[kr * (kT + 1) + c], sdo[c * kPitch + i * 4 + qd], av);
        ak = fmaf(sds[kr * (kT + 1) + c], sq[c * kPitch + i * 4 + qd], ak);
      }
      dv[i] = av;
      dk[i] = ak;
    }
  }
  store_cols_f32<D>(p, p.dk, p.sk, bi, hi, key, dk, p.scale);
  store_cols_f32<D>(p, p.dv, p.sk, bi, hi, key, dv, 1.f);
}

// ---------------------------------------------------------------- host

template <int D>
size_t smem_bytes(int which, bool bf) {
  if (bf) {
    const size_t tile = sizeof(bf16) * TileBf16<D>::kPitch;
    if (which == kFwd) return 5 * 64 * tile;
    if (which == kDq) return 6 * 64 * tile + 2 * 64 * sizeof(float);
    return (2 * 64 + 4 * 32) * tile + 4 * 32 * sizeof(float);
  }
  const size_t tile = sizeof(float) * kT * TileF32<D>::kPitch;
  const size_t sq = sizeof(float) * kT * (kT + 1);
  if (which == kFwd) return 3 * tile + sq;
  if (which == kDq) return 4 * tile + sq;
  return 4 * tile + 2 * sq + 2 * kT * sizeof(float);
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           const FlashParams& p) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// a rank-4 map over a [b, s, h, D] bf16 operand with batch, row and head
// strides `st` (elements): boxes of 64 columns x 1 head x `rows` rows x 1
// batch
int make_map4(CUtensorMap* map, const void* base, int b, int s, int h, int d,
              const Strides& st, int rows) {
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(h),
      static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  return hp::make_map_bf16(map, base, 4, dims, strides, box);
}

// the current card's streaming multiprocessors (read once a device)
int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 0;
  return counts[dev];
}

// bf16 at D <= 128 on Hopper, one grid axis (DenseWalk's order): the
// forward and dq one block per `fold` fold units, fold = ceil(units /
// SMs), so at most one block an SM; dk/dv one block a (tile, batch,
// head); q, k and v through maps of their own strides, dO and out
// contiguous; the forward reads 128-row boxes, the backward 64-row ones,
// out is stored in 64-row boxes
template <int D>
int launch_wgmma(int which, const FlashParams& params, cudaStream_t stream) {
  FlashParams p = params;
  const int rows = which == kFwd ? kFwdM : kBwdSub;
  const Strides ds = {static_cast<int64_t>(p.sq) * p.h * D,
                      static_cast<int64_t>(p.h) * D, D};
  CUtensorMap maps[4];
  int err = make_map4(&maps[0], p.q, p.b, p.sq, p.h, D, p.qs, rows);
  if (!err) err = make_map4(&maps[1], p.k, p.b, p.sk, p.h, D, p.ks, rows);
  if (!err) err = make_map4(&maps[2], p.v, p.b, p.sk, p.h, D, p.vs, rows);
  if (!err)  // dO, or the forward's out
    err = make_map4(&maps[3], which == kFwd ? p.out : p.dout, p.b, p.sq,
                    p.h, D, ds, kBwdSub);
  if (err) return err;
  const int tiles = ((which == kDkv ? p.sk : p.sq) + kFwdM - 1) / kFwdM;
  const int units = (tiles + 1) / 2 * p.b * p.h, sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  p.fold = (units + sms - 1) / sms;
  // a block per `fold` units, or (dk/dv) a block a tile
  const int grid = which == kDkv && !DenseWalk<kDkv>::kMultiTile
                       ? tiles * p.b * p.h
                       : (units + p.fold - 1) / p.fold;
  if (which == kFwd) {
    constexpr int kBytes = FwdSmem<D, DenseWalk<kFwd>>::kBytes;
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    flash_fwd_wgmma<D><<<grid, kFwdThreads, kBytes, stream>>>(
        maps[0], maps[1], maps[2], maps[3], p);
    return static_cast<int>(cudaGetLastError());
  }
  const auto kernel =
      which == kDq ? &flash_bwd_dq_wgmma<D> : &flash_bwd_dkv_wgmma<D>;
  const int bytes = which == kDq ? DqSmem<D>::kBytes : DkvSmem<D>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kFwdThreads, bytes, stream>>>(maps[0], maps[1], maps[2],
                                               maps[3], p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch(int which, int dtype, const FlashParams& p,
             cudaStream_t stream) {
  if (dtype != ptt::kBF16) {  // f32: one block per (32-row tile, h, b)
    const size_t smem = smem_bytes<D>(which, false);
    if (which == kFwd)
      return launch(flash_fwd_f32<D>, dim3(p.sq / kT, p.h, p.b), smem,
                    stream, p);
    if (which == kDq)
      return launch(flash_bwd_dq_f32<D>, dim3(p.sq / kT, p.h, p.b), smem,
                    stream, p);
    return launch(flash_bwd_dkv_f32<D>, dim3(p.sk / kT, p.h, p.b), smem,
                  stream, p);
  }
  // bf16: wgmma up to D 128; mma.sync over 64-row tiles at D 256, where a
  // consumer's 64 x 256 fp32 output beside S and P would not fit
  // setmaxnreg's 240 registers
  if constexpr (D <= 128) {
    return launch_wgmma<D>(which, p, stream);
  } else {
    const size_t smem = smem_bytes<D>(which, true);
    if (which == kFwd)
      return launch(flash_fwd_bf16<D>, dim3(p.sq / 64, p.h, p.b), smem,
                    stream, p);
    if (which == kDq)
      return launch(flash_bwd_dq_bf16<D>, dim3(p.sq / 64, p.h, p.b), smem,
                    stream, p);
    // one block per (64 keys, kCols columns)
    return launch(flash_bwd_dkv_bf16<D>,
                  dim3(p.sk / 64 * (D / TileBf16<D>::kCols), p.h, p.b), smem,
                  stream, p);
  }
}

int run(int which, int dtype, int d, const FlashParams& p, void* stream) {
  // the wrapper admits head_dim 64, 96, 128 and 256 and sequences in
  // whole tiles
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return dispatch<64>(which, dtype, p, s);
  if (d == 96) return dispatch<96>(which, dtype, p, s);
  if (d == 128) return dispatch<128>(which, dtype, p, s);
  if (d == 256) return dispatch<256>(which, dtype, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

FlashParams make_params(const void* q, const void* k, const void* v, int b,
                        int sq, int sk, int h, int64_t qsb, int64_t qss,
                        int64_t qsh, int64_t ksb, int64_t kss, int64_t ksh,
                        int64_t vsb, int64_t vss, int64_t vsh, int causal,
                        float scale) {
  FlashParams p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.qs = {qsb, qss, qsh};
  p.ks = {ksb, kss, ksh};
  p.vs = {vsb, vss, vsh};
  p.b = b;
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.causal = causal;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, float* lse, int dtype, int b, int sq,
                             int sk, int h, int d, int64_t qsb, int64_t qss,
                             int64_t qsh, int64_t ksb, int64_t kss,
                             int64_t ksh, int64_t vsb, int64_t vss,
                             int64_t vsh, int causal, float scale,
                             void* stream) {
  FlashParams p = make_params(q, k, v, b, sq, sk, h, qsb, qss, qsh, ksb, kss,
                              ksh, vsb, vss, vsh, causal, scale);
  p.out = out;
  p.lse = lse;
  return run(kFwd, dtype, d, p, stream);
}

extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* di, void* dq, int dtype, int b,
                                int sq, int sk, int h, int d, int64_t qsb,
                                int64_t qss, int64_t qsh, int64_t ksb,
                                int64_t kss, int64_t ksh, int64_t vsb,
                                int64_t vss, int64_t vsh, int causal,
                                float scale, void* stream) {
  FlashParams p = make_params(q, k, v, b, sq, sk, h, qsb, qss, qsh, ksb, kss,
                              ksh, vsb, vss, vsh, causal, scale);
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.delta = di;
  p.out = dq;
  return run(kDq, dtype, d, p, stream);
}

extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* di, void* dk, void* dv,
                                 int dtype, int b, int sq, int sk, int h,
                                 int d, int64_t qsb, int64_t qss, int64_t qsh,
                                 int64_t ksb, int64_t kss, int64_t ksh,
                                 int64_t vsb, int64_t vss, int64_t vsh,
                                 int causal, float scale, void* stream) {
  FlashParams p = make_params(q, k, v, b, sq, sk, h, qsb, qss, qsh, ksb, kss,
                              ksh, vsb, vss, vsh, causal, scale);
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.delta = di;
  p.dk = dk;
  p.dv = dv;
  return run(kDkv, dtype, d, p, stream);
}
