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
// kernels). dO, out and the gradients are contiguous [b, s, h, d]. Masked
// scores take the stock kernel's finite -0.7 * FLT_MAX, never -inf, so no
// -inf - -inf appears; tiles wholly above the diagonal are skipped.
//
// Design. The TPU kernels carry the running max, sum and output of a q
// block in VMEM scratch across a sequential grid axis of k blocks. Here
// the loop over k tiles (or q tiles) is inside the block, and every output
// tile has one owner: the forward and dq blocks own 64 query rows and walk
// the k tiles up to the diagonal; the dk/dv block owns 64 keys and walks
// the q tiles from the diagonal down. No atomics: every result is the
// same from run to run.
//
// bf16 runs on the tensor cores: mma.sync m16n8k16 with fp32 sums, 4
// warps of 16 rows (or 16 keys in dk/dv), operand fragments by ldmatrix
// (plain for an operand stored k-contiguous, .trans for one stored
// n-contiguous) from tiles that a 2-stage cp.async ring brings into
// shared memory, rows padded by 16 bytes so the 8 rows of an ldmatrix hit
// distinct banks. A product's fp32 accumulator has the register layout of
// the next product's A fragment, so P (and dS) go from one mma to the
// next in registers, packed to bf16 as the TPU kernel casts p to v's type
// before its dot. The softmax runs in base 2 (scores pre-scaled by
// scale * log2 e) with f32 statistics. float32 runs the same walk on the
// CUDA cores (32 x 32 tiles, 4 threads a row, exact fp32 products). Built
// for head_dim 64, 96 and 128; the tile machinery is flash_tiles.cuh.
//
// Bounds (H100 SXM: 989 TFLOP/s dense bf16, 3.35 TB/s). At the gpt3-1.3b
// rung (b 4, s 1024, h 16, d 128, causal) the forward does 17.2 GFLOP
// (17.4 us) and moves 67.4 MB (20.1 us): bytes bound it, by a little; the
// backward does 42.9 GFLOP (43.4 us) against 134.7 MB (40.2 us), so
// operations do. mma.sync from a cp.async ring reaches a fraction of the
// wgmma rate; wgmma with TMA loads and warp specialisation are later work.
#include "flash_tiles.cuh"

namespace {

using namespace ptt::tiles;
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
  const float* di;   // backward: [b, h, sq]
  void* out;         // forward: out; backward: dq (contiguous)
  void* dk;          // backward (contiguous)
  void* dv;
  Strides qs, ks, vs;
  int b, sq, sk, h, causal;
  float scale;
};

// offset of row s of head h in batch b of a contiguous [b, s, h, D] array
template <int D>
__device__ __forceinline__ int64_t dense_at(const FlashParams& p, int s_len,
                                            int bi, int s, int hi) {
  return ((static_cast<int64_t>(bi) * s_len + s) * p.h + hi) * D;
}

// ---------------------------------------------------------------- bf16

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

// rows g and g + 8 of a warp's 16 x D accumulator, times `mul`, as bf16
// rows of a contiguous [b, s, h, D] array from row r0
template <int D>
__device__ __forceinline__ void store_rows(const FlashParams& p, void* dst,
                                           int s_len, int bi, int hi, int r0,
                                           const float (&acc)[D / 8][4],
                                           const float (&mul)[2]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  bf16* out = static_cast<bf16*>(dst);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* row = out + dense_at<D>(p, s_len, bi, r0 + g + r * 8, hi);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
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

    float s[kN / 8][4];
    zero(s);
    mma_abt<kN, D>(s, sq + warp * 16 * kPitch, sk + st * kN * kPitch);
    const int k0 = j * kN, row0 = q0 + warp * 16 + g;
    const bool diag = p.causal && k0 + kN - 1 > q0 + warp * 16;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt)
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
    for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[nt][c] = exp2f(s[nt][c] - m[c >> 1]);
        l[c >> 1] += s[nt][c];
      }
    mma_xb<kN, D>(o, s, sv + st * kN * kPitch);
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
  load_stats<kM>(sdi, p.di, p, bi, hi, q0);
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
    const bf16* kt = sk + st * kN * kPitch;
    const bf16* vt = sv + st * kN * kPitch;
    float s[kN / 8][4], dp[kN / 8][4];
    zero(s);
    zero(dp);
    mma_abt<kN, D>(s, sq + warp * 16 * kPitch, kt);
    mma_abt<kN, D>(dp, sdo + warp * 16 * kPitch, vt);
    const int k0 = j * kN, row0 = q0 + warp * 16 + g;
    const bool diag = p.causal && k0 + kN - 1 > q0 + warp * 16;
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        float pr = exp2f(s[nt][c] * sl2 - lse2[r]);
        if (diag && k0 + nt * 8 + 2 * t + (c & 1) > row0 + r * 8) pr = 0.f;
        s[nt][c] = pr * (dp[nt][c] - di[r]);  // dS
      }
    mma_xb<kN, D>(dq, s, kt);
    __syncthreads();
  }
  cp_async_wait<0>();
  const float mul[2] = {p.scale, p.scale};
  store_rows<D>(p, p.out, p.sq, bi, hi, q0 + warp * 16, dq, mul);
}

// dk/dv: a block owns 64 keys (warp w keys 16w..) and walks the 32-row q
// tiles from the diagonal on: S^T = K Q^T, P^T = exp(S^T - lse), dV +=
// P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T - di), dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_bf16(const FlashParams p) {
  constexpr int kM = 32, kN = 64, kPitch = TileBf16<D>::kPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);  // [kN][kPitch]
  bf16* sv = sk + kN * kPitch;               // [kN][kPitch]
  bf16* sq = sv + kN * kPitch;               // [2][kM][kPitch]
  bf16* sdo = sq + 2 * kM * kPitch;          // [2][kM][kPitch]
  float* slse = reinterpret_cast<float*>(sdo + 2 * kM * kPitch);  // [2][kM]
  float* sdi = slse + 2 * kM;                                      // [2][kM]
  const int k0 = blockIdx.x * kN;  // low key tiles have the longest walks
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
    load_stats<kM>(sdi, p.di, p, bi, hi, qbeg);
  }
  cp_async_commit();

  float dk[D / 8][4], dv[D / 8][4];
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
      load_stats<kM>(sdi + nst * kM, p.di, p, bi, hi, r0 + kM);
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
    mma_xb<kM, D>(dv, s, dot);
    float dp[kM / 8][4];
    zero(dp);
    mma_abt<kM, D>(dp, sv + warp * 16 * kPitch, dot);  // dP^T
#pragma unroll
    for (int nt = 0; nt < kM / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[nt][c] *= dp[nt][c] - dt[nt * 8 + 2 * t + (c & 1)];  // dS^T
    mma_xb<kM, D>(dk, s, qt);
    __syncthreads();
  }
  cp_async_wait<0>();
  const float one[2] = {1.f, 1.f}, mul[2] = {p.scale, p.scale};
  store_rows<D>(p, p.dk, p.sk, bi, hi, k0 + warp * 16, dk, mul);
  store_rows<D>(p, p.dv, p.sk, bi, hi, k0 + warp * 16, dv, one);
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
  const float lse = p.lse[plane], di = p.di[plane];
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
  const float* dip = p.di + (static_cast<int64_t>(bi) * p.h + hi) * p.sq;
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

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

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

template <int D>
int dispatch(int which, int dtype, const FlashParams& p,
             cudaStream_t stream) {
  const bool bf = dtype == ptt::kBF16;
  const size_t smem = smem_bytes<D>(which, bf);
  if (which == kFwd) {
    const dim3 grid(p.sq / (bf ? 64 : kT), p.h, p.b);
    return bf ? launch(flash_fwd_bf16<D>, grid, smem, stream, p)
              : launch(flash_fwd_f32<D>, grid, smem, stream, p);
  }
  if (which == kDq) {
    const dim3 grid(p.sq / (bf ? 64 : kT), p.h, p.b);
    return bf ? launch(flash_bwd_dq_bf16<D>, grid, smem, stream, p)
              : launch(flash_bwd_dq_f32<D>, grid, smem, stream, p);
  }
  const dim3 grid(p.sk / (bf ? 64 : kT), p.h, p.b);
  return bf ? launch(flash_bwd_dkv_bf16<D>, grid, smem, stream, p)
            : launch(flash_bwd_dkv_f32<D>, grid, smem, stream, p);
}

int run(int which, int dtype, int d, const FlashParams& p, void* stream) {
  // the wrapper admits head_dim 64, 96 and 128 and sequences in whole tiles
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return dispatch<64>(which, dtype, p, s);
  if (d == 96) return dispatch<96>(which, dtype, p, s);
  if (d == 128) return dispatch<128>(which, dtype, p, s);
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
  p.di = di;
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
  p.di = di;
  p.dk = dk;
  p.dv = dv;
  return run(kDkv, dtype, d, p, stream);
}
