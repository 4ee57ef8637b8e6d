// Fused KV append + paged GQA decode attention over an int8 KV pool.
//
// Replaces the TPU kernel paged_decode_attention_inplace_q
// (paddle_tpu/nn/functional/paged_attention.py:957, pallas_call at
// :1257). Python wrapper and plain version:
// paddle_tpu_torch/nn/functional/paged_attention.py.
//
// The pool holds int8 token rows [pages, n_kv, page_size, d] and f32
// per-(token, head) scales in planes [n_kv, pages * page_size]: page p's
// slot s at column p * page_size + s. Per batch row r and kv head h (one
// block each):
//   - q is quantized per (row, q head): qs = max(absmax / 127, 1e-8),
//     qq = clip(rint(q / qs), -127, 127);
//   - cached token t (t < seq_lens[r], through block_tables[r] +
//     pool_base, in the layer region) has logit
//     int32(qq . kq[t]) * (qs * d^-0.5) * k_scale[t];
//   - the current token joins unquantized from the operands: logit
//     (qq * qs) . new_k * d^-0.5, value new_v;
//   - an fp32 online softmax over both; the output is
//     sum_t w_t * v_scale[t] * vq[t] + w_cur * new_v;
//   - the append: new_k/new_v[r, h] quantized per row into slot
//     seq_lens[r] % page_size of page block_tables[r, seq_lens[r] /
//     page_size] + pool_base, their scales into the planes; skipped for
//     a full table or a page outside the region [0, pool_pages).
// The TPU kernel also re-quantizes the softmax weights per chunk to run
// P.V on the int8 MXU; that tactic belongs to the TPU's chunk size and
// is not carried over (P.V runs in fp32 here).
//
// Design. As csrc/paged_attention.cu: the TPU kernel streams the whole
// layer region through one ordered grid and masks it with a one-owner-
// per-page map, which is wrong for pages shared between rows. Here each
// block walks its own row's table, so a shared page is read by every row
// that maps it. 4 warps take interleaved runs of 4 tokens; a lane holds
// EPL = ceil(d/32) bytes of each int8 K/V row (one load per row), the
// q.k dot is exact in fp32 (|products| <= 127^2 and d <= 256 keep every
// partial sum an integer below 2^24) and a warp reduction; each warp
// keeps an online softmax that the block merges at the end. Warps 0 and
// 1 quantize and append new_k and new_v; no block reads that slot.
//
// Bound: bytes. Each block reads its row's int8 K and V rows once
// (2 * len * d bytes per kv head) plus 8 bytes of scales per token, half
// the bytes of the bf16 pool; the flops are as in the bf16 kernel.
#include "common.cuh"

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

}  // namespace

// Returns the cudaError_t of the launch. Shapes: q/out [b, n_q, d] and
// new_k/new_v [b, n_kv, d] of dtype code `dtype` (float32 or bfloat16);
// kq_pool/vq_pool [pages, n_kv, page_size, d] int8; ks_plane/vs_plane
// [n_kv, plane_cols] float32 with plane_cols = pages * page_size;
// seq_lens [b] and block_tables [b, pages_per_seq] int32; all contiguous.
// n_q = n_kv * g with g <= 8, d <= 256. The layer region is pool pages
// [pool_base, pool_base + pool_pages); the caller checks it lies in the
// pool.
extern "C" int ptt_paged_decode_attention_q(
    const void* q, const void* new_k, const void* new_v, void* kq_pool,
    void* ks_plane, void* vq_pool, void* vs_plane, const int* seq_lens,
    const int* block_tables, void* out, int dtype, int b, int n_q, int n_kv,
    int d, int page_size, int pages_per_seq, int pool_base, int pool_pages,
    int plane_cols, float scale, void* stream) {
  if (b == 0) return 0;
  if (n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv > 8 || d <= 0 || d > 256 ||
      pool_base < 0 || pool_pages <= 0 ||
      (dtype != ptt::kF32 && dtype != ptt::kBF16))
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
                 scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int epl = (d + 31) / 32;
  if (epl <= 1) return dispatch_g<1>(p, b, st);
  if (epl <= 2) return dispatch_g<2>(p, b, st);
  if (epl <= 4) return dispatch_g<4>(p, b, st);
  return dispatch_g<8>(p, b, st);
}
