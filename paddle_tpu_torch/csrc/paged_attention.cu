// Fused KV append + paged GQA decode attention, in place on the pool.
//
// Replaces the TPU kernel paged_decode_attention_inplace
// (paddle_tpu/nn/functional/paged_attention.py:489, pallas_call at :761).
// Python wrapper: paddle_tpu_torch/nn/functional/paged_attention.py.
//
// What it computes, per batch row r and kv head h (one block each):
//   - attention of the row's g query heads of group h over the pool
//     tokens 0 .. min(seq_lens[r], pages_per_seq*page_size)-1, addressed
//     through block_tables[r] + pool_base, plus the current token, whose
//     K/V come from the new_k/new_v operands;
//   - the append: new_k/new_v[r, h] into slot seq_lens[r] % page_size of
//     page block_tables[r, seq_lens[r] / page_size] + pool_base. A row
//     whose table is full (seq_lens >= pages_per_seq*page_size) has
//     nowhere to append: its write is skipped and its attention still
//     folds in the operand token, as the TPU kernel's masked no-op write.
//   - a table id outside the layer region [0, pool_pages) names no page:
//     its tokens are not attended and an append into it is skipped, so
//     no launch reads or writes outside [pool_base, pool_base+pool_pages).
//
// Design. The TPU kernel streams the whole layer region of the pool
// through one sequential grid and masks it with a page-ownership map;
// that exists because the TPU grid runs in order, and the map keeps one
// owner per page, which is wrong for pages shared between rows (prefix
// pages). Here blocks run in parallel and each walks its own row's block
// table, so a shared page is read by every row that maps it. Within a
// block, 4 warps take interleaved runs of 4 tokens; a lane holds EPL =
// ceil(d/32) elements of each K/V row (one vector load per row when d is
// a multiple of 32), the q.k dot is a warp reduction, and each warp keeps
// an fp32 online softmax (m, l, acc) that the block merges at the end.
//
// No race: no block reads a slot that a block writes in the same launch.
// The current token is taken from the operand, never from the pool, and
// the page receiving a row's write is private to that row (the engines
// share only full prefix pages). Idle batch slots (seq_lens 0, an all-zero
// table) write into the reserved scratch page 0 and read nothing.
//
// Bound: bytes. Each block reads its row's K and V rows once (2 * len *
// d * itemsize per kv head), plus q and the operands, and writes the
// output and the two appended rows; there are 4*d flops per K/V row pair
// per query head, far below the card's byte/flop balance. A split-KV
// form (several blocks per long row) and TMA page loads are later work.
#include "common.cuh"

namespace {

using ptt::from_f32;
using ptt::to_f32;

constexpr int kWarps = 4;
constexpr int kUnroll = 4;  // K/V rows a warp keeps in flight

struct Params {
  const void* q;
  const void* new_k;
  const void* new_v;
  void* k_pool;
  void* v_pool;
  const int* seq_lens;
  const int* tables;
  void* out;
  int n_kv, g, d, ps, pp, pool_base, pool_pages;
  float scale;
};

template <typename T, int N>
struct alignas(sizeof(T) * N <= 16 ? sizeof(T) * N : 16) Pack {
  T v[N];
};

// elements [lane*EPL, lane*EPL + EPL) of a d-long row, as float
template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* row, int lane, int d,
                                         bool full, float (&v)[EPL]) {
  const int e0 = lane * EPL;
  if (full) {
    const Pack<T, EPL> pk = *reinterpret_cast<const Pack<T, EPL>*>(row + e0);
#pragma unroll
    for (int e = 0; e < EPL; ++e) v[e] = to_f32(pk.v[e]);
  } else {
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      v[e] = (e0 + e < d) ? to_f32(row[e0 + e]) : 0.f;
  }
}

// one token into the warp's online softmax of each of its g query heads
template <int EPL, int G>
__device__ __forceinline__ void fold_token(const float (&qv)[G][EPL],
                                           const float (&kr)[EPL],
                                           const float (&vr)[EPL], int g,
                                           float (&m)[G], float (&l)[G],
                                           float (&acc)[G][EPL]) {
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (gi < g) {
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) s = fmaf(qv[gi][e], kr[e], s);
      s = ptt::warp_sum(s);
      const float mn = fmaxf(m[gi], s);
      const float alpha = expf(m[gi] - mn);  // m = -inf before any token
      const float pr = expf(s - mn);
      l[gi] = l[gi] * alpha + pr;
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[gi][e] = fmaf(pr, vr[e], acc[gi][e] * alpha);
      m[gi] = mn;
    }
  }
}

template <typename T, int EPL, int G>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_kernel(const Params p) {
  const int h = blockIdx.x, row = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = p.g, d = p.d, ps = p.ps, n_kv = p.n_kv;
  const int n_q = n_kv * g;
  const bool full = (d == 32 * EPL);
  const T* q = static_cast<const T*>(p.q);
  const T* new_k = static_cast<const T*>(p.new_k);
  const T* new_v = static_cast<const T*>(p.new_v);
  T* k_pool = static_cast<T*>(p.k_pool);
  T* v_pool = static_cast<T*>(p.v_pool);
  const int len = p.seq_lens[row];
  const int cap = p.pp * ps;
  const int n_tok = len < cap ? len : cap;  // pool tokens attended
  const int* trow = p.tables + static_cast<int64_t>(row) * p.pp;
  const int64_t head_stride = static_cast<int64_t>(ps) * d;
  const int64_t page_stride = head_stride * n_kv;
  const int64_t cur = (static_cast<int64_t>(row) * n_kv + h) * d;
  const unsigned region = static_cast<unsigned>(p.pool_pages);

  // the append (skipped for a full table or a page outside the region);
  // nobody reads this slot here
  if (len < cap && static_cast<unsigned>(trow[len / ps]) < region) {
    const int64_t dst = static_cast<int64_t>(trow[len / ps] + p.pool_base) *
                            page_stride +
                        h * head_stride + static_cast<int64_t>(len % ps) * d;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      k_pool[dst + i] = new_k[cur + i];
      v_pool[dst + i] = new_v[cur + i];
    }
  }

  float qv[G][EPL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (gi < g) {
      load_row<T, EPL>(q + (static_cast<int64_t>(row) * n_q + h * g + gi) * d,
                       lane, d, full, qv[gi]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qv[gi][e] *= p.scale;
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qv[gi][e] = 0.f;
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
    float kr[kUnroll][EPL], vr[kUnroll][EPL];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      const int page = t < n_tok ? trow[t / ps] : -1;
      ok[u] = static_cast<unsigned>(page) < region;
      if (ok[u]) {
        const int64_t off =
            static_cast<int64_t>(page + p.pool_base) * page_stride +
            h * head_stride + static_cast<int64_t>(t % ps) * d;
        load_row<T, EPL>(k_pool + off, lane, d, full, kr[u]);
        load_row<T, EPL>(v_pool + off, lane, d, full, vr[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (ok[u]) fold_token<EPL, G>(qv, kr[u], vr[u], g, m, l, acc);
  }
  if (warp == 0) {  // the current token, from the operands
    float kr[EPL], vr[EPL];
    load_row<T, EPL>(new_k + cur, lane, d, full, kr);
    load_row<T, EPL>(new_v + cur, lane, d, full, vr);
    fold_token<EPL, G>(qv, kr, vr, g, m, l, acc);
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
  T* out = static_cast<T*>(p.out);
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
    out[(static_cast<int64_t>(row) * n_q + h * g + gi) * d + e] =
        from_f32<T>(num / den);
  }
}

template <typename T, int EPL, int G>
int launch(const Params& p, int b, cudaStream_t stream) {
  const dim3 grid(p.n_kv, b);
  paged_decode_kernel<T, EPL, G><<<grid, kWarps * 32, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int EPL>
int dispatch_g(const Params& p, int b, cudaStream_t stream) {
  if (p.g <= 1) return launch<T, EPL, 1>(p, b, stream);
  if (p.g <= 2) return launch<T, EPL, 2>(p, b, stream);
  if (p.g <= 4) return launch<T, EPL, 4>(p, b, stream);
  return launch<T, EPL, 8>(p, b, stream);
}

template <typename T>
int dispatch_d(const Params& p, int b, cudaStream_t stream) {
  const int epl = (p.d + 31) / 32;
  if (epl <= 1) return dispatch_g<T, 1>(p, b, stream);
  if (epl <= 2) return dispatch_g<T, 2>(p, b, stream);
  if (epl <= 4) return dispatch_g<T, 4>(p, b, stream);
  return dispatch_g<T, 8>(p, b, stream);
}

}  // namespace

// Returns the cudaError_t of the launch. Shapes: q/out [b, n_q, d],
// new_k/new_v [b, n_kv, d], pools [pages, n_kv, page_size, d] (all of
// `dtype`, contiguous), seq_lens [b] and block_tables [b, pages_per_seq]
// int32. n_q = n_kv * g with g <= 8, d <= 256. The layer region is pool
// pages [pool_base, pool_base + pool_pages); the caller checks it lies in
// the pool.
extern "C" int ptt_paged_decode_attention(
    const void* q, const void* new_k, const void* new_v, void* k_pool,
    void* v_pool, const int* seq_lens, const int* block_tables, void* out,
    int dtype, int b, int n_q, int n_kv, int d, int page_size,
    int pages_per_seq, int pool_base, int pool_pages, float scale,
    void* stream) {
  if (b == 0) return 0;
  if (n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv > 8 || d <= 0 || d > 256 ||
      pool_base < 0 || pool_pages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,         new_k,     new_v,        k_pool,
                 v_pool,    seq_lens,  block_tables, out,
                 n_kv,      n_q / n_kv, d,           page_size,
                 pages_per_seq, pool_base, pool_pages, scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32) return dispatch_d<float>(p, b, st);
  if (dtype == ptt::kBF16) return dispatch_d<__nv_bfloat16>(p, b, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
