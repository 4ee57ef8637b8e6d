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
// table, so a shared page is read by every row that maps it.
//
// bf16 at a head_dim that is a multiple of 32 (paged_decode_mma, the
// serving path): B6's structure on the bf16 pool, from decode_tiles.cuh
// (its ring BfRing and tile body bf16_tile, which B8 shares).
// One block of 4 warps per (row, kv head), or per (row, kv head, split)
// when b * n_kv leaves the card short of blocks (the wrapper's
// decode_q_plan). A row's tokens go in tiles of 16; warp w takes the
// block's tiles w, w + 4, ... through a ring of 3 tiles of its own (a
// tile the warp never reaches is not issued): the tile's 16 K rows and 16
// V rows go by 16-byte cp.async, consecutive lanes on consecutive chunks
// of a row, into rows padded by 16 bytes (ldmatrix meets no bank
// conflict); page ids are read one tile ahead of the copies. A token past
// the length or on a page outside the region is not read: its rows are
// zero-filled and its score and weight are selected away.
//   S = q K^T on the bf16 tensor cores, mma.sync m16n8k16 (the g <= 8
//   query heads as M, q's rows read from shared memory; the tile's 16
//   tokens as two n8 tiles, K by ldmatrix), each k-step's products summed
//   from zero and added to the scores by an fp32 add, then the scale
//   (carrying the sum in the accumulators, which truncate, moved 2.2% of
//   the MoE rung's expert routes off the plain path's; 0.65% this way).
//   Softmax once a tile: a quad shuffle for the max, one rescale of the
//   accumulators, one exp a score.
//   P V on the bf16 tensor cores, m16n8k16 with fp32 sums: the fp32
//   weights split into three bf16 parts hi + mid + lo (within 2^-27 of
//   each, so the plain version's fp32 contract holds), hi in A's rows 0-7
//   and mid in rows 8-15, then lo in rows 0-7; V by ldmatrix.trans, a
//   thread ending with dims 8 n + 2 t4, + 1 of head gq for each n.
// The warps' states merge through shared memory; a split writes its state
// to the workspace and the last split of a (row, head), by an atomic
// ticket, merges them in split order: one launch a call. Only split 0
// appends (warps 0 and 1 copy the operand rows into the pool); no block
// reads that slot, since the current token joins from the operands.
// float32, and a head_dim off a multiple of 32 (paged_decode_kernel): the
// CUDA-core kernel. Within a block, 4 warps take interleaved runs of 4
// tokens; a lane holds EPL = ceil(d/32) elements of each K/V row (one
// vector load per row when d is a multiple of 32), the q.k dot is a warp
// reduction, and each warp keeps an fp32 online softmax (m, l, acc) that
// the block merges at the end.
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
// per query head, far below the card's byte/flop balance.
#include "decode_tiles.cuh"

namespace {

using ptt::from_f32;
using ptt::to_f32;
using ptt::decode::kWarps;
namespace decode = ptt::decode;

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
  float* ws;    // bf16, n_split > 1: the splits' partials, then counters
  int n_split;  // bf16: blocks a (row, kv head)
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

// ---------------------------------------------------------------- bf16

namespace mma {

using bf16 = __nv_bfloat16;
using decode::kStages;

// (a minimum of one block an SM: without it ptxas held d64 at 80
// registers with a 4-byte spill)
template <int NG>
__global__ void __launch_bounds__(kWarps * 32, 1)
    paged_decode_mma(const Params p) {
  using R = decode::BfRing<NG>;
  constexpr int kD = R::kD, kQPitch = R::kQPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t4 = lane & 3;
  const int split = blockIdx.x % p.n_split, h = blockIdx.x / p.n_split;
  const int row = blockIdx.y;
  const int g = p.g, ps = p.ps, n_kv = p.n_kv, n_q = n_kv * g;
  const bf16* q = static_cast<const bf16*>(p.q);
  unsigned char* ring = smem + warp * R::kWarpBytes;
  bf16* s_q = reinterpret_cast<bf16*>(smem + kWarps * R::kWarpBytes);
  float* s_cur = reinterpret_cast<float*>(s_q + 8 * kQPitch);  // [8]
  float* s_nk = s_cur + 8;  // the current token's k and v [kD], as float
  float* s_nv = s_nk + kD;
  int* s_valid = reinterpret_cast<int*>(s_nv + kD) + warp * kStages;
  int* ticket = reinterpret_cast<int*>(s_nv + kD) + kWarps * kStages;

  const int len = p.seq_lens[row];
  const int cap = p.pp * ps;
  const int n_tok = len < cap ? len : cap;  // pool tokens attended
  const int* trow = p.tables + static_cast<int64_t>(row) * p.pp;
  const int64_t head_stride = static_cast<int64_t>(ps) * kD;
  const int64_t page_stride = head_stride * n_kv;
  const int64_t cur = (static_cast<int64_t>(row) * n_kv + h) * kD;
  const unsigned region = static_cast<unsigned>(p.pool_pages);
  const decode::Pool pool{page_stride, head_stride, kD, ps, p.pool_base,
                          region};

  // the block's tiles; warp w takes t_lo + w + 4 j
  const decode::Walk wk = decode::walk(n_tok, split, p.n_split, warp);
  const int nj = wk.nj;
  const int r = lane & 15;
  auto fetch = [&](int j) {
    return decode::page_of(trow, wk, n_tok, ps, warp, j, r);
  };
  // tile j into stage j % kStages (a tile past the warp's last is never
  // read, so not issued)
  auto issue = [&](int j, int id) {
    if (j >= nj) return;
    decode::issue_tile_rows<2 * kD, 2>(
        ring + (j % kStages) * R::kStage, s_valid + j % kStages, id,
        decode::tile_token(wk, warp, j, 0), h, pool, p.k_pool, p.v_pool,
        lane);
  };

  int ids[kStages - 1];
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) ids[j] = fetch(j);
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    issue(j, ids[j]);
    ptt::cp_async_commit();
  }
  int id_next = fetch(kStages - 1);

  // the current token's k (warp 0) and v (warp 1) into shared memory, and
  // their append (split 0; skipped for a full table or a page outside the
  // region); nobody reads this slot here
  if (warp < 2) {
    const bf16* src = static_cast<const bf16*>(warp == 0 ? p.new_k : p.new_v);
    float* sx = warp == 0 ? s_nk : s_nv;
    const bool append = split == 0 && len < cap &&
                        static_cast<unsigned>(trow[len / ps]) < region;
    bf16* dst = nullptr;
    if (append)
      dst = static_cast<bf16*>(warp == 0 ? p.k_pool : p.v_pool) +
            (trow[len / ps] + static_cast<int64_t>(p.pool_base)) *
                page_stride +
            h * head_stride + static_cast<int64_t>(len % ps) * kD;
#pragma unroll
    for (int e = 0; e < NG; ++e) {
      const bf16 v = src[cur + lane + 32 * e];
      sx[lane + 32 * e] = __bfloat162float(v);
      if (append) dst[lane + 32 * e] = v;
    }
  }
  // q's rows into shared memory (rows g..7 zero), 16 bytes a copy
  for (int i = tid; i < 8 * kD / 8; i += kWarps * 32) {
    const int gi = i / (kD / 8), c = i % (kD / 8);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gi < g)
      v = *reinterpret_cast<const uint4*>(
          q + (static_cast<int64_t>(row) * n_q + h * g + gi) * kD + 8 * c);
    *reinterpret_cast<uint4*>(s_q + gi * kQPitch + 8 * c) = v;
  }
  __syncthreads();

  // head gq's state: max, this thread's part of the sum, and the
  // accumulators: acc[n] c0/c1 dims 8 n + 2 t4 (+1), hi and lo products;
  // c2/c3 the mid products of the same dims
  float m = -INFINITY, l = 0.f;
  float acc[4 * NG][4];
  ptt::tiles::zero(acc);
  const bf16* qrow = s_q + gq * kQPitch + 2 * t4;

  for (int j = 0; j < nj; ++j) {
    issue(j + kStages - 1, id_next);
    ptt::cp_async_commit();
    id_next = fetch(j + kStages);
    ptt::cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned valid = static_cast<unsigned>(s_valid[j % kStages]);
    if (valid != 0u)
      decode::bf16_tile<NG>(
          qrow,
          reinterpret_cast<const bf16*>(ring + (j % kStages) * R::kStage),
          valid, p.scale, m, l, acc);
    __syncwarp();  // the stage is refilled from the next tile on
  }
  ptt::cp_async_wait<0>();
  l = ptt::tiles::quad_sum(l);

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
  float* arow = s_acc + (warp * 8 + gq) * R::kAccPitch + 2 * t4;
#pragma unroll
  for (int n = 0; n < 4 * NG; ++n) {
    arow[8 * n] = acc[n][0] + acc[n][2];
    arow[8 * n + 1] = acc[n][1] + acc[n][3];
  }
  // the current token's logit per head, from the operands
  for (int gi = warp; gi < g; gi += kWarps) {
    float dot = 0.f;
    for (int e = lane; e < kD; e += 32)
      dot = fmaf(__bfloat162float(s_q[gi * kQPitch + e]), s_nk[e], dot);
    dot = ptt::warp_sum(dot);
    if (lane == 0) s_cur[gi] = dot * p.scale;
  }
  __syncthreads();
  decode::finish(s_m, s_l, s_acc, R::kAccPitch, s_cur, s_nv, ticket,
                 decode::Finish{p.out, ptt::kBF16,
                                (static_cast<int64_t>(row) * n_q + h * g) * kD,
                                g, kD, p.n_split, split, p.ws,
                                static_cast<int64_t>(row) * n_kv + h});
}

template <int NG>
int launch_mma(const Params& p, int b, cudaStream_t stream) {
  constexpr size_t smem = decode::BfRing<NG>::kSmem;
  const cudaError_t e = cudaFuncSetAttribute(
      paged_decode_mma<NG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(p.n_kv * p.n_split, b);
  paged_decode_mma<NG><<<grid, kWarps * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_mma(const Params& p, int b, cudaStream_t stream) {
  switch (p.d / 32) {
    case 1: return launch_mma<1>(p, b, stream);
    case 2: return launch_mma<2>(p, b, stream);
    case 3: return launch_mma<3>(p, b, stream);
    case 4: return launch_mma<4>(p, b, stream);
    case 5: return launch_mma<5>(p, b, stream);
    case 6: return launch_mma<6>(p, b, stream);
    case 7: return launch_mma<7>(p, b, stream);
    default: return launch_mma<8>(p, b, stream);
  }
}

}  // namespace mma

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

// Whether a launch takes the bf16 tensor-core kernel: bf16 at a head_dim
// that is a multiple of 32 (the others take the CUDA-core kernel).
static bool takes_mma(int dtype, int d) {
  return dtype == ptt::kBF16 && d % 32 == 0;
}

// Returns the cudaError_t of the launch. Shapes: q/out [b, n_q, d],
// new_k/new_v [b, n_kv, d], pools [pages, n_kv, page_size, d] (all of
// `dtype`, contiguous), seq_lens [b] and block_tables [b, pages_per_seq]
// int32. n_q = n_kv * g with g <= 8, d <= 256, b <= 65535. The layer
// region is pool pages [pool_base, pool_base + pool_pages); the caller
// checks it lies in the pool. bf16 at a head_dim that is a multiple of 32
// takes n_split (1 to 16) blocks a (row, kv head); n_split > 1 needs
// `ws`: f32 [b * n_kv * n_split * g * (d + 2)] then int32 [b * n_kv]
// counters (zeroed here). The other launches take n_split 1.
extern "C" int ptt_paged_decode_attention(
    const void* q, const void* new_k, const void* new_v, void* k_pool,
    void* v_pool, const int* seq_lens, const int* block_tables, void* out,
    void* ws, int dtype, int b, int n_q, int n_kv, int d, int page_size,
    int pages_per_seq, int pool_base, int pool_pages, int n_split,
    float scale, void* stream) {
  if (b == 0) return 0;
  if (n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv > 8 || d <= 0 || d > 256 ||
      pool_base < 0 || pool_pages <= 0 || b > 65535 || n_split < 1 ||
      n_split > 16 || (n_split > 1 && (!takes_mma(dtype, d) || ws == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,         new_k,     new_v,        k_pool,
                 v_pool,    seq_lens,  block_tables, out,
                 n_kv,      n_q / n_kv, d,           page_size,
                 pages_per_seq, pool_base, pool_pages, scale,
                 static_cast<float*>(ws), n_split};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (takes_mma(dtype, d)) {
    if (n_split > 1) {
      const size_t rows = static_cast<size_t>(b) * n_kv;
      const cudaError_t e = cudaMemsetAsync(
          p.ws + rows * n_split * (n_q / n_kv) * (d + 2), 0,
          rows * sizeof(int), st);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    return mma::dispatch_mma(p, b, st);
  }
  if (dtype == ptt::kF32) return dispatch_d<float>(p, b, st);
  if (dtype == ptt::kBF16) return dispatch_d<__nv_bfloat16>(p, b, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
