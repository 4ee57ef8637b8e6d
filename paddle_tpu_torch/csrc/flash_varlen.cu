// Paged prefill attention: a prompt chunk's queries over the paged pool.
//
// Replaces the TPU kernel _paged_fwd_pallas
// (paddle_tpu/nn/functional/flash_varlen.py:906, pallas_call at :1022),
// reached through paged_prefill_attention (:1104).
// Python wrapper: paddle_tpu_torch/nn/functional/flash_varlen.py.
//
// What it computes. q [b, c, n_q, d] holds the chunk's queries at
// positions start[b] .. start[b]+c-1 (heads kv-major: head = kv*g + j).
// Query t of row b attends every key at position <= start[b] + t below
// the table's span pp*page_size, read in place from the page-major pool
// [P, n_kv, page_size, d] through block_tables[b] (absolute page ids):
// the cached prefix, pages other rows share, and the chunk's own K/V,
// which the caller wrote before this launch on the same stream. A table
// id outside [0, P) names no page: nothing is read there and its keys
// are not attended. Scores, softmax and accumulation are fp32; the
// output is in q's dtype. A query with nothing to attend gets zeros.
//
// Design. The TPU kernel runs one sequential grid step per batch row and
// double-buffers whole pages of all heads through VMEM. Here blocks run
// in parallel, one per (q tile, kv head, row): a q tile is 64 query
// vectors, 64/g chunk rows times the g query heads of the kv head, so
// the g heads share every K/V tile the block loads. The block walks the
// row's keys in tiles of 32 positions, each key row addressed through
// the block table (a tile is whole pages when page_size divides 32, and
// any start works), converts them to fp32 in shared memory, and stops
// at the tile holding its last query's position (causal early exit).
// 256 threads: thread (r, cg) owns query vectors 4r..4r+3; for the
// scores it takes keys cg and cg+16 of the tile, for the output the
// columns cg, cg+16, ... of d. Each query's online softmax (m, l) is
// reduced over the 16 threads that share it with warp shuffles.
//
// Bound. A chunk of c queries per kv head does 4*d*c flops per key for
// the 4*d bytes of its bf16 K and V rows, read once: c flops a byte, 256
// at c = 256, just under the card's bf16 balance (~295), so the bound is the
// K/V bytes with the tensor cores' operations close behind (5.6 and
// 4.1 us at start 1792, d 128, 16 heads). This kernel runs its products
// on the CUDA cores in fp32 and loads each tile before computing on it,
// so it cannot come near that bound; mma/wgmma tiles and TMA page loads
// overlapped with compute are the later work that would.
#include "common.cuh"

namespace {

using ptt::from_f32;
using ptt::to_f32;

constexpr int kThreads = 256;
constexpr int kQV = 64;    // query vectors (row, head) per block
constexpr int kBK = 32;    // key positions per tile
constexpr int kPerThread = kQV * 16 / kThreads;  // query vectors a thread owns

struct Params {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* tables;
  const int* start;
  void* out;
  int c, n_q, n_kv, g, d, ps, pp, num_pages, rows;
  float scale;
};

__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int d) {
  return sizeof(int64_t) * kBK +
         sizeof(float) * (static_cast<size_t>(kQV) * (d + 1) +
                          static_cast<size_t>(kBK) * (d + 1) +
                          static_cast<size_t>(kBK) * d + kQV * (kBK + 1));
}

// DC: output columns a thread owns, ceil(d / 16) rounded up to a power of 2
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
    paged_prefill_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = p.d, dp = d + 1;
  int64_t* koff = reinterpret_cast<int64_t*>(smem_raw);  // [kBK], -1: none
  float* Qs = reinterpret_cast<float*>(koff + kBK);      // [kQV][d+1]
  float* Ks = Qs + kQV * dp;                             // [kBK][d+1]
  float* Vs = Ks + kBK * dp;                             // [kBK][d]
  float* Ps = Vs + kBK * d;                              // [kQV][kBK+1]

  const int tid = threadIdx.x;
  const int kv = blockIdx.y, bi = blockIdx.z;
  const int g = p.g, c = p.c;
  const int t0 = blockIdx.x * p.rows;
  const int n_vec = p.rows * g;
  const int st = p.start[bi];
  const int t_last = min(t0 + p.rows, c) - 1;
  const int span = p.pp * p.ps;
  const int key_end = min(span, st + t_last + 1);  // causal early exit
  const int64_t row_stride = static_cast<int64_t>(p.n_q) * d;
  const int64_t head_stride = static_cast<int64_t>(p.ps) * d;
  const int64_t page_stride = head_stride * p.n_kv;
  const T* q = static_cast<const T*>(p.q);
  const T* kp = static_cast<const T*>(p.k_pool);
  const T* vp = static_cast<const T*>(p.v_pool);

  // the q tile, scaled, in fp32; vector v is row t0 + v/g, head kv*g + v%g
  for (int i = tid; i < kQV * d; i += kThreads) {
    const int v = i / d, e = i - v * d;
    const int t = t0 + v / g;
    float x = 0.f;
    if (v < n_vec && t < c)
      x = to_f32(q[(static_cast<int64_t>(bi) * c + t) * row_stride +
                   static_cast<int64_t>(kv * g + v % g) * d + e]) *
          p.scale;
    Qs[v * dp + e] = x;
  }
  const int r = tid >> 4, cg = tid & 15;
  int qpos[kPerThread];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int v = r * kPerThread + i;
    const int t = t0 + v / g;
    qpos[i] = (v < n_vec && t < c) ? st + t : -1;  // -1 attends nothing
  }
  float m[kPerThread], l[kPerThread], acc[kPerThread][DC];
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) acc[i][cc] = 0.f;
  }

  for (int kb = 0; kb < key_end; kb += kBK) {
    __syncthreads();  // the previous tile is consumed
    if (tid < kBK) {
      const int pos = kb + tid;
      int64_t off = -1;
      if (pos < key_end) {
        const int page =
            p.tables[static_cast<int64_t>(bi) * p.pp + pos / p.ps];
        if (static_cast<unsigned>(page) < static_cast<unsigned>(p.num_pages))
          off = static_cast<int64_t>(page) * page_stride + kv * head_stride +
                static_cast<int64_t>(pos % p.ps) * d;
      }
      koff[tid] = off;
    }
    __syncthreads();
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int k = i / d, e = i - k * d;
      const int64_t off = koff[k];
      float kx = 0.f, vx = 0.f;
      if (off >= 0) {
        kx = to_f32(kp[off + e]);
        vx = to_f32(vp[off + e]);
      }
      Ks[k * dp + e] = kx;
      Vs[k * d + e] = vx;
    }
    __syncthreads();

    // scores of the thread's 4 query vectors against keys cg and cg+16
    float s[kPerThread][2];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) s[i][0] = s[i][1] = 0.f;
    const float* k0 = Ks + cg * dp;
    const float* k1 = Ks + (cg + 16) * dp;
    const float* qr = Qs + r * kPerThread * dp;
#pragma unroll 4
    for (int e = 0; e < d; ++e) {
      const float a0 = k0[e], a1 = k1[e];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const float qq = qr[i * dp + e];
        s[i][0] = fmaf(qq, a0, s[i][0]);
        s[i][1] = fmaf(qq, a1, s[i][1]);
      }
    }
    // mask, then the online softmax over the 16 threads of each vector
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kk = cg + 16 * j;
        const bool ok = koff[kk] >= 0 && kb + kk <= qpos[i];
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group16_max(mx);
      const float mn = fmaxf(m[i], mx);
      const float mu = mn == -INFINITY ? 0.f : mn;  // nothing seen yet
      const float alpha = expf(m[i] - mu);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float pr = expf(s[i][j] - mu);  // masked: exp(-inf) = 0
        Ps[(r * kPerThread + i) * (kBK + 1) + cg + 16 * j] = pr;
        sum += pr;
      }
      l[i] = l[i] * alpha + group16_sum(sum);
      m[i] = mn;
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) acc[i][cc] *= alpha;
    }
    __syncthreads();
    // acc += P . V over the tile
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float pr[kPerThread];
#pragma unroll
      for (int i = 0; i < kPerThread; ++i)
        pr[i] = Ps[(r * kPerThread + i) * (kBK + 1) + k];
      const float* vrow = Vs + k * d;
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const int col = cg + 16 * cc;
        const float vv = col < d ? vrow[col] : 0.f;
#pragma unroll
        for (int i = 0; i < kPerThread; ++i)
          acc[i][cc] = fmaf(pr[i], vv, acc[i][cc]);
      }
    }
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < kPerThread; ++i) {
    const int v = r * kPerThread + i;
    const int t = t0 + v / g;
    if (v >= n_vec || t >= c) continue;
    T* orow = out + (static_cast<int64_t>(bi) * c + t) * row_stride +
              static_cast<int64_t>(kv * g + v % g) * d;
#pragma unroll
    for (int cc = 0; cc < DC; ++cc) {
      const int col = cg + 16 * cc;
      if (col < d)
        orow[col] = from_f32<T>(l[i] > 0.f ? acc[i][cc] / l[i] : 0.f);
    }
  }
}

template <typename T, int DC>
int launch(const Params& p, int b, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.d);
  static size_t smem_set = 0;  // the opt-in this instantiation was given
  if (smem > 48 * 1024 && smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel<T, DC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const dim3 grid((p.c + p.rows - 1) / p.rows, p.n_kv, b);
  paged_prefill_kernel<T, DC><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Params& p, int b, cudaStream_t stream) {
  if (p.d <= 32) return launch<T, 2>(p, b, stream);
  if (p.d <= 64) return launch<T, 4>(p, b, stream);
  if (p.d <= 128) return launch<T, 8>(p, b, stream);
  return launch<T, 16>(p, b, stream);
}

}  // namespace

// Returns the cudaError_t of the launch. Shapes: q/out [b, c, n_q, d],
// pools [num_pages, n_kv, page_size, d] (all of `dtype`, contiguous),
// block_tables [b, pages_per_seq] and start [b] int32, on the device.
// n_q = n_kv * g with g <= 8, d <= 256.
extern "C" int ptt_paged_prefill_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const int* block_tables, const int* start, void* out, int dtype, int b,
    int c, int n_q, int n_kv, int d, int page_size, int pages_per_seq,
    int num_pages, float scale, void* stream) {
  if (b == 0 || c == 0) return 0;
  if (n_kv <= 0 || n_q % n_kv != 0 || n_q / n_kv > 8 || n_q == 0 || d <= 0 ||
      d > 256 || page_size <= 0 || pages_per_seq <= 0 || num_pages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = n_q / n_kv;
  const Params p{q,         k_pool,        v_pool,    block_tables,
                 start,     out,           c,         n_q,
                 n_kv,      g,             d,         page_size,
                 pages_per_seq, num_pages, kQV / g,   scale};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32) return dispatch_d<float>(p, b, st);
  if (dtype == ptt::kBF16) return dispatch_d<__nv_bfloat16>(p, b, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
