// int8 x int8 weight-streaming GEMM with int32 accumulation (A8W8).
//
// ptt_stream_linear_a8w8 replaces the TPU kernel _stream_linear_a8w8
// (paddle_tpu/nn/functional/stream_linear.py:144, pallas_call at :206):
//     out[M, N] = act(float(x_q[M, K] @ w[K, N]) * x_scale[m] * w_scale[n]
//                     + bias[n])
// x_q holds the activations quantized per token (the wrapper runs the
// dynamic act-quant as PyTorch ops, as the JAX package runs it in XLA
// ahead of its kernel); w is one layer of a contiguous int8 [L, K, N]
// stack, passed by its pointer. The integer sum is exact in int32, so
// the accumulator equals the plain version's bit for bit; the dequant
// rounds (acc * x_scale) then (* w_scale) then (+ bias) one by one, in
// the plain version's order.
//
// Design. As csrc/stream_linear.cu: a block owns a strip of 32 output
// columns and <= 64 rows and walks K in tiles of 256 (8 KB of W) through
// a 4-stage cp.async ring, with 256 threads in 4x4 register tiles split
// into k-groups whose partials meet in shared memory. The products run
// on __dp4a (four int8 products summed into an int32 per instruction):
// x is K-contiguous, so four consecutive k of one row are one word; W is
// N-contiguous, so a thread reads one word (4 columns) from each of 4
// consecutive k rows of the tile and transposes the 4x4 bytes with
// __byte_perm into one word of 4 k per column.
//
// Bound: bytes — the int8 W stream: the d2048 projections are 12.6 MB
// (QKV), 4.2 MB (O), 16.8 MB (FFN1, FFN2) per layer, 3.8 / 1.3 / 5.0 us
// at 3.35 TB/s; at M = 32 the dp4a rate (about 4x the fp32 FMA rate)
// keeps the products below that. Tensor-core tiles (mma/wgmma s8) and a
// fused act-quant are later work.
#include "common.cuh"

namespace {

using ptt::load_dt;
using ptt::store_dt;

constexpr int kThreads = 256;
constexpr int kBN = 32;   // output columns per block
constexpr int kTN = 4;    // columns per thread
constexpr int kTM = 4;    // rows per thread
constexpr int kColGroups = kBN / kTN;
constexpr int kMaxRows = 64;  // rows per block; grid.y covers the rest
constexpr int kStages = 4;
constexpr int kBK = 256;             // K per stage: 8 KB of W
constexpr int kXPitch = kBK + 16;    // x row pitch in shared memory, bytes
constexpr int kWStageBytes = kBK * kBN;
constexpr int kRedBytes = kThreads / kColGroups * kTM * kBN * 4;

struct Params {
  const int8_t* x;
  const float* xs;
  const int8_t* w;
  const float* ws;
  const void* bias;
  void* out;
  int bias_dt, out_dt;
  int M, K, N, act;
  int rg_log2;  // log2 of the 4-row groups a block covers
};

__global__ void __launch_bounds__(kThreads)
    a8w8_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rgs = 1 << p.rg_log2;
  const int rows_pad = rgs * kTM;
  const int kgroups = kThreads / (kColGroups * rgs);
  const int kpg = kBK / kgroups;  // k per group per tile, a multiple of 8
  const int tid = threadIdx.x;
  const int cg = tid % kColGroups;
  const int rg = (tid / kColGroups) & (rgs - 1);
  const int kg = tid / (kColGroups * rgs);
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kMaxRows;
  const int rows = min(kMaxRows, p.M - m0);
  const int x_stage = rows_pad * kXPitch;
  int8_t* sw = reinterpret_cast<int8_t*>(smem);   // [kStages][kBK][kBN]
  int8_t* sx = sw + kStages * kWStageBytes;       // [kStages][rows][pitch]

  auto load_tile = [&](int t, int s) {
    const int k0 = t * kBK;
    constexpr int wc = kBN / 16;  // 16-byte chunks per W tile row
    for (int c = tid; c < kBK * wc; c += kThreads) {
      const int r = c / wc, cc = (c % wc) * 16;
      const int k = k0 + r, n = n0 + cc;
      const bool ok = k < p.K && n < p.N;
      ptt::cp_async16(sw + s * kWStageBytes + r * kBN + cc,
                      ok ? p.w + static_cast<int64_t>(k) * p.N + n : p.w,
                      ok ? 16 : 0);
    }
    constexpr int xc = kBK / 16;  // 16-byte chunks per x row
    for (int c = tid; c < rows_pad * xc; c += kThreads) {
      const int r = c / xc, kk = (c % xc) * 16;
      const int k = k0 + kk;
      const bool ok = r < rows && k < p.K;
      ptt::cp_async16(sx + s * x_stage + r * kXPitch + kk,
                      ok ? p.x + static_cast<int64_t>(m0 + r) * p.K + k : p.x,
                      ok ? 16 : 0);
    }
  };

  int acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  const int ntiles = (p.K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_tile(s, s);
    ptt::cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    ptt::cp_async_wait<kStages - 2>();  // tile t has landed
    __syncthreads();                    // ... for every thread; and stage
                                        // (t-1) % kStages is free again
    const int nt = t + kStages - 1;
    if (nt < ntiles) load_tile(nt, nt % kStages);
    ptt::cp_async_commit();
    const int8_t* tw = sw + (t % kStages) * kWStageBytes + cg * kTN;
    const int8_t* tx = sx + (t % kStages) * x_stage + rg * kTM * kXPitch;
    const int kb = kg * kpg;
#pragma unroll 2
    for (int kk = 0; kk < kpg; kk += 4) {
      const int k = kb + kk;
      // 4 k rows x 4 columns of W, one word per row ...
      uint32_t wr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wr[i] = *reinterpret_cast<const uint32_t*>(tw + (k + i) * kBN);
      // ... transposed to one word of 4 k per column
      const uint32_t lo01 = __byte_perm(wr[0], wr[1], 0x5140);
      const uint32_t hi01 = __byte_perm(wr[0], wr[1], 0x7362);
      const uint32_t lo23 = __byte_perm(wr[2], wr[3], 0x5140);
      const uint32_t hi23 = __byte_perm(wr[2], wr[3], 0x7362);
      const int wcol[kTN] = {
          static_cast<int>(__byte_perm(lo01, lo23, 0x5410)),
          static_cast<int>(__byte_perm(lo01, lo23, 0x7632)),
          static_cast<int>(__byte_perm(hi01, hi23, 0x5410)),
          static_cast<int>(__byte_perm(hi01, hi23, 0x7632))};
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int xr = *reinterpret_cast<const int*>(tx + i * kXPitch + k);
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = __dp4a(xr, wcol[j], acc[i][j]);
      }
    }
  }
  ptt::cp_async_wait<0>();
  __syncthreads();

  // k-group partials meet in shared memory (kRedBytes, over the ring)
  int* red = reinterpret_cast<int*>(smem);  // [kgroups][rows_pad][kBN]
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      red[(kg * rows_pad + rg * kTM + i) * kBN + cg * kTN + j] = acc[i][j];
  __syncthreads();
  for (int o = tid; o < rows_pad * kBN; o += kThreads) {
    const int r = o / kBN, c = o % kBN;
    const int n = n0 + c;
    if (r >= rows || n >= p.N) continue;
    int sum = 0;
    for (int s = 0; s < kgroups; ++s) sum += red[(s * rows_pad + r) * kBN + c];
    // the plain version's rounding order; no contraction into an FMA
    float v = __fmul_rn(__fmul_rn(static_cast<float>(sum), p.xs[m0 + r]),
                        p.ws[n]);
    if (p.bias) v = __fadd_rn(v, load_dt(p.bias, n, p.bias_dt));
    v = ptt::activate(v, p.act);
    store_dt(p.out, static_cast<int64_t>(m0 + r) * p.N + n, p.out_dt, v);
  }
}

size_t a8w8_smem(int rows_pad) {
  const size_t ring =
      kStages * (kWStageBytes + static_cast<size_t>(rows_pad) * kXPitch);
  return ring > kRedBytes ? ring : kRedBytes;
}

}  // namespace

// Returns the cudaError_t of the launch. x_q [M, K] and w [K, N] int8,
// contiguous and 16-byte aligned, K and N multiples of 16; x_scale [M]
// and w_scale [N] float32; bias [N] (may be null) and out [M, N] carry
// their own dtype codes.
extern "C" int ptt_stream_linear_a8w8(const void* x_q, const void* x_scale,
                                      const void* w, const void* w_scale,
                                      const void* bias, int bias_dt,
                                      void* out, int out_dt, int M, int K,
                                      int N, int activation, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K % 16 || N % 16) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = M < kMaxRows ? M : kMaxRows;
  int rg_log2 = 0;
  while ((1 << rg_log2) * kTM < rows) ++rg_log2;
  const Params p{static_cast<const int8_t*>(x_q),
                 static_cast<const float*>(x_scale),
                 static_cast<const int8_t*>(w),
                 static_cast<const float*>(w_scale),
                 bias, out, bias_dt, out_dt, M, K, N, activation, rg_log2};
  cudaError_t err = cudaFuncSetAttribute(
      a8w8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(a8w8_smem(kMaxRows)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBN - 1) / kBN, (M + kMaxRows - 1) / kMaxRows);
  a8w8_kernel<<<grid, kThreads, a8w8_smem((1 << rg_log2) * kTM),
                static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
