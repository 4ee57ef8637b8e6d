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
// Design (a8w8_mma). The products run on the int8 tensor cores:
// mma.sync m16n8k32 s8 x s8 -> s32 (SASS IMMA), 4,096 products a warp
// instruction. A block of 4 warps owns 128 output columns (32 a warp) and
// <= 64 rows (grid.z covers more; a kernel for <= 32 rows holds half the
// accumulators) and walks one K slice in 64-row k-steps through a 3-stage
// cp.async ring of the W tile (8 KB) and the x slice, rows past M
// zero-filled. x is K-contiguous: its A fragments come by
// ldmatrix (an int8 row of 16 bytes is an 8 x 8 b16 matrix row). W is
// N-contiguous and the instruction wants 4 consecutive k of one column in
// a register: lane l = 4 g + a reads the 32-bit words at rows 4 a + i (i <
// 4; and +16) of the word column g of its warp's 32 columns and transposes
// the 4 x 4 bytes with __byte_perm, so its register j holds column 4 g + j
// at k 4 a .. 4 a + 3, a valid B fragment of column g of an n8 tile. The
// four products j = 0..3 cover columns {j, j + 4, ..., j + 28}: in that
// stride-4 order lane l ends holding columns 8 a .. 8 a + 7 of rows g and
// g + 8, which the epilogue stores as they stand. The W tile's 16-byte
// chunks are swizzled by row (chunk c of row r at c ^ 2 ((r / 4) % 4)) so
// the 32 lanes' word reads hit 32 banks.
// Split-K fills the card, as B2 (csrc/stream_linear.cu): the wrapper's
// a8w8_plan picks the split from the shapes and the SM count (about two
// blocks an SM, at most 8 slices of at least two k-steps: QKV runs 288
// blocks, FFN1 320, O-proj and FFN2 128). With more than one slice each
// block stores its int32 partial to the stream's workspace, takes a ticket
// from its column tile's counter after a fence, and the tile's last block
// sums the partials in split order (integers: the same bits whichever
// block comes last), runs the float epilogue once and sets the counter
// back to 0 for the next launch. One slice: the epilogue runs from
// registers. That merge is a serial tail a launch, one SM a tile reading
// every slice (on an H100 at 700 W, about 4 us for one slice plus 0.5
// us a slice more; probe_decode_attn.py's b5_* variants): hence the cap
// of 8 slices.
//
// Bound: bytes — the int8 W stream: the d2048 projections are 12.6 MB
// (QKV), 4.2 MB (O), 16.8 MB (FFN1, FFN2) a layer, 15 us for the four at
// 3.35 TB/s. x is read once a column tile and K slice (a quarter of the
// W bytes at M 32, mostly from the L2), the int32 partials written and
// read once.
#include "common.cuh"

namespace {

using ptt::load_dt;
using ptt::store_dt;

constexpr int kBN = 128;               // output columns a block, 32 a warp
constexpr int kThreads = 128;
constexpr int kBK = 64;                // K rows a k-step: two m16n8k32 steps
constexpr int kRows = 64;              // rows a block; grid.z covers more
constexpr int kStages = 3;
constexpr int kWStage = kBK * kBN;     // bytes: 128-byte rows, swizzled
constexpr int kXPitch = kBK + 16;      // bytes an x row (ldmatrix: no bank
                                       // conflict over 8 rows)
constexpr int kSmemMax = kStages * (kWStage + kRows * kXPitch);

struct Params {
  const int8_t* x;
  const float* xs;
  const int8_t* w;
  const float* ws;
  const void* bias;
  void* out;
  int* part;      // [split][M][N] int32 partials (split > 1)
  int* counters;  // a ticket per (row block, column tile), 0 between calls
  int bias_dt, out_dt;
  int M, K, N, act;
  int split, steps;  // K slices, and k-steps in each
};

// c += A B: int8 m16n8k32 with exact int32 sums
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// byte offset of 16-byte chunk c of W tile row r
__device__ __forceinline__ int w_chunk(int r, int c) {
  return r * kBN + ((c ^ (((r >> 2) & 3) << 1)) << 4);
}

// B fragments of k rows kb .. kb + 15 for the four n8 products of the
// warp's columns: the lane's words at rows kb + 4 a + i of its word column
// g, transposed to one word of 4 k a column (byte 0 the lowest k)
__device__ __forceinline__ void w_frags(const int8_t* tw, int kb, int warp,
                                        int lane, uint32_t (&b)[4]) {
  const int a = lane & 3, g = lane >> 2;
  const int off = ((2 * warp + (g >> 2)) ^ (a << 1)) * 16 + (g & 3) * 4;
  uint32_t wr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    wr[i] = *reinterpret_cast<const uint32_t*>(tw + (kb + 4 * a + i) * kBN +
                                               off);
  const uint32_t lo01 = __byte_perm(wr[0], wr[1], 0x5140);
  const uint32_t hi01 = __byte_perm(wr[0], wr[1], 0x7362);
  const uint32_t lo23 = __byte_perm(wr[2], wr[3], 0x5140);
  const uint32_t hi23 = __byte_perm(wr[2], wr[3], 0x7362);
  b[0] = __byte_perm(lo01, lo23, 0x5410);
  b[1] = __byte_perm(lo01, lo23, 0x7632);
  b[2] = __byte_perm(hi01, hi23, 0x5410);
  b[3] = __byte_perm(hi01, hi23, 0x7632);
}

// One row's W sums of columns n .. n + W - 1 into out: the dequant in the
// plain version's rounding order (no contraction into an FMA), bias,
// activation. Callers read every scale first (`xs`, `ws`, `b`): a load
// after a store through another pointer may not move above it, so a
// scale read per element waited an L2 round trip an element.
template <int W>
__device__ __forceinline__ void finish_cols(const Params& p, int m, int n,
                                            float xs, const float (&ws)[W],
                                            const float (&b)[W],
                                            const int (&acc)[W]) {
#pragma unroll
  for (int e = 0; e < W; ++e) {
    float v = __fmul_rn(__fmul_rn(static_cast<float>(acc[e]), xs), ws[e]);
    if (p.bias) v = __fadd_rn(v, b[e]);
    v = ptt::activate(v, p.act);
    store_dt(p.out, static_cast<int64_t>(m) * p.N + n + e, p.out_dt, v);
  }
}

// the per-column scales and bias of columns n .. n + W - 1
template <int W>
__device__ __forceinline__ void load_cols(const Params& p, int n,
                                          float (&ws)[W], float (&b)[W]) {
#pragma unroll
  for (int e = 0; e < W; ++e) {
    ws[e] = p.ws[n + e];
    b[e] = p.bias ? load_dt(p.bias, n + e, p.bias_dt) : 0.f;
  }
}

// Block (column tile, K slice, row block), with at most G m16 row groups
// (G = 2 at M <= 32 holds half the accumulators: ptxas gave it 93
// registers against 144 at G = 4).
template <int G>
__global__ void __launch_bounds__(kThreads, 2) a8w8_mma(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ticket;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kBN, slice = blockIdx.y;
  const int m0 = blockIdx.z * kRows;
  const int rows = min(kRows, p.M - m0);
  const int groups = (rows + 15) / 16;  // m16 groups with live rows
  const int kt0 = slice * p.steps;
  const int nk = min(p.steps, (p.K + kBK - 1) / kBK - kt0);
  const int x_stage = groups * 16 * kXPitch;  // bytes
  int8_t* sw = reinterpret_cast<int8_t*>(smem);  // [kStages] W tiles
  int8_t* sx = sw + kStages * kWStage;           // [kStages] x slices

  auto load = [&](int t, int s) {
    const int k0 = (kt0 + t) * kBK;
    constexpr int wc = kBN / 16;  // 16-byte chunks a W row
    for (int c = tid; c < kBK * wc; c += kThreads) {
      const int r = c / wc, cc = c % wc;
      const int k = k0 + r, n = n0 + cc * 16;
      const bool ok = k < p.K && n < p.N;
      ptt::cp_async16(sw + s * kWStage + w_chunk(r, cc),
                      ok ? p.w + static_cast<int64_t>(k) * p.N + n : p.w,
                      ok ? 16 : 0);
    }
    constexpr int xc = kBK / 16;  // 16-byte chunks an x row
    for (int c = tid; c < groups * 16 * xc; c += kThreads) {
      const int r = c / xc, kk = (c % xc) * 16;
      const int k = k0 + kk;
      const bool ok = r < rows && k < p.K;
      ptt::cp_async16(sx + s * x_stage + r * kXPitch + kk,
                      ok ? p.x + static_cast<int64_t>(m0 + r) * p.K + k : p.x,
                      ok ? 16 : 0);
    }
  };

  int acc[G][4][4];  // [m16 group][product j][fragment]
#pragma unroll
  for (int mi = 0; mi < G; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    ptt::cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    ptt::cp_async_wait<kStages - 2>();  // k-step t has landed
    __syncthreads();  // ... for every thread; the stage of t-1 is free
    const int nt = t + kStages - 1;
    if (nt < nk) load(nt, nt % kStages);
    ptt::cp_async_commit();
    const int8_t* tw = sw + (t % kStages) * kWStage;
    const int8_t* tx = sx + (t % kStages) * x_stage;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t b0[4], b1[4];
      w_frags(tw, ks * 32, warp, lane, b0);
      w_frags(tw, ks * 32 + 16, warp, lane, b1);
#pragma unroll
      for (int mi = 0; mi < G; ++mi) {
        if (mi >= groups) continue;  // block-uniform
        uint32_t a0, a1, a2, a3;
        ptt::ldmatrix_x4(a0, a1, a2, a3,
                         tx + (mi * 16 + (lane & 15)) * kXPitch + ks * 32 +
                             (lane >> 4) * 16);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[mi][j], a0, a1, a2, a3, b0[j], b1[j]);
      }
    }
  }
  ptt::cp_async_wait<0>();

  // product j's fragment e: row 16 mi + g + 8 (e / 2), column 4 (2 a + e %
  // 2) + j of the warp's: the lane's 8 columns 8 a .. 8 a + 7 of each row
  const int g = lane >> 2, a = lane & 3;
  const int nc = n0 + warp * 32 + 8 * a;  // N % 16 == 0: 8 columns in or out
  if (p.split == 1) {
    if (nc >= p.N) return;
    float ws[8], b[8], xs[G][2];
    load_cols<8>(p, nc, ws, b);
#pragma unroll
    for (int mi = 0; mi < G; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mi * 16 + g + 8 * h;
        xs[mi][h] = r < rows ? p.xs[m0 + r] : 0.f;
      }
#pragma unroll
    for (int mi = 0; mi < G; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mi * 16 + g + 8 * h;
        if (r >= rows) continue;
        const int v[8] = {acc[mi][0][2 * h],     acc[mi][1][2 * h],
                          acc[mi][2][2 * h],     acc[mi][3][2 * h],
                          acc[mi][0][2 * h + 1], acc[mi][1][2 * h + 1],
                          acc[mi][2][2 * h + 1], acc[mi][3][2 * h + 1]};
        finish_cols<8>(p, m0 + r, nc, xs[mi][h], ws, b, v);
      }
    return;
  }
  // this slice's partial
  if (nc < p.N) {
    int* part = p.part + static_cast<int64_t>(slice) * p.M * p.N;
#pragma unroll
    for (int mi = 0; mi < G; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mi * 16 + g + 8 * h;
        if (r >= rows) continue;
        int4* dst = reinterpret_cast<int4*>(
            part + static_cast<int64_t>(m0 + r) * p.N + nc);
        dst[0] = make_int4(acc[mi][0][2 * h], acc[mi][1][2 * h],
                           acc[mi][2][2 * h], acc[mi][3][2 * h]);
        dst[1] = make_int4(acc[mi][0][2 * h + 1], acc[mi][1][2 * h + 1],
                           acc[mi][2][2 * h + 1], acc[mi][3][2 * h + 1]);
      }
  }
  __threadfence();
  __syncthreads();
  const int cid = blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) ticket = atomicAdd(p.counters + cid, 1);
  __syncthreads();
  if (ticket != p.split - 1) return;
  __threadfence();  // every partial of the tile is visible

  // the tile's last block: partials summed in split order, 8 columns a
  // thread; an item's scales are loaded first, beside its partials (a
  // load after a store through another pointer may not move above it)
  const int octs = min(kBN, p.N - n0) / 8;
  const int64_t plane = static_cast<int64_t>(p.M) * p.N / 4;  // int4s
  for (int i = tid; i < rows * octs; i += kThreads) {
    const int r = i / octs, c = n0 + (i % octs) * 8;
    const int4* src = reinterpret_cast<const int4*>(
        p.part + static_cast<int64_t>(m0 + r) * p.N + c);
    float ws[8], b[8];
    load_cols<8>(p, c, ws, b);
    const float xs = p.xs[m0 + r];
    int v[8] = {};
    for (int s = 0; s < p.split; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int4 q = __ldcg(src + s * plane + h);
        v[4 * h] += q.x;
        v[4 * h + 1] += q.y;
        v[4 * h + 2] += q.z;
        v[4 * h + 3] += q.w;
      }
    }
    finish_cols<8>(p, m0 + r, c, xs, ws, b, v);
  }
  if (tid == 0) p.counters[cid] = 0;  // ready for the next launch
}

}  // namespace

// Returns the cudaError_t of the launch. x_q [M, K] and w [K, N] int8,
// contiguous and 16-byte aligned, K and N multiples of 16; x_scale [M]
// and w_scale [N] float32; bias [N] (may be null) and out [M, N] carry
// their own dtype codes. `split` K slices of `steps` 64-row k-steps (the
// wrapper's a8w8_plan); with split > 1, ws holds split * M * N int32
// partials and counters one int per (row block, 128-column tile), all 0
// between calls.
extern "C" int ptt_stream_linear_a8w8(const void* x_q, const void* x_scale,
                                      const void* w, const void* w_scale,
                                      const void* bias, int bias_dt,
                                      void* out, int out_dt, int M, int K,
                                      int N, int activation, void* ws,
                                      int* counters, int split, int steps,
                                      void* stream) {
  if (M == 0 || N == 0) return 0;
  const int nk = (K + kBK - 1) / kBK;
  if (K % 16 || N % 16 || split < 1 || steps < 1 || split > 65535 ||
      static_cast<int64_t>(split - 1) * steps >= nk ||
      static_cast<int64_t>(split) * steps < nk ||
      (split > 1 && (!ws || !counters)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{static_cast<const int8_t*>(x_q),
                 static_cast<const float*>(x_scale),
                 static_cast<const int8_t*>(w),
                 static_cast<const float*>(w_scale),
                 bias, out, static_cast<int*>(ws), counters, bias_dt, out_dt,
                 M, K, N, activation, split, steps};
  const int rows = M < kRows ? M : kRows;
  const int groups = (rows + 15) / 16;
  const size_t smem =
      kStages * (kWStage + static_cast<size_t>(groups) * 16 * kXPitch);
  const dim3 grid((N + kBN - 1) / kBN, split, (M + kRows - 1) / kRows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  static bool attr_set[64] = {};  // per device, set once
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !attr_set[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        a8w8_mma<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          a8w8_mma<4>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) attr_set[dev] = true;
  }
  if (groups <= 2)
    a8w8_mma<2><<<grid, kThreads, smem, st>>>(p);
  else
    a8w8_mma<4><<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
