// Decode attention backends over the page-major paged KV pool: three
// kernels behind FLAGS_paged_attention_backend.
//
// Replace the TPU kernels of paddle_tpu/nn/functional/paged_attention.py:
//   B7 ptt_paged_stream  _stream_paged (:341, pallas_call at :474), the
//                        pool-streaming kernel (backend "stream");
//   B8 ptt_paged_fused   _fused_paged (:145, pallas_call at :272), one
//                        program per sequence (backend "fused");
//   B9 ptt_paged_pallas  _pallas_paged (:89), the stock JAX Pallas paged
//                        attention kernel (backend "pallas").
// Python wrappers: paddle_tpu_torch/nn/functional/paged_attention.py
// (stream_paged, fused_paged, pallas_paged), whose plain versions define
// what each computes.
//
// All three: single-token decode attention, q [b, n_kv * g, d] (the g
// query heads of kv head h are heads h*g .. h*g+g-1), pools [pages, n_kv,
// page_size, d] page-major and head-major within a page (a head's slice
// of a page is a contiguous [page_size, d] block), seq_lens [b] int32 the
// tokens attended (t < seq_lens), softmax scale `scale`, f32 statistics,
// output in q's dtype. A row that attends nothing gets exactly 0.
//
// B7 keeps the TPU design: the layer region's tokens are streamed once,
// in chunks of kChunk = 64 region tokens, and every query row is served
// from each chunk, so a K/V byte of the region is read at most once per
// call. The TPU grid walks the chunks in order and carries an online
// softmax in VMEM. Here (bf16, stream_walk_bf16) a kv head's chunks are cut
// into runs, one block a run, about two blocks an SM in all (the wrapper's
// stream_walk); a block walks its run through a 2-stage cp.async ring,
// folds its chunks by log-sum-exp in registers and writes one f32 state per
// (block, row); a second launch (stream_merge) merges the head's states, a
// few a row. A page that no row holds is not read. float32 keeps one block
// per (chunk, kv head) writing the chunk's partials, merged alike. The mask is the block
// tables': token (p, s) of the region is valid for row r when membership
// [r, p] = j >= 0 and j * page_size + s < seq_lens[r] (membership is the
// wrapper's pool_membership, built on the device); a page two rows hold
// is read by both. (The TPU kernel masks with a one-owner map, wrong for
// shared pages.) As the TPU kernel, B7 casts the probabilities to the
// pool's dtype before the value product (p relative to the chunk's max).
//
// B8 keeps the TPU grid: one block per sequence walking its table's pages
// in order, the next K/V slice in flight (a 2-stage cp.async ring of
// 16-token slices per warp, one kv head a warp: a whole page of all heads,
// 64 KB a side at the d2048 rung, would not fit twice), with an online
// softmax. Pages past the row's length hold no attended token and are not
// read. B9 keeps the stock kernel's schedule: one block per (sequence, kv
// head), compute blocks of `ppcb` pages, lengths masked per compute block,
// and its renormalising update o = (l_prev a o + b o_cur) / l_next; the
// 4 warps of a block share each compute block's slices and merge. The
// stock kernel wants a [n_kv, pages, ps, d] pool, which the reference
// makes by transposing the whole pool on every call; B9 reads the
// page-major pool in place. B8 and B9 take absolute page ids; a page id
// outside the pool is never read (its tokens are masked).
//
// Dtypes. bf16 runs on the tensor cores (mma.sync m16n8k16 from ldmatrix
// fragments, flash_tiles.cuh): S = Q K^T with q's raw bf16 values and the
// scale applied to the f32 scores; in B8 and B9 the probabilities enter
// P V as a bf16 pair (hi + lo), so they are rounded to 2^-17 and not to
// bf16 (the TPU's DEFAULT precision rounds them to bf16; the plain
// versions keep f32). float32 runs on the CUDA cores.
//
// Bounds (H100 SXM: 3.35 TB/s). Decode attention does 4 flops a K/V row
// pair per query head: far below the card's balance, so bytes bound all
// three: B8 and B9 read the attended K/V rows once; B7 the pages some row
// holds once, plus its f32 workspace (bf16: a state per block and row). B8's grid of b blocks fills a
// quarter of the SMs at b 32; wgmma, TMA page loads and a split of long
// rows are later work.
#include <type_traits>

#include "flash_tiles.cuh"

namespace {

using namespace ptt::tiles;
using ptt::cp_async16;
using ptt::cp_async_commit;
using ptt::cp_async_wait;
using ptt::from_f32;
using ptt::to_f32;

constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;  // the TPU kernels' NEG
constexpr int kChunk = 64;      // B7: region tokens a chunk (the wrapper's
                                // STREAM_KERNEL_CHUNK)
constexpr int kRows = 64;       // B7 bf16: query rows a pass, 16 a warp
constexpr int kRing = 2;        // B7 bf16: chunks in flight
constexpr int kSub = 16;        // B8/B9: key rows of a slice
constexpr int kUnroll = 4;      // f32: K/V rows a warp keeps in flight

struct PagedParams {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const int* seq_lens;
  const int* tables;  // B7: membership [b, pool_pages]; B8/B9 [b, pp]
  void* out;
  float* ws_ml;   // B7: [n_kv, nch_blocks, b*g, 2] (m, l)
  float* ws_acc;  // B7: [n_kv, nch_blocks, b*g, d]
  int b, n_kv, g, d, ps, pp, pool_base, pool_pages, num_pages, ppcb, nch;
  int ps_shift;    // B7 bf16: log2(page_size) for a power of two, else -1
  int nch_blocks;  // B7: blocks a kv head (f32: one a chunk)
  int cpb;         // B7 bf16: chunks a block's run
  int run_pages;   // B7 bf16: region pages a run spans, at most
  float scale;
};

// element offset of row gi of kv head h's group in batch row bi of q/out
__device__ __forceinline__ int64_t q_at(const PagedParams& p, int bi, int h,
                                        int gi) {
  return ((static_cast<int64_t>(bi) * p.n_kv + h) * p.g + gi) * p.d;
}

// element offset of slot s of head h in absolute page pg of a pool
__device__ __forceinline__ int64_t pool_at(const PagedParams& p, int pg,
                                           int h, int s) {
  return ((static_cast<int64_t>(pg) * p.n_kv + h) * p.ps + s) * p.d;
}

// ---------------------------------------------------------------- B7

// One block per (run of chunks, kv head): the run's chunks walked through a
// 2-stage cp.async ring, every query row of the head served from each
// chunk, rows in passes of 64 (16 a warp). Per pass the block stages the
// q tile and its batch rows' membership columns of the run's pages once;
// a page no row of the pass holds (every membership entry -1) is not
// read, and a chunk with no such page is skipped. Each chunk's
// probabilities are taken against the chunk's own max and rounded to bf16
// for P V; a warp folds its chunks' (m, l, acc) into one running state by
// log-sum-exp in f32 registers (acc scaled before and after the product,
// so the chunk's p is never rescaled). The pass's states go to the
// workspace, one per (block, row), which stream_merge folds into the
// output.
template <int D>
__global__ void __launch_bounds__(kThreads)
    stream_walk_bf16(const PagedParams p) {
  constexpr int kPitch = TileBf16<D>::kPitch, kVec = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);  // [kRows][kPitch]
  bf16* ring = sq + kRows * kPitch;          // [kRing][K, V][kChunk][kPitch]
  // per batch row of the pass: its valid slots of each run page, then one
  // bit a run token (32 a word)
  int* nvalid = reinterpret_cast<int*>(ring + kRing * 2 * kChunk * kPitch);
  unsigned* vbits =
      reinterpret_cast<unsigned*>(nvalid + kRows * p.run_pages);
  const int n_words = 2 * p.cpb;  // run tokens / 32
  unsigned* live = vbits + kRows * n_words;
  int* list = reinterpret_cast<int*>(live + (p.run_pages + 31) / 32);
  int* misc = list + p.cpb;  // the number of live chunks, then the lengths
                             // of the pass's batch rows
  float* xmax = reinterpret_cast<float*>(misc + 1 + kRows);  // [4][16]
  const int blk = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, t = lane & 3;
  const int T = p.pool_pages * p.ps, bg = p.b * p.g;
  const int c0 = blk * p.cpb, c1 = min(p.nch, c0 + p.cpb);
  // tok / page_size, a shift for a power of two
  auto div_ps = [&](int tok) {
    return p.ps_shift >= 0 ? tok >> p.ps_shift : tok / p.ps;
  };
  const int pg0 = div_ps(c0 * kChunk);  // the run's first region page
  const int n_pg = min(p.pool_pages, div_ps(c1 * kChunk + p.ps - 1)) - pg0;
  const bf16* kp = static_cast<const bf16*>(p.k_pool);
  const bf16* vp = static_cast<const bf16*>(p.v_pool);
  const bf16* q = static_cast<const bf16*>(p.q);
  const int n_rt = (bg + kRows - 1) / kRows;

  for (int rt = 0; rt < n_rt; ++rt) {
    const int r0 = rt * kRows;
    const int bi0 = r0 / p.g;
    const int nb = min(p.b, (min(bg, r0 + kRows) - 1) / p.g + 1) - bi0;
    __syncthreads();  // the previous pass is done with shared memory
    // the q tile (rows past bg zero) by cp.async; the valid slots of each
    // (batch row, run page) from the membership columns meanwhile: j * ps
    // + s < seq_lens for the page's table index j >= 0
    for (int i = tid; i < kRows * kVec; i += kThreads) {
      const int r = i / kVec, e = (i % kVec) * 8, row = r0 + r;
      const bool in = row < bg;
      const int64_t off = in ? q_at(p, row / p.g, h, row % p.g) + e : 0;
      cp_async16(sq + r * kPitch + e, q + off, in ? 16 : 0);
    }
    for (int i = tid; i < (n_pg + 31) / 32; i += kThreads) live[i] = 0u;
    if (tid < nb) misc[1 + tid] = p.seq_lens[bi0 + tid];
    // the membership entries, kStage a thread with their loads in flight
    // together, then their valid slots
    constexpr int kStage = 8;
    for (int i0 = 0; i0 < nb * n_pg; i0 += kThreads * kStage) {
      int jv[kStage];
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        const int i = i0 + k * kThreads + tid;
        jv[k] = -1;
        if (i < nb * n_pg) {
          const int lb = i / n_pg;
          jv[k] = p.tables[static_cast<int64_t>(bi0 + lb) * p.pool_pages +
                           pg0 + i - lb * n_pg];
        }
      }
      __syncthreads();  // the lengths are staged
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        const int i = i0 + k * kThreads + tid;
        if (i < nb * n_pg) {
          const int lb = i / n_pg, pg = i - lb * n_pg;
          const int left = misc[1 + lb] - jv[k] * p.ps;
          nvalid[lb * p.run_pages + pg] =
              jv[k] >= 0 ? max(0, min(p.ps, left)) : 0;
        }
      }
    }
    __syncthreads();
    for (int pg = tid; pg < n_pg; pg += kThreads) {
      bool any = false;
      for (int lb = 0; lb < nb && !any; ++lb)
        any = nvalid[lb * p.run_pages + pg] > 0;
      if (any) atomicOr(live + pg / 32, 1u << (pg % 32));
    }
    // word w of batch row lb: run tokens 32 w .. 32 w + 31, each page's
    // valid slots a run of ones from the page's first token
    for (int i = tid; i < nb * n_words; i += kThreads) {
      const int lb = i / n_words, w = i % n_words;
      const int tw = c0 * kChunk + 32 * w;  // region token of bit 0
      unsigned bits = 0u;
      for (int pg = div_ps(tw) - pg0; pg < n_pg && (pg + pg0) * p.ps < tw + 32;
           ++pg) {
        const int lo = (pg + pg0) * p.ps - tw;  // may be < 0
        const int hi = min(32, lo + nvalid[lb * p.run_pages + pg]);
        const int a = max(0, lo);
        if (hi > a)
          bits |= (hi - a == 32 ? 0xffffffffu : ((1u << (hi - a)) - 1u)) << a;
      }
      vbits[i] = bits;
    }
    __syncthreads();
    if (tid == 0) {  // the run's chunks that hold a live page, in order
      int n = 0;
      for (int c = c0; c < c1; ++c) {
        const int a = div_ps(c * kChunk) - pg0;
        const int z = min(n_pg - 1, div_ps((c + 1) * kChunk - 1) - pg0);
        bool any = false;
        for (int pg = a; pg <= z && !any; ++pg)
          any = (live[pg / 32] >> (pg % 32)) & 1u;
        if (any) list[n++] = c;
      }
      misc[0] = n;
    }
    __syncthreads();
    const int n_live = misc[0];

    // chunk list[i] into stage i % kRing: rows of a page the pass holds,
    // others zero-filled and not read
    auto issue = [&](int i) {
      const int c = list[i];
      bf16* sk = ring + (i % kRing) * 2 * kChunk * kPitch;
      bf16* sv = sk + kChunk * kPitch;
      for (int x = tid; x < kChunk * kVec; x += kThreads) {
        const int r = x / kVec, e = (x % kVec) * 8, tok = c * kChunk + r;
        const int pg = div_ps(tok) - pg0;
        const bool in = tok < T && ((live[pg / 32] >> (pg % 32)) & 1u);
        const int64_t off =
            in ? pool_at(p, p.pool_base + pg0 + pg, h,
                         tok - (pg0 + pg) * p.ps) + e
               : 0;
        cp_async16(sk + r * kPitch + e, kp + off, in ? 16 : 0);
        cp_async16(sv + r * kPitch + e, vp + off, in ? 16 : 0);
      }
    };
    if (n_live > 0) issue(0);
    cp_async_commit();  // with the q tile

    // a pass of at most 32 rows splits each chunk's keys between two warp
    // pairs: warp w takes row tile w & 1 and key half w >> 1, the pair
    // sharing the chunk's max through shared memory; otherwise warp w
    // takes row tile w and every key
    const bool split = bg - r0 <= 32;
    const int rtile = split ? (warp & 1) : warp, kh = split ? warp >> 1 : 0;
    // this thread's rows wr0 + gq (+ 8): their batch rows' bit words
    const int wr0 = r0 + rtile * 16;
    const unsigned* vrow[2];
    bool ok_row[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = wr0 + gq + rr * 8;
      ok_row[rr] = row < bg;
      vrow[rr] = vbits + ((ok_row[rr] ? row / p.g : bi0) - bi0) * n_words;
    }
    float mrun[2] = {kNeg, kNeg}, lrun[2] = {0.f, 0.f};
    float o[D / 8][4];
    zero(o);
    // chunk c from stage `stage`: this warp's KN keys (from key kh * KN)
    // folded into the running state. Every warp runs it (a warp without
    // rows computes masked scores and keeps nothing): the pair's exchange
    // is a block barrier.
    auto fold = [&](auto kn, int c, int stage) {
      constexpr int KN = decltype(kn)::value;
      const bf16* sk =
          ring + stage * 2 * kChunk * kPitch + kh * KN * kPitch;
      const bf16* sv = sk + kChunk * kPitch;
      float s[KN / 8][4];
      zero(s);
      mma_abt<KN, D>(s, sq + rtile * 16 * kPitch, sk);
      float mx[2] = {kNeg, kNeg};
      unsigned vb[2][KN / 32];  // [row][32-key word]
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int hw = 0; hw < KN / 32; ++hw)
          vb[rr][hw] = ok_row[rr]
                           ? vrow[rr][2 * (c - c0) + kh * (KN / 32) + hw]
                           : 0u;
#pragma unroll
      for (int nt = 0; nt < KN / 8; ++nt)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int rr = cc >> 1;
          const int bit = (nt & 3) * 8 + 2 * t + (cc & 1);
          const bool ok = (vb[rr][nt >> 2] >> bit) & 1u;
          const float x = ok ? s[nt][cc] * p.scale : -INFINITY;
          s[nt][cc] = x;
          mx[rr] = fmaxf(mx[rr], x);
        }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) mx[rr] = quad_max(mx[rr]);
      if (KN < kChunk) {  // the chunk's max over both key halves
        if (t == 0) {
          xmax[warp * 16 + gq] = mx[0];
          xmax[warp * 16 + 8 + gq] = mx[1];
        }
        __syncthreads();
        mx[0] = fmaxf(mx[0], xmax[(warp ^ 2) * 16 + gq]);
        mx[1] = fmaxf(mx[1], xmax[(warp ^ 2) * 16 + 8 + gq]);
      }
      // fold the chunk (m_c, l_c, p_c V) into the running state: a new
      // max rescales the state by e^(M - m_c); else the chunk's product
      // enters at weight b = e^(m_c - M), the state divided by b before
      // the product and multiplied after (a chunk 2^-40 below is dropped)
      float pre[2], post[2], lc[2] = {0.f, 0.f};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        pre[rr] = post[rr] = 1.f;
        if (mx[rr] > mrun[rr]) {
          pre[rr] = expf(mrun[rr] - mx[rr]);  // kNeg first: 0
          lrun[rr] *= pre[rr];
          mrun[rr] = mx[rr];
        } else if (mx[rr] > kNeg) {
          post[rr] = expf(mx[rr] - mrun[rr]);
          pre[rr] = post[rr] >= 0x1p-40f ? 1.f / post[rr] : 1.f;
        }
      }
#pragma unroll
      for (int nt = 0; nt < KN / 8; ++nt)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int rr = cc >> 1;
          float e = expf(s[nt][cc] - mx[rr]);  // masked: 0
          lc[rr] += e;
          if (post[rr] < 0x1p-40f) e = 0.f;
          s[nt][cc] = e;
        }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        lrun[rr] = fmaf(lc[rr], post[rr], lrun[rr]);
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          o[nt][2 * rr] *= pre[rr];
          o[nt][2 * rr + 1] *= pre[rr];
        }
      }
      mma_xb<KN, D>(o, s, sv);  // p packed to bf16, as the TPU kernel
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        if (post[rr] == 1.f || post[rr] < 0x1p-40f) continue;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          o[nt][2 * rr] *= post[rr];
          o[nt][2 * rr + 1] *= post[rr];
        }
      }
    };
    for (int i = 0; i < n_live; ++i) {
      if (i + 1 < n_live) issue(i + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // chunk i (and the q tile) landed
      if (split)
        fold(std::integral_constant<int, kChunk / 2>(), list[i], i % kRing);
      else
        fold(std::integral_constant<int, kChunk>(), list[i], i % kRing);
      __syncthreads();  // the stage is refilled by the next chunk
    }
    cp_async_wait<0>();
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) lrun[rr] = quad_sum(lrun[rr]);
    if (split) {  // the second key half's state joins the first's (the
                  // pair kept one max, so the sums simply add)
      float* xo = reinterpret_cast<float*>(ring) + (rtile * 32 + lane) *
                                                        (D / 2 + 2);
      __syncthreads();  // every warp is done with the ring
      if (kh == 1) {
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) xo[nt * 4 + cc] = o[nt][cc];
        xo[D / 2] = lrun[0];
        xo[D / 2 + 1] = lrun[1];
      }
      __syncthreads();
      if (kh == 0) {
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) o[nt][cc] += xo[nt * 4 + cc];
        lrun[0] += xo[D / 2];
        lrun[1] += xo[D / 2 + 1];
      }
    }

    // the pass's state, one per (block, row)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = wr0 + gq + rr * 8;
      if (!ok_row[rr] || kh != 0) continue;
      const int64_t at =
          (static_cast<int64_t>(h) * p.nch_blocks + blk) * bg + row;
      if (t == 0) {
        p.ws_ml[at * 2] = mrun[rr];
        p.ws_ml[at * 2 + 1] = lrun[rr];
      }
      float* acc = p.ws_acc + at * D;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        *reinterpret_cast<float2*>(acc + nt * 8 + 2 * t) =
            make_float2(o[nt][2 * rr], o[nt][2 * rr + 1]);
    }
  }
}

// float32: thread (r = tid / 4, qd = tid % 4) scores row r of a 32-row
// tile against keys qd, qd + 4, ... of the chunk
template <int D>
__global__ void __launch_bounds__(kThreads)
    stream_partial_f32(const PagedParams p) {
  constexpr int kP = TileF32<D>::kPitch, kSp = kChunk + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);  // [kT][kP]
  float* sk = sq + kT * kP;                    // [kChunk][kP]
  float* sv = sk + kChunk * kP;
  float* sp = sv + kChunk * kP;  // [kT][kSp]
  const int c = blockIdx.x, h = blockIdx.y;
  const int r_ = threadIdx.x / 4, qd = threadIdx.x % 4;
  const int T = p.pool_pages * p.ps, t0 = c * kChunk, bg = p.b * p.g;
  const float* kp = static_cast<const float*>(p.k_pool);
  const float* vp = static_cast<const float*>(p.v_pool);
  const float* q = static_cast<const float*>(p.q);
  for (int i = threadIdx.x; i < kChunk * D; i += kThreads) {
    const int r = i / D, e = i % D, tok = t0 + r;
    const bool in = tok < T;
    const int64_t off =
        in ? pool_at(p, p.pool_base + tok / p.ps, h, tok % p.ps) + e : 0;
    sk[r * kP + e] = in ? kp[off] : 0.f;
    sv[r * kP + e] = in ? vp[off] : 0.f;
  }
  for (int r0 = 0; r0 < bg; r0 += kT) {
    __syncthreads();  // the chunk is staged; sq is free
    for (int i = threadIdx.x; i < kT * D; i += kThreads) {
      const int r = i / D, e = i % D, row = r0 + r;
      sq[r * kP + e] =
          row < bg ? q[q_at(p, row / p.g, h, row % p.g) + e] : 0.f;
    }
    __syncthreads();
    const int row = r0 + r_;
    const bool ok_row = row < bg;
    const int bi = ok_row ? row / p.g : 0;
    const int len = p.seq_lens[bi];
    const int* mem = p.tables + static_cast<int64_t>(bi) * p.pool_pages;
    float s[kChunk / 4], mx = kNeg;
#pragma unroll
    for (int i = 0; i < kChunk / 4; ++i) {
      const int key = qd + 4 * i, tok = t0 + key;
      bool ok = ok_row && tok < T;
      if (ok) {
        const int j = mem[tok / p.ps];
        ok = j >= 0 && j * p.ps + tok % p.ps < len;
      }
      s[i] = ok ? dot_rows<D>(sq + r_ * kP, sk + key * kP) * p.scale
                : -INFINITY;
      mx = fmaxf(mx, s[i]);
    }
    mx = quad_max(mx);
    float l = 0.f;
#pragma unroll
    for (int i = 0; i < kChunk / 4; ++i) {
      const float e = expf(s[i] - mx);
      l += e;
      sp[r_ * kSp + qd + 4 * i] = e;
    }
    l = quad_sum(l);
    __syncwarp();  // the row's 4 threads share a warp
    if (ok_row) {
      const int64_t at = (static_cast<int64_t>(h) * p.nch + c) * bg + row;
      if (qd == 0) {
        p.ws_ml[at * 2] = mx;
        p.ws_ml[at * 2 + 1] = l;
      }
      if (l > 0.f) {
        float* acc = p.ws_acc + at * D;
        for (int e = qd; e < D; e += 4) {
          float a = 0.f;
#pragma unroll 8
          for (int k = 0; k < kChunk; ++k)
            a = fmaf(sp[r_ * kSp + k], sv[k * kP + e], a);
          acc[e] = a;
        }
      }
    }
  }
}

// One block per (query row, kv head): the partials (one per chunk in f32,
// per block of the walk in bf16) by log-sum-exp, over those where the row
// attends a token (l > 0; an f32 chunk without one leaves its acc
// unwritten), in order, the loads unrolled so they are in flight at once.
template <typename T>
__global__ void __launch_bounds__(kThreads) stream_merge(const PagedParams p) {
  const int row = blockIdx.x, h = blockIdx.y, bg = p.b * p.g;
  const int n = p.nch_blocks;
  const int64_t at0 = static_cast<int64_t>(h) * n * bg + row;
  float mx = kNeg;
#pragma unroll 8
  for (int c = 0; c < n; ++c) {
    const float* ml = p.ws_ml + (at0 + static_cast<int64_t>(c) * bg) * 2;
    const float lc = ml[1], mc = ml[0];
    mx = lc > 0.f ? fmaxf(mx, mc) : mx;
  }
  T* out = static_cast<T*>(p.out) + q_at(p, row / p.g, h, row % p.g);
  for (int e = threadIdx.x; e < p.d; e += kThreads) {
    float o = 0.f, l = 0.f;
#pragma unroll 8
    for (int c = 0; c < n; ++c) {
      const int64_t at = at0 + static_cast<int64_t>(c) * bg;
      const float lc = p.ws_ml[at * 2 + 1];
      const float w = lc > 0.f ? expf(p.ws_ml[at * 2] - mx) : 0.f;
      const float a = lc > 0.f ? p.ws_acc[at * p.d + e] : 0.f;
      o = fmaf(w, a, o);
      l = fmaf(w, lc, l);
    }
    out[e] = from_f32<T>(o / fmaxf(l, 1e-30f));
  }
}

// ---------------------------------------------------------------- B8/B9
// bf16: a warp's 16-row q tile (rows >= g zero) and a 2-stage ring of
// 16-token K/V slices in shared memory.

template <int D>
__device__ __forceinline__ void warp_load_q(bf16* sq, const PagedParams& p,
                                            int bi, int h) {
  constexpr int kPitch = TileBf16<D>::kPitch, kVec = D / 8;
  const bf16* q = static_cast<const bf16*>(p.q);
  for (int i = threadIdx.x % 32; i < kSub * kVec; i += 32) {
    const int r = i / kVec, e = (i % kVec) * 8;
    const bool in = r < p.g;
    cp_async16(sq + r * kPitch + e, q + (in ? q_at(p, bi, h, r) + e : 0),
               in ? 16 : 0);
  }
}

// absolute page of slice j of batch row bi (16 tokens from token 16 j), or
// -1 when the id lies outside the pool
__device__ __forceinline__ int slice_page(const PagedParams& p, int bi,
                                          int j) {
  const int pg = p.tables[static_cast<int64_t>(bi) * p.pp + j * kSub / p.ps];
  return pg >= 0 && pg < p.num_pages ? pg : -1;
}

// slice j of kv head h's K and V rows into sk/sv, by the lanes of a warp
template <int D>
__device__ __forceinline__ void warp_load_kv(bf16* sk, bf16* sv,
                                             const PagedParams& p, int bi,
                                             int h, int j) {
  constexpr int kPitch = TileBf16<D>::kPitch, kVec = D / 8;
  const int pg = slice_page(p, bi, j), s0 = (j * kSub) % p.ps;
  const bf16* kp = static_cast<const bf16*>(p.k_pool);
  const bf16* vp = static_cast<const bf16*>(p.v_pool);
  for (int i = threadIdx.x % 32; i < kSub * kVec; i += 32) {
    const int r = i / kVec, e = (i % kVec) * 8;
    const int64_t off = pg >= 0 ? pool_at(p, pg, h, s0 + r) + e : 0;
    cp_async16(sk + r * kPitch + e, kp + off, pg >= 0 ? 16 : 0);
    cp_async16(sv + r * kPitch + e, vp + off, pg >= 0 ? 16 : 0);
  }
}

// One slice into a warp's online softmax (m, l per thread-quad row; o
// the 16 x D accumulator): keys key0 + col, valid below n on a page of
// the pool. P V takes p as a bf16 pair (hi + lo).
template <int D>
__device__ __forceinline__ void attend_slice(float (&m)[2], float (&l)[2],
                                             float (&o)[D / 8][4],
                                             const bf16* sq, const bf16* sk,
                                             const bf16* sv, int key0, int n,
                                             bool page_ok, float scale) {
  const int t = threadIdx.x % 4;
  float s[kSub / 8][4];
  zero(s);
  mma_abt<kSub, D>(s, sq, sk);
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < kSub / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int pos = key0 + nt * 8 + 2 * t + (c & 1);
      const float x = page_ok && pos < n ? s[nt][c] * scale : -INFINITY;
      s[nt][c] = x;
      mx[c >> 1] = fmaxf(mx[c >> 1], x);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    const float alpha = expf(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      o[nt][2 * r] *= alpha;
      o[nt][2 * r + 1] *= alpha;
    }
  }
  float lo[kSub / 8][4];
#pragma unroll
  for (int nt = 0; nt < kSub / 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float e = expf(s[nt][c] - m[c >> 1]);  // masked: 0
      l[c >> 1] += e;
      s[nt][c] = bf16_round(e);
      lo[nt][c] = e - s[nt][c];
    }
  mma_xb<kSub, D>(o, s, sv);
  mma_xb<kSub, D>(o, lo, sv);
}

// B8: one block per sequence, kv head h on warp h % 4, its slices in order
template <int D>
__global__ void __launch_bounds__(kThreads) fused_bf16(const PagedParams p) {
  constexpr int kPitch = TileBf16<D>::kPitch, kTile = kSub * kPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, t = lane & 3;
  bf16* sq = reinterpret_cast<bf16*>(smem) + warp * 5 * kTile;
  bf16* sk = sq + kTile;      // [2][kSub][kPitch]
  bf16* sv = sk + 2 * kTile;  // [2][kSub][kPitch]
  const int bi = blockIdx.x;
  const int n = min(max(p.seq_lens[bi], 0), p.pp * p.ps);
  const int nsub = (n + kSub - 1) / kSub;
  bf16* out = static_cast<bf16*>(p.out);
  for (int h = warp; h < p.n_kv; h += kWarps) {
    warp_load_q<D>(sq, p, bi, h);
    if (nsub > 0) warp_load_kv<D>(sk, sv, p, bi, h, 0);
    cp_async_commit();
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, o[D / 8][4];
    zero(o);
    for (int j = 0; j < nsub; ++j) {
      if (j + 1 < nsub)
        warp_load_kv<D>(sk + ((j + 1) & 1) * kTile, sv + ((j + 1) & 1) * kTile,
                        p, bi, h, j + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncwarp();
      attend_slice<D>(m, l, o, sq, sk + (j & 1) * kTile, sv + (j & 1) * kTile,
                      j * kSub, n, slice_page(p, bi, j) >= 0, p.scale);
      __syncwarp();  // the stage is refilled two slices on
    }
    cp_async_wait<0>();
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = gq + r * 8;
      const float den = fmaxf(quad_sum(l[r]), 1e-30f);
      if (row >= p.g) continue;
      bf16* dst = out + q_at(p, bi, h, row);
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(dst + nt * 8 + 2 * t) =
            __floats2bfloat162_rn(o[nt][2 * r] / den, o[nt][2 * r + 1] / den);
    }
  }
}

// B9's merge of one compute block: every warp left its (m, l) per row in
// sml[w][row] and its unnormalised output in so_w[w][row][D]; the stock
// kernel's renormalising update folds them into so (the running output
// [16][d]) with (m_prev, l_prev) in st[row][0..1].
__device__ __forceinline__ void pallas_fold(const PagedParams& p,
                                            const float* sml,
                                            const float* so_w, float* so,
                                            float* st, float* sfac) {
  const int d = p.d;
  if (threadIdx.x < p.g) {
    const int row = threadIdx.x;
    float mc = kNeg;
    for (int w = 0; w < kWarps; ++w) mc = fmaxf(mc, sml[(w * 16 + row) * 2]);
    float lc = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sml[(w * 16 + row) * 2] - mc);  // idle warp: 0
      sfac[w * 16 + row] = f;
      lc = fmaf(f, sml[(w * 16 + row) * 2 + 1], lc);
    }
    const float m_prev = st[row * 4], l_prev = st[row * 4 + 1];
    const float m_next = fmaxf(m_prev, mc);
    const float alpha = expf(m_prev - m_next);  // m_prev = -inf: 0
    const float beta = expf(mc - m_next);
    const float l_next = alpha * l_prev + beta * lc;
    st[row * 4] = m_next;
    st[row * 4 + 1] = l_next;
    st[row * 4 + 2] = l_prev * alpha;
    st[row * 4 + 3] = beta;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < p.g * d; i += kThreads) {
    const int row = i / d, e = i % d;
    float oc = 0.f;
    for (int w = 0; w < kWarps; ++w)
      oc = fmaf(sfac[w * 16 + row], so_w[(w * 16 + row) * d + e], oc);
    so[row * d + e] = (st[row * 4 + 2] * so[row * d + e] +
                       st[row * 4 + 3] * oc) /
                      st[row * 4 + 1];
  }
  __syncthreads();
}

// shared-memory layout of B9's f32 statistics, after the per-dtype tiles:
// so [16][d], so_w [kWarps][16][d] (the bf16 kernel lays it over its
// rings), sml [kWarps][16][2], sfac [kWarps][16], st [16][4]
constexpr int kStatFloats = kWarps * 16 * 2 + kWarps * 16 + 16 * 4;

__device__ __forceinline__ void pallas_init(const PagedParams& p, float* so,
                                            float* st) {
  for (int i = threadIdx.x; i < 16 * p.d; i += kThreads) so[i] = 0.f;
  if (threadIdx.x < 16) {
    st[threadIdx.x * 4] = -INFINITY;  // the stock kernel's m init
    st[threadIdx.x * 4 + 1] = 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void pallas_store(const PagedParams& p, int bi,
                                             int h, const float* so) {
  T* out = static_cast<T*>(p.out);
  for (int i = threadIdx.x; i < p.g * p.d; i += kThreads) {
    const int row = i / p.d, e = i % p.d;
    out[q_at(p, bi, h, row) + e] = from_f32<T>(so[row * p.d + e]);
  }
}

// B9: one block per (sequence, kv head); within each compute block of
// ppcb pages that holds an attended token, warp w takes slices w, w + 4,
// ... with its own ring and online softmax, then the block folds them.
template <int D>
__global__ void __launch_bounds__(kThreads) pallas_bf16(const PagedParams p) {
  constexpr int kPitch = TileBf16<D>::kPitch, kTile = kSub * kPitch;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, t = lane & 3;
  bf16* sq = reinterpret_cast<bf16*>(smem);  // [kSub][kPitch], shared
  bf16* ring = sq + kTile;                   // [kWarps][4][kSub][kPitch]
  bf16* sk = ring + warp * 4 * kTile;
  bf16* sv = sk + 2 * kTile;
  float* so = reinterpret_cast<float*>(ring + kWarps * 4 * kTile);  // [16][D]
  float* sml = so + 16 * D;
  float* sfac = sml + kWarps * 16 * 2;
  float* st = sfac + kWarps * 16;
  float* so_w = reinterpret_cast<float*>(ring);  // over the rings
  const int bi = blockIdx.x, h = blockIdx.y;
  const int n = min(max(p.seq_lens[bi], 0), p.pp * p.ps);
  const int bk = p.ppcb * p.ps, per_blk = bk / kSub;
  for (int i = threadIdx.x; i < kSub * (D / 8); i += kThreads) {
    const int r = i / (D / 8), e = (i % (D / 8)) * 8;
    const bool in = r < p.g;
    cp_async16(sq + r * kPitch + e,
               static_cast<const bf16*>(p.q) + (in ? q_at(p, bi, h, r) + e : 0),
               in ? 16 : 0);
  }
  cp_async_commit();
  pallas_init(p, so, st);
  cp_async_wait<0>();
  __syncthreads();
  for (int blk = 0; blk * bk < n; ++blk) {
    const int mine = (per_blk - warp + kWarps - 1) / kWarps;
    const int j0 = blk * per_blk + warp;
    if (mine > 0) warp_load_kv<D>(sk, sv, p, bi, h, j0);
    cp_async_commit();
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, o[D / 8][4];
    zero(o);
    for (int k = 0; k < mine; ++k) {
      const int j = j0 + k * kWarps;
      if (k + 1 < mine)
        warp_load_kv<D>(sk + ((k + 1) & 1) * kTile, sv + ((k + 1) & 1) * kTile,
                        p, bi, h, j + kWarps);
      cp_async_commit();
      cp_async_wait<1>();
      __syncwarp();
      attend_slice<D>(m, l, o, sq, sk + (k & 1) * kTile, sv + (k & 1) * kTile,
                      j * kSub, n, slice_page(p, bi, j) >= 0, p.scale);
      __syncwarp();
    }
    cp_async_wait<0>();
    __syncthreads();  // every ring is drained: so_w may overwrite them
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = gq + r * 8;
      const float lr = quad_sum(l[r]);
      if (t == 0) {
        sml[(warp * 16 + row) * 2] = m[r];
        sml[(warp * 16 + row) * 2 + 1] = lr;
      }
      float* dst = so_w + (warp * 16 + row) * D;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        *reinterpret_cast<float2*>(dst + nt * 8 + 2 * t) =
            make_float2(o[nt][2 * r], o[nt][2 * r + 1]);
    }
    __syncthreads();
    pallas_fold(p, sml, so_w, so, st, sfac);
  }
  pallas_store<bf16>(p, bi, h, so);
}

// ---------------------------------------------------------------- f32
// CUDA cores, as csrc/paged_attention.cu: a lane holds EPL elements of a
// d-long row (one vector load when d = 32 EPL), a q.k dot is a warp
// reduction, and a warp folds tokens one by one into its online softmax.

template <int N>
struct alignas(sizeof(float) * N <= 16 ? sizeof(float) * N : 16) PackF {
  float v[N];
};

template <int EPL>
__device__ __forceinline__ void load_row(const float* row, int lane, int d,
                                         float (&v)[EPL]) {
  const int e0 = lane * EPL;
  if (d == 32 * EPL) {
    const PackF<EPL> pk = *reinterpret_cast<const PackF<EPL>*>(row + e0);
#pragma unroll
    for (int e = 0; e < EPL; ++e) v[e] = pk.v[e];
  } else {
#pragma unroll
    for (int e = 0; e < EPL; ++e) v[e] = e0 + e < d ? row[e0 + e] : 0.f;
  }
}

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
      const float alpha = expf(m[gi] - mn);
      const float pr = expf(s - mn);
      l[gi] = l[gi] * alpha + pr;
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc[gi][e] = fmaf(pr, vr[e], acc[gi][e] * alpha);
      m[gi] = mn;
    }
  }
}

// tokens [t_lo, t_hi) of batch row bi, kv head h, in runs of kUnroll from
// t_lo + run0 every `stride` tokens, into the warp's online softmax
template <int EPL, int G>
__device__ __forceinline__ void fold_range(const PagedParams& p, int bi,
                                           int h, int t_lo, int t_hi,
                                           int run0, int stride,
                                           const float (&qv)[G][EPL],
                                           float (&m)[G], float (&l)[G],
                                           float (&acc)[G][EPL]) {
  const int lane = threadIdx.x % 32;
  const float* kp = static_cast<const float*>(p.k_pool);
  const float* vp = static_cast<const float*>(p.v_pool);
  const int* trow = p.tables + static_cast<int64_t>(bi) * p.pp;
  for (int t0 = t_lo + run0; t0 < t_hi; t0 += stride) {
    float kr[kUnroll][EPL], vr[kUnroll][EPL];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tok = t0 + u;
      const int pg = tok < t_hi ? trow[tok / p.ps] : -1;
      ok[u] = pg >= 0 && pg < p.num_pages;
      if (ok[u]) {
        const int64_t off = pool_at(p, pg, h, tok % p.ps);
        load_row<EPL>(kp + off, lane, p.d, kr[u]);
        load_row<EPL>(vp + off, lane, p.d, vr[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (ok[u]) fold_token<EPL, G>(qv, kr[u], vr[u], p.g, m, l, acc);
  }
}

template <int EPL, int G>
__device__ __forceinline__ void load_q_scaled(const PagedParams& p, int bi,
                                              int h, float (&qv)[G][EPL]) {
  const int lane = threadIdx.x % 32;
  const float* q = static_cast<const float*>(p.q);
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (gi < p.g) {
      load_row<EPL>(q + q_at(p, bi, h, gi), lane, p.d, qv[gi]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qv[gi][e] *= p.scale;
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qv[gi][e] = 0.f;
    }
  }
}

template <int EPL, int G>
__device__ __forceinline__ void init_state(float (&m)[G], float (&l)[G],
                                           float (&acc)[G][EPL]) {
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNeg;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[gi][e] = 0.f;
  }
}

// B8, float32: one block per sequence, kv head h on warp h % 4
template <int EPL, int G>
__global__ void __launch_bounds__(kThreads) fused_f32(const PagedParams p) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bi = blockIdx.x;
  const int n = min(max(p.seq_lens[bi], 0), p.pp * p.ps);
  float* out = static_cast<float*>(p.out);
  for (int h = warp; h < p.n_kv; h += kWarps) {
    float qv[G][EPL], m[G], l[G], acc[G][EPL];
    load_q_scaled<EPL, G>(p, bi, h, qv);
    init_state<EPL, G>(m, l, acc);
    fold_range<EPL, G>(p, bi, h, 0, n, 0, kUnroll, qv, m, l, acc);
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi >= p.g) continue;
      const float den = fmaxf(l[gi], 1e-30f);
      float* dst = out + q_at(p, bi, h, gi);
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        if (lane * EPL + e < p.d) dst[lane * EPL + e] = acc[gi][e] / den;
    }
  }
}

// B9, float32: one block per (sequence, kv head); within a compute block
// warp w folds the runs of kUnroll tokens w, w + 4, ..., then the block
// folds the warps
template <int EPL, int G>
__global__ void __launch_bounds__(kThreads) pallas_f32(const PagedParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* so = reinterpret_cast<float*>(smem);  // [16][d]
  float* so_w = so + 16 * p.d;                 // [kWarps][16][d]
  float* sml = so_w + kWarps * 16 * p.d;
  float* sfac = sml + kWarps * 16 * 2;
  float* st = sfac + kWarps * 16;
  const int bi = blockIdx.x, h = blockIdx.y;
  const int n = min(max(p.seq_lens[bi], 0), p.pp * p.ps);
  const int bk = p.ppcb * p.ps;
  float qv[G][EPL];
  load_q_scaled<EPL, G>(p, bi, h, qv);
  pallas_init(p, so, st);
  __syncthreads();
  for (int t_lo = 0; t_lo < n; t_lo += bk) {
    float m[G], l[G], acc[G][EPL];
    init_state<EPL, G>(m, l, acc);
    fold_range<EPL, G>(p, bi, h, t_lo, min(t_lo + bk, n), warp * kUnroll,
                       kWarps * kUnroll, qv, m, l, acc);
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi >= p.g) continue;
      if (lane == 0) {
        sml[(warp * 16 + gi) * 2] = m[gi];
        sml[(warp * 16 + gi) * 2 + 1] = l[gi];
      }
      float* dst = so_w + (warp * 16 + gi) * p.d;
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        if (lane * EPL + e < p.d) dst[lane * EPL + e] = acc[gi][e];
    }
    __syncthreads();
    pallas_fold(p, sml, so_w, so, st, sfac);
  }
  pallas_store<float>(p, bi, h, so);
}

// ---------------------------------------------------------------- host

enum Which { kStream = 0, kFused = 1, kPallas = 2 };

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           const PagedParams& p) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

size_t stat_bytes(int d) {
  return sizeof(float) * (16 * d + kStatFloats);
}

template <int D>
int run_stream_bf16(const PagedParams& p, cudaStream_t s) {
  const size_t smem =
      sizeof(bf16) * (kRows + kRing * 2 * kChunk) * TileBf16<D>::kPitch +
      sizeof(int) * (kRows * p.run_pages + kRows * 2 * p.cpb +
                     (p.run_pages + 31) / 32 + p.cpb + 1 + kRows + 64);
  const int e =
      launch(stream_walk_bf16<D>, dim3(p.nch_blocks, p.n_kv), smem, s, p);
  if (e) return e;
  return launch(stream_merge<bf16>, dim3(p.b * p.g, p.n_kv), 0, s, p);
}

template <int D>
int run_paged_bf16(int which, const PagedParams& p, cudaStream_t s) {
  const size_t tile = sizeof(bf16) * kSub * TileBf16<D>::kPitch;
  if (which == kFused)
    return launch(fused_bf16<D>, dim3(p.b), kWarps * 5 * tile, s, p);
  // the f32 so_w [kWarps][16][D] lies over the rings (kWarps * 4 tiles)
  static_assert(kWarps * 16 * D * sizeof(float) <=
                    kWarps * 4 * sizeof(bf16) * kSub * TileBf16<D>::kPitch,
                "so_w must fit over the rings");
  return launch(pallas_bf16<D>, dim3(p.b, p.n_kv),
                (1 + 4 * kWarps) * tile + stat_bytes(D), s, p);
}

template <int EPL, int G>
int run_f32_g(int which, const PagedParams& p, cudaStream_t s) {
  if (which == kFused) return launch(fused_f32<EPL, G>, dim3(p.b), 0, s, p);
  return launch(pallas_f32<EPL, G>, dim3(p.b, p.n_kv),
                stat_bytes(p.d) + sizeof(float) * kWarps * 16 * p.d, s, p);
}

template <int EPL>
int run_f32_e(int which, const PagedParams& p, cudaStream_t s) {
  if (p.g <= 1) return run_f32_g<EPL, 1>(which, p, s);
  if (p.g <= 2) return run_f32_g<EPL, 2>(which, p, s);
  if (p.g <= 4) return run_f32_g<EPL, 4>(which, p, s);
  return run_f32_g<EPL, 8>(which, p, s);
}

template <int D>
int run_stream_f32(const PagedParams& p, cudaStream_t s) {
  constexpr size_t smem =
      sizeof(float) * ((kT + 2 * kChunk) * TileF32<D>::kPitch +
                       kT * (kChunk + 1));
  const int e = launch(stream_partial_f32<D>, dim3(p.nch, p.n_kv), smem, s, p);
  if (e) return e;
  return launch(stream_merge<float>, dim3(p.b * p.g, p.n_kv), 0, s, p);
}

int run(int which, int dtype, const PagedParams& p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.b == 0) return 0;
  if (dtype == ptt::kBF16) {
    if (which == kStream) {
      if (p.d == 128) return run_stream_bf16<128>(p, s);
      if (p.d == 256) return run_stream_bf16<256>(p, s);
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (p.d == 64) return run_paged_bf16<64>(which, p, s);
    if (p.d == 96) return run_paged_bf16<96>(which, p, s);
    if (p.d == 128) return run_paged_bf16<128>(which, p, s);
    if (p.d == 256) return run_paged_bf16<256>(which, p, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype != ptt::kF32) return static_cast<int>(cudaErrorInvalidValue);
  if (which == kStream) {
    if (p.d == 128) return run_stream_f32<128>(p, s);
    if (p.d == 256) return run_stream_f32<256>(p, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int epl = (p.d + 31) / 32;
  if (epl <= 2) return run_f32_e<2>(which, p, s);
  if (epl <= 4) return run_f32_e<4>(which, p, s);
  return run_f32_e<8>(which, p, s);
}

PagedParams make_params(const void* q, const void* k_pool, const void* v_pool,
                        const int* seq_lens, const int* tables, void* out,
                        int b, int n_q, int n_kv, int d, int page_size,
                        float scale) {
  PagedParams p{};
  p.q = q;
  p.k_pool = k_pool;
  p.v_pool = v_pool;
  p.seq_lens = seq_lens;
  p.tables = tables;
  p.out = out;
  p.b = b;
  p.n_kv = n_kv;
  p.g = n_kv > 0 ? n_q / n_kv : 0;
  p.d = d;
  p.ps = page_size;
  p.scale = scale;
  return p;
}

bool shape_ok(int n_q, int n_kv, int d, int page_size) {
  return n_kv > 0 && n_q % n_kv == 0 && n_q / n_kv >= 1 &&
         n_q / n_kv <= 8 && d > 0 && d <= 256 && page_size > 0;
}

}  // namespace

// Returns the cudaError_t of the first failing launch. Shapes: q/out [b,
// n_q, d] (n_q = n_kv * g, g <= 8), pools [pages, n_kv, page_size, d], all
// of `dtype` and contiguous; seq_lens [b] int32. B7: membership [b,
// pool_pages] int32, the layer region pool pages [pool_base, pool_base +
// pool_pages), d 128 or 256, nch = ceil(pool_pages * page_size / 64)
// chunks; workspaces ws_ml [n_kv, blocks, b*g, 2] and ws_acc [n_kv,
// blocks, b*g, d] f32. Two launches: the partials, then their merge. bf16:
// `blocks` a kv head, each a run of `chunks_per_block` chunks spanning at
// most `run_pages` pages, blocks * chunks_per_block >= nch > (blocks - 1)
// * chunks_per_block. float32: blocks = nch, chunks_per_block 1. B8/B9:
// block_tables [b, pages_per_seq] int32 of absolute ids in [0, num_pages),
// d 64, 96, 128 or 256, page_size a multiple of 16; B9 pages_per_seq a
// multiple of ppcb.
extern "C" int ptt_paged_stream(const void* q, const void* k_pool,
                                const void* v_pool, const int* seq_lens,
                                const int* membership, float* ws_ml,
                                float* ws_acc, void* out, int dtype, int b,
                                int n_q, int n_kv, int d,
                                int page_size, int pool_base, int pool_pages,
                                int blocks, int chunks_per_block,
                                int run_pages, float scale, void* stream) {
  if (!shape_ok(n_q, n_kv, d, page_size) || pool_base < 0 ||
      pool_pages <= 0 || n_kv > 65535 || blocks <= 0 ||
      chunks_per_block <= 0 || run_pages <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  PagedParams p = make_params(q, k_pool, v_pool, seq_lens, membership, out, b,
                              n_q, n_kv, d, page_size, scale);
  p.ws_ml = ws_ml;
  p.ws_acc = ws_acc;
  p.pool_base = pool_base;
  p.pool_pages = pool_pages;
  p.nch = static_cast<int>(
      (static_cast<int64_t>(pool_pages) * page_size + kChunk - 1) / kChunk);
  p.nch_blocks = blocks;
  p.cpb = chunks_per_block;
  p.run_pages = run_pages;
  p.ps_shift = -1;
  for (int sh = 0; sh < 31; ++sh)
    if ((1 << sh) == page_size) p.ps_shift = sh;
  const bool bf16_walk = dtype == ptt::kBF16;
  const int64_t covered = static_cast<int64_t>(blocks) * chunks_per_block;
  if (bf16_walk ? (covered < p.nch || covered - chunks_per_block >= p.nch ||
                   static_cast<int64_t>(chunks_per_block) * kChunk >
                       static_cast<int64_t>(run_pages - 1) * page_size)
                : (blocks != p.nch || chunks_per_block != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return run(kStream, dtype, p, stream);
}

extern "C" int ptt_paged_fused(const void* q, const void* k_pool,
                               const void* v_pool, const int* seq_lens,
                               const int* block_tables, void* out, int dtype,
                               int b, int n_q, int n_kv, int d, int page_size,
                               int pages_per_seq, int num_pages, float scale,
                               void* stream) {
  if (!shape_ok(n_q, n_kv, d, page_size) || page_size % kSub != 0 ||
      pages_per_seq <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  PagedParams p = make_params(q, k_pool, v_pool, seq_lens, block_tables, out,
                              b, n_q, n_kv, d, page_size, scale);
  p.pp = pages_per_seq;
  p.num_pages = num_pages;
  return run(kFused, dtype, p, stream);
}

extern "C" int ptt_paged_pallas(const void* q, const void* k_pool,
                                const void* v_pool, const int* seq_lens,
                                const int* block_tables, void* out, int dtype,
                                int b, int n_q, int n_kv, int d, int page_size,
                                int pages_per_seq, int num_pages,
                                int pages_per_compute_block, float scale,
                                void* stream) {
  if (!shape_ok(n_q, n_kv, d, page_size) || page_size % kSub != 0 ||
      pages_per_seq <= 0 || pages_per_compute_block <= 0 ||
      pages_per_seq % pages_per_compute_block != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  PagedParams p = make_params(q, k_pool, v_pool, seq_lens, block_tables, out,
                              b, n_q, n_kv, d, page_size, scale);
  p.pp = pages_per_seq;
  p.num_pages = num_pages;
  p.ppcb = pages_per_compute_block;
  return run(kPallas, dtype, p, stream);
}
