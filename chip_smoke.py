#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out DIR]

Phases, all run every time, each of which fails the run when it fails:
  device   the card's name and power limit, as nvidia-smi reports them;
  build    the CUDA kernels from csrc/, one nvcc per source in parallel;
  kernels  each kernel against its plain PyTorch version at the serving
           path's shapes, in bfloat16 and float32 (tolerances printed),
           then timed with CUDA events beside its plain version, one
           PyTorch library call computing the same function where there
           is one, and the least time the card could take;
  slice    the full-width d2048·L24 FusedCausalLM (bf16, random weights
           from a seed), driven through both serving paths with every
           kernel's launch count set to 0 before and read after each:
           GenerationEngine.generate at batch 32, prompt 128, 129 new
           tokens, and a ContinuousBatchingEngine answering 12 requests;
           between them a teacher-forced comparison of the kernel path
           with the plain path, and one decode step's time and breakdown;
  serving  the same model under the SLO serving frontend (ServingEngine,
           chunked prefill of 256 through the paged-prefill kernel,
           prefix cache): 16 requests, 8 of them sharing a 512-token
           system prompt, with its own launch counts; and one
           1500-token prompt prefilled chunk by chunk on the kernel path
           and on the plain path, whose last logits must agree.
It prints JSON lines; before the last comes one {"kernels": [...]} line,
and the last is {"ok": true, "device": {...}}. Without a CUDA device it
exits non-zero and prints no result. ``--out DIR`` also writes the
compiler logs and every result line there.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

#: published peaks of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

#: the serving path's shapes (bench.py run_decode_bench's flagship rung)
VOCAB, D_MODEL, N_LAYERS, N_HEADS, HEAD_DIM = 51200, 2048, 24, 16, 128
DFF, BATCH, PROMPT, NEW_TOKENS, PAGE = 8192, 32, 128, 129, 16
#: the serving frontend's shapes: table span and prefill chunk
SERVE_MAX_LENGTH, SERVE_CHUNK = 2048, 256

_LINES: list = []


def emit(obj) -> None:
    line = obj if isinstance(obj, str) else json.dumps(obj)
    _LINES.append(line)
    print(line, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    """The least time the card could take: bytes over the memory rate
    or operations over the dtype's peak, whichever is larger."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / PEAK_FLOPS[dtype] * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def cycler(n: int):
    state = {"i": -1}

    def nxt():
        state["i"] = (state["i"] + 1) % n
        return state["i"]
    return nxt


# ---------------------------------------------------------------- device

def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    emit(line)
    return line


# ---------------------------------------------------------------- build

def phase_build(out_dir):
    from paddle_tpu_torch import _kernels

    t0 = time.perf_counter()
    done = _kernels.build(ptxas_verbose=True)
    wall = time.perf_counter() - t0
    emit({"phase": "build", "wall_s": wall,
          "sources": {k: v["seconds"] for k, v in done.items()}})
    if out_dir:
        with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
            for name, v in done.items():
                f.write(f"== {name}\n{v['log']}\n")


# ---------------------------------------------------------------- kernels

def _decode_case(dtype, gen, g=1, d=HEAD_DIM, L=4):
    """Kernel-1 inputs at the path's shapes: batch 32, 16 kv heads
    (x g query heads) of d = 128, page 16, context 0..272 with page
    edges, one idle slot (length 0, all-zero table), one full table,
    two rows sharing a prefix page and one table id past the layer
    region; a 4-layer folded pool so timed calls rotate past the L2."""
    b, n_kv, ps = BATCH, N_HEADS, PAGE
    pp = 17                                    # 272 slots per row
    lens = [0, 1, 15, 16, 17, 31, 32, 33, 47, 48, 63, 64, 65, 100, 127,
            128, 129, 143, 144, 160, 175, 176, 200, 223, 224, 240, 255,
            256, 257, 260, 271, pp * ps]        # last row: full table
    P = b * pp + 1                             # + scratch page 0
    rng = np.random.RandomState(7)
    perm = list(rng.permutation(np.arange(1, P)))
    tables = np.zeros((b, pp), np.int32)
    for r, n in enumerate(lens):
        if r == 0:
            continue                           # idle slot: zero table
        need = min(-(-(n + 1) // ps), pp)
        tables[r, :need] = [perm.pop() for _ in range(need)]
    # rows 7 and 8 (lengths 33 and 47) share their first, full page
    tables[8, 0] = tables[7, 0]
    # row 30 (length 271) maps its last page outside the layer region:
    # those 15 tokens are not attended and its append is skipped
    tables[30, pp - 1] = P
    dev = "cuda"

    def rnd(*s):
        return torch.randn(s, generator=gen, device=dev).to(dtype)
    return dict(
        q=rnd(b, n_kv * g, d), nk=rnd(b, n_kv, d), nv=rnd(b, n_kv, d),
        kp=rnd(L * P, n_kv, ps, d), vp=rnd(L * P, n_kv, ps, d),
        lens=torch.tensor(lens, dtype=torch.int32, device=dev),
        tables=torch.from_numpy(tables).to(dev), P=P, L=L, pp=pp)


def kernel_paged_attention(gen) -> dict:
    import torch.nn.functional as F

    from paddle_tpu_torch.nn.functional import paged_attention as pa

    res = {}
    # tolerances: both sides accumulate in fp32 (sums differ only in
    # order, ~1e-7); bf16 outputs may then round one ulp apart (2^-8
    # below magnitude 2). Beyond the path's shape (g 1, d 128): grouped
    # queries and the vector (64, 256) and masked (96) head widths.
    for (g, d), dtype, tol in [
            (gd, dt, tl) for gd in ((1, HEAD_DIM), (2, 64), (4, 256), (1, 96))
            for dt, tl in ((torch.float32, 2e-5),
                           (torch.bfloat16, 2 ** -7))]:
        c = _decode_case(dtype, gen, g=g, d=d)
        kp2, vp2 = c["kp"].clone(), c["vp"].clone()
        base = c["P"]                           # layer 1's region
        out, _, _ = pa.paged_decode_attention_inplace(
            c["q"], c["nk"], c["nv"], c["kp"], c["vp"], c["lens"],
            c["tables"], pool_base=base, pool_pages=c["P"])
        ref = pa._paged_decode_plain(c["q"], c["nk"], c["nv"], kp2, vp2,
                                     c["lens"], c["tables"], base, c["P"])
        torch.cuda.synchronize()
        err = max_err(out, ref)
        pools_equal = bool(torch.equal(c["kp"], kp2)
                           and torch.equal(c["vp"], vp2))
        emit({"check": "paged_decode_attention_inplace", "g": g, "d": d,
              "dtype": str(dtype), "max_abs_err": err, "tol": tol,
              "pool_after_write_bytewise_equal": pools_equal})
        check(err <= tol, f"paged attention g={g} d={d} {dtype}: "
                          f"{err} > {tol}")
        check(pools_equal, f"paged attention g={g} d={d} {dtype}: pool "
                           "contents after the append differ from the "
                           "plain write")
        if (g, d) == (1, HEAD_DIM):
            res[str(dtype)] = err
        del c, kp2, vp2
    # timing, bf16 (the path's dtype), rotating over the pool's layers
    c = _decode_case(torch.bfloat16, gen)
    nxt = cycler(c["L"])

    def kern():
        pa.paged_decode_attention_inplace(
            c["q"], c["nk"], c["nv"], c["kp"], c["vp"], c["lens"],
            c["tables"], pool_base=nxt() * c["P"], pool_pages=c["P"])

    def plain():
        pa._paged_decode_plain(c["q"], c["nk"], c["nv"], c["kp"], c["vp"],
                               c["lens"], c["tables"], nxt() * c["P"],
                               c["P"])
    # library yardstick: SDPA over the K/V already gathered dense
    # (pool tokens + the current one), masked by length and region
    b, n_kv, d = c["q"].shape
    cap = c["pp"] * PAGE
    kg = c["kp"][c["tables"].long()].permute(0, 2, 1, 3, 4) \
        .reshape(b, n_kv, cap, d)
    vg = c["vp"][c["tables"].long()].permute(0, 2, 1, 3, 4) \
        .reshape(b, n_kv, cap, d)
    kd = torch.cat([kg, c["nk"][:, :, None]], dim=2).contiguous()
    vd = torch.cat([vg, c["nv"][:, :, None]], dim=2).contiguous()
    pos = torch.arange(cap + 1, device="cuda")
    lens_c = torch.clamp(c["lens"].long(), max=cap)
    in_region = (c["tables"] < c["P"]).repeat_interleave(PAGE, dim=1)
    attended = (pos[None, :cap] < lens_c[:, None]) & in_region
    mask = torch.cat([attended, torch.ones_like(attended[:, :1])], dim=1)
    mask = mask[:, None, None, :]
    qd = c["q"][:, :, None, :]

    def library():
        F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)
    ms, plain_ms, lib_ms = time_ms(kern), time_ms(plain), time_ms(library)
    # bytes this run's data needs: each attended K/V row once, q, the
    # operands, the output and the appended rows
    isz = 2
    tok = int(attended.sum())
    wpage = torch.clamp(c["lens"].long() // PAGE, max=c["pp"] - 1)
    n_write = int(((c["lens"] < cap)
                   & (c["tables"].gather(1, wpage[:, None])[:, 0] < c["P"]))
                  .sum())
    nbytes = (2 * tok * n_kv * d * isz + 4 * b * n_kv * d * isz
              + 2 * n_write * n_kv * d * isz + c["tables"].numel() * 4
              + b * 4)
    flops = 4.0 * (tok + b) * n_kv * d         # q.k and p.v, g = 1
    bms, by = bound_ms(nbytes, flops, torch.bfloat16)
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bms, "bound_by": by, "bytes": nbytes,
           "max_abs_err": res[str(torch.bfloat16)]}
    emit({"time": "paged_decode_attention_inplace", **row})
    return row


def kernel_stream_linear(gen) -> dict:
    from paddle_tpu_torch.nn.functional import stream_linear as sl

    dev = "cuda"
    L = N_LAYERS
    qkv_n = 3 * D_MODEL
    res = {}
    # tolerances: fp32 accumulation on both sides (order differs);
    # bf16 outputs may round one ulp apart at magnitude < 2 (2^-7);
    # fp32 outputs of 2048-term sums agree to ~1e-6
    for dtype, tol_qkv, tol_head in ((torch.float32, 1e-4, 1e-4),
                                     (torch.bfloat16, 2 ** -6, 1e-4)):
        x = torch.randn(BATCH, D_MODEL, generator=gen, device=dev) \
            .to(dtype)
        w = (torch.randn(2, D_MODEL, qkv_n, generator=gen, device=dev)
             * 0.02).to(dtype)
        bias = (torch.randn(2, qkv_n, generator=gen, device=dev)
                * 0.02).to(dtype)
        head = (torch.randn(D_MODEL, VOCAB, generator=gen, device=dev)
                * 0.02).to(dtype)
        out = sl.stream_linear(x, w, layer=1, bias=bias)
        ref = sl._stream_linear_plain(x, w, 1, bias)
        out_h = sl.stream_linear(x, head, out_dtype=torch.float32)
        ref_h = sl._stream_linear_plain(x, head, out_dtype=torch.float32)
        out_g = sl.stream_linear(x, w, layer=0, bias=bias,
                                 activation="gelu")
        ref_g = sl._stream_linear_plain(x, w, 0, bias, "gelu")
        torch.cuda.synchronize()
        e_qkv, e_head, e_gelu = (max_err(out, ref), max_err(out_h, ref_h),
                                 max_err(out_g, ref_g))
        emit({"check": "stream_linear", "dtype": str(dtype),
              "qkv_max_abs_err": e_qkv, "qkv_tol": tol_qkv,
              "gelu_max_abs_err": e_gelu,
              "lm_head_f32_out_max_abs_err": e_head,
              "lm_head_tol": tol_head})
        check(e_qkv <= tol_qkv and e_gelu <= tol_qkv,
              f"stream_linear {dtype}: {e_qkv}/{e_gelu} > {tol_qkv}")
        check(e_head <= tol_head,
              f"stream_linear head {dtype}: {e_head} > {tol_head}")
        res[str(dtype)] = max(e_qkv, e_head, e_gelu)
        del w, head
    # other row counts (one row, a ragged 7, two row blocks of 64) and
    # ragged K and N tiles (K 136, N 200), same tolerances
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2 ** -6)):
        w = (torch.randn(136, 200, generator=gen, device=dev) * 0.1) \
            .to(dtype)
        bias = torch.randn(200, generator=gen, device=dev).to(dtype)
        for m, act in ((1, None), (7, "relu"), (100, "gelu")):
            x = torch.randn(m, 136, generator=gen, device=dev).to(dtype)
            e = max_err(sl.stream_linear(x, w, bias=bias, activation=act),
                        sl._stream_linear_plain(x, w, None, bias, act))
            emit({"check": "stream_linear", "dtype": str(dtype), "M": m,
                  "K": 136, "N": 200, "activation": act,
                  "max_abs_err": e, "tol": tol})
            check(e <= tol, f"stream_linear M={m} {dtype}: {e} > {tol}")
    # timing in bf16 at the two decode-step shapes: the QKV projection
    # over the 24-layer stack (layers rotate so W comes from HBM) and the
    # LM head with fp32 logits
    dt = torch.bfloat16
    x = torch.randn(BATCH, D_MODEL, generator=gen, device=dev).to(dt)
    w = (torch.randn(L, D_MODEL, qkv_n, generator=gen, device=dev)
         * 0.02).to(dt)
    bias = (torch.randn(L, qkv_n, generator=gen, device=dev) * 0.02).to(dt)
    head = (torch.randn(D_MODEL, VOCAB, generator=gen, device=dev)
            * 0.02).to(dt)
    nxt = cycler(L)
    rows = {}
    for name, kern, plain, lib, wbytes, n in (
            ("qkv",
             lambda: sl.stream_linear(x, w, layer=nxt(), bias=bias),
             lambda: sl._stream_linear_plain(x, w, nxt(), bias),
             lambda: (lambda l: torch.addmm(bias[l], x, w[l]))(nxt()),
             D_MODEL * qkv_n * 2, qkv_n),
            ("lm_head",
             lambda: sl.stream_linear(x, head, out_dtype=torch.float32),
             lambda: sl._stream_linear_plain(x, head,
                                             out_dtype=torch.float32),
             lambda: torch.matmul(x, head),
             D_MODEL * VOCAB * 2, VOCAB)):
        nbytes = wbytes + BATCH * D_MODEL * 2 + BATCH * n * (
            2 if name == "qkv" else 4) + (n * 2 if name == "qkv" else 0)
        bms, by = bound_ms(nbytes, 2.0 * BATCH * D_MODEL * n, dt)
        rows[name] = {"ms": time_ms(kern), "plain_ms": time_ms(plain),
                      "library_ms": time_ms(lib), "bound_ms": bms,
                      "bound_by": by, "bytes": nbytes}
        emit({"time": f"stream_linear[{name}]", **rows[name]})
    # one decode step runs both shapes once: report their sum
    row = {k: rows["qkv"][k] + rows["lm_head"][k]
           for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    row["bound_by"] = "bytes" if all(
        r["bound_by"] == "bytes" for r in rows.values()) else "operations"
    row["max_abs_err"] = res[str(torch.bfloat16)]
    return row


def _tail_weights(dtype, gen, L):
    dev = "cuda"

    def nrm(*s):
        return (torch.randn(s, generator=gen, device=dev) * 0.02).to(dtype)

    def small(*s):
        return (torch.randn(s, generator=gen, device=dev) * 0.1).to(dtype)
    return dict(
        wo=nrm(L, D_MODEL, D_MODEL), w1=nrm(L, D_MODEL, DFF),
        w2=nrm(L, DFF, D_MODEL), wq=nrm(L, D_MODEL, 3 * D_MODEL),
        bo=small(L, D_MODEL), b1=small(L, DFF), b2=small(L, D_MODEL),
        bq=small(L, 3 * D_MODEL),
        l2s=1 + torch.randn(L, D_MODEL, generator=gen, device=dev) * 0.1,
        l2b=torch.randn(L, D_MODEL, generator=gen, device=dev) * 0.1,
        l1s=1 + torch.randn(L, D_MODEL, generator=gen, device=dev) * 0.1,
        l1b=torch.randn(L, D_MODEL, generator=gen, device=dev) * 0.1)


def _call_tail(fn, att, h, p, l, L):
    nq = dict(w=p["wq"], b=p["bq"], ln_s=p["l1s"], ln_b=p["l1b"],
              layer=min(l + 1, L - 1))
    return fn(att, h, p["wo"], p["w1"], p["w2"], layer=l, bo=p["bo"],
              b1=p["b1"], b2=p["b2"], ln2_scale=p["l2s"],
              ln2_bias=p["l2b"], epsilon=1e-5, activation="gelu",
              next_qkv=nq, out_dtype=h.dtype)


def _plain_tail(att, h, wo, w1, w2, layer=None, *, bo, b1, b2, ln2_scale,
                ln2_bias, epsilon, activation=None, next_qkv=None,
                out_dtype=None, **_):
    """stream_layer_tail's signature over the plain version."""
    from paddle_tpu_torch.nn.functional.stream_linear import _tail_fallback

    stacked = wo.dim() == 3
    return _tail_fallback(att, h, wo, w1, w2, layer, bo, b1, b2, ln2_scale,
                          ln2_bias, epsilon, activation, next_qkv,
                          out_dtype or h.dtype, stacked)


def kernel_stream_layer_tail(gen) -> dict:
    from paddle_tpu_torch.nn.functional import stream_linear as sl

    L = 4
    res = {}
    # tolerances, scaled by the output's largest magnitude m: fp32 —
    # sums of up to 8192 terms in another order, 1e-4 * max(m, 1);
    # bf16 — the plain version rounds h + att.Wo, + bo, h2 + ff.W2 and
    # + b2 to bf16 one by one (half an ulp at the hidden stream's
    # magnitude each) where the kernel keeps h2 in fp32 and rounds once:
    # allow 4 bf16 ulps at m, 4 * 2^-7 * m
    for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, 2 ** -5)):
        p = _tail_weights(dtype, gen, L)
        att = torch.randn(BATCH, D_MODEL, generator=gen,
                          device="cuda").to(dtype)
        h = torch.randn(BATCH, D_MODEL, generator=gen,
                        device="cuda").to(dtype)
        ho, qkv = _call_tail(sl.stream_layer_tail, att, h, p, 1, L)
        rho, rqkv = _call_tail(_plain_tail, att, h, p, 1, L)
        ho2 = sl.stream_layer_tail(
            att, h, p["wo"], p["w1"], p["w2"], layer=2, bo=p["bo"],
            b1=p["b1"], b2=p["b2"], ln2_scale=p["l2s"], ln2_bias=p["l2b"],
            epsilon=1e-5, activation="gelu")
        rho2 = _plain_tail(
            att, h, p["wo"], p["w1"], p["w2"], layer=2, bo=p["bo"],
            b1=p["b1"], b2=p["b2"], ln2_scale=p["l2s"], ln2_bias=p["l2b"],
            epsilon=1e-5, activation="gelu")
        torch.cuda.synchronize()
        ok, err, tols = True, 0.0, {}
        for name, a, b in (("h_out", ho, rho), ("qkv_next", qkv, rqkv),
                           ("h_out_no_next", ho2, rho2)):
            m = float(b.float().abs().max())
            tol = rel * (max(m, 1.0) if dtype == torch.float32 else m)
            e = max_err(a, b)
            tols[name] = {"max_abs_err": e, "tol": tol, "max_abs_ref": m}
            ok = ok and e <= tol
            err = max(err, e)
        emit({"check": "stream_layer_tail", "dtype": str(dtype),
              "max_abs_err": err, **tols})
        check(ok, f"stream_layer_tail {dtype}: outside tolerance {tols}")
        res[str(dtype)] = err
        del p
    # timing, bf16: one tail call with the next layer's QKV, rotating
    # over 4 layers (each layer's 100.7 MB of weights is past the L2)
    dt = torch.bfloat16
    p = _tail_weights(dt, gen, L)
    att = torch.randn(BATCH, D_MODEL, generator=gen, device="cuda").to(dt)
    h = torch.randn(BATCH, D_MODEL, generator=gen, device="cuda").to(dt)
    nxt = cycler(L)
    ms = time_ms(lambda: _call_tail(sl.stream_layer_tail, att, h, p,
                                    nxt(), L))
    plain_ms = time_ms(lambda: _call_tail(_plain_tail, att, h, p, nxt(),
                                          L))
    wbytes = 2 * (D_MODEL * D_MODEL + 2 * D_MODEL * DFF
                  + D_MODEL * 3 * D_MODEL)
    vbytes = 2 * (3 * D_MODEL + DFF + 3 * D_MODEL) + 4 * 4 * D_MODEL
    iobytes = 2 * BATCH * (2 * D_MODEL + D_MODEL + 3 * D_MODEL)
    nbytes = wbytes + vbytes + iobytes
    flops = 2.0 * BATCH * wbytes / 2
    bms, by = bound_ms(nbytes, flops, dt)
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": bms, "bound_by": by, "bytes": nbytes,
           "max_abs_err": res[str(dt)]}
    emit({"time": "stream_layer_tail", **row})
    return row


def _prefill_case(dtype, gen, starts, c, g=1, d=HEAD_DIM, shared=0, L=1):
    """Kernel-4 inputs at the serving path's shapes: per row a full
    table of 128 distinct pages (a 2048-token span, page 16; the first
    ``shared`` pages common to every row), 16 kv heads (x g query heads),
    a chunk of ``c`` queries at ``starts``; an ``L``-layer folded pool
    (tables of layer l are offset by l * P) so timed calls rotate past
    the L2."""
    b, n_kv, pp = len(starts), N_HEADS, SERVE_MAX_LENGTH // PAGE
    P = b * pp + 1                             # + scratch page 0
    rng = np.random.RandomState(11)
    perm = list(rng.permutation(np.arange(1, P)))
    common = [perm.pop() for _ in range(shared)]
    tables = np.asarray([common + [perm.pop() for _ in range(pp - shared)]
                         for _ in range(b)], np.int32)
    dev = "cuda"

    def rnd(*s):
        return torch.randn(s, generator=gen, device=dev).to(dtype)
    return dict(q=rnd(b, c, n_kv * g, d), kp=rnd(L * P, n_kv, PAGE, d),
                vp=rnd(L * P, n_kv, PAGE, d), tables=tables,
                start=torch.tensor(starts, dtype=torch.int32, device=dev),
                n_kv=n_kv, P=P, L=L, pp=pp)


def kernel_paged_prefill(gen) -> dict:
    import torch.nn.functional as F

    from paddle_tpu_torch.nn.functional import flash_varlen as fv

    res = {}
    # (name, starts, chunk, valid rows, g, d, shared pages, table id
    # past the pool at (row, page))
    cases = [
        ("start0", (0,), 256, 256, 1, HEAD_DIM, 0, None),
        ("start512", (512,), 256, 256, 1, HEAD_DIM, 0, None),
        ("start1792", (1792,), 256, 256, 1, HEAD_DIM, 0, None),
        ("unaligned_padded_tail", (37,), 208, 200, 1, HEAD_DIM, 0, None),
        ("shared_prefix_two_rows", (300, 1000), 256, 256, 1, HEAD_DIM, 20,
         None),
        ("table_id_past_pool", (700,), 256, 256, 1, HEAD_DIM, 0, (0, 10)),
        ("g2_d64", (512,), 256, 256, 2, 64, 0, None),
        ("g4_d256", (512,), 256, 256, 4, 256, 0, None)]
    # tolerances, scaled by the output's largest magnitude m: both sides
    # accumulate in fp32 in another order (float32: 2e-5 * max(m, 1));
    # bf16 outputs round the same fp32 value, one rounding may flip: one
    # bf16 ulp at m, 2^(floor(log2 m) - 7)
    for name, starts, c, valid, g, d, shared, bad in cases:
        for dtype in (torch.float32, torch.bfloat16):
            a = _prefill_case(dtype, gen, starts, c, g=g, d=d, shared=shared)
            if bad is not None:
                a["tables"][bad] = a["P"]           # names no page
            tables = torch.from_numpy(a["tables"]).cuda()
            out = fv.paged_prefill_attention(a["q"], a["kp"], a["vp"],
                                             tables, a["start"],
                                             n_kv=a["n_kv"])
            ref = fv._paged_prefill_plain(a["q"], a["kp"], a["vp"], tables,
                                          a["start"], n_kv=a["n_kv"])
            torch.cuda.synchronize()
            out, ref = out[:, :valid], ref[:, :valid]
            m = float(ref.float().abs().max())
            tol = (2e-5 * max(m, 1.0) if dtype == torch.float32
                   else 2.0 ** (np.floor(np.log2(m)) - 7))
            err = max_err(out, ref)
            emit({"check": "paged_prefill_attention", "case": name,
                  "starts": list(starts), "c": c, "valid_rows": valid,
                  "g": g, "d": d, "dtype": str(dtype), "max_abs_err": err,
                  "tol": tol, "max_abs_ref": m})
            check(err <= tol, f"paged prefill {name} {dtype}: {err} > "
                              f"{tol}")
            if name == "start1792":
                res[str(dtype)] = err
            del a, out, ref
    # timing, bf16, the last chunk of a 2048-token context, rotating
    # over 4 layers of the pool (16.8 MB of K/V each, past the L2)
    start, c = SERVE_MAX_LENGTH - SERVE_CHUNK, SERVE_CHUNK
    a = _prefill_case(torch.bfloat16, gen, (start,), c, L=4)
    P, n_kv, d = a["P"], a["n_kv"], HEAD_DIM
    tables = [torch.from_numpy(a["tables"] + l * P).cuda()
              for l in range(a["L"])]
    nxt = cycler(a["L"])

    def kern():
        fv.paged_prefill_attention(a["q"], a["kp"], a["vp"], tables[nxt()],
                                   a["start"], n_kv=n_kv)

    def plain():
        fv._paged_prefill_plain(a["q"], a["kp"], a["vp"], tables[nxt()],
                                a["start"], n_kv=n_kv)
    # library yardstick: SDPA over the K/V already gathered dense, masked
    # by position (key <= query)
    S = a["pp"] * PAGE
    dense = [(a["kp"][t.long()[0]].transpose(0, 1).reshape(1, n_kv, S, d),
              a["vp"][t.long()[0]].transpose(0, 1).reshape(1, n_kv, S, d))
             for t in tables]
    qd = a["q"].transpose(1, 2).contiguous()            # [1, n_q, c, d]
    mask = (torch.arange(S, device="cuda")[None, :]
            <= start + torch.arange(c, device="cuda")[:, None])

    def library():
        kd, vd = dense[nxt()]
        F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)
    ms, plain_ms, lib_ms = time_ms(kern), time_ms(plain), time_ms(library)
    # what these inputs need: every K/V row below the last query's
    # position once, q and the output once; q.k and p.v over the causal
    # span of each query
    isz = 2
    n_q = a["q"].shape[2]
    keys = min(S, start + c)
    nbytes = (2 * keys * n_kv * d * isz + 2 * c * n_q * d * isz
              + a["pp"] * 4 + 4)
    flops = 4.0 * n_q * d * sum(start + t + 1 for t in range(c))
    bms, by = bound_ms(nbytes, flops, torch.bfloat16)
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bms, "bound_by": by, "bytes": nbytes,
           "flops": flops, "start": start, "c": c,
           "max_abs_err": res[str(torch.bfloat16)]}
    emit({"time": "paged_prefill_attention", **row})
    return row


# ---------------------------------------------------------------- slice

def _counters():
    from paddle_tpu_torch.nn.functional import flash_varlen as fv
    from paddle_tpu_torch.nn.functional import paged_attention as pa
    from paddle_tpu_torch.nn.functional import stream_linear as sl

    return {"paged_decode_attention_inplace": pa.launches,
            "stream_linear": sl.launches,
            "stream_layer_tail": sl.tail_launches,
            "paged_prefill_attention": fv.launches}


#: CUDA launches of one stream_layer_tail call with the next layer's
#: QKV: O-proj, FFN1, FFN2 and QKV' GEMMs, LN2 and LN1'
TAIL_LAUNCHES_PER_CALL = 6


def _expected_launches(decode_steps: int, prefills: int,
                       prefill_chunks: int = 0) -> dict:
    """Launches of the grouped, prefetching decode path: per step one
    attention and one tail call per layer, the layer-0 QKV and the LM
    head; per one-shot prefill one LM head; per chunk of the chunked
    prefill one paged-prefill attention per layer and one LM head."""
    return {"paged_decode_attention_inplace": N_LAYERS * decode_steps,
            "stream_linear": 2 * decode_steps + prefills + prefill_chunks,
            "stream_layer_tail":
                TAIL_LAUNCHES_PER_CALL * N_LAYERS * decode_steps,
            "paged_prefill_attention": N_LAYERS * prefill_chunks}


def _check_launches(path: str, counts: dict, expect: dict) -> None:
    """Exact counts; every kernel the path runs launched at least once."""
    for name, n in counts.items():
        check(n > 0 or expect[name] == 0, f"{path} did not launch {name}")
        check(n == expect[name], f"{path} launched {name} {n} times, "
                                 f"expected {expect[name]}")


def _reset_counters():
    from paddle_tpu_torch.nn.functional import flash_varlen as fv
    from paddle_tpu_torch.nn.functional import paged_attention as pa
    from paddle_tpu_torch.nn.functional import stream_linear as sl

    pa.launches = 0
    sl.launches = 0
    sl.tail_launches = 0
    fv.launches = 0


@contextlib.contextmanager
def plain_path():
    """The decode step and the chunked prefill with every kernel call
    replaced by its plain PyTorch version (the reference for the
    teacher-forced and chunked-prefill checks)."""
    from unittest import mock

    from paddle_tpu_torch.incubate.nn import fused_transformer as ft
    from paddle_tpu_torch.inference import engine as eng
    from paddle_tpu_torch.nn.functional import flash_varlen as fv
    from paddle_tpu_torch.nn.functional import paged_attention as pa
    from paddle_tpu_torch.nn.functional import stream_linear as sl

    def attn(q, k, v, ck, cv, lens, tbl, pool_base=None, pool_pages=None):
        return (pa._paged_decode_plain(q, k, v, ck, cv, lens, tbl,
                                       pool_base or 0, pool_pages), ck, cv)

    def lin(x, w, layer=None, bias=None, activation=None, out_dtype=None,
            **_):
        return sl._stream_linear_plain(x, w, layer, bias, activation,
                                       out_dtype)
    with mock.patch.object(ft, "paged_decode_attention_inplace", attn), \
            mock.patch.object(ft, "stream_linear", lin), \
            mock.patch.object(ft, "stream_layer_tail", _plain_tail), \
            mock.patch.object(ft, "paged_prefill_attention",
                              fv._paged_prefill_plain), \
            mock.patch.object(eng, "stream_linear", lin):
        yield


def _build_model():
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.inference import FusedCausalLM

    ptt.seed(0)
    model = FusedCausalLM(
        vocab_size=VOCAB, embed_dim=D_MODEL, num_heads=N_HEADS,
        dim_feedforward=DFF, num_layers=N_LAYERS,
        max_position=SERVE_MAX_LENGTH + SERVE_CHUNK)
    st = model.stack
    # bench.py's serving recipe: bf16 matmul stacks and biases, fp32 LNs
    for n in ("qkv_weight", "qkv_bias", "out_weight", "out_bias",
              "ffn1_weight", "ffn1_bias", "ffn2_weight", "ffn2_bias"):
        p = getattr(st, n)
        p.data = p.data.to(torch.bfloat16)
    return model


def slice_generate(model) -> dict:
    from paddle_tpu_torch.inference import GenerationEngine

    eng = GenerationEngine(model, page_size=PAGE,
                           max_length=PROMPT + NEW_TOKENS)
    ids = np.random.RandomState(0).randint(0, VOCAB, (BATCH, PROMPT))
    eng.generate(ids[:, :16], max_new_tokens=4)          # warm-up
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    out = eng.generate(ids, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _counters()
    expect = _expected_launches(NEW_TOKENS - 1, 1)   # first token: prefill
    # seconds and tokens/s cover the whole call, the prefill included
    emit({"phase": "generate", "batch": BATCH, "prompt": PROMPT,
          "new_tokens": NEW_TOKENS, "seconds": dt,
          "tokens_per_s": BATCH * NEW_TOKENS / dt,
          "launches": counts, "expected_launches": expect})
    check(out.shape == (BATCH, PROMPT + NEW_TOKENS), "generate shape")
    check(bool((out >= 0).all() and (out < VOCAB).all()),
          "generate: token ids outside the vocabulary")
    check(bool((out[:, :PROMPT] == ids).all()), "generate: prompt lost")
    _check_launches("generate", counts, expect)
    return counts


def _prefilled(model, b: int, steps: int, seed: int) -> dict:
    """A prefilled batch of ``b`` random prompts of PROMPT tokens with
    pages for ``steps`` more, and what a decode step needs."""
    from paddle_tpu_torch.inference import (BlockKVCacheManager,
                                            GenerationEngine)

    eng = GenerationEngine(model, page_size=PAGE,
                           max_length=PROMPT + steps + 1)
    st = model.stack
    pages_per_seq = -(-(PROMPT + steps + 1) // PAGE)
    mgr = BlockKVCacheManager(st.num_layers, st.num_kv_heads, st.head_dim,
                              PAGE, num_pages=b * pages_per_seq + 1,
                              dtype=torch.bfloat16, reserve_scratch=True)
    for i in range(b):
        mgr.allocate(i, PROMPT + steps + 1)
    tables = mgr.block_tables(range(b), pages_per_seq)
    cache = mgr.fresh_cache()
    ids = torch.from_numpy(np.random.RandomState(seed).randint(
        0, VOCAB, (b, PROMPT))).cuda()
    lens = torch.full((b,), PROMPT, dtype=torch.int32, device="cuda")
    w, emb, head = eng._weights(), eng._embed(), eng._head_t
    lnf_s, lnf_b = eng._lnf()
    logits, ck, cv = eng._prefill_fn(w, emb, head, lnf_s, lnf_b, ids, lens,
                                     cache.k, cache.v, tables)
    return dict(eng=eng, st=st, tables=tables, ck=ck, cv=cv, lens=lens,
                tok=eng._argmax(logits), w=w, emb=emb, head=head,
                lnf_s=lnf_s, lnf_b=lnf_b)


def slice_teacher_forced(model, steps: int = 16) -> None:
    """Kernel path and plain path decode the same tokens from the same
    prefilled pool; their logits must agree within the bf16 tolerance."""
    from paddle_tpu_torch.incubate.nn.fused_transformer import PagedKV

    b = 8
    s = _prefilled(model, b, steps, seed=1)
    eng, st, tables, ck, cv = (s[k] for k in ("eng", "st", "tables", "ck",
                                               "cv"))
    w, emb, head, lnf_s, lnf_b = (s[k] for k in ("w", "emb", "head",
                                                  "lnf_s", "lnf_b"))
    tok, lens = s["tok"], s["lens"]
    ck2, cv2 = ck.clone(), cv.clone()
    # tolerance: logits have std ~0.9 (LN output x 0.02 embedding over
    # 2048 lanes); the paths round bf16 intermediates at different
    # points (h2, hn, ff), a few 2^-9 relative each per layer
    tol = 0.1
    errs, agree = [], 0
    pos = lens.clone()
    for _ in range(steps):
        x = emb[tok.long()].to(torch.bfloat16)
        h, _ = st.decode_raw(w, x, PagedKV(ck, cv), tables, pos,
                             eng._cos, eng._sin)
        lk = eng._logits(h, head, lnf_s, lnf_b)
        with plain_path():
            h2, _ = st.decode_raw(w, x, PagedKV(ck2, cv2), tables, pos,
                                  eng._cos, eng._sin)
            lp = eng._logits(h2, head, lnf_s, lnf_b)
        check(bool(torch.isfinite(lk).all()), "kernel-path logits finite")
        errs.append(max_err(lk, lp))
        tk = eng._argmax(lk)
        agree += int((tk == eng._argmax(lp)).sum())
        tok = tk
        pos = pos + 1
    emit({"phase": "teacher_forced", "steps": steps, "batch": b,
          "logits_max_abs_err": max(errs), "per_step": errs, "tol": tol,
          "argmax_agreement": agree / (steps * b)})
    check(max(errs) <= tol, f"teacher-forced logits differ by "
                            f"{max(errs)} > {tol}")


def slice_decode_step(model, out_dir, steps: int = 16) -> None:
    """One decode step at batch 32 after a 128-token prompt: a chunk of
    ``steps`` steps (one host sync) timed bare, three times, for the
    wall per step; then once more under torch.profiler for the device
    time by kernel. The idle share is 1 - device busy / bare wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    s = _prefilled(model, BATCH, steps, seed=3)
    eng = s["eng"]

    def chunk():
        eng._decode_k_fn(s["w"], s["emb"], s["head"], s["lnf_s"],
                         s["lnf_b"], s["tok"], s["lens"], s["ck"], s["cv"],
                         s["tables"], k=steps)

    def timed() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3
    timed()                                          # warm-up
    walls = [timed() for _ in range(3)]
    wall_ms = sorted(walls)[1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms = timed()
    groups = {"paged_decode_kernel": "paged_decode_attention_inplace",
              "stream_linear_kernel": "stream_linear GEMM (QKV, head, "
                                      "tail projections)",
              "layer_norm_kernel": "tail LayerNorm"}
    by_group, kernels = {}, []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.self_device_time_total
        kernels.append((ev.key, us / steps / 1e3, ev.count / steps))
        g = next((v for k, v in groups.items() if k in ev.key),
                 "PyTorch ops (rope, LN1, embed, argmax, copies)")
        by_group[g] = by_group.get(g, 0.0) + us / steps / 1e3
    busy = sum(by_group.values())
    kernels.sort(key=lambda r: -r[1])
    emit({"phase": "decode_step", "batch": BATCH, "context": PROMPT,
          "steps": steps, "wall_ms_per_step": wall_ms,
          "wall_ms_per_step_runs": walls,
          "profiled_wall_ms_per_step": profiled_ms,
          "device_busy_ms_per_step": busy if busy else None,
          "device_idle_share": (1 - busy / wall_ms) if busy else None,
          "device_ms_per_step_by_group": by_group,
          "top_kernels": [{"name": k[:60], "ms_per_step": ms,
                           "launches_per_step": n}
                          for k, ms, n in kernels[:6]]})
    if out_dir:
        with open(os.path.join(out_dir, "profile.txt"), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40))


def slice_continuous(model) -> dict:
    """12 requests through a ContinuousBatchingEngine of 8 slots at
    decode chunk 16: two waves (8, then 4 with four idle slots), each
    one prefill per request and two chunks (31 tokens after the
    prefill's first), so 64 decode steps and 12 prefills."""
    from paddle_tpu_torch.inference import ContinuousBatchingEngine
    from paddle_tpu_torch.profiler import stats

    n_req, max_batch, chunk, new = 12, 8, 16, 32
    eng = ContinuousBatchingEngine(model, max_batch=max_batch,
                                   page_size=PAGE, max_length=256,
                                   decode_chunk=chunk)
    free0 = eng._mgr.free_pages
    lens = np.linspace(17, 200, n_req).astype(int)
    rng = np.random.RandomState(2)
    for n in lens:
        eng.submit(rng.randint(0, VOCAB, int(n)), max_new_tokens=new)
    steps0 = stats.counter("serving.decode_steps").value
    admitted0 = stats.counter("serving.admitted").value
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _counters()
    steps = stats.counter("serving.decode_steps").value - steps0
    prefills = stats.counter("serving.admitted").value - admitted0
    waves = -(-n_req // max_batch)
    expect_steps = waves * -(-(new - 1) // chunk) * chunk
    expect = _expected_launches(expect_steps, n_req)
    emit({"phase": "continuous_batching", "requests": len(done),
          "prompt_lens": [int(n) for n in lens], "seconds": dt,
          "decode_steps": steps, "prefills": prefills,
          "launches": counts, "expected_launches": expect,
          "free_pages_start": free0, "free_pages_end":
          eng._mgr.free_pages})
    check(steps == expect_steps and prefills == n_req,
          f"continuous batching ran {steps} decode steps and {prefills} "
          f"prefills, expected {expect_steps} and {n_req}")
    _check_launches("continuous batching", counts, expect)
    check(len(done) == 12, f"{len(done)} of 12 requests finished")
    check(all(len(r.generated) == 32 for r in done),
          "a request finished with other than 32 tokens")
    check(all(0 <= t < VOCAB for r in done for t in r.generated),
          "continuous batching: token ids outside the vocabulary")
    check(eng._mgr.free_pages == free0,
          "the pool's free pages did not return to their start value")
    return counts


def slice_serving(model) -> dict:
    """The SLO serving frontend at full width: ServingEngine with 8 slots,
    page 16, max_length 2048, decode chunk 16 and prefill chunks of 256.
    A 512-token system prompt S; the first request, S + 64 tokens, is
    stepped into decode so its prefix is registered; then 7 more of S +
    16..240 tokens and 8 independent prompts of 40..1500 tokens, all
    with 64 new tokens, are served to the end step by step."""
    from paddle_tpu_torch.profiler import stats
    from paddle_tpu_torch.serving import ServingEngine, SLOConfig

    new = 64
    slo = SLOConfig(prefill_chunk=SERVE_CHUNK)
    eng = ServingEngine(model, max_batch=8, page_size=PAGE,
                        max_length=SERVE_MAX_LENGTH, decode_chunk=16,
                        slo=slo)
    free0 = eng._mgr.free_pages
    rng = np.random.RandomState(4)
    sys_prompt = rng.randint(0, VOCAB, 512)
    first = np.concatenate([sys_prompt, rng.randint(0, VOCAB, 64)])
    shared = [np.concatenate([sys_prompt, rng.randint(0, VOCAB, int(n))])
              for n in rng.randint(16, 241, 7)]
    indep = [rng.randint(0, VOCAB, int(n))
             for n in np.linspace(40, 1500, 8).astype(int)]
    trace = []                        # (action, decoding before the step)

    def step():
        decoding, n = eng.num_active > 0, len(eng.action_log)
        eng.step()
        trace.append((eng.action_log[n] if len(eng.action_log) > n
                      else None, decoding))
    stats.reset()
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    rids = [eng.submit(first, max_new_tokens=new)]
    while not eng.num_active:
        step()
    rids += [eng.submit(p, max_new_tokens=new) for p in shared + indep]
    while eng.has_work:
        step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _counters()
    chunks = stats.counter("serve.prefill_chunks").value
    dsteps = stats.counter("serving.decode_steps").value
    expect = _expected_launches(dsteps, 0, chunks)
    done = {r.id: r for r in eng.finished}
    # the stall bound: consecutive prefill chunks while a request decodes
    streak = longest = 0
    for action, decoding in trace:
        streak = streak + 1 if action == "prefill" and decoding else 0
        longest = max(longest, streak)
    hit = stats.counter("serving.prefix_hit").value
    saved = stats.counter("serving.prefix_pages_saved").value
    free_end = eng._mgr.free_pages
    cleared = eng.prefix_cache.clear()
    ttft = stats.histogram("serve.ttft_ms").summary()
    tpot = stats.histogram("serve.tpot_ms").summary()
    # where the serve's wall went, by scheduler phase (each chunk ends in
    # its token fetch, so a chunk's wall holds its device time)
    phase_ms = {p: stats.histogram(f"serve.step.{p}_ms").total
                for p in ("admit", "prefill_chunk", "decode_chunk",
                          "host_overhead")}
    emit({"phase": "serving", "requests": len(done),
          "prompt_lens": [len(first)] + [len(p) for p in shared + indep],
          "seconds": dt, "tokens_per_s": len(rids) * new / dt,
          "ttft_ms_p50": ttft["p50"], "ttft_ms_p99": ttft["p99"],
          "tpot_ms_p50": tpot["p50"], "tpot_ms_p99": tpot["p99"],
          "step_ms_by_phase": phase_ms,
          "prefill_chunks": chunks, "decode_steps": dsteps,
          "prefill_tokens": stats.counter("serve.prefill_tokens").value,
          "prefix_hit": hit, "prefix_pages_saved": saved,
          "steps": len(trace), "actions": {
              a: eng.action_log.count(a) for a in ("prefill", "decode")},
          "longest_prefill_streak_while_decoding": longest,
          "prefill_burst": slo.prefill_burst,
          "launches": counts, "expected_launches": expect,
          "free_pages_start": free0, "free_pages_end": free_end,
          "prefix_pages_cleared": cleared,
          "free_pages_after_clear": eng._mgr.free_pages})
    check(sorted(done) == sorted(rids),
          f"{len(done)} of {len(rids)} requests finished")
    check(all(done[r].state == "ok" and len(done[r].generated) == new
              for r in rids), f"a request ended other than ok with {new} "
                              "tokens")
    check(all(0 <= t < VOCAB for r in rids for t in done[r].generated),
          "serving: token ids outside the vocabulary")
    check(hit >= 7 and saved >= 7 * 32,
          f"prefix cache: {hit} hits saving {saved} pages, expected >= 7 "
          "and >= 224")
    check(eng.action_log.count("prefill") > 0
          and eng.action_log.count("decode") > 0,
          "serving: prefill and decode did not both run")
    check(longest <= slo.prefill_burst,
          f"{longest} consecutive prefill chunks while a request decoded "
          f"(bound {slo.prefill_burst})")
    check(eng._mgr.free_pages == free0,
          "the pool's free pages did not return to their start value "
          "after the prefix cache was cleared")
    _check_launches("serving", counts, expect)
    return counts


def slice_chunked_prefill(model) -> None:
    """One 1500-token prompt prefilled in chunks of 256 (the tail chunk
    bucket-padded to 224), as the serving frontend does, on the kernel
    path and on the plain path, each into its own pool; the logits of
    the last prompt position must agree."""
    from paddle_tpu_torch.inference import (BlockKVCacheManager,
                                            GenerationEngine)

    n, c, bucket = 1500, SERVE_CHUNK, 16
    st = model.stack
    eng = GenerationEngine(model, page_size=PAGE,
                           max_length=SERVE_MAX_LENGTH)
    pp = SERVE_MAX_LENGTH // PAGE
    ids = torch.from_numpy(np.random.RandomState(5).randint(
        0, VOCAB, n)).cuda()
    w, emb, head = eng._weights(), eng._embed(), eng._head_t
    lnf_s, lnf_b = eng._lnf()

    def prefill():
        mgr = BlockKVCacheManager(st.num_layers, st.num_kv_heads,
                                  st.head_dim, PAGE, num_pages=pp + 1,
                                  dtype=torch.bfloat16,
                                  reserve_scratch=True, device=model.device)
        mgr.allocate(0, n)
        tables = mgr.block_tables([0], pp)
        cache = mgr.fresh_cache()
        for s0 in range(0, n, c):
            m = min(c, n - s0)
            cp = -(-m // bucket) * bucket
            chunk = torch.zeros(1, cp, dtype=torch.long, device="cuda")
            chunk[0, :m] = ids[s0:s0 + m]
            h, cache = st.prefill_chunk_raw(
                w, emb[chunk].to(torch.bfloat16), cache, tables,
                torch.tensor([s0], dtype=torch.int32, device="cuda"),
                torch.tensor([m], dtype=torch.int32, device="cuda"),
                eng._cos, eng._sin)
        return eng._logits(h[:, m - 1], head, lnf_s, lnf_b)
    lk = prefill()
    with plain_path():
        lp = prefill()
    torch.cuda.synchronize()
    # tolerance: as for the teacher-forced decode — logits of std ~0.9;
    # the two attention paths sum in fp32 in another order and round to
    # bf16, a flipped rounding (2^-8 relative) then passes through 24
    # layers of bf16 products
    tol = 0.1
    err = max_err(lk, lp)
    agree = bool((eng._argmax(lk) == eng._argmax(lp)).all())
    emit({"phase": "chunked_prefill", "prompt": n, "chunk": c,
          "chunks": -(-n // c), "logits_max_abs_err": err, "tol": tol,
          "first_token_agrees": agree})
    check(bool(torch.isfinite(lk).all()), "chunked prefill: logits finite")
    check(err <= tol, f"chunked prefill logits differ by {err} > {tol}")


# ---------------------------------------------------------------- main

_SOURCES = {
    "paged_decode_attention_inplace": (
        "paddle_tpu_torch/csrc/paged_attention.cu",
        "paddle_tpu/nn/functional/paged_attention.py:489"),
    "stream_linear": (
        "paddle_tpu_torch/csrc/stream_linear.cu",
        "paddle_tpu/nn/functional/stream_linear.py:289"),
    "stream_layer_tail": (
        "paddle_tpu_torch/csrc/stream_linear.cu",
        "paddle_tpu/nn/functional/stream_linear.py:482"),
    "paged_prefill_attention": (
        "paddle_tpu_torch/csrc/flash_varlen.cu",
        "paddle_tpu/nn/functional/flash_varlen.py:906"),
}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for compiler logs and result lines")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    sys.path.insert(0, HERE)
    import paddle_tpu_torch  # noqa: F401  (fails outside the repo)

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_device()
    phase_build(args.out)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {"paged_decode_attention_inplace": kernel_paged_attention(gen),
            "stream_linear": kernel_stream_linear(gen),
            "stream_layer_tail": kernel_stream_layer_tail(gen),
            "paged_prefill_attention": kernel_paged_prefill(gen)}
    model = _build_model()
    by_path = {"generate": slice_generate(model)}
    slice_teacher_forced(model)
    slice_decode_step(model, args.out)
    by_path["continuous_batching"] = slice_continuous(model)
    by_path["serving"] = slice_serving(model)
    slice_chunked_prefill(model)
    kernels = []
    for name, row in rows.items():
        src, replaces = _SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {p: c[name] for p, c in by_path.items()},
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    emit({"kernels": kernels})
    emit({"phase": "done", "wall_s": time.perf_counter() - t_start})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.jsonl"), "w") as f:
            f.write("\n".join(_LINES) + "\n")


if __name__ == "__main__":
    main()
