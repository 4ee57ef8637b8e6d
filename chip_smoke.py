#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one GPU.

    python3 chip_smoke.py [--out DIR]

Phases, all run every time, each of which fails the run when it fails:
  device   the card's name and power limit, as nvidia-smi reports them;
  build    the CUDA kernels from csrc/, one nvcc per source in parallel,
           then the machine code of the redesigned bf16 kernels read back
           (cuobjdump -sass: HGMMA in B10-B15, HMMA or HGMMA in B2 and B7,
           HMMA in B1, B8, B9 and B16, IMMA in B5 and B6; no ptxas
           spill);
  kernels  each kernel against its plain PyTorch version at the serving
           path's shapes, in bfloat16 and float32 (tolerances printed;
           the paged-prefill kernel on 16 cases with a swapped-pages
           control that must fail; B2's split-K merge at the tail's
           N = 2048 shapes and B5's at its four projections, repeatable
           bit for bit, each with a control that leaves out one K slice),
           then timed with CUDA events (and, for most kernels, the
           profiler's device time) beside its plain version, one
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
           system prompt, with its own launch counts; one 1500-token
           prompt prefilled chunk by chunk on the kernel path and on
           the plain path, whose last logits must agree; and one
           256-token chunk at start 1792 timed through the stack
           (prefill_chunk: wall, device ms, the paged-prefill kernel's
           share, the top host ops);
  quantized the quantized kernels (the int8-weight GEMM and tail, the
           A8W8 GEMM, the int8-KV decode attention: also with NaN scales
           past every row's length, on long split rows, and a control
           skipping each row's last live page) checked and timed with
           the others; then the same model's stack quantized to
           int8 in place and driven through bench.py's quantized decode
           rungs — generate_int8 (b32), generate_a8w8 (b32),
           generate_int8kv (int8 weights and KV pool, b64), each with a
           teacher-forced check against the plain path and a timed,
           profiled decode step — and serving_int8kv, the serving
           workload above over int8 weights and an int8 pool;
  moe/lora the ragged grouped GEMM (B14, with a control that drops one
           expert's first 64-wide k-step) and the LoRA delta (B16) checked
           against their plain versions at the MoE rung's and the
           d2048 projections' shapes, and timed; serving_lora, the
           serving workload above (on the bf16 stack, before it is
           quantized) under a 4-slot AdapterBank with requests stamped
           round-robin over four adapters and the base model and a hot
           swap between its halves, every step's launches checked, and
           a teacher-forced adaptered decode against the plain path;
           then bench.py's MoE decode rung (d1024, 12 layers, 8 experts,
           top-2) at batch 32 through GenerationEngine (generate_moe),
           its teacher-forced check (route agreement and logits on the
           rows whose routes agree, with a faulty-FFN2 control) and a
           profiled decode step (decode_step_moe);
  train    dense flash attention (B10: the forward and the dq and dk/dv
           backward kernels; bf16 at head_dim 64-128 the wgmma kernels
           flash_*_wgmma on a dense walk) checked against its plain
           versions at the training rung's shapes, at lengths that are
           multiples of 64 but not of 128 and at cross lengths (bf16
           limits from a one-ulp witness, a faulty control per kernel)
           and timed (events and profiler device time) beside
           scaled_dot_product_attention and the aten flash backward;
           then bench.py's gpt3-1.3b training rung (d2048, 24 layers,
           seq 1024, batch 4, the _FAST options) through the port's
           bench.make_train_step: the kernel route against the plain
           attention route from one initial
           state (logits, loss, every gradient, 3 steps' losses, each
           within twice a one-ulp witness, a faulty control outside),
           5 timed steps (tokens/s, MFU, device busy and idle share,
           peak memory, 24 launches of each B10 kernel a step) and 2
           steps with remat="full" (48 forward launches a step); B10 at
           head_dim 96 is checked and timed at the gpt-760m rung's shape
           too;
  varlen   packed varlen flash attention (B11-B13: the forward, dq and
           dk/dv kernels over the block map) checked against its plain
           versions (the JAX XLA tile walks) on seven packs: the
           --attn-varlen rung (8 causal segments of 4096, 16 heads of
           128, bf16), a 72-document ragged pack, totals off the tile, an
           empty key segment (rows exactly 0), non-causal, f32 at
           head_dim 64 and bf16 at 96 (witness limits as for B10, one
           faulty-map control per kernel; a second backward bitwise
           equal to the first), and timed beside the aten varlen flash
           forward and backward, also as one flash_attn_unpadded
           forward + backward through autograd; then slice_attn_varlen:
           bench.run_attn_varlen_bench() (21 forward launches; tokens/s,
           peak memory O(T·d)) and one training-shaped flash_attn_unpadded
           call on the ragged pack (one launch of each kernel, held to
           the plain route); and slice_train_760m: bench.py's gpt-760m
           rung (head_dim 96) for 3 timed steps, 24 launches of each B10
           kernel a step;
  moe train the ragged grouped weight gradient (B15) and B14's backward
           mode (dx over the bank read transposed) checked against their
           plain versions at the MoE training rung's two banks from 8192
           rows, bf16 and f32, four offset layouts (witness limits, a
           faulty control per kernel, empty experts exactly 0), and
           timed beside torch._grouped_mm; B10 at head_dim 64 is checked
           and timed at that rung's attention shape with the other B10
           cases. Then slice_train_moe: bench.py's --moe-train rung
           (d1024, 12 layers, 8 experts top-2 no-drop, seq 1024, batch
           4) through the port's bench.make_moe_train_step: one MoE
           layer's forward and backward held to the plain route, a
           3-step loss trajectory on the plain, witness and kernel
           routes with per-layer route agreement, the eager no-drop pin,
           8 timed steps (tokens/s, MFU by activated FLOPs, device idle
           share, peak memory; 60 B14, 24 B15, 12/12/12 B10 launches a
           step).
  backends the decode backends of FLAGS_paged_attention_backend: B7
           (stream_paged, pool streaming), B8 (fused_paged, B1's tile
           walk with no current token) and B9 (pallas_paged: the same
           walk under its own name, held to the stock kernel's compute
           blocks; both also on long rows they split) checked
           against their plain versions on the decode check's inputs (an
           empty row exactly 0, a shared page, an id past the region; a
           control per kernel) and timed beside
           SDPA over gathered K/V; then, on the bf16 d2048·L24 model
           before it is quantized, generate_fused and generate_pallas
           (b32, prompt 128, 33 new tokens: 24 launches of B8 or B9 a
           decode step, none of B1) with their teacher-forced checks,
           one decode step under stream (B1, not B7), xla raising on the
           card, and the public paged_attention under auto on a live
           pool for each layer (stream, 48 launches). Then, on the same
           model, sampled decoding (generate at b32 with temperature 0.8,
           top-k 50, top-p 0.9 from an explicit generator beside greedy,
           launches as greedy's, top_k=1 bitwise greedy, 10^5 draws on one
           logits row within a total-variation limit of the filtered
           softmax) and speculative decoding (bench.py's --decode-spec
           protocol: 8 requests, prompt 128, 128 new, spec_k 4, a
           ScheduledDrafter replaying the plain run's streams; tokens/s
           of both, accept rate, rounds, 24 B4 launches a verify round,
           the pool drained; the verify pass held to the decode step
           teacher-forced; a few rounds with SelfDraftHeads and with a
           d1024·L4 draft model). B10 is also
           checked at head_dim 80 and B11-B13 at 40, both zero-padded
           by their wrappers, with the padding's cost timed (B11-B13
           are also timed at 96 and 256).
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
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

#: published peaks of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}

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


def device_ms(fn, kernel, iters: int = 20, per_call=None,
              attempts: int = 4) -> float:
    """Device time per call of ``fn`` spent in the CUDA kernels whose
    name holds ``kernel`` (a name, or a tuple of names), by
    torch.profiler: the kernels alone, where ``time_ms`` also counts the
    gaps a host-bound caller leaves. With ``per_call`` (the launches one
    call makes) the time is the mean of the launches the profiler
    recorded times ``per_call``, which stays right when it drops some of
    a long process's events. A window in which the profiler recorded
    none of them (it drops every event now and then in a long process)
    is profiled again, up to ``attempts`` windows; 0.0 after that."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA
               and any(k in ev.key for k in names)]
        n = sum(ev.count for ev in evs)
        if n:
            us = sum(ev.self_device_time_total for ev in evs)
            return us / iters / 1e3 if per_call is None else \
                us / n * per_call / 1e3
    return 0.0


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

#: the redesigned kernels whose machine code the build phase reads back:
#: library, kernel name, the tensor-core instruction each was built
#: around (HGMMA: wgmma; HMMA: mma.sync)
DESIGNED_SASS = (("grouped_gemm", "grouped_gemm_wgmma", ("HGMMA",)),
                 ("flash_attention", "flash_fwd_wgmma", ("HGMMA",)),
                 ("flash_attention", "flash_bwd_dq_wgmma", ("HGMMA",)),
                 ("flash_attention", "flash_bwd_dkv_wgmma", ("HGMMA",)),
                 ("stream_linear", "stream_gemm_mma", ("HMMA", "HGMMA")),
                 ("grouped_gemm", "grouped_dw_wgmma", ("HGMMA",)),
                 ("flash_varlen_packed", "varlen_fwd_wgmma", ("HGMMA",)),
                 ("flash_varlen_packed", "varlen_bwd_dq_wgmma", ("HGMMA",)),
                 ("flash_varlen_packed", "varlen_bwd_dkv_wgmma",
                  ("HGMMA",)),
                 ("paged_attention_q", "paged_decode_q_mma", ("IMMA",)),
                 ("paged_backends", "stream_walk_bf16", ("HMMA", "HGMMA")),
                 ("paged_attention", "paged_decode_mma", ("HMMA",)),
                 ("grouped_gemm", "lora_delta_mma", ("HMMA",)),
                 ("stream_linear_a8w8", "a8w8_mma", ("IMMA",)),
                 ("paged_backends", "fused_paged_mma", ("HMMA",)),
                 ("paged_backends", "pallas_paged_mma", ("HMMA",)))


def _sass_functions(path) -> dict:
    """{mangled kernel name: SASS text} of a built library, by cuobjdump
    (beside nvcc)."""
    from paddle_tpu_torch import _kernels

    tool = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {k: "\n".join(v) for k, v in funcs.items()}


def _ptxas_info(log: str) -> dict:
    """{mangled name: {"registers", "spill_stores", "spill_loads"}} from
    an nvcc -Xptxas -v log."""
    info, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$.]+)'?", line)
        if m:
            cur = info.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return info


def phase_build(out_dir):
    """Every library built from csrc/, one nvcc per source in parallel;
    then the redesigned kernels' machine code read back: each
    instantiation of the bf16 kernels of B14, B15, B10 and B11-B13 (d64,
    d96, d128) must hold HGMMA (wgmma), B2's and B7's bf16 kernels HMMA or
    HGMMA, B5's and B6's kernels IMMA (int8 mma.sync) and B1's, B8's, B9's
    and B16's bf16 kernels HMMA, with no register spill in ptxas's
    report."""
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
    for lib, kernel, opcodes in DESIGNED_SASS:
        funcs = {k: v for k, v in _sass_functions(
            _kernels._lib_path(lib)).items() if kernel in k}
        ptxas = _ptxas_info(done[lib]["log"]) if lib in done else {}
        check(bool(funcs), f"build: no {kernel} kernel in lib{lib}")
        for name, sass in funcs.items():
            found = [op for op in opcodes if op in sass]
            info = ptxas.get(name, {})
            emit({"check": "sass", "kernel": name, "wants": list(opcodes),
                  "found": found, "registers": info.get("registers"),
                  "spill_stores": info.get("spill_stores"),
                  "spill_loads": info.get("spill_loads"),
                  "ptxas": "reported" if info else
                  "not reported (library not compiled in this run)"})
            check(bool(found), f"build: {name} holds none of {opcodes}")
            check(not info.get("spill_stores") and
                  not info.get("spill_loads"),
                  f"build: {name} spills registers ({info})")


# ---------------------------------------------------------------- kernels

#: contexts of the decode-kernel checks (page 16, 17 pages a row): page
#: edges up to 272, an idle slot (0) and a full table (the last)
DECODE_LENS = [0, 1, 15, 16, 17, 31, 32, 33, 47, 48, 63, 64, 65, 100, 127,
               128, 129, 143, 144, 160, 175, 176, 200, 223, 224, 240, 255,
               256, 257, 260, 271, 17 * PAGE]


def _decode_tables(lens, pp: int, seed: int):
    """Block tables for rows of ``lens`` tokens: distinct random pages
    (never the scratch page 0) covering lens + 1 tokens, row 0 idle (an
    all-zero table), rows 7 and 8 (lengths 33 and 47) sharing their
    first, full page, and row 30 (length 271) mapping its last page
    outside the layer region (its last 15 tokens are not attended and
    its append is skipped). Returns (tables, pages per layer)."""
    b = len(lens)
    P = b * pp + 1                             # + scratch page 0
    rng = np.random.RandomState(seed)
    perm = list(rng.permutation(np.arange(1, P)))
    tables = np.zeros((b, pp), np.int32)
    for r, n in enumerate(lens):
        if r == 0:
            continue
        need = min(-(-(n + 1) // PAGE), pp)
        tables[r, :need] = [perm.pop() for _ in range(need)]
    tables[8, 0] = tables[7, 0]
    tables[30, pp - 1] = P
    return tables, P


def _long_tables(lens, pp: int):
    """Block tables for the long-row cases of B1 and B6: distinct random
    pages (never page 0) covering lens + 1 tokens, no shared page and
    no id past the region. Returns (tables, pages per layer)."""
    P = len(lens) * pp + 1
    perm = list(np.random.RandomState(9).permutation(np.arange(1, P)))
    tables = np.zeros((len(lens), pp), np.int32)
    for r, n in enumerate(lens):
        need = min(-(-(n + 1) // PAGE), pp)
        tables[r, :need] = [perm.pop() for _ in range(need)]
    return tables, P


def _decode_case(dtype, gen, g=1, d=HEAD_DIM, L=4, lens=None, pp=17):
    """Kernel-1 inputs at the path's shapes: batch 32 of DECODE_LENS
    (_decode_tables), 16 kv heads (x g query heads) of d = 128, page 16;
    a 4-layer folded pool so timed calls rotate past the L2. ``lens`` and
    ``pp`` replace the batch (distinct pages, no shared page and no id
    past the region)."""
    n_kv, ps = N_HEADS, PAGE
    if lens is None:
        lens = DECODE_LENS
        tables, P = _decode_tables(lens, pp, 7)
    else:
        tables, P = _long_tables(lens, pp)
    b = len(lens)
    dev = "cuda"

    def rnd(*s):
        return torch.randn(s, generator=gen, device=dev).to(dtype)
    return dict(
        q=rnd(b, n_kv * g, d), nk=rnd(b, n_kv, d), nv=rnd(b, n_kv, d),
        kp=rnd(L * P, n_kv, ps, d), vp=rnd(L * P, n_kv, ps, d),
        lens=torch.tensor(lens, dtype=torch.int32, device=dev),
        tables=torch.from_numpy(tables).to(dev), P=P, L=L, pp=pp)


def kernel_paged_attention(gen) -> dict:
    """Kernel B1 (bf16/f32 decode attention with its in-place append)
    against the plain version: batch 32 at contexts 0..272 (an idle
    row, page edges, rows 7 and 8 sharing their first page, a page past
    the region, a full table) at (g, d) = (1, 128), (2, 64), (4, 256),
    (1, 96), the pools after the append compared bytewise; a long-row
    batch (b4, 64 pages a row, which decode_q_plan splits for bf16, from
    its own generator); a control per case, the plain version leaving
    out each row's last live 16-token tile, which must exceed the limit;
    timed (events and the profiler's device time) beside SDPA over the
    pre-gathered K/V."""
    import torch.nn.functional as F

    from paddle_tpu_torch.nn.functional import paged_attention as pa

    res = {}
    # tolerances: both sides accumulate in fp32 (sums differ only in
    # order, ~1e-7; the bf16 tensor-core kernel's weights enter P V as
    # three bf16 parts, within 2^-27 of each); bf16 outputs may then
    # round one ulp apart (2^-8 below magnitude 2). Beyond the path's
    # shape (g 1, d 128): grouped queries and the vector (64, 256) and
    # masked (96) head widths, and the long rows.
    long_gen = torch.Generator(device="cuda")
    long_gen.manual_seed(15)
    cases = [(gd, dt, tl, {}) for gd in ((1, HEAD_DIM), (2, 64), (4, 256),
                                         (1, 96))
             for dt, tl in ((torch.float32, 2e-5), (torch.bfloat16, 2 ** -7))]
    cases += [((1, HEAD_DIM), dt, tl,
               {"lens": DECODE_Q_LONG_LENS, "pp": 64, "L": 2})
              for dt, tl in ((torch.float32, 2e-5), (torch.bfloat16, 2 ** -7))]
    for (g, d), dtype, tol, kw in cases:
        c = _decode_case(dtype, long_gen if kw else gen, g=g, d=d, **kw)
        kp2, vp2 = c["kp"].clone(), c["vp"].clone()
        kp3, vp3 = c["kp"].clone(), c["vp"].clone()
        base = c["P"]                           # layer 1's region
        out, _, _ = pa.paged_decode_attention_inplace(
            c["q"], c["nk"], c["nv"], c["kp"], c["vp"], c["lens"],
            c["tables"], pool_base=base, pool_pages=c["P"])
        ref = pa._paged_decode_plain(c["q"], c["nk"], c["nv"], kp2, vp2,
                                     c["lens"], c["tables"], base, c["P"])
        ctrl = pa._paged_decode_plain(c["q"], c["nk"], c["nv"], kp3, vp3,
                                      c["lens"], c["tables"], base, c["P"],
                                      skip_last_tile=True)
        torch.cuda.synchronize()
        err, ctrl_err = max_err(out, ref), max_err(ctrl, ref)
        pools_equal = bool(torch.equal(c["kp"], kp2)
                           and torch.equal(c["vp"], vp2))
        b = int(c["q"].shape[0])
        n_split = (pa.decode_q_plan(b, N_HEADS, c["pp"] * PAGE,
                                    pa._sm_count(c["q"].device))[0]
                   if dtype == torch.bfloat16 and d % 32 == 0 else 1)
        emit({"check": "paged_decode_attention_inplace", "g": g, "d": d,
              "dtype": str(dtype), "batch": b, "pages_per_seq": c["pp"],
              "n_split": n_split, "max_abs_err": err, "tol": tol,
              "control_err": ctrl_err,
              "pool_after_write_bytewise_equal": pools_equal})
        what = f"paged attention g={g} d={d} {dtype} b={b}"
        check(err <= tol, f"{what}: {err} > {tol}")
        check(ctrl_err > tol, f"{what}: the control (last live tile "
              f"skipped, {ctrl_err}) is within the limit {tol}")
        check(pools_equal, f"{what}: pool contents after the append "
                           "differ from the plain write")
        if (g, d) == (1, HEAD_DIM) and not kw:
            res[str(dtype)] = err
        del c, kp2, vp2, kp3, vp3
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
    dev_ms = device_ms(kern, B1_KERNEL, per_call=1)
    check(dev_ms > 0.0, f"paged attention: no {B1_KERNEL} device time "
                        "recorded")
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
    row = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
           "bytes": nbytes, "attended_tokens": tok,
           "max_abs_err": res[str(torch.bfloat16)]}
    emit({"time": "paged_decode_attention_inplace", "batch": b,
          "n_split": pa.decode_q_plan(b, n_kv, cap,
                                      pa._sm_count(c["q"].device))[0],
          **row})
    return row


#: profiler names of the bf16 GEMM of B2 (also B3's four GEMMs), of
#: B3's launches, and of B14's bf16 kernel (forward and backward mode)
B2_KERNEL = "stream_gemm_mma"
#: profiler names of B5's kernel and of B8's and B9's bf16 kernels (f32
#: keeps fused_f32 and pallas_f32)
B5_KERNEL = "a8w8_mma"
B8_KERNEL = "fused_paged_mma"
B9_KERNEL = "pallas_paged_mma"
B3_KERNELS = (B2_KERNEL, "layer_norm_kernel")
B14_KERNEL = "grouped_gemm_wgmma"
#: profiler names of B15's bf16 kernel and of B11's, B12's and B13's bf16
#: kernels at head_dim 64, 96 and 128 (d256 keeps varlen_fwd_bf16,
#: varlen_bwd_dq_bf16 and varlen_bwd_dkv_bf16)
B15_KERNEL = "grouped_dw_wgmma"
B11_KERNEL = "varlen_fwd_wgmma"
B12_KERNEL = "varlen_bwd_dq_wgmma"
B13_KERNEL = "varlen_bwd_dkv_wgmma"
#: profiler names of B7's bf16 launches, the walk and the merge (f32 keeps
#: stream_partial_f32)
B7_KERNELS = ("stream_walk_bf16", "stream_merge")


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
    _split_k_check(gen)
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
        split, steps, blocks, _ = sl.stream_plan(BATCH, D_MODEL, n,
                                                 sl._sm_count(x.device))
        rows[name] = {"ms": time_ms(kern),
                      "device_ms": device_ms(kern, B2_KERNEL,
                                             per_call=1),
                      "plain_ms": time_ms(plain),
                      "library_ms": time_ms(lib), "bound_ms": bms,
                      "bound_by": by, "bytes": nbytes, "split": split,
                      "blocks": blocks}
        emit({"time": f"stream_linear[{name}]", **rows[name]})
    # one decode step runs both shapes once: report their sum
    row = {k: rows["qkv"][k] + rows["lm_head"][k]
           for k in ("ms", "device_ms", "plain_ms", "library_ms",
                     "bound_ms")}
    row["bound_by"] = "bytes" if all(
        r["bound_by"] == "bytes" for r in rows.values()) else "operations"
    row["max_abs_err"] = res[str(torch.bfloat16)]
    return row


def _split_k_check(gen) -> None:
    """B2's split-K merge at the tail's two N = 2048 shapes (O-proj: 8
    slices of 4 k-steps; FFN2: 9 of 15), bf16, M 32, with bias and an
    f32 residual: the kernel against the plain version (one bf16 ulp at
    the output's largest magnitude), a second call bit for bit equal
    (the merge order does not depend on which block comes last), the
    counters back at 0; and a control, the plan's split rendered in
    PyTorch with one K slice left out (a merge that skips a partial),
    which must miss the plain version by more than ten times the
    limit."""
    from paddle_tpu_torch.nn.functional import stream_linear as sl

    dev, dt = "cuda", torch.bfloat16
    for name, K in (("o_proj", D_MODEL), ("ffn2", DFF)):
        x = torch.randn(BATCH, K, generator=gen, device=dev).to(dt)
        w = (torch.randn(K, D_MODEL, generator=gen, device=dev)
             * 0.02).to(dt)
        bias = (torch.randn(D_MODEL, generator=gen, device=dev)
                * 0.1).to(dt)
        res = torch.randn(BATCH, D_MODEL, generator=gen, device=dev)
        split, steps, blocks, _ = sl.stream_plan(BATCH, K, D_MODEL,
                                                 sl._sm_count(x.device))
        out = sl._gemm("stream_linear", x, w, bias=bias, residual=res)
        again = sl._gemm("stream_linear", x, w, bias=bias, residual=res)
        ref = (sl._stream_linear_plain(x, w, None, bias,
                                       out_dtype=torch.float32)
               + res).to(dt)
        ctrl = (sl._split_k_plain(x, w, split, steps, drop=split // 2)
                + bias.float() + res).to(dt)
        torch.cuda.synchronize()
        tol = _ulp_tol(float(ref.float().abs().max()))
        tickets = sl._split_buffers(
            x.device, torch.cuda.current_stream().cuda_stream, 0, 0)[1]
        e, c = max_err(out, ref), max_err(ctrl, ref)
        same = torch.equal(out, again)
        zeroed = int(tickets.abs().sum()) == 0
        emit({"check": "stream_linear_split_k", "shape": name, "M": BATCH,
              "K": K, "N": D_MODEL, "split": split, "steps": steps,
              "blocks": blocks, "max_abs_err": e, "tol": tol,
              "control_one_slice_left_out": c,
              "second_call_bitwise_equal": same,
              "counters_back_at_zero": zeroed})
        check(split > 1, f"split-K {name}: the plan does not split")
        check(e <= tol, f"split-K {name}: {e} > {tol}")
        check(same and zeroed, f"split-K {name}: a second call differs "
                               f"({same}) or a counter is left set")
        check(c > 10 * tol, f"split-K {name}: the control {c} is not "
                            f"over ten times the limit {tol}")
        # what the split buys: the plan's device time against one slice
        emit({"time": f"stream_linear_split_k[{name}]", "split": split,
              "device_ms": device_ms(
                  lambda: _gemm_at_split(x, w, split, steps), B2_KERNEL,
                  per_call=1),
              "device_ms_one_slice": device_ms(
                  lambda: _gemm_at_split(x, w, 1, -(-K // sl.STREAM_BK)),
                  B2_KERNEL, per_call=1)})


def _gemm_at_split(x, w, split: int, steps: int):
    """One launch of B2's bf16 kernel (x @ w, bf16 out) at a given split,
    bypassing stream_plan: for timing the split against one slice."""
    from paddle_tpu_torch import _kernels
    from paddle_tpu_torch.nn.functional import stream_linear as sl

    (M, K), N = x.shape, w.shape[1]
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    ws, tickets = sl._split_buffers(x.device, stream, split * M * N,
                                    -(-N // sl.STREAM_BN))
    _kernels.check(_kernels.lib("stream_linear").ptt_stream_linear(
        x.data_ptr(), w.data_ptr(), 1, None, 0, None, 0, None, 0,
        out.data_ptr(), 1, 1, M, K, N, 0, ws.data_ptr(), tickets.data_ptr(),
        split, steps, stream), "stream_linear at a split")
    return out


def _tail_weights(dtype, gen, L, int8=False):
    """A tail's stacked weights; ``int8``: wo/w1/w2/wq quantized to int8
    with their scales so/s1/s2/sq (the rest as drawn)."""
    dev = "cuda"

    def nrm(*s):
        return (torch.randn(s, generator=gen, device=dev) * 0.02).to(dtype)

    def small(*s):
        return (torch.randn(s, generator=gen, device=dev) * 0.1).to(dtype)
    p = dict(
        wo=nrm(L, D_MODEL, D_MODEL), w1=nrm(L, D_MODEL, DFF),
        w2=nrm(L, DFF, D_MODEL), wq=nrm(L, D_MODEL, 3 * D_MODEL),
        bo=small(L, D_MODEL), b1=small(L, DFF), b2=small(L, D_MODEL),
        bq=small(L, 3 * D_MODEL),
        l2s=1 + torch.randn(L, D_MODEL, generator=gen, device=dev) * 0.1,
        l2b=torch.randn(L, D_MODEL, generator=gen, device=dev) * 0.1,
        l1s=1 + torch.randn(L, D_MODEL, generator=gen, device=dev) * 0.1,
        l1b=torch.randn(L, D_MODEL, generator=gen, device=dev) * 0.1)
    if int8:
        for w, sc in (("wo", "so"), ("w1", "s1"), ("w2", "s2"),
                      ("wq", "sq")):
            p[w], p[sc] = _quantized(p[w].float())
    return p


def _call_tail(fn, att, h, p, l, L, with_q=True):
    nq = dict(w=p["wq"], b=p["bq"], s=p.get("sq"), ln_s=p["l1s"],
              ln_b=p["l1b"], layer=min(l + 1, L - 1)) if with_q else None
    return fn(att, h, p["wo"], p["w1"], p["w2"], layer=l, bo=p["bo"],
              b1=p["b1"], b2=p["b2"], ln2_scale=p["l2s"],
              ln2_bias=p["l2b"], epsilon=1e-5, activation="gelu",
              so=p.get("so"), s1=p.get("s1"), s2=p.get("s2"),
              next_qkv=nq, out_dtype=h.dtype)


def _plain_tail(att, h, wo, w1, w2, layer=None, *, bo, b1, b2, ln2_scale,
                ln2_bias, epsilon, activation=None, so=None, s1=None,
                s2=None, next_qkv=None, out_dtype=None):
    """stream_layer_tail's signature over the plain version, int8
    scales (so/s1/s2, next_qkv["s"]) included."""
    from paddle_tpu_torch.nn.functional.stream_linear import _tail_fallback

    stacked = wo.dim() == 3
    l = (0 if layer is None else int(layer)) if stacked else None
    qg = None
    if next_qkv is not None:
        qg = dict(next_qkv)
        if stacked:
            qg["layer"] = int(qg.get("layer") or 0)
    return _tail_fallback(att, h, wo, w1, w2, l, so, s1, s2, bo, b1, b2,
                          ln2_scale, ln2_bias, epsilon, activation, qg,
                          out_dtype or h.dtype, stacked)


def kernel_stream_layer_tail(gen, int8=False) -> dict:
    """The grouped tail (B3) against its plain version, with the next
    layer's QKV and without, at batch 32 (and 64 over int8 stacks);
    timed at batch 32 with the next QKV, rotating over 4 layers (a
    layer's weights are past the L2)."""
    from paddle_tpu_torch.nn.functional import stream_linear as sl

    name = "stream_layer_tail_w8" if int8 else "stream_layer_tail"
    L = 4
    res = {}
    # tolerances, scaled by the output's largest magnitude m: fp32 —
    # sums of up to 8192 terms in another order, 1e-4 * max(m, 1);
    # bf16 — the plain version rounds h + att.Wo, + bo, h2 + ff.W2 and
    # + b2 to bf16 one by one (half an ulp at the hidden stream's
    # magnitude each) where the kernel keeps h2 in fp32 and rounds once:
    # allow 4 bf16 ulps at m, 4 * 2^-7 * m; over int8 stacks the plain
    # version also rounds each product to bf16 BEFORE its bf16-rounded
    # scale, where the kernel scales the fp32 accumulator: 6 ulps
    bf16_rel = (6 if int8 else 4) * 2 ** -7
    for dtype, rel in ((torch.float32, 1e-4), (torch.bfloat16, bf16_rel)):
        p = _tail_weights(dtype, gen, L, int8)
        for m_rows in (BATCH, 64) if int8 else (BATCH,):
            att = torch.randn(m_rows, D_MODEL, generator=gen,
                              device="cuda").to(dtype)
            h = torch.randn(m_rows, D_MODEL, generator=gen,
                            device="cuda").to(dtype)
            ho, qkv = _call_tail(sl.stream_layer_tail, att, h, p, 1, L)
            rho, rqkv = _call_tail(_plain_tail, att, h, p, 1, L)
            ho2 = _call_tail(sl.stream_layer_tail, att, h, p, 2, L,
                             with_q=False)
            rho2 = _call_tail(_plain_tail, att, h, p, 2, L, with_q=False)
            torch.cuda.synchronize()
            ok, err, tols = True, 0.0, {}
            for part, a, b in (("h_out", ho, rho), ("qkv_next", qkv, rqkv),
                               ("h_out_no_next", ho2, rho2)):
                m = float(b.float().abs().max())
                tol = rel * (max(m, 1.0) if dtype == torch.float32 else m)
                e = max_err(a, b)
                tols[part] = {"max_abs_err": e, "tol": tol, "max_abs_ref": m}
                ok = ok and e <= tol
                err = max(err, e)
            emit({"check": name, "dtype": str(dtype), "M": m_rows,
                  "max_abs_err": err, **tols})
            check(ok, f"{name} {dtype} M={m_rows}: outside tolerance "
                      f"{tols}")
            if m_rows == BATCH:
                res[str(dtype)] = err
        del p
    dt = torch.bfloat16
    p = _tail_weights(dt, gen, L, int8)
    att = torch.randn(BATCH, D_MODEL, generator=gen, device="cuda").to(dt)
    h = torch.randn(BATCH, D_MODEL, generator=gen, device="cuda").to(dt)
    nxt = cycler(L)
    ms = time_ms(lambda: _call_tail(sl.stream_layer_tail, att, h, p,
                                    nxt(), L))
    dev_ms = device_ms(lambda: _call_tail(sl.stream_layer_tail, att, h, p,
                                          nxt(), L), B3_KERNELS,
                       per_call=TAIL_LAUNCHES_PER_CALL)
    plain_ms = time_ms(lambda: _call_tail(_plain_tail, att, h, p, nxt(),
                                          L))
    welems = D_MODEL * D_MODEL + 2 * D_MODEL * DFF + D_MODEL * 3 * D_MODEL
    vbytes = 2 * (3 * D_MODEL + DFF + 3 * D_MODEL) + 4 * 4 * D_MODEL
    if int8:                                   # the f32 scales
        vbytes += 4 * (2 * D_MODEL + DFF + 3 * D_MODEL)
    iobytes = 2 * BATCH * (2 * D_MODEL + D_MODEL + 3 * D_MODEL)
    nbytes = welems * (1 if int8 else 2) + vbytes + iobytes
    bms, by = bound_ms(nbytes, 2.0 * BATCH * welems, dt)
    row = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
           "library_ms": None, "bound_ms": bms, "bound_by": by,
           "bytes": nbytes, "max_abs_err": res[str(dt)]}
    emit({"time": name, **row})
    return row


def _prefill_case(dtype, gen, starts, c, g=1, d=HEAD_DIM, shared=0, L=1,
                  ps=PAGE, n_kv=N_HEADS):
    """Kernel-4 inputs at the serving path's shapes: per row a full
    table of distinct pages spanning 2048 tokens (128 pages of 16, or
    ``ps`` tokens a page; the first ``shared`` pages common to every
    row), ``n_kv`` kv heads (x g query heads), a chunk of ``c`` queries at
    ``starts``; an ``L``-layer folded pool (tables of layer l are offset
    by l * P) so timed calls rotate past the L2."""
    b, pp = len(starts), SERVE_MAX_LENGTH // ps
    P = b * pp + 1                             # + scratch page 0
    rng = np.random.RandomState(11)
    perm = list(rng.permutation(np.arange(1, P)))
    common = [perm.pop() for _ in range(shared)]
    tables = np.asarray([common + [perm.pop() for _ in range(pp - shared)]
                         for _ in range(b)], np.int32)
    dev = "cuda"

    def rnd(*s):
        return torch.randn(s, generator=gen, device=dev).to(dtype)
    return dict(q=rnd(b, c, n_kv * g, d), kp=rnd(L * P, n_kv, ps, d),
                vp=rnd(L * P, n_kv, ps, d), tables=tables,
                start=torch.tensor(starts, dtype=torch.int32, device=dev),
                n_kv=n_kv, P=P, L=L, pp=pp, ps=ps)


#: kernel-4 check cases: (name, starts, chunk, valid rows, g, d, shared
#: pages, table id past the pool at (row, page), page size, kv heads).
#: The serving rung's chunks (start 0, 512, 1792), a bucket-padded tail,
#: shared prefix pages, an id past the pool; GQA at g 2, 4 and 8; page
#: sizes 8 and 32 (a 64-key tile is 8 pages, or half a page); chunks of
#: 16 and 64 (one q tile, 16 and 5 key slices); three rows at other
#: starts, the second ending on a slice boundary (key_end 320: five key
#: tiles, one a slice); head_dim 64, 96 and 256
PREFILL_CASES = (
    ("start0", (0,), 256, 256, 1, HEAD_DIM, 0, None, PAGE, N_HEADS),
    ("start512", (512,), 256, 256, 1, HEAD_DIM, 0, None, PAGE, N_HEADS),
    ("start1792", (1792,), 256, 256, 1, HEAD_DIM, 0, None, PAGE, N_HEADS),
    ("unaligned_padded_tail", (37,), 208, 200, 1, HEAD_DIM, 0, None, PAGE,
     N_HEADS),
    ("shared_prefix_two_rows", (300, 1000), 256, 256, 1, HEAD_DIM, 20,
     None, PAGE, N_HEADS),
    ("table_id_past_pool", (700,), 256, 256, 1, HEAD_DIM, 0, (0, 10), PAGE,
     N_HEADS),
    ("g2_d64", (512,), 256, 256, 2, 64, 0, None, PAGE, N_HEADS),
    ("g4_d256", (512,), 256, 256, 4, 256, 0, None, PAGE, N_HEADS),
    ("g8", (1000,), 256, 256, 8, HEAD_DIM, 0, None, PAGE, 2),
    ("page8", (777,), 256, 256, 1, HEAD_DIM, 0, None, 8, N_HEADS),
    ("page32", (1500,), 256, 256, 1, HEAD_DIM, 0, None, 32, N_HEADS),
    ("c16", (1900,), 16, 16, 1, HEAD_DIM, 0, None, PAGE, N_HEADS),
    ("c64", (333,), 64, 64, 1, HEAD_DIM, 0, None, PAGE, N_HEADS),
    ("b3_split_boundary", (7, 256, 1500), 64, 64, 1, HEAD_DIM, 0, None,
     PAGE, N_HEADS),
    ("d64", (1024,), 256, 256, 1, 64, 0, None, PAGE, N_HEADS),
    ("d96", (1024,), 256, 256, 1, 96, 0, None, PAGE, N_HEADS),
)


def _prefill_time(gen, start: int) -> dict:
    """Kernel 4 timed (bf16, b1, a 256-token chunk at ``start``, h16
    d128, rotating over 4 layers of the pool: 16.8 MB of K/V each, past
    the L2) by CUDA events and by the profiler, beside the plain version,
    SDPA over the K/V already gathered dense (masked by position, key <=
    query) and the bound; one "time" line."""
    import torch.nn.functional as F

    from paddle_tpu_torch.nn.functional import flash_varlen as fv

    c = SERVE_CHUNK
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
    dev_ms = device_ms(kern, "paged_prefill_mma")
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
    q_tiles, n_split, blocks = fv.prefill_grid(
        1, c, n_kv, 1, S, d, torch.cuda.get_device_properties(0)
        .multi_processor_count)
    row = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
           "bytes": nbytes, "flops": flops, "start": start, "c": c,
           "q_tiles": q_tiles, "n_split": n_split, "blocks": blocks,
           "tflops": flops / ms / 1e9,
           "library_note": "scaled_dot_product_attention over pre-gathered "
                           "K/V, masked by position"}
    emit({"time": "paged_prefill_attention", **row})
    del a, tables, dense
    return row


def kernel_paged_prefill(gen) -> dict:
    """Kernel 4 against its plain version on PREFILL_CASES, f32 and bf16,
    at the limits below; a control per dtype (the plain version fed the
    start1792 table with pages 1 and 127 swapped) must exceed them. Then
    timed at start 512 and 1792 (the kernels line's row)."""
    from paddle_tpu_torch.nn.functional import flash_varlen as fv

    res = {}
    # tolerances, scaled by the output's largest magnitude m: both sides
    # accumulate in fp32 in another order (float32: 2e-5 * max(m, 1));
    # bf16 outputs round the same fp32 value, one rounding may flip: one
    # bf16 ulp at m, 2^(floor(log2 m) - 7)
    for name, starts, c, valid, g, d, shared, bad, ps, n_kv in PREFILL_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            a = _prefill_case(dtype, gen, starts, c, g=g, d=d, shared=shared,
                              ps=ps, n_kv=n_kv)
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
            line = {"check": "paged_prefill_attention", "case": name,
                    "starts": list(starts), "c": c, "valid_rows": valid,
                    "g": g, "d": d, "page_size": ps, "n_kv": n_kv,
                    "dtype": str(dtype), "max_abs_err": err, "tol": tol,
                    "max_abs_ref": m}
            if name == "start1792":
                swapped = a["tables"].copy()
                swapped[0, [1, -1]] = swapped[0, [-1, 1]]
                ctrl = fv._paged_prefill_plain(
                    a["q"], a["kp"], a["vp"],
                    torch.from_numpy(swapped).cuda(), a["start"],
                    n_kv=a["n_kv"])
                line["control_err"] = max_err(out, ctrl[:, :valid])
                res[str(dtype)] = err
            emit(line)
            check(err <= tol, f"paged prefill {name} {dtype}: {err} > "
                              f"{tol}")
            if "control_err" in line:
                check(line["control_err"] > tol,
                      f"paged prefill control (pages swapped) {dtype}: "
                      f"{line['control_err']} is within {tol}")
            del a, out, ref
    _prefill_time(gen, 512)
    row = _prefill_time(gen, SERVE_MAX_LENGTH - SERVE_CHUNK)
    check(row["blocks"] >= 132, f"paged prefill at the rung runs "
                                f"{row['blocks']} blocks, fewer than 132")
    return {**row, "max_abs_err": res[str(torch.bfloat16)]}


# ------------------------------------------------- quantized kernels

def _quantized(w):
    """Weight-only int8 of float weights [.., K, N], per output column
    over K (quantize_weight_only_int8's rule): (int8 w, f32 scale)."""
    from paddle_tpu_torch.quantization.dynamic import absmax_scale

    s = absmax_scale(w.float().abs().amax(dim=-2, keepdim=True))
    q = torch.clamp(torch.round(w.float() / s), -127, 127).to(torch.int8)
    return q.contiguous(), s.squeeze(-2).contiguous()


def _ulp_tol(m: float) -> float:
    """One bf16 ulp at magnitude m."""
    return 2.0 ** (np.floor(np.log2(max(m, 2.0 ** -20))) - 7)


def kernel_stream_linear_w8(gen) -> dict:
    """The int8-weight GEMM of stream_linear (B2 with scale=): the QKV
    projection of the int8 stack at batch 32, other row counts and
    ragged tiles; timed on the QKV shape rotating over 24 layers."""
    from paddle_tpu_torch.nn.functional import stream_linear as sl

    dev, L, qkv_n = "cuda", N_LAYERS, 3 * D_MODEL
    res = {}
    # tolerances: the int8 weights are exact in fp32 on both sides, so
    # only the fp32 summation order differs (float32: 1e-4 at outputs of
    # magnitude ~1); bf16 outputs may round one ulp apart (2^-6 below 4)
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2 ** -6)):
        wq, s = _quantized(torch.randn(2, D_MODEL, qkv_n, generator=gen,
                                       device=dev) * 0.02)
        bias = torch.randn(2, qkv_n, generator=gen, device=dev) * 0.02
        for m, act in ((BATCH, None), (BATCH, "gelu"), (1, None),
                       (64, "relu")):
            x = torch.randn(m, D_MODEL, generator=gen, device=dev).to(dtype)
            out = sl.stream_linear(x, wq, layer=1, bias=bias, scale=s,
                                   activation=act)
            ref = sl._stream_linear_plain(x, wq, 1, bias, act, scale=s)
            torch.cuda.synchronize()
            e = max_err(out, ref)
            emit({"check": "stream_linear_w8", "dtype": str(dtype), "M": m,
                  "K": D_MODEL, "N": qkv_n, "activation": act,
                  "max_abs_err": e, "tol": tol})
            check(e <= tol, f"stream_linear_w8 M={m} {dtype}: {e} > {tol}")
            if m == BATCH and act is None:
                res[str(dtype)] = e
        wq, s = _quantized(torch.randn(136, 208, generator=gen, device=dev))
        bias = torch.randn(208, generator=gen, device=dev).to(dtype)
        for m in (7, 100):
            x = torch.randn(m, 136, generator=gen, device=dev).to(dtype)
            e = max_err(sl.stream_linear(x, wq, bias=bias, scale=s),
                        sl._stream_linear_plain(x, wq, None, bias,
                                                scale=s))
            tol2 = tol * 16                    # outputs of magnitude ~12
            emit({"check": "stream_linear_w8", "dtype": str(dtype), "M": m,
                  "K": 136, "N": 208, "max_abs_err": e, "tol": tol2})
            check(e <= tol2, f"stream_linear_w8 M={m} K=136 {dtype}: "
                             f"{e} > {tol2}")
    dt = torch.bfloat16
    x = torch.randn(BATCH, D_MODEL, generator=gen, device=dev).to(dt)
    wq, s = _quantized(torch.randn(L, D_MODEL, qkv_n, generator=gen,
                                   device=dev) * 0.02)
    bias = (torch.randn(L, qkv_n, generator=gen, device=dev) * 0.02).to(dt)
    nxt = cycler(L)
    ms = time_ms(lambda: sl.stream_linear(x, wq, layer=nxt(), bias=bias,
                                          scale=s))
    plain_ms = time_ms(lambda: (lambda l: sl._stream_linear_plain(
        x, wq, l, bias, scale=s))(nxt()))
    nbytes = (D_MODEL * qkv_n + BATCH * D_MODEL * 2 + BATCH * qkv_n * 2
              + qkv_n * (4 + 2))
    bms, by = bound_ms(nbytes, 2.0 * BATCH * D_MODEL * qkv_n, dt)
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": bms, "bound_by": by, "bytes": nbytes,
           "max_abs_err": res[str(dt)]}
    emit({"time": "stream_linear_w8[qkv]", **row})
    return row


#: the A8W8 decode step's four projections of the d2048 model: name,
#: K, N, activation
A8W8_SHAPES = (("qkv", D_MODEL, 3 * D_MODEL, None),
               ("out", D_MODEL, D_MODEL, None),
               ("ffn1", D_MODEL, DFF, "gelu"),
               ("ffn2", DFF, D_MODEL, None))


def kernel_stream_linear_a8w8(gen) -> dict:
    """Kernel B5 (stream_linear act_quant=True): the four projections
    at batch 32, plus batch 1 and 64, against the plain version; at batch
    32 a second call bitwise equal to the first with the merge counters
    back at 0, and a control per projection, the split's PyTorch
    rendering with one K slice left out, which must exceed its limit;
    then timed per projection at batch 32 (events and the profiler's
    device time) beside torch._int_mm."""
    from paddle_tpu_torch.nn.functional import stream_linear as sl
    from paddle_tpu_torch.quantization.dynamic import dynamic_act_quant

    dev = "cuda"
    res = {}
    # the int32 accumulators agree exactly and the dequant rounds in the
    # same order, so float32 outputs without activation are bitwise
    # equal; GELU's tanh may differ by an ulp or two (2e-6 relative);
    # bf16 outputs round the same fp32 value (one bf16 ulp at most)
    for name, K, N, act in A8W8_SHAPES:
        wq, s = _quantized(torch.randn(2, K, N, generator=gen,
                                       device=dev) * 0.02)
        bias = torch.randn(2, N, generator=gen, device=dev) * 0.02
        for dtype in (torch.float32, torch.bfloat16):
            for m in (BATCH, 1, 64):
                x = torch.randn(m, K, generator=gen, device=dev).to(dtype)
                out = sl.stream_linear(x, wq, layer=1, bias=bias, scale=s,
                                       activation=act, act_quant=True)
                xq, xs = dynamic_act_quant(x)
                ref = sl._stream_linear_a8w8_plain(xq, xs, wq, s, 1, bias,
                                                   act, dtype)
                torch.cuda.synchronize()
                mref = float(ref.float().abs().max())
                tol = ((0.0 if act is None else 2e-6 * max(mref, 1.0))
                       if dtype == torch.float32 else _ulp_tol(mref))
                e = max_err(out, ref)
                split, steps, _, _ = sl.a8w8_plan(m, K, N,
                                                  sl._sm_count(x.device))
                line = {"check": "stream_linear_a8w8", "proj": name,
                        "dtype": str(dtype), "M": m, "K": K, "N": N,
                        "activation": act, "split": split, "steps": steps,
                        "max_abs_err": e, "tol": tol}
                what = f"stream_linear_a8w8 {name} M={m} {dtype}"
                if m == BATCH and dtype == torch.float32:
                    again = sl.stream_linear(x, wq, layer=1, bias=bias,
                                             scale=s, activation=act,
                                             act_quant=True)
                    ctrl = sl._a8w8_split_plain(
                        xq, xs, wq[1], s[1], split, steps, bias[1], act,
                        dtype, drop=split // 2)
                    tickets = sl._split_buffers(
                        x.device, torch.cuda.current_stream().cuda_stream,
                        0, 0)[1]
                    torch.cuda.synchronize()
                    line.update(
                        control_one_slice_left_out=max_err(ctrl, ref),
                        second_call_bitwise_equal=torch.equal(out, again),
                        counters_back_at_zero=int(tickets.abs().sum()) == 0)
                    check(split > 1, f"{what}: the plan does not split")
                    check(line["second_call_bitwise_equal"]
                          and line["counters_back_at_zero"],
                          f"{what}: a second call differs or a merge "
                          "counter is left set")
                    check(line["control_one_slice_left_out"] >
                          max(tol, _ulp_tol(mref)),
                          f"{what}: the control (one K slice left out) is "
                          f"within the limit ({line})")
                emit(line)
                check(e <= tol, f"{what}: {e} > {tol}")
                if m == BATCH:
                    res[str(dtype)] = max(res.get(str(dtype), 0.0), e)
        del wq
    # timing: bf16 activations at batch 32, each projection rotating over
    # 24 layers of its int8 weights (past the L2); the plain version and
    # torch._int_mm take the same pre-quantized x
    L, dt = N_LAYERS, torch.bfloat16
    rows = {}
    for name, K, N, act in A8W8_SHAPES:
        wq, s = _quantized(torch.randn(L, K, N, generator=gen,
                                       device=dev) * 0.02)
        bias = (torch.randn(L, N, generator=gen, device=dev) * 0.02).to(dt)
        x = torch.randn(BATCH, K, generator=gen, device=dev).to(dt)
        xq, xs = dynamic_act_quant(x)
        nxt = cycler(L)

        def kern():
            l = nxt()
            sl._stream_linear_a8w8(xq, xs, wq[l], s[l], bias[l], act, dt)

        def plain():
            sl._stream_linear_a8w8_plain(xq, xs, wq, s, nxt(), bias, act,
                                         dt)

        def library():
            torch._int_mm(xq, wq[nxt()])
        nbytes = K * N + BATCH * K + BATCH * 4 + N * (4 + 2) + BATCH * N * 2
        bms, by = bound_ms(nbytes, 2.0 * BATCH * K * N, torch.int8)
        dev_ms = device_ms(kern, B5_KERNEL, per_call=1)
        check(dev_ms > 0.0, f"stream_linear_a8w8 {name}: no {B5_KERNEL} "
                            "device time recorded")
        rows[name] = {"ms": time_ms(kern), "device_ms": dev_ms,
                      "plain_ms": time_ms(plain),
                      "library_ms": time_ms(library), "bound_ms": bms,
                      "bound_by": by, "bytes": nbytes,
                      "split": sl.a8w8_plan(BATCH, K, N,
                                            sl._sm_count(x.device))[0]}
        emit({"time": f"stream_linear_a8w8[{name}]", **rows[name]})
        del wq
    # one decode step runs each projection once per layer: report the
    # sum of the four
    row = {k: sum(r[k] for r in rows.values())
           for k in ("ms", "device_ms", "plain_ms", "library_ms",
                     "bound_ms")}
    row["bound_by"] = "bytes" if all(
        r["bound_by"] == "bytes" for r in rows.values()) else "operations"
    row["max_abs_err"] = res[str(dt)]
    emit({"time": "stream_linear_a8w8[four projections]", **row})
    return row


#: profiler name of B6's bf16 kernel (f32 keeps paged_decode_q_kernel)
B6_KERNEL = "paged_decode_q_mma"
#: profiler names of B1's bf16 kernel (f32 keeps paged_decode_kernel) and
#: of B16's bf16 kernel (f32 takes lora_delta_fma)
B1_KERNEL = "paged_decode_mma"
B16_KERNEL = "lora_delta_mma"
#: the long-row case of B6 (b4, 64 pages a row: the kernel splits rows)
DECODE_Q_LONG_LENS = [1023, 777, 301, 16]


def _decode_q_case(dtype, gen, g=1, d=HEAD_DIM, L=2, lens=None, pp=17):
    """Kernel-6 inputs at the int8-KV rung's shapes: batch 64 (the 32
    rows of DECODE_LENS — idle slot, page edges, a shared page, a table
    id past the region, a full table — and 32 more at contexts
    128..257), 16 kv heads of d, page 16, 17 pages a row; an L-layer
    int8 pool with its scale planes, quantized from random rows. ``lens``
    and ``pp`` replace the batch (distinct pages, no shared page and no
    id past the region)."""
    from paddle_tpu_torch.nn.functional.paged_attention import (
        quantize_kv_rows)

    n_kv, ps = N_HEADS, PAGE
    if lens is None:
        lens = DECODE_LENS + [int(n) for n in np.linspace(128, 257, BATCH)]
        tables, P = _decode_tables(lens, pp, 8)
    else:
        tables, P = _long_tables(lens, pp)
    b = len(lens)
    dev = "cuda"

    def rnd(*s):
        return torch.randn(s, generator=gen, device=dev).to(dtype)

    def pool():
        rows, sc = quantize_kv_rows(torch.randn(
            L * P, n_kv, ps, d, generator=gen, device=dev))
        plane = sc.permute(1, 0, 2).reshape(n_kv, L * P * ps).contiguous()
        return rows.contiguous(), plane
    kq, ks = pool()
    vq, vs = pool()
    return dict(q=rnd(b, n_kv * g, d), nk=rnd(b, n_kv, d),
                nv=rnd(b, n_kv, d), kq=kq, ks=ks, vq=vq, vs=vs,
                lens=torch.tensor(lens, dtype=torch.int32, device=dev),
                tables=torch.from_numpy(tables).to(dev), P=P, L=L, pp=pp)


def _nan_past_lengths(c, base: int) -> None:
    """Scale planes (both sides) set to NaN at every slot, in layer
    ``base``'s region, of every table page at or past its row's length
    (the append's slot included), as a pool from torch.empty may hold
    where nothing was written."""
    ps, pp = PAGE, c["pp"]
    tables = c["tables"].long()
    pos = torch.arange(pp * ps, device="cuda")
    page = tables[:, pos // ps]                              # [b, cap]
    past = (pos[None, :] >= c["lens"].long()[:, None]) & (page < c["P"])
    cols = ((page + base) * ps + pos % ps)[past]
    for k in ("ks", "vs"):
        c[k][:, cols] = float("nan")


def kernel_paged_attention_q(gen) -> dict:
    """Kernel B6 (int8-KV decode attention with its quantized append):
    batch 64 at contexts 0..272 against the plain version, the pool rows
    and planes after the append compared exactly; g 4 / d 64 and d 96
    besides; the rung's shape again with every scale past a row's length
    NaN (outputs finite and within the limit: the kernel selects, never
    multiplies, what it masks); a long-row batch (b4, 64 pages a row,
    which decode_q_plan splits); a control per case, the plain version
    skipping each row's last live page, which must exceed the limit;
    timed (events and the profiler's device time) beside SDPA over the
    pre-dequantized gathered K/V."""
    import torch.nn.functional as F

    from paddle_tpu_torch.nn.functional import paged_attention as pa

    res = {}
    # tolerances: the logits of cached tokens are the same fp32 products
    # on both sides (an exact integer dot); the softmax and the weighted
    # sums differ only in summation order (float32: 2e-5 at outputs of
    # magnitude ~1; bf16 outputs one ulp, 2^-7 below 2; the bf16 kernel's
    # weights enter P V as a bf16 pair, within 2^-16 of each)
    cases = [((g, d), dt, tl, kw)
             for (g, d), kw in (((1, HEAD_DIM), {}), ((4, 64), {}),
                                ((2, 96), {}), ((1, HEAD_DIM), {"nan": 1}),
                                ((1, HEAD_DIM),
                                 {"lens": DECODE_Q_LONG_LENS, "pp": 64}))
             for dt, tl in ((torch.float32, 2e-5),
                            (torch.bfloat16, 2 ** -7))]
    for (g, d), dtype, tol, kw in cases:
        kw = dict(kw)
        nan = kw.pop("nan", 0)
        c = _decode_q_case(dtype, gen, g=g, d=d, **kw)
        base = c["P"]
        if nan:
            _nan_past_lengths(c, base)
        ref_pool = [c[k].clone() for k in ("kq", "ks", "vq", "vs")]
        ctrl_pool = [t.clone() for t in ref_pool]
        out = pa.paged_decode_attention_inplace_q(
            c["q"], c["nk"], c["nv"], c["kq"], c["ks"], c["vq"], c["vs"],
            c["lens"], c["tables"], pool_base=base, pool_pages=c["P"])[0]
        ref = pa._paged_decode_q_plain(c["q"], c["nk"], c["nv"], *ref_pool,
                                       c["lens"], c["tables"], base, c["P"])
        ctrl = pa._paged_decode_q_plain(c["q"], c["nk"], c["nv"],
                                        *ctrl_pool, c["lens"], c["tables"],
                                        base, c["P"], skip_last_page=True)
        torch.cuda.synchronize()
        err, ctrl_err = max_err(out, ref), max_err(ctrl, ref)
        # NaN planes compare equal where both hold NaN
        pools_equal = all(torch.equal(c[k], r) if k in ("kq", "vq") else
                          bool(torch.equal(c[k].isnan(), r.isnan()) and
                               torch.equal(c[k].nan_to_num(), r.nan_to_num()))
                          for k, r in zip(("kq", "ks", "vq", "vs"), ref_pool))
        finite = bool(torch.isfinite(out).all())
        b = int(c["q"].shape[0])
        n_split = (pa.decode_q_plan(b, N_HEADS, c["pp"] * PAGE,
                                    pa._sm_count(c["q"].device))[0]
                   if dtype == torch.bfloat16 else 1)
        emit({"check": "paged_decode_attention_inplace_q", "g": g, "d": d,
              "dtype": str(dtype), "batch": b, "pages_per_seq": c["pp"],
              "nan_planes_past_lengths": bool(nan), "n_split": n_split,
              "max_abs_err": err, "tol": tol, "control_err": ctrl_err,
              "output_finite": finite,
              "pool_and_planes_after_append_equal": pools_equal})
        what = f"paged attention q g={g} d={d} {dtype} b={b}" + \
            (" (NaN planes)" if nan else "")
        check(finite, f"{what}: output not finite")
        check(err <= tol, f"{what}: {err} > {tol}")
        check(ctrl_err > tol, f"{what}: the control (last live page "
              f"skipped, {ctrl_err}) is within the limit {tol}")
        check(pools_equal, f"{what}: int8 rows or scale planes after the "
                           "append differ from the plain write")
        if (g, d) == (1, HEAD_DIM) and not nan and b == 2 * BATCH:
            res[str(dtype)] = err
        del c, ref_pool, ctrl_pool
    # timing, bf16, alternating over the pool's 2 layers
    c = _decode_q_case(torch.bfloat16, gen)
    nxt = cycler(c["L"])
    args = [c[k] for k in ("q", "nk", "nv", "kq", "ks", "vq", "vs", "lens",
                           "tables")]

    def kern():
        pa.paged_decode_attention_inplace_q(
            *args, pool_base=nxt() * c["P"], pool_pages=c["P"])

    def plain():
        pa._paged_decode_q_plain(*args, nxt() * c["P"], c["P"])
    # library yardstick: SDPA over the K/V gathered and dequantized
    # beforehand (pool tokens + the current one), masked by length and
    # region
    b, n_kv, d = c["q"].shape
    cap, ps = c["pp"] * PAGE, PAGE
    tl = torch.where(c["tables"] < c["P"], c["tables"], 0).long()
    cols = (tl[:, :, None] * ps + torch.arange(ps, device="cuda")) \
        .reshape(b, cap)

    def deq(rows, plane):
        g_ = rows[tl].float().permute(0, 2, 1, 3, 4).reshape(b, n_kv, cap, d)
        return (g_ * plane[:, cols].permute(1, 0, 2)[..., None]) \
            .to(torch.bfloat16)
    kd = torch.cat([deq(c["kq"], c["ks"]), c["nk"][:, :, None]], dim=2)
    vd = torch.cat([deq(c["vq"], c["vs"]), c["nv"][:, :, None]], dim=2)
    pos = torch.arange(cap + 1, device="cuda")
    lens_c = torch.clamp(c["lens"].long(), max=cap)
    in_region = (c["tables"] < c["P"]).repeat_interleave(PAGE, dim=1)
    attended = (pos[None, :cap] < lens_c[:, None]) & in_region
    mask = torch.cat([attended, torch.ones_like(attended[:, :1])],
                     dim=1)[:, None, None, :]
    qd = c["q"][:, :, None, :]

    def library():
        F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)
    ms, plain_ms, lib_ms = time_ms(kern), time_ms(plain), time_ms(library)
    dev_ms = device_ms(kern, B6_KERNEL, per_call=1)
    check(dev_ms > 0.0, f"paged attention q: no {B6_KERNEL} device time "
                        "recorded")
    # bytes this run's data needs: each attended int8 K/V row and its two
    # f32 scales once, q, the operands, the output, the appended rows and
    # scales, the tables and lengths
    tok = int(attended.sum())
    wpage = torch.clamp(c["lens"].long() // PAGE, max=c["pp"] - 1)
    n_write = int(((c["lens"] < cap)
                   & (c["tables"].gather(1, wpage[:, None])[:, 0] < c["P"]))
                  .sum())
    isz = 2
    nbytes = (2 * tok * n_kv * (d + 4) + 4 * b * n_kv * d * isz
              + 2 * n_write * n_kv * (d + 4) + c["tables"].numel() * 4
              + b * 4)
    flops = 4.0 * (tok + b) * n_kv * d
    bms, by = bound_ms(nbytes, flops, torch.bfloat16)
    row = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
           "bytes": nbytes, "attended_tokens": tok,
           "max_abs_err": res[str(torch.bfloat16)]}
    emit({"time": "paged_decode_attention_inplace_q", "batch": b,
          "n_split": pa.decode_q_plan(b, n_kv, cap,
                                      pa._sm_count(c["q"].device))[0],
          **row})
    return row


# ------------------------------------------------- MoE and LoRA kernels

#: the MoE rung's shapes (bench.py run_moe_decode_bench): d1024, 12
#: layers, 16 heads of 64, dff 4096, 8 experts, top-2; batch 32,
#: prompt 128, 65 new tokens
MOE_D, MOE_LAYERS, MOE_HEADS, MOE_E, MOE_TOPK = 1024, 12, 16, 8, 2
MOE_DFF, MOE_NEW = 4 * MOE_D, 65
#: the LoRA serve's bank: 4 slots of rank 8 (padded to 16 in bf16)
LORA_SLOTS, LORA_RANK = 4, 8


def _moe_offsets(case: str, T: int, E: int = MOE_E):
    """int32 [E+1] offsets of T rows over E experts: uniform, one expert
    owning every row, two empty experts, a total short of T (the rows
    past it must come out 0), or "unaligned": every count 1-15 rows past
    a multiple of 16, a one-row expert, the last expert ending at T."""
    if case == "unaligned":
        counts = [1, 1039, 1001, 1109, 1143, 1015, 995][:E - 1]
        counts = counts + [T - sum(counts)]
    elif case == "uniform":
        counts = [T // E] * E
    elif case == "one_expert":
        counts = [0] * E
        counts[3] = T
    elif case == "two_empty":
        counts = [T // (E - 2)] * E
        counts[1] = counts[5] = 0
    else:                                     # "short"
        counts = [T // (E + 1)] * E
    if case not in ("short", "unaligned"):
        counts[-1] += T - sum(counts)
    return torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                        dtype=torch.int32, device="cuda")


def _zero_bits(t) -> bool:
    """All elements +0.0, bit for bit."""
    it = torch.int32 if t.dtype == torch.float32 else torch.int16
    return bool((t.contiguous().view(it) == 0).all())


#: B14's k-step in bf16 (wgmma's K of four k16 products a stage)
B14_KSTEP = 64


def kernel_grouped_gemm(gen) -> dict:
    """Kernel B14 (grouped_gemm) against grouped_gemm_plain at the MoE
    rung's FFN shapes — FFN1 [T, 1024] x [8, 1024, 4096] + bias + GELU
    in x's dtype, FFN2 [T, 4096] x [8, 4096, 1024] + bias in f32 — at
    T = 64 (decode, batch 32 top-2) and 8192 (prefill, 32 x 128 x 2), in
    float32 and bf16, over four offset layouts; and a ragged K 136 / N
    200. Then timed in bf16 with the weights rotating over 12 layers."""
    from paddle_tpu_torch.nn.functional import grouped_gemm as gg

    dev, E, d, dff = "cuda", MOE_E, MOE_D, MOE_DFF
    res = {}
    # tolerances: both sides accumulate in fp32 (the bf16 products are
    # exact there), so they differ by the summation order (~1e-6 of the
    # outputs' magnitude ~1, float32 and the f32 FFN2: 1e-4); a bf16
    # output may then round one ulp apart (_ulp_tol of its largest value)
    for dtype in (torch.float32, torch.bfloat16):
        w1 = (torch.randn(E, d, dff, generator=gen, device=dev)
              * 0.02).to(dtype)
        b1 = torch.randn(E, dff, generator=gen, device=dev) * 0.02
        w2 = (torch.randn(E, dff, d, generator=gen, device=dev)
              * 0.02).to(dtype)
        b2 = torch.randn(E, d, generator=gen, device=dev) * 0.02
        for T in (64, 8192):
            x = torch.randn(T, d, generator=gen, device=dev).to(dtype)
            for case in ("uniform", "one_expert", "two_empty", "short"):
                off = _moe_offsets(case, T)
                total = int(off[-1])
                h = gg.grouped_gemm(x, w1, off, bias=b1, activation="gelu")
                h_ref = gg.grouped_gemm_plain(x, w1, off, bias=b1,
                                              activation="gelu")
                # FFN2 takes the same input on both sides
                y = gg.grouped_gemm(h_ref, w2, off, bias=b2,
                                    out_dtype=torch.float32)
                y_ref = gg.grouped_gemm_plain(h_ref, w2, off, bias=b2,
                                              out_dtype=torch.float32)
                torch.cuda.synchronize()
                e1, e2 = max_err(h, h_ref), max_err(y, y_ref)
                tol1 = 1e-4 if dtype == torch.float32 else _ulp_tol(
                    float(h_ref.float().abs().max()))
                tol2 = 1e-4
                zeros = _zero_bits(h[total:]) and _zero_bits(y[total:])
                # control: B14's first k-step (64 of K) of one expert's
                # bank left out, in the forward layout
                ctrl = None
                if dtype == torch.bfloat16:
                    ce = next(e for e in range(E)
                              if int(off[e + 1]) > int(off[e]))
                    w1_c = w1.clone()
                    w1_c[ce, :B14_KSTEP] = 0
                    ctrl = max_err(gg.grouped_gemm_plain(
                        x, w1_c, off, bias=b1, activation="gelu"), h_ref)
                    del w1_c
                # the units the kernel decoded, against grouped_work_map
                bm = gg.DEFAULT_BLOCK_ROWS
                same_map = all(torch.equal(a, b) for a, b in zip(
                    gg.kernel_work_map(off, T),
                    gg.grouped_work_map(off, -(-T // bm) * bm, bm)))
                emit({"check": "grouped_gemm", "dtype": str(dtype), "T": T,
                      "offsets": case, "rows_past_offsets_E": T - total,
                      "ffn1_max_abs_err": e1, "ffn1_tol": tol1,
                      "ffn2_f32_max_abs_err": e2, "ffn2_tol": tol2,
                      "rows_past_offsets_E_bitwise_zero": zeros,
                      "kernel_units_equal_grouped_work_map": same_map,
                      "ffn1_control_first_kstep_left_out": ctrl})
                check(same_map, f"grouped_gemm T={T} {case}: the kernel's "
                                "units differ from grouped_work_map")
                check(e1 <= tol1 and e2 <= tol2,
                      f"grouped_gemm {dtype} T={T} {case}: {e1}/{e2} > "
                      f"{tol1}/{tol2}")
                check(zeros, f"grouped_gemm {dtype} T={T} {case}: rows "
                             "past offsets[E] are not +0.0")
                check(ctrl is None or ctrl > 10 * tol1,
                      f"grouped_gemm {dtype} T={T} {case}: the k-step "
                      f"control {ctrl} is not over ten times {tol1}")
                if T == 64 and case == "uniform":
                    res[str(dtype)] = max(e1, e2)
            del x
        del w1, w2
        # K and N that are not multiples of 128 (nor of the kernel's
        # 64-column tile): the kernel masks its ragged edges itself
        x = torch.randn(50, 136, generator=gen, device=dev).to(dtype)
        w = (torch.randn(3, 136, 200, generator=gen, device=dev)
             * 0.1).to(dtype)
        b = torch.randn(3, 200, generator=gen, device=dev)
        off = torch.tensor([0, 20, 20, 45], dtype=torch.int32, device=dev)
        out = gg.grouped_gemm(x, w, off, bias=b, activation="relu")
        ref = gg.grouped_gemm_plain(x, w, off, bias=b, activation="relu")
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == torch.float32 else _ulp_tol(
            float(ref.float().abs().max()))
        e = max_err(out, ref)
        emit({"check": "grouped_gemm", "dtype": str(dtype), "T": 50,
              "K": 136, "N": 200, "max_abs_err": e, "tol": tol,
              "rows_past_offsets_E_bitwise_zero": _zero_bits(out[45:])})
        check(e <= tol and _zero_bits(out[45:]),
              f"grouped_gemm K=136 N=200 {dtype}: {e} > {tol}")
    # timing, bf16, uniform routing, weights rotating over 12 layers:
    # decode (T 64) and prefill (T 8192), FFN1 + FFN2 of one layer
    dt, L = torch.bfloat16, MOE_LAYERS
    w1 = (torch.randn(L, E, d, dff, generator=gen, device=dev)
          * 0.02).to(dt)
    w2 = (torch.randn(L, E, dff, d, generator=gen, device=dev)
          * 0.02).to(dt)
    b1 = torch.randn(L, E, dff, generator=gen, device=dev) * 0.02
    b2 = torch.randn(L, E, d, generator=gen, device=dev) * 0.02
    grouped_mm = getattr(torch, "_grouped_mm", None)
    rows = {}
    for phase, T in (("decode", 64), ("prefill", 8192)):
        x = torch.randn(T, d, generator=gen, device=dev).to(dt)
        off = _moe_offsets("uniform", T)
        h = gg.grouped_gemm(x, w1[0], off, bias=b1[0], activation="gelu")
        nxt = cycler(L)

        def kern():
            l = nxt()
            gg.grouped_gemm(x, w1[l], off, bias=b1[l], activation="gelu")
            gg.grouped_gemm(h, w2[l], off, bias=b2[l],
                            out_dtype=torch.float32)

        def plain():
            l = nxt()
            gg.grouped_gemm_plain(x, w1[l], off, bias=b1[l],
                                  activation="gelu")
            gg.grouped_gemm_plain(h, w2[l], off, bias=b2[l],
                                  out_dtype=torch.float32)
        bounds = off.tolist()

        def loop():
            l = nxt()
            for e in range(E):
                torch.matmul(x[bounds[e]:bounds[e + 1]], w1[l, e])
                torch.matmul(h[bounds[e]:bounds[e + 1]], w2[l, e])
        lib_ms, lib_note = None, "none (no single call)"
        if grouped_mm is not None:
            ends = off[1:].contiguous()
            try:
                grouped_mm(x, w1[0], offs=ends)
                torch.cuda.synchronize()

                def library():
                    # bf16 out (the call takes no other), no bias or GELU
                    l = nxt()
                    grouped_mm(x, w1[l], offs=ends)
                    grouped_mm(h, w2[l], offs=ends)
                lib_ms, lib_note = time_ms(library), "torch._grouped_mm"
            except (RuntimeError, TypeError, ValueError) as err:
                lib_note = f"torch._grouped_mm refused: {str(err)[:120]}"
        active = int((off[1:] > off[:-1]).sum())   # experts with rows
        nbytes = (active * 2 * d * dff * 2 + T * d * 2 + 2 * T * dff * 2
                  + T * d * 4 + active * (dff + d) * 4)
        flops = 2.0 * T * d * dff * 2
        bms, by = bound_ms(nbytes, flops, dt)
        rows[phase] = {"ms": time_ms(kern),
                       "device_ms": device_ms(kern, B14_KERNEL,
                                              per_call=2),
                       "plain_ms": time_ms(plain),
                       "library_ms": lib_ms, "library": lib_note,
                       "per_expert_matmul_loop_ms": time_ms(loop),
                       "bound_ms": bms, "bound_by": by, "bytes": nbytes,
                       "flops": flops, "T": T}
        rows[phase]["tflops"] = flops / rows[phase]["device_ms"] / 1e9
        emit({"time": f"grouped_gemm[{phase}]", **rows[phase]})
        del x, h
    del w1, w2
    # the kernels line holds the decode step's pair (the main path runs
    # it 12 times a step); the prefill pair is in its own line
    row = dict(rows["decode"])
    row["max_abs_err"] = res[str(dt)]
    return row


def _lora_rows(T: int, S: int, gen):
    """Slot ids of T rows: base rows (-1) and slots 0, 1, 3 (slot 2
    empty), shuffled."""
    pattern = torch.tensor([0, 1, -1, 3, 0, 1, 3, -1], device="cuda")
    ids = pattern.repeat(-(-T // 8))[:T]
    perm = torch.randperm(T, generator=gen, device="cuda")
    return ids[perm].to(torch.int32)


def kernel_lora_delta(gen) -> dict:
    """Kernel B16 (lora_delta) against lora_delta_plain on the four
    d2048 projections (QKV 2048 -> 6144, O 2048 -> 2048, FFN1 2048 ->
    8192, FFN2 8192 -> 2048), 4 slots of rank 16, T 8 / 32 / 256 rows
    mixing base rows and slots with one slot empty, in float32 and bf16,
    and three narrow widths at T 256; then timed at T 8 (the serve's decode batch) over 24 layers."""
    from paddle_tpu_torch.nn.functional import lora as tl

    dev, S, R = "cuda", LORA_SLOTS, 16
    res = {}
    # tolerance: fp32 sums on both sides in another order (the bf16
    # products are exact in fp32); deltas are of magnitude ~0.1
    tol = 2e-5
    for dtype in (torch.float32, torch.bfloat16):
        for name, K, N, _ in A8W8_SHAPES:
            a = (torch.randn(S, K, R, generator=gen, device=dev)
                 * 0.02).to(dtype)
            b = (torch.randn(S, R, N, generator=gen, device=dev)
                 * 0.02).to(dtype)
            for T in (8, 32, 256):
                order, offsets, _ = tl.sort_by_adapter(
                    _lora_rows(T, S, gen), S)
                xs = torch.randn(T, K, generator=gen, device=dev) \
                    .to(dtype)[order.long()]
                out = tl.lora_delta(xs, a, b, offsets)
                ref = tl.lora_delta_plain(xs, a, b, offsets)
                torch.cuda.synchronize()
                total = int(offsets[-1])
                e = max_err(out, ref)
                zeros = _zero_bits(out[total:])
                emit({"check": "lora_delta", "proj": name,
                      "dtype": str(dtype), "T": T, "base_rows": T - total,
                      "max_abs_err": e, "tol": tol,
                      "base_rows_bitwise_zero": zeros})
                check(e <= tol and zeros,
                      f"lora_delta {name} {dtype} T={T}: {e} > {tol} or "
                      "a base row is not +0.0")
                if T == 8:
                    res[str(dtype)] = max(res.get(str(dtype), 0.0), e)
    # narrow widths (N not a multiple of 64: the cluster's top blocks own
    # no column) at T 256, with tiles wholly below offsets[S] and with
    # every row adaptered; own generator, so later phases' inputs stay
    narrow_gen = torch.Generator(device="cuda")
    narrow_gen.manual_seed(16)
    for dtype in (torch.float32, torch.bfloat16):
        for K, N in ((2048, 200), (256, 72), (2048, 100)):
            a = (torch.randn(S, K, R, generator=narrow_gen, device=dev)
                 * 0.02).to(dtype)
            b = (torch.randn(S, R, N, generator=narrow_gen, device=dev)
                 * 0.02).to(dtype)
            for full in (False, True):
                ids = _lora_rows(256, S, narrow_gen)
                if full:
                    ids[ids < 0] = 0
                order, offsets, _ = tl.sort_by_adapter(ids, S)
                xs = torch.randn(256, K, generator=narrow_gen, device=dev) \
                    .to(dtype)[order.long()]
                out = tl.lora_delta(xs, a, b, offsets)
                ref = tl.lora_delta_plain(xs, a, b, offsets)
                torch.cuda.synchronize()
                total = int(offsets[-1])
                e = max_err(out, ref)
                zeros = _zero_bits(out[total:])
                emit({"check": "lora_delta", "proj": f"{K}->{N}",
                      "dtype": str(dtype), "T": 256,
                      "base_rows": 256 - total, "max_abs_err": e,
                      "tol": tol, "base_rows_bitwise_zero": zeros})
                check(e <= tol and zeros,
                      f"lora_delta {K}->{N} {dtype} T=256 "
                      f"base_rows={256 - total}: {e} > {tol} or a base "
                      "row is not +0.0")
    dt, L, T = torch.bfloat16, N_LAYERS, 8
    order, offsets, _ = tl.sort_by_adapter(_lora_rows(T, S, gen), S)
    active = int((offsets[1:] > offsets[:-1]).sum())
    rows = {}
    for name, K, N, _ in A8W8_SHAPES:
        a = (torch.randn(L, S, K, R, generator=gen, device=dev)
             * 0.02).to(dt)
        b = (torch.randn(L, S, R, N, generator=gen, device=dev)
             * 0.02).to(dt)
        xs = torch.randn(T, K, generator=gen, device=dev).to(dt)
        nxt = cycler(L)

        def kern():
            l = nxt()
            tl.lora_delta(xs, a[l], b[l], offsets)

        def plain():
            l = nxt()
            tl.lora_delta_plain(xs, a[l], b[l], offsets)
        # bytes this run needs: x, the active slots' A and B, the output
        nbytes = T * K * 2 + active * (K * R + R * N) * 2 + T * N * 4
        flops = 2.0 * T * R * (K + N)
        bms, by = bound_ms(nbytes, flops, dt)
        rows[name] = {"ms": time_ms(kern),
                      "device_ms": device_ms(kern, B16_KERNEL),
                      "plain_ms": time_ms(plain), "library_ms": None,
                      "bound_ms": bms, "bound_by": by, "bytes": nbytes}
        emit({"time": f"lora_delta[{name}]", **rows[name]})
        del a, b
    row = {k: sum(r[k] for r in rows.values())
           for k in ("ms", "device_ms", "plain_ms", "bound_ms")}
    row["library_ms"] = None
    row["bound_by"] = "bytes" if all(
        r["bound_by"] == "bytes" for r in rows.values()) else "operations"
    row["max_abs_err"] = res[str(dt)]
    return row


# ---------------------------------------------------------------- slice

#: the MoE training rung (bench.py --moe-train, run_moe_train_bench): the
#: MoE serving rung's model trained at seq 1024, batch 4 (T = 4096
#: tokens, 8192 expert rows a layer), 8 timed steps
MOE_TRAIN_SEQ, MOE_TRAIN_BATCH, MOE_TRAIN_STEPS = 1024, 4, 8
MOE_ROWS = MOE_TRAIN_SEQ * MOE_TRAIN_BATCH * MOE_TOPK


def _expert_rel_l2(got, ref, off, per_row: bool) -> float:
    """The largest relative L2 error over the experts that own rows: of
    each expert's block of a dw ``[E, K, N]``, or (``per_row``) of its
    rows of a ``[T, K]`` dx."""
    worst = 0.0
    bounds = off.tolist()
    for e in range(len(bounds) - 1):
        lo, hi = bounds[e], bounds[e + 1]
        if hi <= lo:
            continue
        g, r = (got[lo:hi], ref[lo:hi]) if per_row else (got[e], ref[e])
        num = float((g.float() - r.float()).square().sum())
        den = max(float(r.float().square().sum()), 1e-30)
        worst = max(worst, (num / den) ** 0.5)
    return worst


def _first_kstep_dropped(off, kstep: int) -> tuple:
    """(expert, rows) of the controls' fault: the first expert owning
    at least two k-steps, and its first ``kstep`` rows."""
    bounds = off.tolist()
    e = next(i for i in range(len(bounds) - 1)
             if bounds[i + 1] - bounds[i] >= 2 * kstep)
    return e, (bounds[e], bounds[e] + kstep)


def kernel_grouped_gemm_bwd(gen) -> dict:
    """Kernel B15 (grouped_dw: dw[e] = x[seg]^T dz[seg]) and B14's
    backward mode (dx = dz @ w[e]^T, the bank read in place) against
    their plain versions at the MoE training rung's two banks — FFN1
    [8, 1024, 4096] and FFN2 [8, 4096, 1024] — from T = 8192 rows, in
    bf16 and f32, over the five _moe_offsets layouts (rows past
    offsets[E] hold 1e3, which must change nothing).

    Metric: the largest relative L2 error of any expert's dw block or
    any expert's dx rows (``_expert_rel_l2``). In bf16 the kernels
    multiply dz rounded to bf16 (the TPU's DEFAULT precision) where the
    plain versions keep the f32 dz: the limit is twice what that
    rounding moves the plain version (the witness: the plain version fed
    the bf16-rounded dz) plus 1e-5 for B15's f32 output, plus 2^-9 for
    dx's bf16 output; in f32 it is 1e-5 (f32 sums in another order). One
    control per kernel and case, a plain version with the first k-step
    of one expert left out (B15: its first rows; dx: the first columns of
    its reduction), must exceed ten times the limit. Empty experts' dw
    and dx rows past offsets[E] must be +0.0 bit for bit, a second B15
    call bitwise equal to the first (deterministic), and in bf16 B15's
    bf16 output (the training step's) its f32 output rounded and its walk
    (heaviest expert first) ``dw_tile_order``'s. Then both
    kernels timed in bf16 (bf16 out, as the training step runs them)
    beside the plain versions, the bound and torch._grouped_mm."""
    from paddle_tpu_torch.nn.functional import grouped_gemm as gg

    dev, E, T = "cuda", MOE_E, MOE_ROWS
    banks = {"ffn1": (MOE_D, MOE_DFF), "ffn2": (MOE_DFF, MOE_D)}
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        bf16 = dtype == torch.bfloat16
        kstep = 32 if bf16 else 16
        for bank, (K, N) in banks.items():
            w = (torch.randn(E, K, N, generator=gen, device=dev)
                 * 0.02).to(dtype)
            x = torch.randn(T, K, generator=gen, device=dev).to(dtype)
            dz = torch.randn(T, N, generator=gen, device=dev) * 0.01
            for case in ("uniform", "one_expert", "two_empty", "short",
                         "unaligned"):
                off = _moe_offsets(case, T)
                total = int(off[-1])
                xs, dzs = x.clone(), dz.clone()
                xs[total:], dzs[total:] = 1e3, 1e3
                dz_k = dzs.to(dtype)
                # B15 (f32 out) and dx (x's dtype out, as in training)
                dw = gg._grouped_dw_cuda(xs, dz_k, off, E, torch.float32)
                dx = gg._grouped_gemm_cuda(dz_k, w, off, None, None, dtype,
                                           trans_w=True)
                # one writer and one row order per element: a second call
                # is bitwise equal
                again = torch.equal(dw.view(torch.int32), gg._grouped_dw_cuda(
                    xs, dz_k, off, E, torch.float32).view(torch.int32))
                # the bf16 output (the training step's, stored by TMA from
                # shared memory) is the f32 result rounded, bit for bit
                out16 = None if not bf16 else torch.equal(
                    gg._grouped_dw_cuda(xs, dz_k, off, E, dtype)
                    .view(torch.int16), dw.to(dtype).view(torch.int16))
                # the bf16 kernel's walk, worked out on the device, is
                # dw_tile_order's
                walk = None if not bf16 else torch.equal(
                    gg.kernel_dw_tile_order(off, K, N),
                    gg.dw_tile_order(off, K, N))
                torch.cuda.synchronize()
                dw_ref = gg.grouped_dw_plain(xs, dzs, off, E)
                dx_ref = gg.grouped_gemm_plain(
                    dzs, w.transpose(1, 2), off, out_dtype=dtype)
                e_dw = _expert_rel_l2(dw, dw_ref, off, False)
                e_dx = _expert_rel_l2(dx, dx_ref, off, True)
                if bf16:
                    wdz = dzs.to(dtype).float()
                    wit_dw = _expert_rel_l2(gg.grouped_dw_plain(
                        xs, wdz, off, E), dw_ref, off, False)
                    wit_dx = _expert_rel_l2(gg.grouped_gemm_plain(
                        wdz, w.transpose(1, 2), off, out_dtype=dtype),
                        dx_ref, off, True)
                    tol_dw = 2 * wit_dw + 1e-5
                    tol_dx = 2 * wit_dx + 2.0 ** -9
                else:
                    wit_dw = wit_dx = None
                    tol_dw = tol_dx = 1e-5
                # controls: one expert's first k-step left out
                ce, (r0, r1) = _first_kstep_dropped(off, kstep)
                x_c = xs.clone()
                x_c[r0:r1] = 0
                c_dw = _expert_rel_l2(gg.grouped_dw_plain(
                    x_c, dzs, off, E), dw_ref, off, False)
                w_c = w.clone()
                w_c[ce, :, :kstep] = 0
                c_dx = _expert_rel_l2(gg.grouped_gemm_plain(
                    dzs, w_c.transpose(1, 2), off, out_dtype=dtype),
                    dx_ref, off, True)
                empty = [e for e in range(E)
                         if int(off[e + 1]) == int(off[e])]
                zeros = all(_zero_bits(dw[e]) for e in empty) \
                    and _zero_bits(dx[total:])
                emit({"check": "grouped_gemm_bwd", "bank": bank,
                      "dtype": str(dtype), "T": T, "offsets": case,
                      "metric": "largest per-expert relative L2",
                      "grouped_dw_err": e_dw, "grouped_dw_tol": tol_dw,
                      "grouped_dw_witness": wit_dw,
                      "grouped_dw_control": c_dw,
                      "dx_err": e_dx, "dx_tol": tol_dx,
                      "dx_witness": wit_dx, "dx_control": c_dx,
                      "control_expert": ce,
                      "empty_experts": empty,
                      "grouped_dw_max_abs_err": max_err(dw, dw_ref),
                      "dx_max_abs_err": max_err(dx, dx_ref),
                      "empty_dw_and_dead_dx_rows_bitwise_zero": zeros,
                      "grouped_dw_second_call_bitwise_equal": again,
                      "grouped_dw_bf16_out_is_f32_out_rounded": out16,
                      "grouped_dw_walk_is_dw_tile_order": walk})
                what = f"grouped_gemm_bwd {bank} {dtype} {case}"
                check(e_dw <= tol_dw, f"{what}: B15 {e_dw} > {tol_dw}")
                check(e_dx <= tol_dx, f"{what}: dx {e_dx} > {tol_dx}")
                check(c_dw > 10 * tol_dw, f"{what}: the B15 control "
                      f"{c_dw} is not over 10x the limit {tol_dw}")
                check(c_dx > 10 * tol_dx, f"{what}: the dx control "
                      f"{c_dx} is not over 10x the limit {tol_dx}")
                check(zeros, f"{what}: an empty expert's dw or a dx row "
                             "past offsets[E] is not +0.0")
                check(again, f"{what}: a second B15 call is not bitwise "
                             "equal to the first")
                check(out16 is not False, f"{what}: B15's bf16 output is "
                      "not its f32 output rounded to bf16")
                check(walk is not False, f"{what}: B15's walk is not "
                      "dw_tile_order's")
                if bf16 and bank == "ffn1" and case == "uniform":
                    errs["grouped_dw"] = max_err(dw, dw_ref)
                del xs, dzs, dz_k, dw, dx, dw_ref, dx_ref, x_c, w_c
            del w, x, dz
    # timing: bf16, uniform routing, bf16 outputs (the training step's)
    dt = torch.bfloat16
    off = _moe_offsets("uniform", T)
    ends = off[1:].contiguous()
    total = int(off[-1])
    grouped_mm = getattr(torch, "_grouped_mm", None)
    rows = {}
    for bank, (K, N) in banks.items():
        w = (torch.randn(E, K, N, generator=gen, device=dev) * 0.02).to(dt)
        x = torch.randn(T, K, generator=gen, device=dev).to(dt)
        dz = torch.randn(T, N, generator=gen, device=dev) * 0.01
        dz16 = dz.to(dt)
        calls = {
            "grouped_dw": (
                lambda: gg._grouped_dw_cuda(x, dz16, off, E, dt),
                lambda: gg.grouped_dw_plain(x, dz, off, E).to(dt),
                lambda: grouped_mm(x.t(), dz16, offs=ends),
                lambda: gg.grouped_dw_plain(x, dz16, off, E),
                (T * K * 2 + T * N * 2 + E * K * N * 2)),
            "grouped_gemm_dx": (
                lambda: gg._grouped_gemm_cuda(dz16, w, off, None, None, dt,
                                              trans_w=True),
                lambda: gg.grouped_gemm_plain(dz, w.transpose(1, 2), off,
                                              out_dtype=dt),
                lambda: grouped_mm(dz16, w.transpose(1, 2), offs=ends),
                lambda: gg.grouped_gemm_plain(dz16, w.transpose(1, 2), off,
                                              out_dtype=dt),
                (T * N * 2 + E * K * N * 2 + T * K * 2))}
        for name, (kern, plain, lib, ref, nbytes) in calls.items():
            flops = 2.0 * total * K * N
            lib_ms, lib_note, lib_err = None, "none (no single call)", None
            if grouped_mm is not None:
                try:
                    got = lib()
                    torch.cuda.synchronize()
                    lib_err = _expert_rel_l2(
                        got, ref(), off, name == "grouped_gemm_dx")
                    lib_ms, lib_note = time_ms(lib), "torch._grouped_mm"
                except (RuntimeError, TypeError, ValueError) as err:
                    lib_note = f"torch._grouped_mm refused: {str(err)[:120]}"
            bms, by = bound_ms(nbytes, flops, dt)
            row = {"ms": time_ms(kern),
                   "device_ms": device_ms(kern, B14_KERNEL
                                          if name == "grouped_gemm_dx"
                                          else B15_KERNEL, per_call=1),
                   "plain_ms": time_ms(plain, iters=5),
                   "library_ms": lib_ms, "library": lib_note,
                   "library_rel_l2_vs_plain_bf16_dz": lib_err,
                   "bound_ms": bms, "bound_by": by, "bytes": nbytes,
                   "flops": flops, "T": T, "bank": [E, K, N]}
            row["tflops"] = flops / row["ms"] / 1e9
            rows[(name, bank)] = row
            emit({"time": f"{name}[{bank}]", **row})
        del w, x, dz, dz16
    # the kernels line: B15's pair of one layer (FFN1's and FFN2's dw)
    pair = [rows[("grouped_dw", b)] for b in banks]

    def total_of(key):
        vals = [r[key] for r in pair]
        return None if any(v is None for v in vals) else sum(vals)
    bms, by = bound_ms(sum(r["bytes"] for r in pair),
                       sum(r["flops"] for r in pair), dt)
    return {"max_abs_err": errs["grouped_dw"], "ms": total_of("ms"),
            "plain_ms": total_of("plain_ms"),
            "library_ms": total_of("library_ms"), "bound_ms": bms,
            "bound_by": by, "note": "FFN1 + FFN2 dw of one layer"}


def _counters():
    from paddle_tpu_torch.nn.functional import attention as at
    from paddle_tpu_torch.nn.functional import flash_varlen as fv
    from paddle_tpu_torch.nn.functional import grouped_gemm as gg
    from paddle_tpu_torch.nn.functional import lora as tl
    from paddle_tpu_torch.nn.functional import paged_attention as pa
    from paddle_tpu_torch.nn.functional import stream_linear as sl

    return {"paged_decode_attention_inplace": pa.launches,
            "stream_linear": sl.launches,
            "stream_layer_tail": sl.tail_launches,
            "paged_prefill_attention": fv.launches,
            "stream_linear_w8": sl.w8_launches,
            "stream_layer_tail_w8": sl.tail_w8_launches,
            "stream_linear_a8w8": sl.a8w8_launches,
            "paged_decode_attention_inplace_q": pa.q_launches,
            "grouped_gemm": gg.launches,
            "grouped_dw": gg.dw_launches,
            "lora_delta": tl.launches,
            "flash_attention_fwd": at.fwd_launches,
            "flash_attention_bwd_dq": at.dq_launches,
            "flash_attention_bwd_dkv": at.dkv_launches,
            "flash_varlen_fwd": fv.fwd_varlen_launches,
            "flash_varlen_bwd_dq": fv.dq_varlen_launches,
            "flash_varlen_bwd_dkv": fv.dkv_varlen_launches,
            "paged_attention_stream": pa.stream_launches,
            "paged_attention_fused": pa.fused_launches,
            "paged_attention_pallas": pa.pallas_launches}


#: CUDA launches of one stream_layer_tail call with the next layer's
#: QKV: O-proj, FFN1, FFN2 and QKV' GEMMs, LN2 and LN1'
TAIL_LAUNCHES_PER_CALL = 6


def _expected_launches(decode_steps: int, prefills: int,
                       prefill_chunks: int = 0, quant=None,
                       kv_dtype=None, moe=False,
                       layers: int = N_LAYERS, attention=None) -> dict:
    """Launches of a path. Per decode step: one attention per layer
    (B6 over an int8 pool; under FLAGS_paged_attention_backend
    ``attention`` = fused or pallas B8 or B9; else B1) and the LM head;
    the grouped,
    prefetching loop adds the layer-0 QKV and one tail call per layer
    (their int8-weight kernels under quant="int8"); A8W8 runs the
    ungrouped loop instead, four B5 GEMMs per layer; an MoE stack runs
    the ungrouped loop with plain QKV/O products and two grouped GEMMs
    (B14, FFN1 and FFN2) per layer, in its prefill too. Per one-shot
    prefill one LM head; per chunk of the chunked prefill one LM head
    and, over a float pool, one paged-prefill attention per layer (an
    int8 pool takes the gather path, PyTorch ops)."""
    L, steps = layers, decode_steps
    e = dict.fromkeys(_SOURCES, 0)
    e["paged_decode_attention_inplace_q" if kv_dtype == "int8"
      else f"paged_attention_{attention}" if attention
      else "paged_decode_attention_inplace"] = L * steps
    e["stream_linear"] = steps + prefills + prefill_chunks
    if moe:
        e["grouped_gemm"] = 2 * L * (steps + prefills + prefill_chunks)
    elif quant == "a8w8":
        e["stream_linear_a8w8"] = 4 * L * steps
    elif quant == "int8":
        e["stream_linear_w8"] = steps
        e["stream_layer_tail_w8"] = TAIL_LAUNCHES_PER_CALL * L * steps
    else:
        e["stream_linear"] += steps
        e["stream_layer_tail"] = TAIL_LAUNCHES_PER_CALL * L * steps
    if kv_dtype != "int8":
        e["paged_prefill_attention"] = L * prefill_chunks
    return e


def _check_launches(path: str, counts: dict, expect: dict) -> None:
    """Exact counts; every kernel the path runs launched at least once."""
    for name, n in counts.items():
        check(n > 0 or expect[name] == 0, f"{path} did not launch {name}")
        check(n == expect[name], f"{path} launched {name} {n} times, "
                                 f"expected {expect[name]}")


def _reset_counters():
    from paddle_tpu_torch.nn.functional import attention as at
    from paddle_tpu_torch.nn.functional import flash_varlen as fv
    from paddle_tpu_torch.nn.functional import paged_attention as pa
    from paddle_tpu_torch.nn.functional import stream_linear as sl

    from paddle_tpu_torch.nn.functional import grouped_gemm as gg
    from paddle_tpu_torch.nn.functional import lora as tl

    pa.launches = pa.q_launches = 0
    pa.stream_launches = pa.fused_launches = pa.pallas_launches = 0
    sl.launches = sl.tail_launches = 0
    sl.w8_launches = sl.tail_w8_launches = sl.a8w8_launches = 0
    fv.launches = gg.launches = gg.dw_launches = tl.launches = 0
    at.fwd_launches = at.dq_launches = at.dkv_launches = 0
    fv.fwd_varlen_launches = fv.dq_varlen_launches = 0
    fv.dkv_varlen_launches = 0


def _ulp_nudge(x, gen):
    """x with a random half of its elements one ulp further from zero."""
    it = torch.int32 if x.dtype == torch.float32 else torch.int16
    flip = torch.rand(x.shape, generator=gen, device=x.device) < 0.5
    return (x.contiguous().view(it) + flip.to(it)).view(x.dtype)


@contextlib.contextmanager
def plain_path(act_quant_ulp=None, drop_k_tile=False, drop_ffn2_k=False,
               ffn1_ulp=None):
    """The decode step and the chunked prefill with every kernel call
    replaced by its plain PyTorch version (the reference for the
    teacher-forced and chunked-prefill checks).

    Two variants serve the A8W8 check. ``act_quant_ulp`` (a generator)
    nudges a random half of every act-quant input by one ulp before it
    is quantized: the witness of how far rounding noise of that size
    moves the logits. ``drop_k_tile`` makes every A8W8 product skip its
    last 32 K lanes, a tile-edge fault that the check must catch.
    The MoE check has two: ``drop_ffn2_k``, its control, makes every
    expert's FFN2 (the grouped product without activation) skip its last
    32 K lanes; ``ffn1_ulp`` (a generator), its witness, nudges a random
    half of every FFN1 output one ulp."""
    from unittest import mock

    from paddle_tpu_torch.incubate.nn import fused_transformer as ft
    from paddle_tpu_torch.inference import engine as eng
    from paddle_tpu_torch.nn.functional import flash_varlen as fv
    from paddle_tpu_torch.nn.functional import grouped_gemm as gg
    from paddle_tpu_torch.nn.functional import lora as tl
    from paddle_tpu_torch.nn.functional import paged_attention as pa
    from paddle_tpu_torch.nn.functional import stream_linear as sl
    from paddle_tpu_torch.quantization.dynamic import dynamic_act_quant

    def attn(q, k, v, ck, cv, lens, tbl, pool_base=None, pool_pages=None):
        return (pa._paged_decode_plain(q, k, v, ck, cv, lens, tbl,
                                       pool_base or 0, pool_pages), ck, cv)

    def attn_q(q, k, v, kq, ks, vq, vs, lens, tbl, pool_base=None,
               pool_pages=None):
        return (pa._paged_decode_q_plain(q, k, v, kq, ks, vq, vs, lens, tbl,
                                         pool_base or 0, pool_pages),
                kq, ks, vq, vs)

    def lin(x, w, layer=None, bias=None, scale=None, activation=None,
            out_dtype=None, act_quant=False):
        if act_quant:
            if act_quant_ulp is not None:
                x = _ulp_nudge(x, act_quant_ulp)
            xq, xs = dynamic_act_quant(x)
            if drop_k_tile:
                xq = xq.clone()
                xq[..., -32:] = 0
            return sl._stream_linear_a8w8_plain(xq, xs, w, scale, layer,
                                                bias, activation,
                                                out_dtype or x.dtype)
        return sl._stream_linear_plain(x, w, layer, bias, activation,
                                       out_dtype, scale=scale)

    def grouped(x, w, offsets, *, bias=None, activation=None,
                out_dtype=None, backend="auto"):
        # backend names a kernel route; the plain version has none
        if drop_ffn2_k and activation is None:
            x = x.clone()
            x[:, -32:] = 0
        y = gg.grouped_gemm_plain(x, w, offsets, bias=bias,
                                  activation=activation,
                                  out_dtype=out_dtype)
        if ffn1_ulp is not None and activation is not None:
            y = _ulp_nudge(y, ffn1_ulp)
        return y

    def delta(x, a, b, offsets, *, out_dtype=None, backend="auto"):
        return tl.lora_delta_plain(x, a, b, offsets, out_dtype=out_dtype)

    def stream(q, kc, vc, lens, tbl, pool_base=None, pool_pages=None,
               membership=None):
        base, region = pa._layer_region("stream_paged", kc.shape[0],
                                        pool_base, pool_pages)
        return pa._stream_paged_plain(q, kc, vc, lens, tbl, base, region,
                                      membership)
    with mock.patch.object(ft, "paged_decode_attention_inplace", attn), \
            mock.patch.object(pa, "stream_paged", stream), \
            mock.patch.object(pa, "fused_paged", pa._fused_paged_plain), \
            mock.patch.object(pa, "pallas_paged", pa._pallas_paged_plain), \
            mock.patch.object(ft, "paged_decode_attention_inplace_q",
                              attn_q), \
            mock.patch.object(ft, "stream_linear", lin), \
            mock.patch.object(ft, "stream_layer_tail", _plain_tail), \
            mock.patch.object(ft, "paged_prefill_attention",
                              fv._paged_prefill_plain), \
            mock.patch.object(gg, "grouped_gemm", grouped), \
            mock.patch.object(ft, "lora_delta", delta), \
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


def slice_generate(model, name="generate", quant=None, kv_dtype=None,
                   batch=BATCH, new_tokens=NEW_TOKENS,
                   attention=None) -> dict:
    """GenerationEngine.generate at ``batch``, prompt 128, ``new_tokens``
    (bench.py's decode rungs; ``quant``/``kv_dtype`` select the
    quantized ones, an MoE model the MoE rung; ``attention`` names the
    FLAGS_paged_attention_backend value the caller set), its launch
    counts reset before and checked after."""
    from paddle_tpu_torch.inference import GenerationEngine
    from paddle_tpu_torch.profiler import stats

    st = model.stack
    moe = bool(st.moe_num_experts)
    eng = GenerationEngine(model, page_size=PAGE,
                           max_length=PROMPT + new_tokens, quant=quant,
                           kv_dtype=kv_dtype)
    ids = np.random.RandomState(0).randint(0, VOCAB, (batch, PROMPT))
    eng.generate(ids[:, :16], max_new_tokens=4)          # warm-up
    torch.cuda.synchronize()
    mm0 = stats.counter("quant.a8w8_matmuls").value
    _reset_counters()
    t0 = time.perf_counter()
    out = eng.generate(ids, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _counters()
    # first token: prefill
    expect = _expected_launches(new_tokens - 1, 1, quant=quant,
                                kv_dtype=kv_dtype, moe=moe,
                                layers=st.num_layers, attention=attention)
    a8w8_matmuls = stats.counter("quant.a8w8_matmuls").value - mm0
    # seconds and tokens/s cover the whole call, the prefill included
    emit({"phase": name, "batch": batch, "prompt": PROMPT,
          "new_tokens": new_tokens, "quant": quant,
          "kv_dtype": kv_dtype, "attention": attention,
          "layers": st.num_layers,
          "d_model": st.embed_dim, "experts": st.moe_num_experts,
          "seconds": dt, "tokens_per_s": batch * new_tokens / dt,
          "quant_a8w8_matmuls": a8w8_matmuls,
          "launches": counts, "expected_launches": expect})
    check(out.shape == (batch, PROMPT + new_tokens), f"{name} shape")
    check(bool((out >= 0).all() and (out < VOCAB).all()),
          f"{name}: token ids outside the vocabulary")
    check(bool((out[:, :PROMPT] == ids).all()), f"{name}: prompt lost")
    check(a8w8_matmuls == (4 * N_LAYERS * new_tokens if quant == "a8w8"
                           else 0),
          f"{name}: quant.a8w8_matmuls counted {a8w8_matmuls}")
    _check_launches(name, counts, expect)
    return counts


def _prefilled(model, b: int, steps: int, seed: int, quant=None,
               kv_dtype=None) -> dict:
    """A prefilled batch of ``b`` random prompts of PROMPT tokens with
    pages for ``steps`` more, and what a decode step needs."""
    from paddle_tpu_torch.inference import (BlockKVCacheManager,
                                            GenerationEngine)

    eng = GenerationEngine(model, page_size=PAGE,
                           max_length=PROMPT + steps + 1, quant=quant,
                           kv_dtype=kv_dtype)
    st = model.stack
    pages_per_seq = -(-(PROMPT + steps + 1) // PAGE)
    mgr = BlockKVCacheManager(st.num_layers, st.num_kv_heads, st.head_dim,
                              PAGE, num_pages=b * pages_per_seq + 1,
                              dtype=eng._kv_dtype, reserve_scratch=True)
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
                tok=eng._argmax(logits), logits=logits, w=w, emb=emb,
                head=head,
                lnf_s=lnf_s, lnf_b=lnf_b)


def _clone(side):
    return tuple(t.clone() for t in side) if isinstance(side, tuple) \
        else side.clone()


def slice_teacher_forced(model, steps: int = 16, quant=None,
                         kv_dtype=None, name="teacher_forced",
                         adapters=None) -> None:
    """Kernel path and plain path decode the same tokens from the same
    prefilled pool; their logits must agree within the bf16 tolerance.
    ``adapters`` (bank operands and per-row slots) runs the adaptered
    decode step on both paths."""
    from paddle_tpu_torch.incubate.nn.fused_transformer import PagedKV

    b = 8
    s = _prefilled(model, b, steps, seed=1, quant=quant, kv_dtype=kv_dtype)
    eng, st, tables, ck, cv = (s[k] for k in ("eng", "st", "tables", "ck",
                                               "cv"))
    w, emb, head, lnf_s, lnf_b = (s[k] for k in ("w", "emb", "head",
                                                  "lnf_s", "lnf_b"))
    tok, lens = s["tok"], s["lens"]
    # tolerance: logits have std ~0.9 (LN output x 0.02 embedding over
    # 2048 lanes); the paths round bf16 intermediates at different
    # points (h2, hn, ff; an int8 product before its scale), a few 2^-9
    # relative each per layer. A8W8's per-token act quant steps by
    # absmax/127 (two bf16 ulps at the row's largest element, more for
    # the smaller ones), so a one-ulp difference upstream can move an
    # element by a whole step: its limit is set from sound runs on an
    # H100 (0.1234 in each of four), and two more plain runs go beside
    # it — a witness nudging one ulp before each act quant (0.193 on
    # that card), and a control with a faulty A8W8 product (1.27),
    # which must fail the limit
    a8w8 = quant == "a8w8"
    tol = 0.15 if a8w8 else 0.1
    variants = {"plain": {}}
    if a8w8:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        variants.update(witness={"act_quant_ulp": gen},
                        control={"drop_k_tile": True})
    pools = {v: (_clone(ck), _clone(cv)) for v in variants}
    errs = {v: [] for v in variants}
    agree = 0
    pos = lens.clone()
    t0 = time.perf_counter()
    for _ in range(steps):
        x = emb[tok.long()].to(torch.bfloat16)
        h, _ = st.decode_raw(w, x, PagedKV(ck, cv), tables, pos,
                             eng._cos, eng._sin, a8w8=eng._a8w8,
                             adapters=adapters)
        lk = eng._logits(h, head, lnf_s, lnf_b)
        check(bool(torch.isfinite(lk).all()), f"{name}: logits finite")
        tk = eng._argmax(lk)
        for v, kw in variants.items():
            with plain_path(**kw):
                h2, _ = st.decode_raw(w, x, PagedKV(*pools[v]), tables,
                                      pos, eng._cos, eng._sin,
                                      a8w8=eng._a8w8, adapters=adapters)
                lp = eng._logits(h2, head, lnf_s, lnf_b)
            # the witness is held against the plain path, the rest
            # against the kernel path ("plain" runs first)
            errs[v].append(max_err(lp, lp_plain) if v == "witness"
                           else max_err(lk, lp))
            if v == "plain":
                lp_plain = lp
                agree += int((tk == eng._argmax(lp)).sum())
        tok = tk
        pos = pos + 1
    emit({"phase": name, "quant": quant, "kv_dtype": kv_dtype,
          "steps": steps, "batch": b,
          "logits_max_abs_err": max(errs["plain"]),
          "per_step": errs["plain"], "tol": tol,
          **{f"{v}_logits_max_abs_err": max(errs[v])
             for v in variants if v != "plain"},
          "argmax_agreement": agree / (steps * b),
          "wall_s": time.perf_counter() - t0})
    err = max(errs["plain"])
    check(err <= tol, f"{name}: logits differ by {err} > {tol}")
    if a8w8:
        err = max(errs["control"])
        check(err > tol, f"{name}: the faulty A8W8 product passes the "
              f"limit ({err} <= {tol})")


def slice_decode_step(model, out_dir, steps: int = 16, quant=None,
                      kv_dtype=None, batch=BATCH,
                      name="decode_step") -> None:
    """One decode step at ``batch`` after a 128-token prompt: a chunk of
    ``steps`` steps (one host sync) timed bare, three times, for the
    wall per step; then once more under torch.profiler for the device
    time by kernel. The idle share is 1 - device busy / bare wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    s = _prefilled(model, batch, steps, seed=3, quant=quant,
                   kv_dtype=kv_dtype)
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
              B1_KERNEL: "paged_decode_attention_inplace",
              "paged_decode_q_kernel": "paged_decode_attention_inplace_q",
              B6_KERNEL: "paged_decode_attention_inplace_q",
              B2_KERNEL: "stream_linear GEMM (QKV, head, tail "
                         "projections)",
              "stream_linear_kernel": "stream_linear GEMM (QKV, head, "
                                      "tail projections)",
              B5_KERNEL: "stream_linear_a8w8 GEMM",
              "layer_norm_kernel": "tail LayerNorm",
              B14_KERNEL: "grouped_gemm (MoE FFN1 + FFN2)",
              "grouped_gemm_kernel": "grouped_gemm (MoE FFN1 + FFN2)",
              "lora_delta_": "lora_delta"}
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
    emit({"phase": name, "batch": batch, "context": PROMPT,
          "quant": quant, "kv_dtype": kv_dtype,
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
        with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
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


def slice_serving(model, name="serving", quant=None,
                  kv_dtype=None) -> dict:
    """The SLO serving frontend at full width: ServingEngine with 8 slots,
    page 16, max_length 2048, decode chunk 16 and prefill chunks of 256.
    A 512-token system prompt S; the first request, S + 64 tokens, is
    stepped into decode so its prefix is registered; then 7 more of S +
    16..240 tokens and 8 independent prompts of 40..1500 tokens, all
    with 64 new tokens, are served to the end step by step.
    ``quant``/``kv_dtype`` serve the same workload quantized."""
    from paddle_tpu_torch.profiler import stats
    from paddle_tpu_torch.serving import ServingEngine, SLOConfig

    new = 64
    slo = SLOConfig(prefill_chunk=SERVE_CHUNK)
    eng = ServingEngine(model, max_batch=8, page_size=PAGE,
                        max_length=SERVE_MAX_LENGTH, decode_chunk=16,
                        slo=slo, quant=quant, kv_dtype=kv_dtype)
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
    expect = _expected_launches(dsteps, 0, chunks, quant=quant,
                                kv_dtype=kv_dtype)
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
    emit({"phase": name, "quant": quant, "kv_dtype": kv_dtype,
          "requests": len(done),
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
    _check_launches(name, counts, expect)
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


def slice_prefill_chunk(model) -> None:
    """One ``prefill_chunk_raw`` of 256 tokens at start 1792 (the last
    chunk of a 2048-token prompt) through the d2048·L24 stack: its wall
    ms on the host clock (each call ended by a synchronize; 5 calls after
    2), and by the profiler its device ms, kernel 4's share of them and
    the host ops with the most self CPU time; exactly one kernel-4
    launch a layer."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference import (BlockKVCacheManager,
                                            GenerationEngine)

    st = model.stack
    eng = GenerationEngine(model, page_size=PAGE,
                           max_length=SERVE_MAX_LENGTH)
    pp = SERVE_MAX_LENGTH // PAGE
    mgr = BlockKVCacheManager(st.num_layers, st.num_kv_heads, st.head_dim,
                              PAGE, num_pages=pp + 1, dtype=torch.bfloat16,
                              reserve_scratch=True, device=model.device)
    mgr.allocate(0, SERVE_MAX_LENGTH)
    tables = mgr.block_tables([0], pp)
    cache = mgr.fresh_cache()
    start, c = SERVE_MAX_LENGTH - SERVE_CHUNK, SERVE_CHUNK
    ids = torch.from_numpy(np.random.RandomState(6).randint(
        0, VOCAB, c)).cuda()
    x = eng._embed()[ids][None].to(torch.bfloat16)
    w = eng._weights()
    s0 = torch.tensor([start], dtype=torch.int32, device="cuda")
    n = torch.tensor([c], dtype=torch.int32, device="cuda")

    def chunk():
        return st.prefill_chunk_raw(w, x, cache, tables, s0, n, eng._cos,
                                    eng._sin)
    for _ in range(2):
        chunk()
    torch.cuda.synchronize()
    _reset_counters()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    counts = _counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            chunk()
        torch.cuda.synchronize()
    avg = prof.key_averages()
    evs = [ev for ev in avg if ev.device_type == DeviceType.CUDA]
    host = sorted((ev for ev in avg if ev.device_type == DeviceType.CPU),
                  key=lambda ev: -ev.self_cpu_time_total)[:8]
    busy = sum(ev.self_device_time_total for ev in evs) / 3 / 1e3
    b4 = sum(ev.self_device_time_total for ev in evs
             if "paged_prefill" in ev.key) / 3 / 1e3
    top = sorted(evs, key=lambda ev: -ev.self_device_time_total)[:6]
    emit({"phase": "prefill_chunk", "start": start, "chunk": c,
          "layers": st.num_layers, "wall_ms": walls,
          "wall_ms_min": min(walls), "device_ms": busy,
          "paged_prefill_device_ms": b4, "paged_prefill_share": b4 / busy,
          "top_kernels_ms": {ev.key[:60]: ev.self_device_time_total / 3e3
                             for ev in top},
          "top_host_ops_self_ms": {
              ev.key[:60]: [ev.self_cpu_time_total / 3e3, ev.count // 3]
              for ev in host},
          "launches": {k: v for k, v in counts.items() if v}})
    check(counts["paged_prefill_attention"] == 5 * st.num_layers,
          f"prefill_chunk: {counts['paged_prefill_attention']} kernel-4 "
          f"launches in 5 chunks, expected {5 * st.num_layers}")
    del mgr, cache


# ---------------------------------------------------------------- MoE

def _build_moe_model():
    """bench.py's --moe-decode rung at full width: FusedCausalLM d1024,
    12 layers, 16 heads of 64, dff 4096, vocab 51200, 8 experts, top-2;
    random weights from seed 0, bf16 *_weight / moe_w* / gate_weight,
    fp32 biases and LNs (run_moe_decode_bench's recipe)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.inference import FusedCausalLM

    ptt.seed(0)
    model = FusedCausalLM(
        vocab_size=VOCAB, embed_dim=MOE_D, num_heads=MOE_HEADS,
        dim_feedforward=MOE_DFF, num_layers=MOE_LAYERS,
        max_position=PROMPT + MOE_NEW + 1, moe_num_experts=MOE_E,
        moe_top_k=MOE_TOPK)
    for n, p in model.stack.named_parameters():
        if "weight" in n or n.startswith(("moe_w", "gate")):
            p.data = p.data.to(torch.bfloat16)
    return model


def slice_teacher_forced_moe(model, steps: int = 16) -> None:
    """The MoE decode step on the kernel path and on the plain path, fed
    the kernel path's tokens (b 8, 16 steps); each step the plain path
    starts from a copy of the kernel path's pool, so every step is
    compared from one state. Routing is discrete: paths a bf16 rounding
    apart can pick another expert near a tie (and then differ in the
    later layers of that token), so the check reports the share of
    (token, layer) top-k sets on which the paths differ — under 1% — and
    holds the logits to the bf16 limit of 0.1 on the rows whose routes
    agree in every layer. Two more plain runs go beside it: a witness
    whose FFN1 outputs are nudged one ulp (its route share against the
    plain path says how far rounding noise alone moves routes), and a
    control whose FFN2 skips each expert's last 32 K lanes, which must
    fail the logits limit on the same rows."""
    from unittest import mock

    from paddle_tpu_torch.incubate.nn.fused_transformer import PagedKV
    from paddle_tpu_torch.nn.functional import grouped_gemm as gg

    b, tol = 8, 0.1
    s = _prefilled(model, b, steps, seed=1)
    eng, st, tables, ck, cv = (s[k] for k in ("eng", "st", "tables", "ck",
                                               "cv"))
    w, emb, head, lnf_s, lnf_b = (s[k] for k in ("w", "emb", "head",
                                                  "lnf_s", "lnf_b"))
    tok, pos = s["tok"], s["lens"].clone()
    routes = []
    route = gg.moe_route

    def recording(x, gate_w, top_k):
        out = route(x, gate_w, top_k)
        routes.append(out[2].sort(dim=-1).values)
        return out

    def step(kw, pool):
        routes.clear()
        ctx = plain_path(**kw) if kw is not None else contextlib.nullcontext()
        with ctx, mock.patch.object(gg, "moe_route", recording):
            h, _ = st.decode_raw(w, x, PagedKV(*pool), tables, pos, eng._cos,
                                 eng._sin)
            lg = eng._logits(h, head, lnf_s, lnf_b)
        return lg, torch.stack(routes)                 # [L, b, k]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    variants = {"plain": {}, "witness": {"ffn1_ulp": gen},
                "control": {"drop_ffn2_k": True}}
    errs = {v: [] for v in variants}
    differ = {"plain": 0, "witness": 0}
    total = agreeing_rows = 0
    t0 = time.perf_counter()
    for _ in range(steps):
        x = emb[tok.long()].to(torch.bfloat16)
        state = (_clone(ck), _clone(cv))
        lk, rk = step(None, (ck, cv))
        check(bool(torch.isfinite(lk).all()), "teacher_forced_moe: logits "
                                              "finite")
        for v, kw in variants.items():
            lp, rp = step(kw, (_clone(state[0]), _clone(state[1])))
            if v == "plain":
                same = (rk == rp).all(-1)              # [L, b]
                differ[v] += int((~same).sum())
                total += same.numel()
                rows = same.all(0).nonzero()[:, 0]
                agreeing_rows += len(rows)
                lp_plain, rp_plain = lp, rp
            if v == "witness":
                differ[v] += int((~(rp == rp_plain).all(-1)).sum())
            else:
                errs[v].append(max_err(lk[rows], lp[rows]) if len(rows)
                               else 0.0)
        tok = eng._argmax(lk)
        pos = pos + 1
    share = differ["plain"] / total
    emit({"phase": "teacher_forced_moe", "steps": steps, "batch": b,
          "route_sets": total, "route_sets_differing": differ["plain"],
          "route_differing_share": share,
          "witness_route_differing_share": differ["witness"] / total,
          "rows_compared": agreeing_rows,
          "logits_max_abs_err": max(errs["plain"]),
          "per_step": errs["plain"], "tol": tol,
          "control_logits_max_abs_err": max(errs["control"]),
          "wall_s": time.perf_counter() - t0})
    check(share < 0.01, f"teacher_forced_moe: {share:.4f} of the route "
                        "sets differ (limit 1%)")
    check(agreeing_rows >= steps * b // 2, "teacher_forced_moe: fewer than "
          "half the rows kept their routes on both paths")
    err = max(errs["plain"])
    check(err <= tol, f"teacher_forced_moe: logits differ by {err} > {tol}")
    err = max(errs["control"])
    check(err > tol, f"teacher_forced_moe: the faulty FFN2 passes the "
                     f"limit ({err} <= {tol})")


# ---------------------------------------------------------------- LoRA

def _lora_bank(model, names=("lora0", "lora1", "lora2", "lora3")):
    """AdapterBank.from_stack of the model (bf16 stack: a bf16 bank, rank
    8 padded to 16) with 4 slots, holding ``names`` made by
    random_adapter from seeds 0, 1, ... (the same in every process)."""
    from paddle_tpu_torch.serving import AdapterBank

    bank = AdapterBank.from_stack(model.stack._stack(), slots=LORA_SLOTS,
                                  rank=LORA_RANK)
    for i, n in enumerate(names):
        bank.load(bank.random_adapter(n, seed=i))
    return bank


def slice_serving_lora(model) -> dict:
    """The serving workload of ``slice_serving`` under a 4-slot bank:
    requests stamped round-robin lora0, lora1, lora2, lora3 and the base
    model, so chunks and decode steps mix adapters with base rows. The
    first request and the 7 sharing the system prompt run first; then
    lora3 is unloaded and lora4 loaded into its slot (a version bump:
    the bank's device tensors stay, refreshed in place), and the 8
    independent prompts run with lora4 where lora3 was. Every step's
    launches are checked: a chunk or decode step with an adaptered row
    adds 4 lora_delta launches per layer and, in decode, runs the
    four-call per-layer form (4 stream_linear a layer, no tail); a
    base-only decode step keeps the grouped tail."""
    from paddle_tpu_torch.profiler import stats
    from paddle_tpu_torch.serving import ServingEngine, SLOConfig

    L, new = N_LAYERS, 64
    bank = _lora_bank(model)
    slo = SLOConfig(prefill_chunk=SERVE_CHUNK)
    eng = ServingEngine(model, max_batch=8, page_size=PAGE,
                        max_length=SERVE_MAX_LENGTH, decode_chunk=16,
                        slo=slo, adapters=bank)
    free0 = eng._mgr.free_pages
    rng = np.random.RandomState(4)                # slice_serving's prompts
    sys_prompt = rng.randint(0, VOCAB, 512)
    first = np.concatenate([sys_prompt, rng.randint(0, VOCAB, 64)])
    shared = [np.concatenate([sys_prompt, rng.randint(0, VOCAB, int(n))])
              for n in rng.randint(16, 241, 7)]
    indep = [rng.randint(0, VOCAB, int(n))
             for n in np.linspace(40, 1500, 8).astype(int)]
    stamps = ("lora0", "lora1", "lora2", "lora3", None)
    adapter_of = {}
    tally = {"adaptered_decode_steps": 0, "base_decode_steps": 0,
             "adaptered_chunks": 0, "base_chunks": 0}
    attn = "paged_decode_attention_inplace"

    def submit(prompt, i, swap=False):
        a = stamps[i % len(stamps)]
        if swap and a == "lora3":
            a = "lora4"
        rid = eng.submit(prompt, max_new_tokens=new, adapter_id=a)
        adapter_of[rid] = a
        return rid

    def step():
        c0, d0 = _counters(), stats.counter("serving.decode_steps").value
        seq0, n = eng.journal.recorded, len(eng.action_log)
        adaptered = any(getattr(r, "_adapter_slot", None) is not None
                        for r in eng._slots if r is not None)
        eng.step()
        got = {k: v - c0[k] for k, v in _counters().items()}
        action = eng.action_log[n] if len(eng.action_log) > n else None
        expect = dict.fromkeys(got, 0)
        if action == "decode":
            k = stats.counter("serving.decode_steps").value - d0
            expect[attn] = L * k
            if adaptered:
                expect["lora_delta"] = 4 * L * k
                expect["stream_linear"] = (4 * L + 1) * k
            else:
                expect["stream_layer_tail"] = TAIL_LAUNCHES_PER_CALL * L * k
                expect["stream_linear"] = 2 * k
            tally["adaptered_decode_steps" if adaptered
                  else "base_decode_steps"] += k
        elif action == "prefill":
            rids = [e["rid"] for e in eng.journal.events()
                    if e["seq"] >= seq0 and e["ev"] == "prefill_chunk"]
            if rids:                              # not a stalled chunk
                ad = adapter_of[rids[0]] is not None
                expect["paged_prefill_attention"] = L
                expect["stream_linear"] = 1
                expect["lora_delta"] = 4 * L if ad else 0
                tally["adaptered_chunks" if ad else "base_chunks"] += 1
        check(got == expect, f"serving_lora step {len(eng.action_log)} "
                             f"({action}): launches {got}, expected "
                             f"{expect}")
    stats.reset()
    torch.cuda.synchronize()
    _reset_counters()
    t0 = time.perf_counter()
    rids = [submit(first, 0)]
    while not eng.num_active:
        step()
    rids += [submit(p, i) for i, p in enumerate(shared, 1)]
    while eng.has_work:
        step()
    ops = bank.operands()
    ptrs, uploads = {k: v.data_ptr() for k, v in ops.items()}, bank.uploads
    version = bank.version
    freed = bank.unload("lora3")
    slot = bank.load(bank.random_adapter("lora4", seed=4))
    rids += [submit(p, i, swap=True)
             for i, p in enumerate(indep, 1 + len(shared))]
    while eng.has_work:
        step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _counters()
    done = {r.id: r for r in eng.finished}
    ops_after = bank.operands()
    same_tensors = {k: v.data_ptr() for k, v in ops_after.items()} == ptrs
    grouped = stats.counter("lora.grouped_launches").value
    ttft = stats.histogram("serve.ttft_ms").summary()
    tpot = stats.histogram("serve.tpot_ms").summary()
    phase_ms = {p: stats.histogram(f"serve.step.{p}_ms").total
                for p in ("admit", "prefill_chunk", "decode_chunk",
                          "host_overhead")}
    free_end = eng._mgr.free_pages
    cleared = eng.prefix_cache.clear()
    emit({"phase": "serving_lora", "requests": len(done),
          "adapters": [adapter_of[r] for r in rids], "seconds": dt,
          "tokens_per_s": len(rids) * new / dt,
          "ttft_ms_p50": ttft["p50"], "ttft_ms_p99": ttft["p99"],
          "tpot_ms_p50": tpot["p50"], "tpot_ms_p99": tpot["p99"],
          "step_ms_by_phase": phase_ms, **tally,
          "prefill_chunks": stats.counter("serve.prefill_chunks").value,
          "prefix_hit": stats.counter("serving.prefix_hit").value,
          "lora_grouped_launches": grouped, "lora_swaps":
          stats.counter("lora.swaps").value, "swap": {
              "unloaded_freed": freed, "loaded_slot": slot,
              "versions": [version, bank.version],
              "uploads": [uploads, bank.uploads],
              "same_device_tensors": same_tensors},
          "launches": counts, "free_pages_start": free0,
          "free_pages_end": free_end, "prefix_pages_cleared": cleared,
          "free_pages_after_clear": eng._mgr.free_pages})
    check(sorted(done) == sorted(rids),
          f"{len(done)} of {len(rids)} requests finished")
    check(all(done[r].state == "ok" and len(done[r].generated) == new
              for r in rids), f"a request ended other than ok with {new} "
                              "tokens")
    check(all(0 <= t < VOCAB for r in rids for t in done[r].generated),
          "serving_lora: token ids outside the vocabulary")
    check(counts["lora_delta"] == grouped,
          f"lora_delta launched {counts['lora_delta']} times, the "
          f"scheduler counted lora.grouped_launches = {grouped}")
    check(min(tally.values()) > 0, f"serving_lora did not run every kind "
                                   f"of step: {tally}")
    check(freed and slot == 3 and same_tensors
          and bank.uploads == uploads + 1 and bank.version == version + 2,
          "serving_lora: the swap rebuilt or re-uploaded more than its "
          "version bump")
    check(all(bank.refcount(n) == 0 for n in bank.loaded()),
          "serving_lora: an adapter is still pinned")
    check(eng._mgr.free_pages == free0,
          "the pool's free pages did not return to their start value "
          "after the prefix cache was cleared")
    return counts


def slice_teacher_forced_lora(model) -> None:
    """The adaptered decode step (b 8, slots 0 1 2 3 base 0 1 base)
    against the plain path, 16 teacher-forced steps, the bf16 limit."""
    bank = _lora_bank(model)
    adapters = dict(bank.operands())
    adapters["slots"] = torch.tensor([0, 1, 2, 3, -1, 0, 1, -1],
                                     dtype=torch.int32, device="cuda")
    slice_teacher_forced(model, name="teacher_forced_lora",
                         adapters=adapters)


# ---------------------------------------------------------------- training

#: the training rung (bench.py's gpt3-1.3b: d2048, 24 layers, 16 heads of
#: 128, seq 1024, batch 4, vocab 51200, the _FAST options)
TRAIN_SEQ, TRAIN_BATCH = 1024, 4
#: the key tile the flash kernels walk
FLASH_TILE = 64


def _flash_pairs(sq: int, sk: int, causal: bool) -> int:
    """Visible (query, key) pairs of one head: key j from query i iff
    j <= i under the top-left causal mask."""
    if not causal:
        return sq * sk
    return sum(min(i + 1, sk) for i in range(sq))


def _flash_bounds(b, sq, sk, h, d, causal, dtype) -> dict:
    """Bytes (each input read once, each output written once) and
    operations of each B10 kernel's function: the forward QK^T and PV;
    dq's S, dP and dS K; dk/dv's S, dP, P^T dO and dS^T Q."""
    e = torch.tensor([], dtype=dtype).element_size()
    n = b * h * _flash_pairs(sq, sk, causal) * d
    q_io, k_io, stats = b * sq * h * d * e, b * sk * h * d * e, b * h * sq * 4
    return {
        "fwd": (2 * q_io + 2 * k_io + stats, 4.0 * n),
        "dq": (3 * q_io + 2 * k_io + 2 * stats, 6.0 * n),
        "dkv": (2 * q_io + 4 * k_io + 2 * stats, 8.0 * n)}


def _flash_inputs(gen, b, s, h, d, dtype, sk=None):
    """q, k, v as strided views of one [b, s, 3, h, d] tensor (as the
    GPT block hands them over), and a dout; with ``sk`` (cross lengths),
    k and v are views of a second such tensor of ``sk`` rows."""
    qkv = torch.randn(b, s, 3, h, d, generator=gen, device="cuda").to(dtype)
    q, k, v = qkv.unbind(2)
    if sk is not None:
        k, v = torch.randn(b, sk, 3, h, d, generator=gen,
                           device="cuda").to(dtype).unbind(2)[1:]
    do = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
    return q, k, v, do


def _flash_kernel_all(q, k, v, do, causal, scale):
    from paddle_tpu_torch.nn.functional import attention as at

    out, lse = at.flash_attention_fwd(q, k, v, causal, scale)
    return (out, lse, *at.flash_attention_bwd(q, k, v, out, lse, do,
                                              causal, scale))


def _flash_plain_all(q, k, v, do, causal, scale):
    from paddle_tpu_torch.nn.functional import attention as at

    out, lse = at.flash_attention_fwd_plain(q, k, v, causal, scale)
    return (out, lse, *at.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                    causal, scale))


#: B10's outputs, in the order the kernel and plain helpers return them
FLASH_OUTPUTS = ("out", "lse", "dq", "dk", "dv")
#: each kernel's faulty-kernel control: the outputs that must exceed
#: their limits when that kernel skips _late_tile_drop's pairs
FLASH_CONTROLS = {"fwd": ("out",), "dq": ("dq",), "dkv": ("dk", "dv")}


def _late_tile_drop(sq: int, sk: int):
    """The (query, key) pairs a faulty kernel would skip, for the
    controls: key tile ``t = min(sq, sk) / 128`` (the middle one of the
    shorter length, so causal rows see it at cross lengths too) from
    every query row past it, rows ``(t + 1) * 64`` on (key tile 8 from
    row 576 at s 1024)."""
    t = min(sq, sk) // (2 * FLASH_TILE)
    drop = torch.zeros((sq, sk), dtype=torch.bool, device="cuda")
    drop[(t + 1) * FLASH_TILE:, t * FLASH_TILE:(t + 1) * FLASH_TILE] = True
    return drop


def _tile_rel_l2(got, ref) -> float:
    """The largest relative L2 error of any (b, h, 64-row tile) of a
    ``[b, s, h, d]`` output: ``||got - ref|| / ||ref||`` over the tile's
    rows and head dim, so a late row's small values weigh as much as an
    early row's large ones."""
    b, s, h, d = ref.shape
    g = got.float().reshape(b, s // FLASH_TILE, FLASH_TILE, h, d)
    r = ref.float().reshape(b, s // FLASH_TILE, FLASH_TILE, h, d)
    num = (g - r).pow(2).sum((2, 4))
    den = r.pow(2).sum((2, 4)).clamp_min(1e-30)
    return float((num / den).sqrt().max())


def _flash_errs(got, ref, bf16: bool) -> dict:
    """Each output's error under its limit's metric: lse, and every
    output of a float32 run, by the largest absolute error; a bf16
    run's out, dq, dk and dv by ``_tile_rel_l2``."""
    return {n: (_tile_rel_l2 if bf16 and n != "lse" else max_err)(g, r)
            for n, g, r in zip(FLASH_OUTPUTS, got, ref)}


def _over(errs: dict, tols: dict) -> list:
    """The outputs whose error exceeds its limit."""
    return [n for n in errs if errs[n] > tols[n]]


#: kernel-check cases: (b, s, h, d, dtype, causal), s an int or (sq, sk):
#: the rung, the s2048 rung, head_dim 64 in f32 both ways and bf16, odd
#: batch x heads, head_dim 96 at the gpt-760m rung's shape (bf16) and in
#: f32, head_dim 64 at the MoE training rung's shape (bf16), head_dim 80,
#: which the wrappers run zero-padded to 96 (bf16), head_dim 256 (the
#: width of public models such as Gemma's; bf16 and f32) and 200, padded
#: to 256 (bf16); then the wgmma kernels' edges at d128: a length that is
#: a multiple of 64 but not of 128 (the last tile half past it), causal
#: and not, and cross lengths both ways
FLASH_CASES = (
    (4, 1024, 16, 128, torch.bfloat16, True),
    (2, 2048, 16, 128, torch.bfloat16, True),
    (2, 256, 4, 64, torch.float32, True),
    (2, 256, 4, 64, torch.float32, False),
    (2, 256, 4, 64, torch.bfloat16, False),
    (3, 384, 5, 128, torch.bfloat16, True),
    (3, 256, 5, 128, torch.float32, False),
    (8, 1024, 16, 96, torch.bfloat16, True),
    (2, 256, 4, 96, torch.float32, True),
    (4, 1024, 16, 64, torch.bfloat16, True),
    (2, 512, 8, 80, torch.bfloat16, True),
    (2, 512, 8, 256, torch.bfloat16, True),
    (2, 256, 4, 256, torch.float32, True),
    (2, 512, 8, 200, torch.bfloat16, True),
    (2, 320, 4, 128, torch.bfloat16, True),
    (2, 320, 4, 128, torch.bfloat16, False),
    (2, (384, 768), 4, 128, torch.bfloat16, True),
    (2, (768, 384), 4, 128, torch.bfloat16, True),
)
#: profiler names of B10's bf16 kernels at head_dim 64, 96 and 128 (d256
#: keeps flash_fwd_bf16, flash_bwd_dq_bf16 and flash_bwd_dkv_bf16)
B10_KERNELS = {"fwd": "flash_fwd_wgmma", "dq": "flash_bwd_dq_wgmma",
               "dkv": "flash_bwd_dkv_wgmma"}
#: the gpt-760m rung (bench.py LADDER[1]: d1536, 16 heads of 96, seq
#: 1024, batch 8, the _FAST options)
R760_D, R760_BATCH = 1536, 8


def _flash_times(gen, b, s, h, d) -> dict:
    """B10's three kernels timed at ``[b, s, h, d]`` (bf16, causal),
    inputs rotating over 4 layers' worth, beside the plain versions,
    scaled_dot_product_attention and the aten flash backward; one "time"
    line each. Returns the rows of the kernels line."""
    from paddle_tpu_torch.nn.functional import attention as at

    dt = torch.bfloat16
    scale = d ** -0.5
    sets = []
    for _ in range(4):
        q, k, v, do = _flash_inputs(gen, b, s, h, d, dt)
        out, lse = at.flash_attention_fwd(q, k, v, True, scale)
        sets.append((q, k, v, do, out, lse, at.flash_delta(out, do)))
    nxt = cycler(len(sets))

    def fwd():
        q, k, v = sets[nxt()][:3]
        at.flash_attention_fwd(q, k, v, True, scale)

    def dq():
        q, k, v, do, _, lse, di = sets[nxt()]
        at._flash_bwd_dq_cuda(q, k, v, do, lse, di, True, scale)

    def dkv():
        q, k, v, do, _, lse, di = sets[nxt()]
        at._flash_bwd_dkv_cuda(q, k, v, do, lse, di, True, scale)

    def bwd():
        q, k, v, do, out, lse, _ = sets[nxt()]
        at.flash_attention_bwd(q, k, v, out, lse, do, True, scale)

    def plain_fwd():
        q, k, v = sets[nxt()][:3]
        at.flash_attention_fwd_plain(q, k, v, True, scale)

    def plain_bwd():
        q, k, v, do, out, lse, _ = sets[nxt()]
        at.flash_attention_bwd_plain(q, k, v, out, lse, do, True, scale)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [tuple(t.detach().transpose(1, 2).requires_grad_(True)
                    for t in st[:3]) + (st[3].transpose(1, 2),)
              for st in sets]

    def lib_fwd():
        with torch.no_grad():
            sdpa(*leaves[nxt()][:3], is_causal=True)

    def lib_fwd_bwd():
        q, k, v, do = leaves[nxt()]
        sdpa(q, k, v, is_causal=True).backward(do)

    # the aten flash backward on its own forward's out and logsumexp: one
    # call that computes dq, dk and dv
    aten = torch.ops.aten
    saved = []
    for q, k, v, do in leaves:
        q, k, v = q.detach(), k.detach(), v.detach()
        o, lse, cq, ck, mq, mk, seed, off, _ = \
            aten._scaled_dot_product_flash_attention(q, k, v, 0.0, True,
                                                      False, scale=scale)
        saved.append((do, q, k, v, o, lse, cq, ck, mq, mk, 0.0, True, seed,
                      off))

    def lib_bwd(i=None):
        return aten._scaled_dot_product_flash_attention_backward(
            *saved[nxt() if i is None else i], scale=scale)

    bounds = _flash_bounds(b, s, s, h, d, True, dt)
    rows = {}
    times = {"fwd": time_ms(fwd), "dq": time_ms(dq), "dkv": time_ms(dkv)}
    device = {}
    for n, fn in (("fwd", fwd), ("dq", dq), ("dkv", dkv)):
        # one launch a call
        device[n] = device_ms(fn, B10_KERNELS[n], per_call=1)
    check(all(v > 0 for v in device.values()),
          f"flash_attention {[b, s, h, d]}: the profiler found no "
          f"{list(B10_KERNELS.values())} kernel time: {device}")
    plain = {"fwd": time_ms(plain_fwd, iters=5),
             "bwd": time_ms(plain_bwd, iters=5)}
    lib = {"fwd": time_ms(lib_fwd), "fwd_bwd": time_ms(lib_fwd_bwd),
           "bwd": time_ms(lib_bwd)}
    # the library backward computes the same function: its dq, dk, dv
    # against the plain version's, on the metric of the bf16 limits
    lib_grads = [g.transpose(1, 2) for g in lib_bwd(0)]
    q, k, v, do, out, lse, _ = sets[0]
    plain_grads = at.flash_attention_bwd_plain(q, k, v, out, lse, do, True,
                                               scale)
    lib_err = {n: _tile_rel_l2(g, r) for n, g, r in
               zip(("dq", "dk", "dv"), lib_grads, plain_grads)}
    whole_bwd = time_ms(bwd)

    def delta():
        _, _, _, do, out, _, _ = sets[nxt()]
        at.flash_delta(out, do)

    di_ms = time_ms(delta)
    for name in ("fwd", "dq", "dkv"):
        nbytes, flops = bounds[name]
        bms, by = bound_ms(nbytes, flops, dt)
        rows[name] = {"ms": times[name], "device_ms": device[name],
                      "plain_ms": plain["fwd" if name == "fwd" else "bwd"],
                      "library_ms": lib["fwd" if name == "fwd" else "bwd"],
                      "bound_ms": bms, "bound_by": by, "bytes": nbytes,
                      "flops": flops}
        emit({"time": f"flash_attention_{name}", "shape": [b, s, h, d],
              "causal": True, **rows[name],
              "tflops": flops / times[name] / 1e9,
              "plain_note": None if name == "fwd" else
              "flash_attention_bwd_plain computes dq, dk and dv",
              "library_note": "scaled_dot_product_attention, forward"
              if name == "fwd" else "aten._scaled_dot_product_flash_"
              "attention_backward computes dq, dk and dv"})
    nb, fl = (sum(bounds[n][i] for n in ("dq", "dkv")) for i in (0, 1))
    emit({"time": "flash_attention_backward", "shape": [b, s, h, d],
          "ms": whole_bwd, "note": "di reduction + dq + dk/dv launches",
          "di_ms": di_ms, "di_share": di_ms / whole_bwd,
          "plain_ms": plain["bwd"], "sdpa_fwd_ms": lib["fwd"],
          "sdpa_fwd_bwd_ms": lib["fwd_bwd"], "library_ms": lib["bwd"],
          "library_tile_rel_l2": lib_err,
          "bound_ms_whole_backward_5_products": bound_ms(
              7 * b * s * h * d * 2 + 2 * b * h * s * 4,
              10.0 * b * h * _flash_pairs(s, s, True) * d, dt)[0]})
    del sets, leaves, saved, lib_grads, plain_grads
    return rows


def kernel_flash_attention(gen) -> dict:
    """Kernel B10 (flash_attention_fwd and the dq and dk/dv backward
    kernels) against its plain versions on the same inputs, at
    FLASH_CASES: out, lse, dq, dk, dv. Tolerances: float32 1e-5 (out,
    lse) and 1e-4 (dq, dk, dv) absolute, f32 sums in another order; lse
    is f32 in bf16 runs too, 1e-5 absolute. A bf16 out, dq, dk or dv is
    held to its largest relative L2 error over any (b, h, 64-row tile)
    (``_tile_rel_l2``), limited by what one-ulp noise on the inputs
    moves the plain version on that metric (the witness: q, k, v and
    dout with a random half nudged one ulp) plus one relative bf16 ulp
    (2^-8). One control per kernel, in every case: the plain versions
    skipping a late key tile for the rows past it (``_late_tile_drop``)
    must exceed the forward's out limit, the dq limit, and both the dk
    and dv limits. Then timed at the rung's shape, at the gpt-760m
    rung's (head_dim 96) and at the MoE training rung's (head_dim 64)
    beside the plain versions, torch's scaled_dot_product_attention and
    the aten flash backward."""
    from paddle_tpu_torch.nn.functional import attention as at

    res = {}
    for b, s, h, d, dtype, causal in FLASH_CASES:
        sq, sk = s if isinstance(s, tuple) else (s, s)
        q, k, v, do = _flash_inputs(gen, b, sq, h, d, dtype,
                                    None if sk == sq else sk)
        scale = d ** -0.5
        bf16 = dtype == torch.bfloat16
        got = _flash_kernel_all(q, k, v, do, causal, scale)
        torch.cuda.synchronize()
        ref = _flash_plain_all(q, k, v, do, causal, scale)
        errs = _flash_errs(got, ref, bf16)
        max_abs = {n: max_err(g, r)
                   for n, g, r in zip(FLASH_OUTPUTS, got, ref)}
        line = {"check": "flash_attention", "shape": [b, s, h, d]
                if sq == sk else [b, [sq, sk], h, d],
                "dtype": str(dtype), "causal": causal,
                "metric": "tile_rel_l2" if bf16 else "max_abs_err",
                "err": errs, "max_abs_err": max_abs}
        if bf16:
            wit = _flash_errs(_flash_plain_all(
                *(_ulp_nudge(t, gen) for t in (q, k, v, do)), causal,
                scale), ref, bf16)
            tols = {n: wit[n] + 2.0 ** -8 for n in FLASH_OUTPUTS}
            tols["lse"] = 1e-5
            line["witness_err"] = wit
        else:
            tols = {"out": 1e-5, "lse": 1e-5, "dq": 1e-4, "dk": 1e-4,
                    "dv": 1e-4}
        drop = _late_tile_drop(sq, sk)
        c_out, c_lse = at.flash_attention_fwd_plain(q, k, v, causal, scale,
                                                    drop=drop)
        ctrl = _flash_errs((c_out, c_lse, *at.flash_attention_bwd_plain(
            q, k, v, *ref[:2], do, causal, scale, drop=drop)), ref, bf16)
        line.update({"tol": tols, "control_err": ctrl})
        emit(line)
        what = f"flash_attention {line['shape']} {dtype} causal={causal}"
        bad = _over(errs, tols)
        check(not bad, f"{what}: {bad} over the limits: {errs} > {tols}")
        bad = _over(ctrl, tols)
        for kern, outs in FLASH_CONTROLS.items():
            check(all(n in bad for n in outs), f"{what}: the faulty-{kern} "
                  f"control ({ctrl}) is within the limits {tols}")
        if (b, s, h, d) == (TRAIN_BATCH, TRAIN_SEQ, N_HEADS, HEAD_DIM):
            res = max_abs
        del q, k, v, do, got, ref, c_out, c_lse
    # timing at the rung's shape, at the gpt-760m rung's (head_dim 96)
    # and at the MoE training rung's (head_dim 64)
    rows = _flash_times(gen, TRAIN_BATCH, TRAIN_SEQ, N_HEADS, HEAD_DIM)
    _flash_times(gen, R760_BATCH, TRAIN_SEQ, N_HEADS, R760_D // N_HEADS)
    _flash_times(gen, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_HEADS,
                 MOE_D // MOE_HEADS)
    _flash_pad_times(gen, 80)
    _flash_pad_times(gen, 256)
    _flash_pad_times(gen, 200)
    outputs = {"fwd": ("out", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}
    names = {"fwd": "flash_attention_fwd", "dq": "flash_attention_bwd_dq",
             "dkv": "flash_attention_bwd_dkv"}
    return {names[n]: {**rows[n],
                       "max_abs_err": max(res[k] for k in outputs[n])}
            for n in names}


def _flash_pad_times(gen, d: int) -> None:
    """B10 at head_dim ``d`` (b2 s512 h8, bf16, causal) through its
    wrappers, which zero-pad a width without a kernel (80 -> 96, 200 ->
    256) and slice back, beside the same kernels on operands padded
    beforehand (the difference is the padding copies, PyTorch ops), the
    plain versions, and the library: SDPA's forward and the aten flash
    backward (dq, dk and dv in one call) at the true head_dim; the bounds
    count the true head_dim. One "time" line, ``flash_attention_d{d}``."""
    from paddle_tpu_torch.nn.functional import attention as at
    from paddle_tpu_torch.nn.functional import flash_varlen as fv

    b, s, h, dt = 2, 512, 8, torch.bfloat16
    w = fv.kernel_head_dim(d, at.FLASH_HEAD_DIMS, "flash_attention")
    scale = d ** -0.5
    q, k, v, do = _flash_inputs(gen, b, s, h, d, dt)
    qp, kp, vp, dop = (fv.pad_head(t, w).contiguous()
                       for t in (q, k, v, do))
    out, lse = at.flash_attention_fwd(q, k, v, True, scale)
    outp = fv.pad_head(out, w).contiguous()
    aten = torch.ops.aten
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_bwd = aten._scaled_dot_product_flash_attention_backward
    ql, kl, vl = (t.transpose(1, 2) for t in (q, k, v))
    o, lse_l, cq, ck, mq, mk, seed, off, _ = \
        aten._scaled_dot_product_flash_attention(ql, kl, vl, 0.0, True,
                                                  False, scale=scale)
    saved = (do.transpose(1, 2), ql, kl, vl, o, lse_l, cq, ck, mq, mk, 0.0,
             True, seed, off)
    times = {
        "fwd_ms": time_ms(lambda: at.flash_attention_fwd(q, k, v, True,
                                                         scale)),
        "fwd_kernel_ms": time_ms(lambda: at._flash_fwd_cuda(qp, kp, vp, True,
                                                            scale)),
        "bwd_ms": time_ms(lambda: at.flash_attention_bwd(
            q, k, v, out, lse, do, True, scale)),
        "bwd_kernel_ms": time_ms(lambda: at._flash_bwd_cuda(
            qp, kp, vp, outp, lse, dop, True, scale)),
        "plain_fwd_ms": time_ms(lambda: at.flash_attention_fwd_plain(
            q, k, v, True, scale), iters=5),
        "plain_bwd_ms": time_ms(lambda: at.flash_attention_bwd_plain(
            q, k, v, out, lse, do, True, scale), iters=5),
        "library_fwd_ms": time_ms(lambda: sdpa(ql, kl, vl, is_causal=True,
                                               scale=scale)),
        "library_bwd_ms": time_ms(lambda: lib_bwd(*saved, scale=scale))}
    bounds = {n: bound_ms(*_flash_bounds(b, s, s, h, d, True, dt)[n], dt)
              for n in ("fwd", "dq", "dkv")}
    emit({"time": f"flash_attention_d{d}", "shape": [b, s, h, d],
          "padded_to": w, "causal": True, **times,
          "pad_ms": times["fwd_ms"] - times["fwd_kernel_ms"]
          + times["bwd_ms"] - times["bwd_kernel_ms"],
          "bound_ms": {n: v[0] for n, v in bounds.items()},
          "bound_by": {n: v[1] for n, v in bounds.items()},
          "library_note": "scaled_dot_product_attention forward; aten."
                          "_scaled_dot_product_flash_attention_backward "
                          "computes dq, dk and dv"})
    del q, k, v, do, qp, kp, vp, dop, out, outp, saved


@contextlib.contextmanager
def attention_route(kind: str, gen=None):
    """The flash route with B10 replaced by its plain versions
    (``"plain"``); by the plain versions on inputs with a random half
    nudged one ulp in both passes (``"witness"``); or by a faulty
    forward that leaves out the division by the softmax sum, before the
    plain backward (``"control"``). ``"kernel"`` leaves the kernels in
    place."""
    from unittest import mock

    from paddle_tpu_torch.nn.functional import attention as at

    if kind == "kernel":
        yield
        return
    fwd, bwd = at.flash_attention_fwd_plain, at.flash_attention_bwd_plain
    if kind == "witness":
        def fwd(q, k, v, causal, scale):
            return at.flash_attention_fwd_plain(
                _ulp_nudge(q, gen), _ulp_nudge(k, gen), _ulp_nudge(v, gen),
                causal, scale)

        def bwd(q, k, v, out, lse, do, causal, scale):
            return at.flash_attention_bwd_plain(
                _ulp_nudge(q, gen), _ulp_nudge(k, gen), _ulp_nudge(v, gen),
                out, lse, _ulp_nudge(do, gen), causal, scale)
    elif kind == "control":
        def fwd(q, k, v, causal, scale):
            out, lse = at.flash_attention_fwd_plain(q, k, v, causal, scale)
            m = at._logits(q, k, None, causal, scale).amax(-1)
            l = torch.exp(lse - m).transpose(1, 2)[..., None]
            return (out.float() * l).to(out.dtype), lse
    with mock.patch.object(at, "flash_attention_fwd", fwd), \
            mock.patch.object(at, "flash_attention_bwd", bwd):
        yield


def _train_rung(remat="none"):
    from paddle_tpu_torch import bench

    opts = dict(bench._FAST, remat=remat)
    model, step = bench.make_train_step(D_MODEL, N_LAYERS, N_HEADS,
                                        TRAIN_SEQ, opts)
    inputs, labels = bench.rung_batch(TRAIN_BATCH, TRAIN_SEQ, "cuda")
    return model, step, inputs, labels


def _train_expected(fwd: int, bwd: int) -> dict:
    e = dict.fromkeys(_SOURCES, 0)
    e.update({"flash_attention_fwd": fwd, "flash_attention_bwd_dq": bwd,
              "flash_attention_bwd_dkv": bwd})
    return e


def slice_train(out_dir, steps: int = 5, warmup: int = 2) -> dict:
    """bench.py's gpt3-1.3b training rung through the port's entry points
    (``bench.make_train_step``: build_model, AdamW with bf16 moments and
    stochastic rounding, AMP O2 decorate, TrainStep), at full width and
    depth, from seed 0.

    (a) Agreement, each route from the same initial state and the same
    stochastic-rounding seed: the kernel route against the plain route
    (B10 replaced by its plain versions) in the step-1 logits (relative
    L2) and loss, in the gradients of every parameter (relative L2 over
    all of them, and the worst parameter), and in the losses of 3
    TrainStep steps. Each limit is twice what the witness route (one-ulp
    noise on attention's inputs) moves the plain route, the loss-based
    ones at least 4 f32 ulps; the control route (a forward without the
    softmax division) must exceed every limit.
    (b) Timing: ``warmup`` steps, then ``steps`` steps timed on the host
    clock (ended by reading the loss), then 2 steps under torch.profiler
    for the device time by kernel, and one step split by CUDA events
    into forward and loss, backward and optimizer; tokens/s, MFU (6N +
    12·L·s·d over bench.H100_PEAK_BF16), peak memory, and exactly 24
    launches of each B10 kernel a step.
    (c) 2 steps with remat="full": 48 forward launches a step, and the
    losses of the kernel route in (a) within the trajectory limit."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import bench

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    # ---- (a) agreement
    ref, agree = None, {}
    for kind in ("plain", "kernel", "witness", "control"):
        model, step, inputs, labels = _train_rung()
        _reset_counters()
        with attention_route(kind, gen):
            logits = model(*inputs)
            loss = step.loss_fn(logits, *labels)
            loss.backward()
            grads = [p.grad for p in model.parameters()]
            _check_launches(f"train_grads[{kind}]", _counters(),
                            _train_expected(*((N_LAYERS, N_LAYERS)
                                              if kind == "kernel"
                                              else (0, 0))))
            row = {"loss": float(loss.detach())}
            if ref is None:
                ref = {"logits": logits.detach(),
                       "grads": [g.clone() for g in grads]}
                ref["logits_sq"] = float(logits.float().square().sum())
                ref["grads_sq"] = sum(float(g.float().square().sum())
                                      for g in grads)
            else:
                row["logits_rel_l2"] = (float(
                    (logits.float() - ref["logits"].float()).square().sum())
                    / ref["logits_sq"]) ** 0.5
                diff_sq, worst = 0.0, (0.0, None)
                for (name, _), g, r in zip(model.named_parameters(), grads,
                                           ref["grads"]):
                    dif = g.float() - r.float()
                    diff_sq += float(dif.square().sum())
                    rel = float(dif.abs().max()) / max(
                        float(r.float().abs().max()), 1e-30)
                    if rel > worst[0]:
                        worst = (rel, name)
                row.update({"grad_rel_l2": (diff_sq / ref["grads_sq"]) ** 0.5,
                            "worst_param": worst[1],
                            "worst_param_rel_max_err": worst[0]})
            del logits, loss, grads
            step.optimizer.clear_grad()
            _reset_counters()
            row["losses"] = [float(step(inputs, labels)) for _ in range(3)]
            _check_launches(f"train_steps[{kind}]", _counters(),
                            _train_expected(*((3 * N_LAYERS, 3 * N_LAYERS)
                                              if kind == "kernel"
                                              else (0, 0))))
        agree[kind] = row
        del model, step
        torch.cuda.empty_cache()
    base = agree["plain"]
    for kind in ("kernel", "witness", "control"):
        a = agree[kind]
        a["loss_rel_err"] = abs(a["loss"] - base["loss"]) / abs(base["loss"])
        a["trajectory_rel_err"] = max(
            abs(x - y) / abs(y) for x, y in zip(a["losses"], base["losses"]))
    # twice the witness; the loss-based ones no tighter than 4 f32 ulps
    floor = 4 * 2.0 ** -23
    limits = {m: max(2 * agree["witness"][m],
                     floor if "loss" in m or "trajectory" in m else 0.0)
              for m in ("loss_rel_err", "logits_rel_l2", "grad_rel_l2",
                        "trajectory_rel_err")}
    emit({"check": "train_agreement", "limits": limits,
          "rule": "2 x the witness route's deviation (loss and trajectory "
                  "at least 4 f32 ulps)", **agree})
    for m, lim in limits.items():
        check(agree["kernel"][m] <= lim, f"train: kernel route {m} "
              f"{agree['kernel'][m]} > {lim}")
        check(agree["control"][m] > lim, f"train: the control route's {m} "
              f"({agree['control'][m]}) is within the limit {lim}")
    for kind in agree:
        check(all(np.isfinite(agree[kind]["losses"])),
              f"train: non-finite loss on the {kind} route")
    del ref
    torch.cuda.empty_cache()
    # ---- (b) timing
    torch.cuda.reset_peak_memory_stats()
    model, step, inputs, labels = _train_rung()
    n_params = sum(p.numel() for p in model.parameters())
    for _ in range(warmup):
        first = float(step(inputs, labels))
    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(inputs, labels)
    final = float(loss)
    wall = time.perf_counter() - t0
    counts = _counters()
    _check_launches("train", counts, _train_expected(steps * N_LAYERS,
                                                     steps * N_LAYERS))
    peak = torch.cuda.max_memory_allocated()
    prof_steps = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(prof_steps):
            loss = step(inputs, labels)
        float(loss)
    groups = {"flash_fwd": "B10 forward", "flash_bwd_dq": "B10 dq",
              "flash_bwd_dkv": "B10 dk/dv"}
    by_group, kernels = {}, []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / prof_steps / 1e3
        kernels.append((ev.key, ms, ev.count / prof_steps))
        lk = ev.key.lower()
        g = next((v for k, v in groups.items() if k in ev.key), None)
        if g is None:
            g = ("GEMMs (cuBLAS/CUTLASS)" if any(
                t in lk for t in ("gemm", "cutlass", "xmma", "nvjet"))
                else "other PyTorch ops (LN, GELU, CE, AdamW, copies)")
        by_group[g] = by_group.get(g, 0.0) + ms
    busy = sum(by_group.values())
    kernels.sort(key=lambda r: -r[1])
    # one more step, split on the device clock: forward and loss,
    # backward, optimizer
    opt = step.optimizer
    opt.clear_grad()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    loss = step.loss_fn(model(*inputs), *labels)
    ev[1].record()
    loss.backward()
    ev[2].record()
    opt.step()
    ev[3].record()
    opt.clear_grad()
    torch.cuda.synchronize()
    split = {name: ev[i].elapsed_time(ev[i + 1]) for i, name in
             enumerate(("forward_and_loss", "backward", "optimizer"))}
    del loss
    wall_ms = wall / steps * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    fpt = bench.flops_per_token(n_params, N_LAYERS, TRAIN_SEQ, D_MODEL)
    tps = tokens * steps / wall
    result = {"phase": "train", "rung": "gpt3-1.3b", "n_params": n_params,
              "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": steps,
              "warmup": warmup, "tokens_per_s": tps,
              "mfu": tps * fpt / bench.H100_PEAK_BF16,
              "flops_per_token": fpt, "wall_ms_per_step": wall_ms,
              "device_busy_ms_per_step": busy,
              "device_idle_share": 1 - busy / wall_ms,
              "device_ms_per_step_by_group": by_group,
              "ms_by_phase_one_step": split,
              "max_memory_allocated_gb": peak / 1e9,
              "first_call_s": step.first_call_seconds,
              "launches_per_step": {k: v / steps for k, v in counts.items()
                                    if v},
              "loss_after_warmup": first, "loss_final": final,
              "top_kernels": [{"name": k[:60], "ms_per_step": ms,
                               "launches_per_step": n}
                              for k, ms, n in kernels[:8]]}
    emit(result)
    check(np.isfinite(final), "train: non-finite loss")
    if out_dir:
        with open(os.path.join(out_dir, "profile_train.txt"), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40))
    del model, step, prof
    torch.cuda.empty_cache()
    # ---- (c) recompute
    model, step, inputs, labels = _train_rung(remat="full")
    _reset_counters()
    remat_losses = [float(step(inputs, labels)) for _ in range(2)]
    _check_launches("train_remat_full", _counters(),
                    _train_expected(2 * 2 * N_LAYERS, 2 * N_LAYERS))
    ref = agree["kernel"]["losses"][:2]
    rel = max(abs(x - y) / abs(y) for x, y in zip(remat_losses, ref))
    emit({"phase": "train_remat_full", "losses": remat_losses,
          "remat_none_losses": ref, "rel_err": rel,
          "step1_loss_bitwise_equal": remat_losses[0] == ref[0],
          "fwd_launches_per_step": 2 * N_LAYERS})
    check(rel <= limits["trajectory_rel_err"], "train: remat='full' moved "
          f"the losses by {rel} > {limits['trajectory_rel_err']}")
    del model, step
    torch.cuda.empty_cache()
    emit({"phase": "train_paths", "wall_s": time.perf_counter() - t_phase})
    return counts


# ---------------------------------------------------------------- varlen

#: the --attn-varlen rung (bench.py run_attn_varlen_bench): 16 heads of
#: 128, bf16, 8 causal segments of 4096
VARLEN_LENS = [4096] * 8


def _ragged_lens(total: int, seed: int) -> list:
    """A pretraining pack: document lengths from a seeded generator,
    log-uniform between 1 and 4096 (many short documents, a few long
    ones), the last one cut so that they sum to ``total``."""
    rng = np.random.RandomState(seed)
    lens = []
    while sum(lens) < total:
        n = int(np.exp(rng.uniform(0.0, np.log(4096.0))))
        lens.append(min(max(n, 1), total - sum(lens)))
    return lens


#: kernel-check cases: (name, q lengths, k lengths or None, h, d, dtype,
#: causal): the rung; a ragged pack; totals off the 64-row tile; cross
#: lengths with an empty k segment; non-causal; f32 at d64; bf16 at d96;
#: bf16 at d40, which the wrappers run zero-padded to 64; bf16 and f32 at
#: d256
VARLEN_CASES = (
    ("rung", VARLEN_LENS, None, 16, 128, torch.bfloat16, True),
    ("ragged", _ragged_lens(32768, 11), None, 16, 128, torch.bfloat16, True),
    ("off_tile", [1000, 37, 2500, 77], None, 8, 128, torch.bfloat16, True),
    ("cross_empty", [700, 300, 1000], [500, 0, 1200], 8, 128,
     torch.bfloat16, True),
    ("non_causal", [1024, 512, 2048, 512], None, 8, 128, torch.bfloat16,
     False),
    ("f32_d64", [300, 700, 24], None, 4, 64, torch.float32, True),
    ("bf16_d96", [1536, 512, 1000], None, 16, 96, torch.bfloat16, True),
    ("bf16_d40", [1536, 512, 1000], None, 16, 40, torch.bfloat16, True),
    ("bf16_d256", [700, 300, 1000], None, 8, 256, torch.bfloat16, True),
    ("f32_d256", [300, 200], None, 2, 256, torch.float32, True),
)
VARLEN_OUTPUTS = ("out", "lse", "dq", "dk", "dv")
#: each kernel's faulty-kernel control and the outputs it must push out
VARLEN_CONTROLS = {"fwd": ("out",), "dq": ("dq",), "dkv": ("dk", "dv")}
#: the kernels' names in the kernels line and the launch counts
VARLEN_NAMES = {"fwd": "flash_varlen_fwd", "dq": "flash_varlen_bwd_dq",
                "dkv": "flash_varlen_bwd_dkv"}


def _cu(lens) -> torch.Tensor:
    return torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                        dtype=torch.int32, device="cuda")


def _varlen_pairs(lq, lk, causal: bool) -> int:
    """Visible (query, key) pairs of one head: within a segment, key j
    from query i iff j <= i under causal (top left)."""
    if not causal:
        return sum(a * b for a, b in zip(lq, lk))
    return sum(b * (b + 1) // 2 + (a - b) * b if a >= b else a * (a + 1) // 2
               for a, b in zip(lq, lk))


def _unpartnered(lq, lk, causal: bool):
    """Boolean masks of the queries that see no key and of the keys that
    no query sees (an empty segment on the other side; under causal,
    keys at in-segment positions past the segment's last query)."""
    rows = torch.zeros(sum(lq), dtype=torch.bool, device="cuda")
    keys = torch.zeros(sum(lk), dtype=torch.bool, device="cuda")
    for i, (a, b) in enumerate(zip(lq, lk)):
        q0, k0 = sum(lq[:i]), sum(lk[:i])
        if b == 0:
            rows[q0:q0 + a] = True
        seen = min(a, b) if causal else (b if a else 0)
        keys[k0 + seen:k0 + b] = True
    return rows, keys


def _varlen_inputs(gen, tq, tk, h, d, dtype):
    mk = lambda t: torch.randn(t, h, d, generator=gen,  # noqa: E731
                               device="cuda").to(dtype)
    return mk(tq), mk(tk), mk(tk), mk(tq)


def _drop_first_tile(bm, which: str):
    """The map a faulty kernel would walk: for the second half of the q
    tiles (``fwd``, ``dq``) or of the k tiles (``dkv``), the first tile of
    a walk of two or more is skipped."""
    import dataclasses

    start, length = ("qstart2", "qlen2") if which == "dkv" else \
        ("kstart", "klen")
    s, n = getattr(bm, start), getattr(bm, length)
    late = torch.arange(n.shape[0], device=n.device) >= n.shape[0] // 2
    cut = (late & (n >= 2)).to(n.dtype)
    return dataclasses.replace(bm, **{start: s + cut, length: n - cut})


def _varlen_plain_all(q, k, v, do, cq, ck, causal, scale, fault=None):
    """out, lse and dq, dk, dv by the plain versions (the JAX XLA tile
    walks at the default 128 tiles), with ``fault`` (a key of
    VARLEN_CONTROLS) walking ``_drop_first_tile``'s map in that
    kernel's walk."""
    from paddle_tpu_torch.nn.functional import flash_varlen as fv

    tq, tk = q.shape[0], k.shape[0]
    bq = bk = fv.DEFAULT_BLOCK_Q
    qt, kt, vt, bm = fv._packed_prepare(q, k, v, cq, ck, causal, bq, bk)
    bad = bm if fault is None else _drop_first_tile(bm, fault)
    out, lse = fv._packed_fwd_plain(qt, kt, vt, bad if fault == "fwd"
                                    else bm, scale, causal, bq, bk)
    tqp = qt.shape[1]
    outp = out[:, :tq].transpose(0, 1).to(q.dtype)
    dq, dk, dv = fv._packed_bwd_plain(
        qt, kt, vt, fv._pad_rows(do.transpose(0, 1), tqp), lse,
        fv.packed_delta(outp, do, tqp), bad if fault in ("dq", "dkv")
        else bm, scale, causal, bq, bk)
    return (outp, lse[:, :tq], dq[:, :tq].transpose(0, 1).to(q.dtype),
            dk[:, :tk].transpose(0, 1).to(k.dtype),
            dv[:, :tk].transpose(0, 1).to(v.dtype))


def _varlen_kernel_all(q, k, v, do, cq, ck, causal, scale):
    from paddle_tpu_torch.nn.functional import flash_varlen as fv

    out, lse = fv.packed_fwd(q, k, v, cq, ck, scale=scale, causal=causal)
    return (out, lse[:, :q.shape[0]],
            *fv.packed_bwd(q, k, v, out, lse, do, cq, ck, scale=scale,
                           causal=causal))


def _packed_tile_rel_l2(got, ref) -> float:
    """``_tile_rel_l2`` of a packed ``[t, h, d]`` output: 64-row tiles,
    the last one zero-padded."""
    pad = -got.shape[0] % FLASH_TILE

    def tiles(t):
        t = torch.cat([t.float(), t.new_zeros(pad, *t.shape[1:]).float()])
        return t[None]
    return _tile_rel_l2(tiles(got), tiles(ref))


def _varlen_errs(got, ref, bf16: bool) -> dict:
    """lse (real rows) and every f32 output by the largest absolute
    error; a bf16 out, dq, dk, dv by ``_packed_tile_rel_l2``."""
    return {n: (_packed_tile_rel_l2 if bf16 and n != "lse" else max_err)(
        g, r) for n, g, r in zip(VARLEN_OUTPUTS, got, ref)}


def _varlen_bounds(tq, tk, h, d, pairs, dtype) -> dict:
    """Bytes (each input read once, each output written once) and
    operations of each kernel's function over this run's visible pairs:
    B11 QK^T and PV; B12 S, dP and dS K; B13 S, dP, P^T dO and dS^T Q."""
    e = torch.tensor([], dtype=dtype).element_size()
    n = h * pairs * d
    q_io, k_io, stats = tq * h * d * e, tk * h * d * e, h * tq * 4
    return {
        "fwd": (2 * q_io + 2 * k_io + stats, 4.0 * n),
        "dq": (3 * q_io + 2 * k_io + 2 * stats, 6.0 * n),
        "dkv": (2 * q_io + 4 * k_io + 2 * stats, 8.0 * n)}


def kernel_flash_varlen(gen) -> dict:
    """Kernels B11-B13 (packed varlen forward, dq, dk/dv) against their
    plain versions (the JAX XLA tile walks) on the same inputs, at
    VARLEN_CASES: out, lse, dq, dk, dv. Limits as for B10: a bf16 out,
    dq, dk or dv by its largest relative L2 error over any (64-row tile,
    head), limited by the one-ulp witness on that metric plus 2^-8; lse
    (real rows) 1e-5 absolute; float32 1e-5 (out) and 1e-4 (dq, dk, dv)
    absolute. Rows that see no key must be exactly 0 with lse -1e30, and
    their dq rows 0; keys that no row sees get dk and dv exactly 0. A
    second call of the kernels must give bitwise the same outputs (one
    owner a tile, no atomics). One control per kernel, in every case:
    the plain walk over the map with the first tile of the late walks
    dropped (``_drop_first_tile``) must exceed the out, dq, and dk and dv
    limits. Then timed at the rung beside the plain versions and the aten
    varlen flash forward and backward (``_flash_attention_forward``/
    ``_backward`` with cum_seq)."""
    from paddle_tpu_torch.nn.functional import flash_varlen as fv

    res = {}
    for name, lq, lk, h, d, dtype, causal in VARLEN_CASES:
        lk = lk or lq
        cq, ck = _cu(lq), _cu(lk)
        q, k, v, do = _varlen_inputs(gen, sum(lq), sum(lk), h, d, dtype)
        scale = d ** -0.5
        bf16 = dtype == torch.bfloat16
        got = _varlen_kernel_all(q, k, v, do, cq, ck, causal, scale)
        again = _varlen_kernel_all(q, k, v, do, cq, ck, causal, scale)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        ref = _varlen_plain_all(q, k, v, do, cq, ck, causal, scale)
        errs = _varlen_errs(got, ref, bf16)
        max_abs = {n: max_err(g, r)
                   for n, g, r in zip(VARLEN_OUTPUTS, got, ref)}
        line = {"check": "flash_varlen", "case": name, "h": h, "d": d,
                "tq": sum(lq), "tk": sum(lk), "segments": len(lq),
                "dtype": str(dtype), "causal": causal,
                "metric": "tile_rel_l2" if bf16 else "max_abs_err",
                "err": errs, "max_abs_err": max_abs,
                "second_call_bitwise": bitwise}
        if bf16:
            wit = _varlen_errs(_varlen_plain_all(
                *(_ulp_nudge(t, gen) for t in (q, k, v, do)), cq, ck,
                causal, scale), ref, bf16)
            tols = {n: wit[n] + 2.0 ** -8 for n in VARLEN_OUTPUTS}
            tols["lse"] = 1e-5
            line["witness_err"] = wit
        else:
            tols = {"out": 1e-5, "lse": 1e-5, "dq": 1e-4, "dk": 1e-4,
                    "dv": 1e-4}
        ctrl = {}
        for kern, outs in VARLEN_CONTROLS.items():
            bad = _varlen_errs(_varlen_plain_all(
                q, k, v, do, cq, ck, causal, scale, fault=kern), ref, bf16)
            ctrl.update({n: bad[n] for n in outs})
        line.update({"tol": tols, "control_err": ctrl})
        what = f"flash_varlen {name}"
        rows, keys = _unpartnered(lq, lk, causal)
        if bool(rows.any()):
            empty_ok = bool((got[0][rows] == 0).all()) and bool(
                (got[1][:, rows] == -1e30).all()) and bool(
                (got[2][rows] == 0).all())
            line["empty_rows_exact"] = empty_ok
            check(empty_ok, f"{what}: rows that see no key are not exactly "
                  "0 with lse -1e30 and dq 0")
        if bool(keys.any()):
            keys_ok = bool((got[3][keys] == 0).all()) and bool(
                (got[4][keys] == 0).all())
            line["unseen_keys_exact"] = keys_ok
            check(keys_ok, f"{what}: keys that no row sees do not get dk "
                  "and dv exactly 0")
        emit(line)
        check(bitwise, f"{what}: a second call is not bitwise equal")
        bad = _over(errs, tols)
        check(not bad, f"{what}: {bad} over the limits: {errs} > {tols}")
        for kern, outs in VARLEN_CONTROLS.items():
            check(all(ctrl[n] > tols[n] for n in outs), f"{what}: the "
                  f"faulty-{kern} control ({ctrl}) is within {tols}")
        if name == "rung":
            res = max_abs
        del q, k, v, do, got, ref
    torch.cuda.empty_cache()
    for d in (40, 96, 256):
        _varlen_pad_times(gen, d)
    return _varlen_times(gen, res)


def _varlen_pad_times(gen, d: int) -> None:
    """B11-B13 at head_dim ``d`` on the [1536, 512, 1000] pack (h16,
    bf16, causal) through their wrappers, which zero-pad a width without
    a kernel (40 -> 64; 96 and 256 are built) and slice back, beside the
    same kernels on operands padded beforehand, the plain versions and
    the aten varlen flash forward and backward at the true head_dim; the
    bounds count the true head_dim. One "time" line,
    ``flash_varlen_d{d}``."""
    from paddle_tpu_torch.nn.functional import flash_varlen as fv

    lens, h, dt = [1536, 512, 1000], 16, torch.bfloat16
    w = fv.kernel_head_dim(d, fv.VARLEN_HEAD_DIMS, "flash_varlen_packed")
    T, scale, cu = sum(lens), d ** -0.5, _cu(lens)
    q, k, v, do = _varlen_inputs(gen, T, T, h, d, dt)
    qp, kp, vp, dop = (fv.pad_head(t, w).contiguous()
                       for t in (q, k, v, do))
    out, lse = fv.packed_fwd(q, k, v, cu, cu, scale=scale, causal=True)
    outp = fv.pad_head(out, w).contiguous()
    times = {
        "fwd_ms": time_ms(lambda: fv.packed_fwd(q, k, v, cu, cu,
                                                scale=scale, causal=True)),
        "fwd_kernel_ms": time_ms(lambda: fv._varlen_fwd_cuda(
            qp, kp, vp, cu, cu, True, scale)),
        "bwd_ms": time_ms(lambda: fv.packed_bwd(
            q, k, v, out, lse, do, cu, cu, scale=scale, causal=True)),
        "bwd_kernel_ms": time_ms(lambda: fv._varlen_bwd_cuda(
            qp, kp, vp, outp, lse, dop, cu, cu, True, scale)),
        "plain_fwd_ms": time_ms(lambda: fv.packed_fwd_plain(
            q, k, v, cu, cu, scale=scale, causal=True), iters=3, warmup=1),
        "plain_bwd_ms": time_ms(lambda: fv.packed_bwd_plain(
            q, k, v, out, lse, do, cu, cu, scale=scale, causal=True),
            iters=3, warmup=1)}
    # the calls above are host-bound (the block map is built per call):
    # the kernels' own device time, by the profiler
    times["fwd_device_ms"] = device_ms(lambda: fv._varlen_fwd_cuda(
        qp, kp, vp, cu, cu, True, scale), "varlen_fwd")
    times["bwd_device_ms"] = device_ms(lambda: fv._varlen_bwd_cuda(
        qp, kp, vp, outp, lse, dop, cu, cu, True, scale), "varlen_bwd")
    lib, lib_err, why = _aten_varlen_times([(q, k, v, do, out)], cu,
                                           max(lens), scale)
    bounds = {n: bound_ms(*v, dt) for n, v in _varlen_bounds(
        T, T, h, d, _varlen_pairs(lens, lens, True), dt).items()}
    emit({"time": f"flash_varlen_d{d}", "h": h, "d": d, "padded_to": w,
          "tq": T, "segments": len(lens), "causal": True, **times,
          "library_fwd_ms": lib["fwd"], "library_bwd_ms": lib["bwd"],
          "library_out_tile_rel_l2": lib_err, "library_note": why or
          "aten._flash_attention_forward/_backward (cum_seq); the backward "
          "computes dq, dk and dv",
          "pad_ms": times["fwd_ms"] - times["fwd_kernel_ms"]
          + times["bwd_ms"] - times["bwd_kernel_ms"],
          "bound_ms": {n: v[0] for n, v in bounds.items()},
          "bound_by": {n: v[1] for n, v in bounds.items()}})
    del q, k, v, do, qp, kp, vp, dop, out, outp


def _aten_varlen_times(sets, cu, cmax: int, scale: float):
    """The library yardstick: ``aten._flash_attention_forward`` and
    ``_backward`` with ``cum_seq_q/k`` (the one PyTorch call computing
    packed varlen attention; the backward gives dq, dk and dv at once),
    timed on ``sets`` (causal). Returns ``({"fwd": ms, "bwd": ms}, its
    out's tile relative L2 error against the first set's out, None)``,
    or ``({"fwd": None, "bwd": None}, None, reason)`` when this torch
    build cannot run it."""
    aten = torch.ops.aten
    nxt = cycler(len(sets))
    try:
        saved = []
        for q, k, v, do, *_ in sets:
            o, lse, seed, offset, _ = aten._flash_attention_forward(
                q, k, v, cu, cu, cmax, cmax, 0.0, True, False, scale=scale)
            saved.append((do, q, k, v, o, lse, cu, cu, cmax, cmax, 0.0,
                          True, seed, offset))
        err = _packed_tile_rel_l2(saved[0][4], sets[0][4])

        def fwd():
            q, k, v = sets[nxt()][:3]
            aten._flash_attention_forward(q, k, v, cu, cu, cmax, cmax, 0.0,
                                          True, False, scale=scale)

        def bwd():
            aten._flash_attention_backward(*saved[nxt()], scale=scale)
        return {"fwd": time_ms(fwd), "bwd": time_ms(bwd)}, err, None
    except Exception as exc:  # noqa: BLE001  (the yardstick is optional)
        return ({"fwd": None, "bwd": None}, None,
                f"{type(exc).__name__}: {str(exc)[:300]}")


def _varlen_times(gen, res: dict) -> dict:
    """B11-B13 timed at the rung (CUDA events over 20 calls after 3
    warm-ups, inputs rotating over 4 sets) and by the profiler, beside the
    plain versions and the aten varlen flash forward and backward; then
    one ``flash_attn_unpadded`` forward + backward through autograd (one
    block map for the three launches) beside aten's forward + backward."""
    from paddle_tpu_torch.nn.functional import attention as at
    from paddle_tpu_torch.nn.functional import flash_varlen as fv

    lens, h, d, dt = VARLEN_LENS, 16, 128, torch.bfloat16
    T, scale = sum(lens), d ** -0.5
    cu = _cu(lens)
    sets = []
    for _ in range(4):
        q, k, v, do = _varlen_inputs(gen, T, T, h, d, dt)
        out, lse = fv.packed_fwd(q, k, v, cu, cu, scale=scale, causal=True)
        sets.append((q, k, v, do, out, lse,
                     fv.packed_delta(out, do, lse.shape[1])))
    nxt = cycler(len(sets))

    def fwd():
        q, k, v = sets[nxt()][:3]
        fv._varlen_fwd_cuda(q, k, v, cu, cu, True, scale)

    def dq():
        q, k, v, do, _, lse, delta = sets[nxt()]
        fv._varlen_bwd_dq_cuda(q, k, v, do, lse, delta, cu, cu, True, scale)

    def dkv():
        q, k, v, do, _, lse, delta = sets[nxt()]
        fv._varlen_bwd_dkv_cuda(q, k, v, do, lse, delta, cu, cu, True, scale)

    def plain_fwd():
        q, k, v = sets[nxt()][:3]
        fv.packed_fwd_plain(q, k, v, cu, cu, scale=scale, causal=True)

    def plain_bwd():
        q, k, v, do, out, lse, _ = sets[nxt()]
        fv.packed_bwd_plain(q, k, v, out, lse, do, cu, cu, scale=scale,
                            causal=True)

    times = {"fwd": time_ms(fwd), "dq": time_ms(dq), "dkv": time_ms(dkv)}
    device = {"fwd": device_ms(fwd, B11_KERNEL),
              "dq": device_ms(dq, B12_KERNEL),
              "dkv": device_ms(dkv, B13_KERNEL)}
    plain = {"fwd": time_ms(plain_fwd, iters=3, warmup=1),
             "bwd": time_ms(plain_bwd, iters=3, warmup=1)}
    lib, lib_err, why = _aten_varlen_times(sets, cu, max(lens), scale)
    bounds = _varlen_bounds(T, T, h, d, _varlen_pairs(lens, lens, True), dt)
    rows = {}
    for name in ("fwd", "dq", "dkv"):
        nbytes, flops = bounds[name]
        bms, by = bound_ms(nbytes, flops, dt)
        pass_ = "fwd" if name == "fwd" else "bwd"
        rows[name] = {"ms": times[name], "device_ms": device[name],
                      "plain_ms": plain[pass_], "library_ms": lib[pass_],
                      "bound_ms": bms, "bound_by": by, "bytes": nbytes,
                      "flops": flops}
        note = why if lib[pass_] is None else (
            "aten._flash_attention_forward (cum_seq)" if name == "fwd" else
            "aten._flash_attention_backward (cum_seq) computes dq, dk, dv")
        emit({"time": VARLEN_NAMES[name], "h": h, "d": d, "tq": T,
              "segments": len(lens), "causal": True, **rows[name],
              "tflops": flops / times[name] / 1e9,
              "plain_note": None if name == "fwd" else
              "packed_bwd_plain computes dq, dk and dv",
              "library_note": note,
              "library_out_tile_rel_l2": lib_err})

    def train():
        q, k, v, do = sets[nxt()][:4]
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out, _ = at.flash_attn_unpadded(*leaves, cu, cu, max(lens),
                                        max(lens), scale, causal=True)
        out.backward(do)

    both = None if lib["fwd"] is None else lib["fwd"] + lib["bwd"]
    emit({"time": "flash_attn_unpadded_train", "h": h, "d": d, "tq": T,
          "segments": len(lens), "causal": True, "ms": time_ms(train),
          "kernels_device_ms": device_ms(
              train, (B11_KERNEL, B12_KERNEL, B13_KERNEL)),
          "device_ms": device_ms(train, ""),
          "kernels_bound_ms": sum(r["bound_ms"] for r in rows.values()),
          "library_ms": both, "library_note": why if both is None else
          "aten._flash_attention_forward + _backward (cum_seq), apart",
          "note": "autograd forward + backward: the block map once, "
          "delta, B11, B12, B13; device_ms counts every kernel"})
    del sets
    torch.cuda.empty_cache()
    outputs = {"fwd": ("out", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}
    return {VARLEN_NAMES[n]: {**rows[n], "max_abs_err": max(
        res[k] for k in outputs[n])} for n in outputs}


def _varlen_expected(fwd: int, bwd: int) -> dict:
    e = dict.fromkeys(_SOURCES, 0)
    e.update({"flash_varlen_fwd": fwd, "flash_varlen_bwd_dq": bwd,
              "flash_varlen_bwd_dkv": bwd})
    return e


def slice_attn_varlen(gen) -> dict:
    """The packed varlen path through the port's entry points, launch
    counts set to 0 before each run and read after it:
    (a) bench.run_attn_varlen_bench() at the rung (one warm-up and 20
    timed forward calls: exactly 21 B11 launches and none of B12/B13),
    its tokens/s and peak memory, which must stay O(T·d);
    (b) one training-shaped call of flash_attn_unpadded on the ragged
    pack (q, k, v requiring grad, then backward(dout)): exactly one launch
    of each of B11, B12, B13, and out, dq, dk, dv within the witness
    limits of the plain route (the plain functions on the same inputs)."""
    from paddle_tpu_torch import bench
    from paddle_tpu_torch.nn.functional import attention as at

    t_phase = time.perf_counter()
    _reset_counters()
    tps, peak, total, backend = bench.run_attn_varlen_bench()
    counts = _counters()
    _check_launches("attn_varlen_bench", counts, _varlen_expected(21, 0))
    q_bytes = total * 16 * 128 * 2
    emit({"phase": "attn_varlen_bench", "tokens_per_s": tps,
          "peak_bytes": peak, "total_tokens": total, "backend": backend,
          "peak_over_q_bytes": peak / q_bytes,
          "dense_logits_bytes": 16 * total * total * 4,
          "launches": {k: v for k, v in counts.items() if v}})
    check(backend == "cuda", "attn_varlen_bench: not on the kernel route")
    check(peak < 8 * q_bytes, f"attn_varlen_bench: peak {peak} bytes is not "
          f"O(T·d) (q is {q_bytes})")
    # (b) a training-shaped call on the ragged pack
    lens = VARLEN_CASES[1][1]
    h, d, dt = 16, 128, torch.bfloat16
    cu, scale = _cu(lens), d ** -0.5
    q, k, v, do = _varlen_inputs(gen, sum(lens), sum(lens), h, d, dt)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    _reset_counters()
    out, none = at.flash_attn_unpadded(*leaves, cu, cu, max(lens), max(lens),
                                       scale, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    train_counts = _counters()
    _check_launches("attn_varlen_train", train_counts, _varlen_expected(1, 1))
    got = (out.detach(), None, *(t.grad for t in leaves))
    ref = _varlen_plain_all(q, k, v, do, cu, cu, True, scale)
    wit = _varlen_plain_all(*(_ulp_nudge(t, gen) for t in (q, k, v, do)), cu,
                            cu, True, scale)
    names = ("out", "dq", "dk", "dv")
    errs = {n: _packed_tile_rel_l2(got[i], ref[i])
            for n, i in zip(names, (0, 2, 3, 4))}
    tols = {n: _packed_tile_rel_l2(wit[i], ref[i]) + 2.0 ** -8
            for n, i in zip(names, (0, 2, 3, 4))}
    emit({"check": "attn_varlen_train", "segments": len(lens),
          "tq": sum(lens), "returns_none": none is None, "err": errs,
          "tol": tols, "launches": {k: v for k, v in train_counts.items()
                                    if v}})
    check(none is None, "flash_attn_unpadded: the second result is not None")
    bad = _over(errs, tols)
    check(not bad, f"attn_varlen_train: {bad} over the limits {errs} > "
          f"{tols}")
    del q, k, v, do, leaves, out, got, ref, wit
    torch.cuda.empty_cache()
    emit({"phase": "attn_varlen_paths", "wall_s": time.perf_counter() -
          t_phase})
    return {n: counts[n] + train_counts[n] for n in counts}


def slice_train_760m(steps: int = 3, warmup: int = 1) -> dict:
    """bench.py's gpt-760m rung (d1536, 24 layers, 16 heads of 96, seq
    1024, batch 8, the _FAST options) through the port's
    bench.make_train_step, from seed 0: ``warmup`` steps, then ``steps``
    steps timed on the host clock (ended by reading the loss), exactly 24
    launches of each B10 kernel a step (head_dim 96), tokens/s, MFU, peak
    memory and a finite final loss. The d96 kernel checks of
    kernel_flash_attention carry the correctness."""
    from paddle_tpu_torch import bench

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, step = bench.make_train_step(R760_D, N_LAYERS, N_HEADS, TRAIN_SEQ,
                                        dict(bench._FAST))
    inputs, labels = bench.rung_batch(R760_BATCH, TRAIN_SEQ, "cuda")
    n_params = sum(p.numel() for p in model.parameters())
    for _ in range(warmup):
        first = float(step(inputs, labels))
    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(inputs, labels)
    final = float(loss)
    wall = time.perf_counter() - t0
    counts = _counters()
    _check_launches("train_760m", counts,
                    _train_expected(steps * N_LAYERS, steps * N_LAYERS))
    tokens = R760_BATCH * TRAIN_SEQ
    tps = tokens * steps / wall
    fpt = bench.flops_per_token(n_params, N_LAYERS, TRAIN_SEQ, R760_D)
    emit({"phase": "train_760m", "rung": "gpt-760m", "n_params": n_params,
          "batch": R760_BATCH, "seq": TRAIN_SEQ, "head_dim":
          R760_D // N_HEADS, "steps": steps, "warmup": warmup,
          "tokens_per_s": tps, "mfu": tps * fpt / bench.H100_PEAK_BF16,
          "flops_per_token": fpt, "wall_ms_per_step": wall / steps * 1e3,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "first_call_s": step.first_call_seconds,
          "launches_per_step": {k: v / steps for k, v in counts.items()
                                if v},
          "loss_after_warmup": first, "loss_final": final,
          "wall_s": time.perf_counter() - t_phase})
    check(np.isfinite(final), "train_760m: non-finite loss")
    del model, step
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- moe train

@contextlib.contextmanager
def moe_train_route(kind: str, gen=None):
    """The MoE training step with its kernels in place (``"kernel"``);
    with B14, B15 and B10 replaced by their plain versions
    (``"plain"``); or by the plain versions fed the bf16-rounded dz that
    the kernels multiply (the TPU's DEFAULT precision), with one-ulp
    noise on attention's inputs (``"witness"``, see attention_route)."""
    from unittest import mock

    from paddle_tpu_torch.nn.functional import grouped_gemm as gg

    if kind == "kernel":
        yield
        return
    dx, dw = gg._dx, gg._dw

    def witness_dx(dz, w, off, dtype, route):
        return dx(dz.to(w.dtype).to(dz.dtype), w, off, dtype, route)

    def witness_dw(x, dz, off, E, dtype, route):
        return dw(x, dz.to(x.dtype).to(dz.dtype), off, E, dtype, route)
    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(
            gg, "resolve_backend", lambda *a: "plain"))
        if kind == "witness":
            stack.enter_context(mock.patch.object(gg, "_dx", witness_dx))
            stack.enter_context(mock.patch.object(gg, "_dw", witness_dw))
        stack.enter_context(attention_route(kind, gen))
        yield


@contextlib.contextmanager
def _record_routes(into: list, layers: int):
    """Each MoE layer's top-k experts of the next forward (the first
    ``layers`` calls), kept on the device."""
    from unittest import mock

    from paddle_tpu_torch.incubate.moe import moe_layer as ml

    real = ml.moe_ffn_nodrop

    def recording(*a, **k):
        res = real(*a, **k)
        if len(into) < layers:
            into.append(res[2].detach())
        return res
    with mock.patch.object(ml, "moe_ffn_nodrop", recording):
        yield


def _route_agreement(a, b) -> float:
    """The share of tokens whose top-k expert sets agree."""
    return float((a.sort(-1).values == b.sort(-1).values).all(-1)
                 .float().mean())


def _moe_expected(steps: int) -> dict:
    """Launches of ``steps`` MoE training steps: per layer B14 twice
    forward (FFN1 with GELU, FFN2), once for FFN1's pre-activation and
    twice for dx; B15 twice (dw1, dw2); B10 once each."""
    e = dict.fromkeys(_SOURCES, 0)
    L = MOE_LAYERS * steps
    e.update({"grouped_gemm": 5 * L, "grouped_dw": 2 * L,
              "flash_attention_fwd": L, "flash_attention_bwd_dq": L,
              "flash_attention_bwd_dkv": L})
    return e


def _rel_l2(got, ref) -> float:
    num = float((got.float() - ref.float()).square().sum())
    return (num / max(float(ref.float().square().sum()), 1e-30)) ** 0.5


def _moe_block_check(gen) -> None:
    """One full-width MoE layer (d1024, 8 experts, top-2, d_hidden 4096,
    bf16 as under O2) over T = 4096 tokens, forward and backward, on the
    kernel route against the plain route from the same weights, input
    and cotangent: the routes must be identical (the router is plain
    torch on both), the output, dx and every parameter gradient within
    twice the witness route's relative L2 deviation plus 2^-8 (one
    relative bf16 ulp), with exactly 5 B14 and 2 B15 launches."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.amp import decorate
    from paddle_tpu_torch.incubate.moe import MoELayer

    seed(11)
    layer = decorate(MoELayer(MOE_D, num_experts=MOE_E, gate="gshard",
                              top_k=MOE_TOPK, d_hidden=MOE_DFF,
                              capacity_factor=None, device="cuda"),
                     level="O2", dtype="bfloat16")
    shape = (MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_D)
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    res = {}
    for kind in ("plain", "kernel", "witness"):
        routes = []
        xi = x.clone().requires_grad_()
        layer.zero_grad(set_to_none=True)
        _reset_counters()
        with moe_train_route(kind, gen), _record_routes(routes, 1):
            y = layer(xi)
            y.backward(g)
        torch.cuda.synchronize()
        counts = _counters()
        want = dict.fromkeys(_SOURCES, 0)
        if kind == "kernel":
            want.update({"grouped_gemm": 5, "grouped_dw": 2})
        _check_launches(f"moe_block[{kind}]", counts, want)
        res[kind] = {"y": y.detach(), "dx": xi.grad, "routes": routes[0],
                     **{n: p.grad for n, p in layer.named_parameters()}}
    names = [n for n in res["plain"] if n != "routes"]
    errs = {k: {n: _rel_l2(res[k][n], res["plain"][n]) for n in names}
            for k in ("kernel", "witness")}
    tols = {n: 2 * errs["witness"][n] + 2.0 ** -8 for n in names}
    same = torch.equal(res["kernel"]["routes"], res["plain"]["routes"])
    emit({"check": "moe_block", "tokens": MOE_TRAIN_BATCH * MOE_TRAIN_SEQ,
          "experts": MOE_E, "metric": "relative L2 vs the plain route",
          "routes_identical": same, "err": errs["kernel"],
          "witness_err": errs["witness"], "tol": tols})
    check(same, "moe_block: the kernel route routed differently")
    bad = [n for n in names if errs["kernel"][n] > tols[n]]
    check(not bad, f"moe_block: {bad} over the limits: {errs['kernel']} "
                   f"> {tols}")
    del layer, res, x, g
    torch.cuda.empty_cache()


def slice_train_moe(out_dir, gen, steps: int = MOE_TRAIN_STEPS) -> dict:
    """bench.py's --moe-train rung (d1024, 12 layers, 16 heads of 64,
    seq 1024, batch 4, 8 experts top-2 no-drop, AMP O2 with f32 masters,
    AdamW with bf16 moments) through the port's
    bench.make_moe_train_step, at full width and depth, from seed 0.

    (a) _moe_block_check: one MoE layer, kernel route against plain.
    (b) 3 steps on the plain, witness and kernel routes (moe_train_route)
    from the same initial state: each route's losses, and each layer's
    route agreement with the plain route at step 1; the kernel route's
    largest relative loss deviation under a tenth of the smallest
    relative move the plain route's loss makes in one step (the witness
    route's deviation beside it), exactly 60 B14, 24 B15 and 12/12/12
    B10 launches a step.
    (c) On the kernel route, after bench.moe_nodrop_pin (an eager forward
    that stamps moe.* and raises on a dropped token) and those 3 steps:
    ``steps`` steps timed on the host clock (ended by reading the loss),
    with launches checked, then 2 steps under torch.profiler for the
    device time by kernel and the idle share; tokens/s, MFU (activated
    FLOPs over bench.H100_PEAK_BF16), peak memory, final loss."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import bench
    from paddle_tpu_torch.profiler import stats

    t_phase = time.perf_counter()
    _moe_block_check(gen)
    rung = (MOE_D, MOE_LAYERS, MOE_HEADS, MOE_TRAIN_SEQ, MOE_E, MOE_TOPK)
    inputs, labels = bench.rung_batch(MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, "cuda")
    traj, routes = {}, {}
    for kind in ("plain", "witness", "kernel"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model, step = bench.make_moe_train_step(*rung)
        routes[kind] = []
        with moe_train_route(kind, gen):
            if kind == "kernel":
                drop0 = stats.counter("moe.dropped_tokens").value
                bench.moe_nodrop_pin(model, inputs)
                stamped = stats.histogram("moe.tokens_per_expert").count
            _reset_counters()
            with _record_routes(routes[kind], MOE_LAYERS):
                losses = [float(step(inputs, labels)) for _ in range(3)]
            _check_launches(f"train_moe_steps[{kind}]", _counters(),
                            _moe_expected(3) if kind == "kernel" else
                            dict.fromkeys(_SOURCES, 0))
        traj[kind] = losses
        if kind != "kernel":
            del model, step
    base = traj["plain"]
    dev = {k: max(abs(a - b) / abs(b) for a, b in zip(traj[k], base))
           for k in ("witness", "kernel")}
    # a tenth of the smallest step-to-step move of the plain route's loss
    limit = 0.1 * min(abs(a - b) / abs(b) for a, b in zip(base[1:], base))
    agree = {k: [_route_agreement(a, b) for a, b in
                 zip(routes[k], routes["plain"])]
             for k in ("witness", "kernel")}
    emit({"check": "train_moe_trajectory", "losses": traj,
          "rel_dev": dev, "limit": limit,
          "rule": "0.1 x the smallest relative move of the plain route's "
                  "loss in one step",
          "route_agreement_step1_by_layer": agree})
    check(all(np.isfinite(traj[k]).all() for k in traj),
          "train_moe: non-finite loss")
    check(dev["kernel"] <= limit, f"train_moe: kernel route loss deviation "
          f"{dev['kernel']} > {limit}")
    # ---- timing on the kernel route, from its state after 3 steps
    n_params, n_active = bench.moe_param_counts(model, MOE_D, MOE_LAYERS,
                                                MOE_E, MOE_TOPK)
    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(inputs, labels)
    final = float(loss)
    wall = time.perf_counter() - t0
    counts = _counters()
    _check_launches("train_moe", counts, _moe_expected(steps))
    prof_steps = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(prof_steps):
            loss = step(inputs, labels)
        float(loss)
    groups = {B14_KERNEL: "B14 (forward, recompute, dx)",
              "grouped_gemm_kernel": "B14 (forward, recompute, dx)",
              "grouped_dw_kernel": "B15 (dw)", B15_KERNEL: "B15 (dw)",
              "flash_fwd": "B10 forward",
              "flash_bwd_dq": "B10 dq", "flash_bwd_dkv": "B10 dk/dv"}
    by_group, kernels = {}, []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / prof_steps / 1e3
        kernels.append((ev.key, ms, ev.count / prof_steps))
        lk = ev.key.lower()
        grp = next((v for k, v in groups.items() if k in ev.key), None)
        if grp is None:
            grp = ("GEMMs (cuBLAS/CUTLASS)" if any(
                t in lk for t in ("gemm", "cutlass", "xmma", "nvjet"))
                else "other PyTorch ops (router, sort, gathers, LN, CE, "
                     "AdamW, copies)")
        by_group[grp] = by_group.get(grp, 0.0) + ms
    busy = sum(by_group.values())
    kernels.sort(key=lambda r: -r[1])
    peak = torch.cuda.max_memory_allocated()
    tokens = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
    tps = tokens * steps / wall
    fpt = bench.moe_flops_per_token(n_active, MOE_LAYERS, MOE_TRAIN_SEQ,
                                    MOE_D)
    wall_ms = wall / steps * 1e3
    emit({"phase": "train_moe", "rung": "moe-train d1024 L12 E8 top-2",
          "n_params": n_params, "n_active": n_active,
          "batch": MOE_TRAIN_BATCH, "seq": MOE_TRAIN_SEQ, "steps": steps,
          "warmup": 3, "tokens_per_s": tps,
          "mfu": tps * fpt / bench.H100_PEAK_BF16,
          "flops_per_token": fpt, "wall_ms_per_step": wall_ms,
          "device_busy_ms_per_step": busy,
          "device_idle_share": 1 - busy / wall_ms,
          "device_ms_per_step_by_group": by_group,
          "max_memory_allocated_gb": peak / 1e9,
          "first_call_s": step.first_call_seconds,
          "launches_per_step": {k: v / steps for k, v in counts.items()
                                if v},
          "nodrop_pin": {"dropped_tokens_moved":
                         stats.counter("moe.dropped_tokens").value - drop0,
                         "tokens_per_expert_observed": stamped,
                         "imbalance": stats.gauge("moe.imbalance").value},
          "loss_final": final,
          "top_kernels": [{"name": k[:60], "ms_per_step": ms,
                           "launches_per_step": n}
                          for k, ms, n in kernels[:8]],
          "wall_s": time.perf_counter() - t_phase})
    check(np.isfinite(final), "train_moe: non-finite loss")
    if out_dir:
        with open(os.path.join(out_dir, "profile_train_moe.txt"), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40))
    del model, step, prof
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- decode
# backends (FLAGS_paged_attention_backend: B7, B8, B9)

#: kernel-check shapes (g, d) of each backend: the decode rung's (g 1,
#: d 128), grouped queries, the widest head, a masked width (96); the
#: stream kernel takes head_dim % 128 == 0 only
BACKEND_SHAPES = {"stream": ((1, HEAD_DIM), (2, HEAD_DIM), (4, 256)),
                  "fused": ((1, HEAD_DIM), (2, 64), (4, 256), (1, 96)),
                  "pallas": ((1, HEAD_DIM), (2, 64), (4, 256), (1, 96))}
#: new tokens of generate_fused / generate_pallas: cut from NEW_TOKENS
#: (129) to hold the script's time
BACKEND_NEW_TOKENS = 33


def _rel1_err(got, ref) -> float:
    """The largest ``|got - ref| / max(1, |ref|)``: absolute below 1,
    relative above, so one bf16 ulp of either output counts at most
    2^-7 whatever the value's size."""
    g, r = got.float(), ref.float()
    return float(((g - r).abs() / r.abs().clamp_min(1.0)).max())


def _backend_call(name, c, base, membership=None, plain=False, **kw):
    """One call of backend ``name`` (kernel or plain version) on a
    _decode_case over the layer region at ``base``: the stream kernel
    takes the layer-local tables and the region, the others the
    absolute tables."""
    from paddle_tpu_torch.nn.functional import paged_attention as pa

    args = (c["q"], c["kp"], c["vp"], c["lens"])
    if name == "stream":
        if plain:
            return pa._stream_paged_plain(*args, c["tables"], base, c["P"],
                                          membership, **kw)
        return pa.stream_paged(*args, c["tables"], pool_base=base,
                               pool_pages=c["P"], membership=membership)
    tables = c["tables"] + base
    if plain:
        fn = {"fused": pa._fused_paged_plain,
              "pallas": pa._pallas_paged_plain}[name]
        return fn(*args, tables, **kw)
    return {"fused": pa.fused_paged, "pallas": pa.pallas_paged}[name](
        *args, tables)


def _stream_tol(witness: float) -> float:
    """B7's bf16 limit: 2^-7, or the witness plus 2^-8 where more. B7 and
    its plain version both round p to bf16, so an f32-order difference
    in a score can move one p by a bf16 ulp; the witness (the plain
    version with p kept in f32) measures how far such rounding reaches
    on these inputs."""
    return max(2.0 ** -7, witness + 2.0 ** -8)


def kernel_paged_backends(gen) -> dict:
    """Kernels B7 (stream_paged), B8 (fused_paged) and B9 (pallas_paged)
    against their plain versions on _decode_case's inputs (attending
    seq_lens tokens: an idle row 0 of length 0, rows 7 and 8 sharing a
    full page, row 30's last page outside the region) over layer 1's
    region of a 4-layer folded pool, at BACKEND_SHAPES. Limits: float32
    2e-5 absolute (f32 sums in another order); bf16 2^-7 on
    ``_rel1_err`` (both sides keep f32 statistics; B8 and B9 feed P V
    three bf16 parts, within 2^-27 of f32, so only f32 order and the
    output's rounding differ: one bf16 ulp); B7 and its plain version round the probabilities to bf16
    alike, where an f32-order difference can flip one rounding, so B7's
    limit is ``_stream_tol`` of a witness. Rows of length 0 must be exactly 0. One control
    per kernel, which must exceed its limit: B7's plain version masked by
    build_pool_ownership (the JAX kernel's one-owner map: row 7 or 8
    loses the shared page); B8's and B9's skipping each row's last live
    page. Then each is timed at the rung (b32, g1, d128, bf16), rotating
    over the 4 layers, beside its plain version and SDPA over K/V
    already gathered; its bound counts the attended K/V rows, q, out,
    the tables and lengths."""
    from paddle_tpu_torch.nn.functional import paged_attention as pa

    rows = {}
    for name, shapes in BACKEND_SHAPES.items():
        res = {}
        for (g, d), dtype in [(gd, dt) for gd in shapes
                              for dt in (torch.float32, torch.bfloat16)]:
            bf16 = dtype == torch.bfloat16
            c = _decode_case(dtype, gen, g=g, d=d)
            base = c["P"]                          # layer 1's region
            mem = pa.pool_membership(c["tables"], c["lens"], c["P"], PAGE)
            got = _backend_call(name, c, base, mem)
            torch.cuda.synchronize()
            ref = _backend_call(name, c, base, mem, plain=True)
            if name == "stream":
                own = pa.build_pool_ownership(c["tables"], c["lens"], c["P"],
                                              PAGE)
                ctrl_out = _backend_call(name, c, base, plain=True,
                                         ownership=own)
            else:
                ctrl_out = _backend_call(name, c, base, plain=True,
                                         skip_last_page=True)
            metric = _rel1_err if bf16 else max_err
            tol, witness = (2.0 ** -7 if bf16 else 2e-5), None
            if bf16 and name == "stream":
                witness = _rel1_err(_backend_call(
                    name, c, base, mem, plain=True, round_p=False), ref)
                tol = _stream_tol(witness)
            err, ctrl = metric(got, ref), metric(ctrl_out, ref)
            empty_exact = bool((got[0] == 0).all())
            line = {"check": f"paged_attention_{name}", "g": g, "d": d,
                    "dtype": str(dtype),
                    "metric": "rel1" if bf16 else "max_abs_err",
                    "err": err, "max_abs_err": max_err(got, ref),
                    "tol": tol, "witness_err": witness, "control_err": ctrl,
                    "empty_row_exact_zero": empty_exact}
            if name == "stream":
                line["control_err_rows_7_8"] = [
                    max_err(ctrl_out[r], ref[r]) for r in (7, 8)]
            emit(line)
            what = f"paged_attention_{name} g={g} d={d} {dtype}"
            check(err <= tol, f"{what}: {err} > {tol}")
            check(ctrl > tol, f"{what}: the control ({ctrl}) is within the "
                              f"limit {tol}")
            check(empty_exact, f"{what}: the row of length 0 is not 0")
            if (g, d) == (1, HEAD_DIM):
                res[str(dtype)] = line["max_abs_err"]
            del c, got, ref, ctrl_out
        if name in ("fused", "pallas"):
            _walk_long_rows(name)
        rows[f"paged_attention_{name}"] = _backend_times(name, gen, res)
    torch.cuda.empty_cache()
    return rows


def _walk_long_rows(name) -> None:
    """B8 or B9 (``name`` "fused" or "pallas") on B1's long rows (b4, 64
    pages a row, from its own generator so later inputs do not move),
    which decode_q_plan splits for bf16: f32 2e-5, bf16 2^-7 on
    ``_rel1_err`` against the backend's plain version (B9's keeps the
    stock kernel's compute blocks of 32 pages); the skip-last-page
    control must exceed the limit."""
    from paddle_tpu_torch.nn.functional import paged_attention as pa

    long_gen = torch.Generator(device="cuda")
    long_gen.manual_seed(16)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2.0 ** -7)):
        bf16 = dtype == torch.bfloat16
        c = _decode_case(dtype, long_gen, lens=DECODE_Q_LONG_LENS, pp=64,
                         L=2)
        base = c["P"]
        got = _backend_call(name, c, base)
        torch.cuda.synchronize()
        ref = _backend_call(name, c, base, plain=True)
        ctrl_out = _backend_call(name, c, base, plain=True,
                                 skip_last_page=True)
        metric = _rel1_err if bf16 else max_err
        err, ctrl = metric(got, ref), metric(ctrl_out, ref)
        b = int(c["q"].shape[0])
        n_split = pa.decode_q_plan(b, N_HEADS, c["pp"] * PAGE,
                                   pa._sm_count(c["q"].device))[0] \
            if bf16 else 1
        emit({"check": f"paged_attention_{name}_long_rows",
              "dtype": str(dtype), "batch": b, "pages_per_seq": c["pp"],
              "n_split": n_split, "err": err,
              "max_abs_err": max_err(got, ref), "tol": tol,
              "control_err": ctrl})
        what = f"paged_attention_{name} long rows {dtype}"
        check(err <= tol, f"{what}: {err} > {tol}")
        check(ctrl > tol, f"{what}: the control ({ctrl}) is within the "
                          f"limit {tol}")
        check(n_split > 1 or not bf16, f"{what}: the rows are not split")
        del c, got, ref, ctrl_out


def _backend_times(name, gen, res) -> dict:
    """Backend ``name`` timed at the rung (b32, g1, d128, bf16), inputs
    rotating over the 4 layers' regions; one "time" line."""
    import torch.nn.functional as F

    from paddle_tpu_torch.nn.functional import paged_attention as pa

    c = _decode_case(torch.bfloat16, gen)
    P, pp, L = c["P"], c["pp"], c["L"]
    args = (c["q"], c["kp"], c["vp"], c["lens"])
    mem = pa.pool_membership(c["tables"], c["lens"], P, PAGE)
    # absolute ids of each layer's region; row 30's id past the region
    # reads its layer's scratch page 0 here, so the last layer's stays in
    # the pool
    local = torch.where(c["tables"] < P, c["tables"], 0)
    absolute = [local + l * P for l in range(L)]
    nxt = cycler(L)
    if name == "stream":
        def kern():
            pa.stream_paged(*args, c["tables"], pool_base=nxt() * P,
                            pool_pages=P, membership=mem)

        def plain():
            pa._stream_paged_plain(*args, c["tables"], nxt() * P, P, mem)
    else:
        fn = {"fused": pa.fused_paged, "pallas": pa.pallas_paged}[name]
        pfn = {"fused": pa._fused_paged_plain,
               "pallas": pa._pallas_paged_plain}[name]

        def kern():
            fn(*args, absolute[nxt()])

        def plain():
            pfn(*args, absolute[nxt()])
    # what each row attends: its tokens below seq_lens through its table;
    # the stream kernel drops row 30's id outside the region
    b, n_kv, d = c["q"].shape
    cap = pp * PAGE
    tok = torch.arange(cap, device="cuda")
    attended = tok[None, :] < c["lens"].long()[:, None]
    if name == "stream":
        attended &= (c["tables"] < P).repeat_interleave(PAGE, dim=1)
    kg = c["kp"][absolute[1].long()].permute(0, 2, 1, 3, 4) \
        .reshape(b, n_kv, cap, d).contiguous()
    vg = c["vp"][absolute[1].long()].permute(0, 2, 1, 3, 4) \
        .reshape(b, n_kv, cap, d).contiguous()
    mask = attended[:, None, None, :]
    qd = c["q"][:, :, None, :]

    def library():
        F.scaled_dot_product_attention(qd, kg, vg, attn_mask=mask)
    ms, plain_ms = time_ms(kern), time_ms(plain, iters=5)
    lib_ms = time_ms(library)
    if name == "stream":
        # the profiler's device time a call, and of each of its launches
        dev = {}
        for k in B7_KERNELS:
            dev[k] = device_ms(kern, k, per_call=1)
            check(dev[k] > 0.0, f"stream: no {k} device time recorded")
        dev_ms = sum(dev.values())
    isz, n_tok = 2, int(attended.sum())
    nbytes = (2 * n_tok * n_kv * d * isz + 2 * b * n_kv * d * isz
              + b * 4 + (b * P * 4 if name == "stream"
                         else c["tables"].numel() * 4))
    flops = 4.0 * n_tok * n_kv * d
    bms, by = bound_ms(nbytes, flops, torch.bfloat16)
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bms, "bound_by": by, "bytes": nbytes,
           "max_abs_err": res[str(torch.bfloat16)]}
    extra = {}
    if name in ("fused", "pallas"):
        # the profiler's device time of B8's (B9's) bf16 kernel a call
        kname = B8_KERNEL if name == "fused" else B9_KERNEL
        row["device_ms"] = device_ms(kern, kname, per_call=1)
        check(row["device_ms"] > 0.0,
              f"{name}: no {kname} device time recorded")
        extra = {"n_split": pa.decode_q_plan(
            b, n_kv, cap, pa._sm_count(c["q"].device))[0]}
    if name == "stream":
        region = 2 * P * PAGE * n_kv * d * isz
        blocks, cpb, run_pages, _ = pa.stream_walk(
            b, 1, n_kv, P, PAGE, pa._sm_count(c["q"].device))
        live = int(pa.stream_live_pages(mem, 1).sum())
        row["device_ms"] = dev_ms
        extra = {"device_ms": dev_ms, "device_ms_by_launch": dev,
                 "region_bytes": region,
                 "region_bound_ms": region / HBM_BYTES_PER_S * 1e3,
                 "live_pages": live, "region_pages": P,
                 "live_bytes": 2 * live * PAGE * n_kv * d * isz,
                 "blocks_per_head": blocks, "chunks_per_block": cpb,
                 "workspace_bytes": n_kv * blocks * b * (d + 2) * 4,
                 "launches_per_call": 2}
    emit({"time": f"paged_attention_{name}", "batch": b, "g": 1, "d": d,
          "pages_per_seq": pp, "attended_tokens": n_tok, **row, **extra,
          "library_note": "scaled_dot_product_attention over K/V already "
                          "gathered, masked by length"})
    del c, kg, vg, absolute
    return row


def slice_decode_backends(model) -> dict:
    """The decode rung's model (bf16 d2048·L24, before it is quantized)
    under each FLAGS_paged_attention_backend value, launch counts reset
    before and read after each path:
    - fused and pallas: GenerationEngine.generate at batch 32, prompt
      128, BACKEND_NEW_TOKENS new tokens (generate_fused,
      generate_pallas): 24 launches of B8 (B9) a decode step, none of
      B1; then the teacher-forced check against the plain path;
    - stream: one decode step, which takes B1 in place (24 launches) and
      not B7, as the JAX decode step does on its chip;
    - xla: decode_raw on the card raises;
    - the public paged_attention under auto on a prefilled batch's live
      pool, each of the 24 layers at pool_base = l * pages: it takes
      stream (48 launches: partials and merge a layer), each layer held
      to B7's plain version within ``_stream_tol`` of the witness (that
      plain version's distance to paged_attention_plain, the gather,
      which keeps p in f32), and to the gather on the absolute tables
      within that limit plus the witness."""
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.incubate.nn.fused_transformer import PagedKV
    from paddle_tpu_torch.nn.functional import paged_attention as pa

    t0 = time.perf_counter()
    st = model.stack
    L = st.num_layers
    by_path = {}
    try:
        for value in ("fused", "pallas"):
            set_flags({"paged_attention_backend": value})
            by_path[f"generate_{value}"] = slice_generate(
                model, f"generate_{value}", new_tokens=BACKEND_NEW_TOKENS,
                attention=value)
            slice_teacher_forced(model, name=f"teacher_forced_{value}")
        s = _prefilled(model, BATCH, 1, seed=4)
        x = s["emb"][s["tok"].long()].to(torch.bfloat16)
        step = (s["w"], x, PagedKV(s["ck"], s["cv"]), s["tables"],
                s["lens"], s["eng"]._cos, s["eng"]._sin)
        set_flags({"paged_attention_backend": "stream"})
        _reset_counters()
        h, _ = st.decode_raw(*step)
        torch.cuda.synchronize()
        counts = _counters()
        by_path["decode_step_stream"] = counts
        emit({"phase": "decode_step_stream", "batch": BATCH,
              "launches": counts, "hidden_finite":
              bool(torch.isfinite(h).all())})
        check(counts["paged_decode_attention_inplace"] == L,
              f"stream: B1 launched {counts['paged_decode_attention_inplace']}"
              f" times in a decode step, expected {L}")
        for k in ("stream", "fused", "pallas"):
            check(counts[f"paged_attention_{k}"] == 0,
                  f"stream: a decode step launched paged_attention_{k}")
        check(bool(torch.isfinite(h).all()), "stream: hidden not finite")
        set_flags({"paged_attention_backend": "xla"})
        try:
            st.decode_raw(*step)
            raised = None
        except ValueError as exc:
            raised = str(exc)
        emit({"phase": "decode_step_xla", "raised": raised})
        check(raised is not None and "CPU only" in raised,
              "xla: decode_raw on the card did not raise")
    finally:
        set_flags({"paged_attention_backend": "auto"})
    del s, step
    # the public op under auto on a live pool, layer by layer
    s = _prefilled(model, BATCH, 8, seed=5)
    npages = st._pages_per_layer(PagedKV(s["ck"], s["cv"]))
    q = torch.randn(BATCH, st.num_heads, st.head_dim, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(5)
                    ).to(torch.bfloat16)
    mem = pa.pool_membership(s["tables"], s["lens"], npages, PAGE)
    _reset_counters()
    outs, taken = [], set()
    for l in range(L):
        outs.append(pa.paged_attention(q, s["ck"], s["cv"], s["lens"],
                                       s["tables"], pool_base=l * npages,
                                       pool_pages=npages, ownership=mem))
        taken.add(pa.last_paged_attention_backend())
    torch.cuda.synchronize()
    counts = _counters()
    # each layer against B7's plain version (the kernel check's limit)
    # and against the plain gather on the absolute tables: B7 rounds the
    # probabilities to bf16 where the gather keeps f32, so that limit
    # adds the witness, B7's plain version's own distance to the gather
    errs, xla_errs, witness = [], [], []
    for l, o in enumerate(outs):
        ref = pa._stream_paged_plain(q, s["ck"], s["cv"], s["lens"],
                                     s["tables"], l * npages, npages, mem)
        xla = pa.paged_attention_plain(q, s["ck"], s["cv"], s["lens"],
                                       s["tables"] + l * npages)
        errs.append(_rel1_err(o, ref))
        xla_errs.append(_rel1_err(o, xla))
        witness.append(_rel1_err(ref, xla))
    tols = [_stream_tol(w) for w in witness]
    by_path["paged_attention_auto"] = counts
    wall = time.perf_counter() - t0
    emit({"phase": "paged_attention_auto", "batch": BATCH,
          "context": PROMPT, "layers": L, "backends": sorted(taken),
          "launches": counts, "metric": "rel1", "err_by_layer": errs,
          "tol_by_layer": tols, "xla_err_by_layer": xla_errs,
          "witness_by_layer": witness, "wall_s": wall})
    check(taken == {"stream"}, f"auto took {sorted(taken)} on the card")
    expect = dict.fromkeys(_SOURCES, 0)
    expect["paged_attention_stream"] = 2 * L
    _check_launches("paged_attention_auto", counts, expect)
    bad = [l for l in range(L) if errs[l] > tols[l]]
    check(not bad, f"paged_attention auto: layers {bad} differ from B7's "
          "plain version by more than their limits")
    bad = [l for l in range(L) if xla_errs[l] > witness[l] + tols[l]]
    check(not bad, f"paged_attention auto: layers {bad} differ from the "
          "plain gather by more than the witness + their limits")
    del s, outs, q
    torch.cuda.empty_cache()
    emit({"phase": "decode_backends", "wall_s": wall})
    return by_path


# ---------------------------------------------------------------- A6

#: GenerationEngine.generate's sampling settings of the sampling phase
SAMPLE_CFG = (0.8, 50, 0.9)
#: draws of the sampling phase's distribution check, and its limit on
#: their total-variation distance from the filtered softmax (at most 50
#: tokens kept: the expected distance at 10^5 draws is below 0.009)
SAMPLE_DRAWS, SAMPLE_TV_LIMIT = 100_000, 0.02
#: the speculative phase: bench.py's --decode-spec protocol (batch 8,
#: prompt 128, 128 new tokens, spec_k 4) and the draft model of the
#: DraftModelDrafter rounds
SPEC_BATCH, SPEC_NEW, SPEC_K = 8, 128, 4
DRAFT_D, DRAFT_LAYERS, DRAFT_HEADS, DRAFT_DFF = 1024, 4, 8, 4096


def slice_sampling(model) -> dict:
    """Sampled decoding on the bf16 d2048·L24 model: GenerationEngine.
    generate at batch 32, prompt 128, BACKEND_NEW_TOKENS new tokens,
    greedy and with do_sample (temperature 0.8, top-k 50, top-p 0.9, the
    Gumbel noise from an explicit torch.Generator), tokens/s of both;
    launch counts reset before and checked after the sampled call (the
    filter and the draw are PyTorch ops: the same B1/B2/B3 launches as
    greedy); top_k=1 sampling bitwise equal to the greedy output; then
    SAMPLE_DRAWS draws on one prefill logits row of the model, whose
    total-variation distance from the filtered softmax (the engine's own
    ``_filter_logits``, then softmax) must stay under SAMPLE_TV_LIMIT,
    with no draw outside the kept set."""
    from paddle_tpu_torch.inference import GenerationEngine
    from paddle_tpu_torch.inference.engine import gumbel_noise

    new = BACKEND_NEW_TOKENS
    eng = GenerationEngine(model, page_size=PAGE, max_length=PROMPT + new)
    ids = np.random.RandomState(0).randint(0, VOCAB, (BATCH, PROMPT))
    gen = torch.Generator(device="cuda")
    t, top_k, top_p = SAMPLE_CFG
    sample = dict(do_sample=True, temperature=t, top_k=top_k, top_p=top_p)
    eng.generate(ids[:, :16], max_new_tokens=4, generator=gen,
                 **sample)                                # warm-up
    res = {}
    for name, kw in (("greedy", {}),
                     ("sampled", dict(sample, generator=gen))):
        gen.manual_seed(17)
        torch.cuda.synchronize()
        _reset_counters()
        t0 = time.perf_counter()
        out = eng.generate(ids, max_new_tokens=new, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        res[name] = dict(out=out, seconds=dt, counts=_counters(),
                         tokens_per_s=BATCH * new / dt)
    expect = _expected_launches(new - 1, 1, layers=model.stack.num_layers)
    gen.manual_seed(17)
    top1 = eng.generate(ids, max_new_tokens=new, do_sample=True,
                        temperature=t, top_k=1, top_p=top_p, generator=gen)
    greedy, sampled = res["greedy"]["out"], res["sampled"]["out"]
    # the distribution of the draw on one row of real logits
    s = _prefilled(model, 1, 1, seed=7)
    row = s["logits"][0].float()
    cfg = (t, top_k, top_p)
    probs = torch.softmax(GenerationEngine._filter_logits(row[None], cfg),
                          dim=-1)[0]
    kept = probs > 0
    counts = torch.zeros(VOCAB, dtype=torch.float64, device="cuda")
    draw_gen = torch.Generator(device="cuda")
    draw_gen.manual_seed(5)
    chunk = 2000
    t0 = time.perf_counter()
    for _ in range(SAMPLE_DRAWS // chunk):
        lg = row.expand(chunk, VOCAB)
        toks = GenerationEngine._pick_token(
            lg, gumbel_noise(lg.shape, draw_gen), cfg)
        counts += torch.bincount(toks.long(), minlength=VOCAB)
    freq = counts / SAMPLE_DRAWS
    tv = float(0.5 * (freq - probs.double()).abs().sum())
    outside = int(counts[~kept].sum())
    draw_s = time.perf_counter() - t0
    differ = float((sampled[:, PROMPT:] != greedy[:, PROMPT:]).mean())
    emit({"phase": "sampling", "batch": BATCH, "prompt": PROMPT,
          "new_tokens": new, "temperature": t, "top_k": top_k,
          "top_p": top_p,
          "greedy_tokens_per_s": res["greedy"]["tokens_per_s"],
          "sampled_tokens_per_s": res["sampled"]["tokens_per_s"],
          "greedy_seconds": res["greedy"]["seconds"],
          "sampled_seconds": res["sampled"]["seconds"],
          "sampled_differs_from_greedy": differ,
          "top_k_1_equals_greedy": bool((top1 == greedy).all()),
          "draws": SAMPLE_DRAWS, "kept_tokens": int(kept.sum()),
          "tv_distance": tv, "tv_limit": SAMPLE_TV_LIMIT,
          "draws_outside_kept": outside, "draw_seconds": draw_s,
          "launches": res["sampled"]["counts"], "expected_launches": expect})
    for name in ("greedy", "sampled"):
        out = res[name]["out"]
        check(out.shape == (BATCH, PROMPT + new), f"sampling {name} shape")
        check(bool((out >= 0).all() and (out < VOCAB).all()),
              f"sampling {name}: token ids outside the vocabulary")
        check(bool((out[:, :PROMPT] == ids).all()),
              f"sampling {name}: prompt lost")
        _check_launches(f"generate {name}", res[name]["counts"], expect)
    check(bool((top1 == greedy).all()),
          "sampling: top_k=1 differs from the greedy tokens")
    check(differ > 0.0, "sampling: the sampled tokens are the greedy ones")
    check(outside == 0, f"sampling: {outside} draws outside the kept set")
    check(tv < SAMPLE_TV_LIMIT, f"sampling: total-variation distance {tv} "
          f">= {SAMPLE_TV_LIMIT}")
    del s
    return res["sampled"]["counts"]


def _spec_teacher_forced(model, k: int = SPEC_K) -> None:
    """The verify pass against the decode step, teacher-forced: from one
    prefilled pool (b 8, context 128) the decode path (B1, B2/B3) takes
    k + 1 greedy steps; the verify pass (B4 and the prompt GEMMs, then
    the LM head on b (k + 1) rows) scores the same k + 1 tokens at once
    from a copy of the starting pool. Their logits at each window
    position must agree within the bf16 teacher-forced limit (0.1: the
    two round bf16 intermediates at other points); the share of equal
    greedy picks is printed (at a near-tie they can differ, so the
    speculative stream is not required to equal the plain one token for
    token)."""
    from paddle_tpu_torch.incubate.nn.fused_transformer import PagedKV

    b, tol = SPEC_BATCH, 0.1
    s = _prefilled(model, b, k + 1, seed=6)
    eng, st, tables = s["eng"], s["st"], s["tables"]
    w, emb, head, lnf_s, lnf_b = (s[n] for n in ("w", "emb", "head",
                                                 "lnf_s", "lnf_b"))
    ck0, cv0 = _clone(s["ck"]), _clone(s["cv"])
    tok, pos = s["tok"], s["lens"].clone()
    window, dec = [tok], []
    for _ in range(k + 1):
        x = emb[tok.long()].to(torch.bfloat16)
        h, _ = st.decode_raw(w, x, PagedKV(s["ck"], s["cv"]), tables, pos,
                             eng._cos, eng._sin)
        lg = eng._logits(h, head, lnf_s, lnf_b)
        dec.append(lg)
        tok = eng._argmax(lg)
        window.append(tok)
        pos = pos + 1
    ids = torch.stack(window[:k + 1], dim=1)                  # [b, k+1]
    x = emb[ids.long()].to(torch.bfloat16)
    h, _ = st.prefill_chunk_raw(
        w, x, PagedKV(ck0, cv0), tables, s["lens"],
        torch.full((b,), k + 1, dtype=torch.int32, device="cuda"),
        eng._cos, eng._sin)
    ver = eng._logits(h.reshape(b * (k + 1), -1), head, lnf_s, lnf_b) \
        .reshape(b, k + 1, -1)
    dec = torch.stack(dec, dim=1)
    errs = [max_err(ver[:, j], dec[:, j]) for j in range(k + 1)]
    agree = float((eng._argmax(ver.reshape(b * (k + 1), -1))
                   == eng._argmax(dec.reshape(b * (k + 1), -1)))
                  .float().mean())
    emit({"phase": "teacher_forced_verify", "batch": b, "window": k + 1,
          "context": PROMPT, "logits_max_abs_err": max(errs),
          "per_position": errs, "tol": tol, "argmax_agreement": agree})
    check(bool(torch.isfinite(ver).all()), "verify: logits not finite")
    check(max(errs) <= tol, f"verify: logits differ from the decode "
          f"step's by {max(errs)} > {tol}")
    del s, ck0, cv0


def _build_draft_model():
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.inference import FusedCausalLM

    ptt.seed(3)
    draft = FusedCausalLM(
        vocab_size=VOCAB, embed_dim=DRAFT_D, num_heads=DRAFT_HEADS,
        dim_feedforward=DRAFT_DFF, num_layers=DRAFT_LAYERS,
        max_position=PROMPT + SPEC_NEW + 1)
    st = draft.stack
    for n in ("qkv_weight", "qkv_bias", "out_weight", "out_bias",
              "ffn1_weight", "ffn1_bias", "ffn2_weight", "ffn2_bias"):
        p = getattr(st, n)
        p.data = p.data.to(torch.bfloat16)
    return draft


def slice_speculative(model) -> dict:
    """Speculative decoding on the bf16 d2048·L24 model, bench.py's
    --decode-spec protocol: the same 8 requests (prompt 128, 128 new
    tokens) through a ContinuousBatchingEngine plain, then with spec_k 4
    and a ScheduledDrafter replaying greedy streams: first the plain
    run's, then (timed as the acceptance ceiling) the speculative run's
    own, since the verify pass and the decode step pick apart at
    near-ties; tokens/s of each, accept rates and rounds.
    Launch counts reset before and checked after each: the plain run's
    as slice_continuous's; the speculative run's 24 B4 launches a verify
    round and one LM head (B2) a round and an admission, nothing else.
    The pool drains to its starting free pages. Every emitted token is
    the verify pass's own pick, so the streams are held to the plain ones
    only through the teacher-forced check (_spec_teacher_forced) and the
    accept rate. Then a few rounds each with SelfDraftHeads and with a
    DraftModelDrafter (d1024·L4, 8 heads of 128, bf16, random weights
    from a seed): valid tokens, the pool drained."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            DraftModelDrafter,
                                            ScheduledDrafter)
    from paddle_tpu_torch.profiler import stats

    t_phase = time.perf_counter()
    L = model.stack.num_layers
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, VOCAB, (PROMPT,)) for _ in range(SPEC_BATCH)]
    kw = dict(max_batch=SPEC_BATCH, page_size=PAGE,
              max_length=PROMPT + SPEC_NEW)

    def drive(eng, n_new=SPEC_NEW, ps=prompts):
        free0 = eng._mgr.free_pages
        rids = [eng.submit(p, max_new_tokens=n_new) for p in ps]
        torch.cuda.synchronize()
        _reset_counters()
        steps0 = stats.counter("serving.decode_steps").value
        keys = ("serving.spec_rounds", "serving.spec_drafted_tokens",
                "serving.spec_accepted_tokens")
        c0 = {k: stats.counter(k).value for k in keys}
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        by = {r.id: list(r.generated) for r in eng.finished}
        eng.finished.clear()
        return dict(seconds=dt, streams=[by[r] for r in rids],
                    counts=_counters(), free=(free0, eng._mgr.free_pages),
                    steps=stats.counter("serving.decode_steps").value
                    - steps0,
                    **{k.split(".")[1]: stats.counter(k).value - c0[k]
                       for k in keys})

    def same(a, b):
        return float(np.mean([u == v for x, y in zip(a, b)
                              for u, v in zip(x, y)]))

    plain_eng = ContinuousBatchingEngine(model, **kw)
    drive(plain_eng, 4, prompts[:2])                          # warm-up
    plain = drive(plain_eng)
    streams = plain["streams"]
    script = {}
    drafter = ScheduledDrafter(
        lambda req: script.get(np.asarray(req.prompt).tobytes(), []))
    spec_eng = ContinuousBatchingEngine(model, speculative=drafter,
                                        spec_k=SPEC_K, **kw)
    drive(spec_eng, 4, [rng.randint(0, VOCAB, (PROMPT,))])    # warm-up
    # first the plain run's streams as the script; the verify pass (B4
    # and the prompt GEMMs) and the decode step (B1, B2/B3) pick apart
    # at near-ties of the random model's logits (teacher_forced_verify
    # prints the share), and a stream that moved off its script is
    # rejected from there on. Then the speculative run's own streams as
    # the script: the acceptance ceiling of bench.py's protocol, timed
    script.update((np.asarray(p, np.int32).tobytes(), st)
                  for p, st in zip(prompts, streams))
    replay_plain = drive(spec_eng)
    script.update((np.asarray(p, np.int32).tobytes(), st)
                  for p, st in zip(prompts, replay_plain["streams"]))
    spec = drive(spec_eng)
    total = sum(len(x) for x in streams)
    accept = spec["spec_accepted_tokens"] / spec["spec_drafted_tokens"]
    rounds = spec["spec_rounds"]
    expect_plain = _expected_launches(plain["steps"], SPEC_BATCH, layers=L)
    expect_spec = dict.fromkeys(_SOURCES, 0)
    expect_spec["paged_prefill_attention"] = L * rounds
    expect_spec["stream_linear"] = rounds + SPEC_BATCH
    emit({"phase": "speculative", "batch": SPEC_BATCH, "prompt": PROMPT,
          "new_tokens": SPEC_NEW, "spec_k": SPEC_K,
          "drafter": "ScheduledDrafter (a speculative run's own streams)",
          "plain_seconds": plain["seconds"],
          "spec_seconds": spec["seconds"],
          "plain_tokens_per_s": total / plain["seconds"],
          "spec_tokens_per_s": total / spec["seconds"],
          "speedup": plain["seconds"] / spec["seconds"],
          "accept_rate": accept, "rounds": rounds,
          "plain_decode_steps": plain["steps"],
          "replaying_plain": {
              "seconds": replay_plain["seconds"],
              "tokens_per_s": total / replay_plain["seconds"],
              "accept_rate": replay_plain["spec_accepted_tokens"]
              / replay_plain["spec_drafted_tokens"],
              "rounds": replay_plain["spec_rounds"],
              "tokens_equal_to_plain": same(replay_plain["streams"],
                                            streams)},
          "tokens_equal_to_plain": same(spec["streams"], streams),
          "tokens_equal_to_script": same(spec["streams"],
                                         replay_plain["streams"]),
          "free_pages": {"plain": plain["free"], "spec": spec["free"]},
          "launches_plain": plain["counts"],
          "launches_spec": spec["counts"],
          "expected_launches_spec": expect_spec})
    _check_launches("speculative plain", plain["counts"], expect_plain)
    _check_launches("speculative", spec["counts"], expect_spec)
    check(rounds > 0, "speculative: no verify round ran")
    check(all(len(x) == SPEC_NEW for x in spec["streams"]),
          "speculative: a request finished with other than 128 tokens")
    check(all(0 <= t < VOCAB for x in spec["streams"] for t in x),
          "speculative: token ids outside the vocabulary")
    for name, r in (("plain", plain), ("speculative", spec),
                    ("speculative replaying plain", replay_plain)):
        check(r["free"][0] == r["free"][1], f"{name}: the pool's free pages "
              f"did not return to their start value {r['free']}")
    _spec_teacher_forced(model)
    # a few rounds with each learned-free drafter
    draft = _build_draft_model()
    for name, arg in (("self", "self"), ("draft_model",
                                         DraftModelDrafter(draft))):
        eng = ContinuousBatchingEngine(model, speculative=arg,
                                       spec_k=SPEC_K, **kw)
        r = drive(eng, 2 * (SPEC_K + 1) + 1)
        emit({"phase": f"speculative_{name}", "batch": SPEC_BATCH,
              "new_tokens": 2 * (SPEC_K + 1) + 1, "rounds": r["spec_rounds"],
              "accept_rate": r["spec_accepted_tokens"]
              / max(r["spec_drafted_tokens"], 1),
              "seconds": r["seconds"], "free_pages": r["free"],
              "launches": r["counts"]})
        check(r["spec_rounds"] >= 2, f"speculative_{name}: fewer than two "
              "rounds ran")
        check(all(0 <= t < VOCAB for x in r["streams"] for t in x),
              f"speculative_{name}: token ids outside the vocabulary")
        check(r["free"][0] == r["free"][1],
              f"speculative_{name}: the pool did not drain {r['free']}")
        check(r["counts"]["paged_prefill_attention"] >= L * r["spec_rounds"],
              f"speculative_{name}: the verify did not run B4")
        del eng
    del draft
    torch.cuda.empty_cache()
    emit({"phase": "a6_paths", "wall_s": time.perf_counter() - t_phase})
    return spec["counts"]


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
    "stream_linear_w8": (
        "paddle_tpu_torch/csrc/stream_linear.cu",
        "paddle_tpu/nn/functional/stream_linear.py:289"),
    "stream_layer_tail_w8": (
        "paddle_tpu_torch/csrc/stream_linear.cu",
        "paddle_tpu/nn/functional/stream_linear.py:482"),
    "stream_linear_a8w8": (
        "paddle_tpu_torch/csrc/stream_linear_a8w8.cu",
        "paddle_tpu/nn/functional/stream_linear.py:144"),
    "paged_decode_attention_inplace_q": (
        "paddle_tpu_torch/csrc/paged_attention_q.cu",
        "paddle_tpu/nn/functional/paged_attention.py:957"),
    "grouped_gemm": (
        "paddle_tpu_torch/csrc/grouped_gemm.cu",
        "paddle_tpu/nn/functional/grouped_gemm.py:170"),
    "lora_delta": (
        "paddle_tpu_torch/csrc/grouped_gemm.cu",
        "paddle_tpu/nn/functional/lora.py:99"),
    "grouped_dw": (
        "paddle_tpu_torch/csrc/grouped_gemm.cu",
        "paddle_tpu/nn/functional/grouped_gemm.py:270"),
    "flash_attention_fwd": (
        "paddle_tpu_torch/csrc/flash_attention.cu",
        "paddle_tpu/nn/functional/attention.py:109"),
    "flash_attention_bwd_dq": (
        "paddle_tpu_torch/csrc/flash_attention.cu",
        "paddle_tpu/nn/functional/attention.py:119"),
    "flash_attention_bwd_dkv": (
        "paddle_tpu_torch/csrc/flash_attention.cu",
        "paddle_tpu/nn/functional/attention.py:119"),
    "flash_varlen_fwd": (
        "paddle_tpu_torch/csrc/flash_varlen_packed.cu",
        "paddle_tpu/nn/functional/flash_varlen.py:235"),
    "flash_varlen_bwd_dq": (
        "paddle_tpu_torch/csrc/flash_varlen_packed.cu",
        "paddle_tpu/nn/functional/flash_varlen.py:373"),
    "flash_varlen_bwd_dkv": (
        "paddle_tpu_torch/csrc/flash_varlen_packed.cu",
        "paddle_tpu/nn/functional/flash_varlen.py:500"),
    "paged_attention_stream": (
        "paddle_tpu_torch/csrc/paged_backends.cu",
        "paddle_tpu/nn/functional/paged_attention.py:341"),
    "paged_attention_fused": (
        "paddle_tpu_torch/csrc/paged_backends.cu",
        "paddle_tpu/nn/functional/paged_attention.py:145"),
    "paged_attention_pallas": (
        "paddle_tpu_torch/csrc/paged_backends.cu",
        "paddle_tpu/nn/functional/paged_attention.py:89"),
}

#: the quantized decode rungs of bench.py (--decode-int8, --decode-a8w8,
#: --decode-int8kv): path name, quant, kv_dtype, batch
QUANT_PATHS = (("generate_int8", "int8", None, BATCH),
               ("generate_a8w8", "a8w8", None, BATCH),
               ("generate_int8kv", "int8", "int8", 2 * BATCH))


def drive(args) -> None:
    """Every phase, in order; the last line is the ok line."""
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
    t0 = time.perf_counter()
    rows.update({
        "stream_linear_w8": kernel_stream_linear_w8(gen),
        "stream_layer_tail_w8": kernel_stream_layer_tail(gen, int8=True),
        "stream_linear_a8w8": kernel_stream_linear_a8w8(gen),
        "paged_decode_attention_inplace_q": kernel_paged_attention_q(gen)})
    emit({"phase": "quantized_kernels", "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    rows.update({"grouped_gemm": kernel_grouped_gemm(gen),
                 "lora_delta": kernel_lora_delta(gen)})
    emit({"phase": "moe_lora_kernels", "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    rows.update(kernel_flash_attention(gen))
    emit({"phase": "flash_kernels", "wall_s": time.perf_counter() - t0})
    model = _build_model()
    by_path = {"generate": slice_generate(model)}
    slice_teacher_forced(model)
    slice_decode_step(model, args.out)
    by_path["continuous_batching"] = slice_continuous(model)
    by_path["serving"] = slice_serving(model)
    slice_chunked_prefill(model)
    slice_prefill_chunk(model)
    # multi-LoRA serving on the bf16 stack, before it is quantized
    t0 = time.perf_counter()
    by_path["serving_lora"] = slice_serving_lora(model)
    slice_teacher_forced_lora(model)
    emit({"phase": "lora_paths", "wall_s": time.perf_counter() - t0})
    # the decode backends (B7-B9), on the bf16 stack
    t0 = time.perf_counter()
    rows.update(kernel_paged_backends(gen))
    emit({"phase": "decode_backend_kernels",
          "wall_s": time.perf_counter() - t0})
    by_path.update(slice_decode_backends(model))
    # sampled and speculative decoding, on the bf16 stack
    t0 = time.perf_counter()
    by_path["generate_sampled"] = slice_sampling(model)
    by_path["speculative"] = slice_speculative(model)
    emit({"phase": "sampling_speculative", "wall_s":
          time.perf_counter() - t0})
    # quantized serving on the same model: the first quantized engine
    # turns its bf16 stack into int8 in place
    t0 = time.perf_counter()
    for name, quant, kv_dtype, batch in QUANT_PATHS:
        by_path[name] = slice_generate(model, name, quant, kv_dtype, batch)
        tag = name[len("generate_"):]
        slice_teacher_forced(model, quant=quant, kv_dtype=kv_dtype,
                             name=f"teacher_forced_{tag}")
        slice_decode_step(model, args.out, quant=quant, kv_dtype=kv_dtype,
                          batch=batch, name=f"decode_step_{tag}")
    by_path["serving_int8kv"] = slice_serving(
        model, "serving_int8kv", quant="int8", kv_dtype="int8")
    emit({"phase": "quantized_paths", "wall_s": time.perf_counter() - t0})
    del model
    torch.cuda.empty_cache()
    # the MoE rung on a model of its own
    t0 = time.perf_counter()
    moe = _build_moe_model()
    by_path["generate_moe"] = slice_generate(moe, "generate_moe",
                                             new_tokens=MOE_NEW)
    slice_teacher_forced_moe(moe)
    slice_decode_step(moe, args.out, name="decode_step_moe")
    emit({"phase": "moe_paths", "wall_s": time.perf_counter() - t0})
    del moe
    torch.cuda.empty_cache()
    # the training rung
    by_path["train"] = slice_train(args.out)
    # packed varlen attention (B11-B13) and the gpt-760m rung (B10 at
    # head_dim 96)
    t0 = time.perf_counter()
    rows.update(kernel_flash_varlen(gen))
    emit({"phase": "flash_varlen_kernels", "wall_s": time.perf_counter() - t0})
    by_path["attn_varlen"] = slice_attn_varlen(gen)
    by_path["train_760m"] = slice_train_760m()
    # the no-drop MoE training rung: B15, B14's backward mode, B10 at d64
    t0 = time.perf_counter()
    rows["grouped_dw"] = kernel_grouped_gemm_bwd(gen)
    emit({"phase": "moe_train_kernels", "wall_s": time.perf_counter() - t0})
    by_path["train_moe"] = slice_train_moe(args.out, gen)
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="directory for compiler logs and result lines")
    args = ap.parse_args()
    try:
        drive(args)
    finally:
        # every result line so far, also when a phase failed
        if args.out and os.path.isdir(args.out):
            with open(os.path.join(args.out, "chip_smoke.jsonl"), "w") as f:
                f.write("\n".join(_LINES) + "\n")


if __name__ == "__main__":
    main()
