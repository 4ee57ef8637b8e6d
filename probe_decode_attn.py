"""Probes of the decode kernels B1, B5, B6, B7, B8, B9 and B16 on one card.

    python3 probe_decode_attn.py [--check] [--parent DIR] [--step]
                                 [--variants NAME,...] [--rounds N]
                                 [--b5-caps N,...] [--out DIR]

``--check`` first runs ``chip_smoke.phase_build`` and the B1, B6, B7-B9,
B16 and B5 kernel checks (``kernel_paged_attention``,
``kernel_paged_attention_q``, ``kernel_paged_backends``,
``kernel_lora_delta``, ``kernel_stream_linear_a8w8``) on this tree.
Then, for this tree and, with ``--parent DIR`` (another tree's root, e.g. the parent commit unpacked
by ``git archive`` into a git-ignored directory), for that tree too, in
turns (parent, this, this, parent; ``--rounds`` times over), one
process each:
  - B1 (bf16 decode attention with its append) at the decode rung's
    inputs (``chip_smoke._decode_case``: b32 g1 d128, page 16, 17 pages
    a row, rotating over 4 layers): CUDA events ms a call and the
    profiler's device ms of the kernels named ``paged_decode_`` (either
    tree's B1 kernel); SDPA over the pre-gathered K/V beside it; and one
    hash of its outputs and pools after the append at the check's (g,
    d) = (1, 128), (2, 64), (4, 256), (1, 96) (trees with the same B1
    print the same);
  - B8 (``fused_paged``, bf16) at the same inputs over absolute tables,
    rotating over the 4 layers: events ms and the device ms of the
    kernels named ``fused_`` (either tree's B8), SDPA beside it;
  - B9 (``pallas_paged``, bf16) at the same inputs: events ms and the
    device ms of the kernels named ``pallas_`` (either tree's B9);
  - hashes of B8's and B6's outputs at the check's four (g, d), inputs
    from generators of their own (trees with the same B8 or B6 print the
    same);
  - B6 (int8-KV decode attention, bf16) at the int8-KV rung's inputs
    (``chip_smoke._decode_q_case``: b64, 16 kv heads of 128, page 16, 17
    pages a row), alternating over its 2 layers: events and device ms
    of the kernels named ``paged_decode_q``, and a hash of its first
    output (trees with the same B6 print the same);
  - B7 (``stream_paged``, bf16) at the decode backends' rung
    (``chip_smoke._decode_case`` over a 545-page region, rotating over 4
    layers): events ms a call, the device ms of every ``stream_`` kernel
    a call and of each kernel name apart;
  - B16 (``lora_delta``, bf16) on the four d2048 projections at T 8, 4
    slots of rank 16 (one empty), rotating over 24 layers: events and
    device ms (kernels named ``lora_delta``) summed over the four;
  - B5 (``_stream_linear_a8w8``) on the four projections at batch 32,
    rotating over 24 layers: events and device ms (kernels named
    ``a8w8_``, either tree's B5) summed over the four;
  - with ``--step``, the bf16 decode step (``chip_smoke``'s
    ``slice_decode_step`` on the d2048·L24 stack, b32 at context 128:
    its device ms by group, B1's among them), the int8-KV decode step
    (the stack quantized to int8 weights and an int8 pool, b64) and the
    A8W8 decode step (b32: B5's share by group).
With ``--variants`` (names of ``VARIANTS`` below: text substitutions
of one kernel source, ablations of the design), each variant and the
design are built into libraries of their own, one nvcc each, all started
together, and timed in this process in turns (design, variants...,
variants reversed, design) by the profiler's device ms of their kernel
at the same inputs; B5's per projection at each of ``--b5-caps``
(``a8w8_plan``'s most slices, default 8). Prints the card's name and
power limit first, then one JSON line per tree, variant and reading,
each also appended to ``--out``/results.jsonl (a long call's output is
cut to its tail). Needs one card and nvcc; imports nothing of JAX. On a card's machine, from the repo root:
``python3 probe_decode_attn.py --check --parent <dir> --step``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

#: name -> (what it changes, the library, {old text: new text} in its .cu)
VARIANTS = {
    "b1_scores_in_mma": (
        "B1's scores carried across k-steps in the mma accumulators (the "
        "first design; moved the MoE rung's routes)",
        "paged_attention",
        {"""        float t[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        ptt::mma_bf16(t[0], a0, 0u, a2, 0u, b0, b1);
        ptt::mma_bf16(t[1], a0, 0u, a2, 0u, b2, b3);
#pragma unroll
        for (int q = 0; q < 8; ++q) c[q / 4][q % 4] += t[q / 4][q % 4];""":
         """        ptt::mma_bf16(c[0], a0, 0u, a2, 0u, b0, b1);
        ptt::mma_bf16(c[1], a0, 0u, a2, 0u, b2, b3);"""}),
    "b5_stages4": (
        "B5's ring of 4 stages (the design: 3)", "stream_linear_a8w8",
        {"constexpr int kStages = 3;": "constexpr int kStages = 4;"}),
    "b5_stages6": (
        "B5's ring of 6 stages (the design: 3)", "stream_linear_a8w8",
        {"constexpr int kStages = 3;": "constexpr int kStages = 6;"}),
    "b5_no_swizzle": (
        "B5's W tile unswizzled (4-way bank conflicts on the B reads)",
        "stream_linear_a8w8",
        {"return r * kBN + ((c ^ (((r >> 2) & 3) << 1)) << 4);":
         "return r * kBN + (c << 4);",
         "const int off = ((2 * warp + (g >> 2)) ^ (a << 1)) * 16":
         "const int off = (2 * warp + (g >> 2)) * 16"}),
    "b5_ticket_only": (
        "B5's last block resets its counter and returns (the ticket alone; "
        "no output)", "stream_linear_a8w8",
        {"  if (ticket != p.split - 1) return;":
         "  if (tid == 0 && ticket == p.split - 1) p.counters[cid] = 0;\n"
         "  return;"}),
    "b5_merge_one_slice": (
        "B5's last block reads one slice (wrong output; what of the merge "
        "grows with the split)", "stream_linear_a8w8",
        {"    for (int s = 0; s < p.split; ++s) {":
         "    for (int s = 0; s < 1; ++s) {"}),
    "b5_no_acquire_fence": (
        "B5's last block without the fence after its ticket",
        "stream_linear_a8w8",
        {"  __threadfence();  // every partial of the tile is visible\n": ""}),
    "b5_no_merge": (
        "B5's last block skips the merge (the walk and the partials alone; "
        "no output)", "stream_linear_a8w8",
        {"  if (tid == 0) ticket = atomicAdd(p.counters + cid, 1);":
         "  return;  // no ticket (the counters stay 0), no merge"}),
    "b7_no_merge": (
        "B7's last block does not merge (the walk alone; no output)",
        "paged_backends",
        {"  return launch(stream_merge<bf16>, dim3(p.b * p.g, p.n_kv), 0, s, p);":
         "  return 0;"}),
    "b7_no_compute": (
        "B7 loads its chunks but computes nothing (wrong outputs)",
        "paged_backends",
        {"      if (wr0 < bg) {\n        const int c = list[i];":
         "      if (false) {\n        const int c = list[i];"}),
    "b7_no_loads": (
        "B7 reads no K/V (every row zero-filled; wrong outputs)",
        "paged_backends",
        {"        const bool in = tok < T && ((live[pg / 32] >> (pg % 32)) "
         "& 1u);": "        const bool in = false;"}),
    "b7_no_fold": (
        "B7 loads its live chunks but folds none (wrong outputs)",
        "paged_backends",
        {"      if (split)\n        fold(": "      if (false)\n        fold(",
         "      else\n        fold(std::integral_constant<int, kChunk>()":
         "      else if (false)\n        fold(std::integral_constant<int, "
         "kChunk>()"}),
    "b7_prologue_only": (
        "B7 blocks stage their masks and walk no chunk (the fixed cost)",
        "paged_backends",
        {"    const int n_live = misc[0];": "    const int n_live = 0;"}),
    "b7_one_chunk": (
        "each B7 block walks at most one chunk (its fixed cost)",
        "paged_backends",
        {"    const int n_live = misc[0];":
         "    const int n_live = min(misc[0], 1);"}),
}

#: run inside a tree's root: its own chip_smoke and paddle_tpu_torch
_MEASURE = r"""
import hashlib, json, sys, torch
import torch.nn.functional as F
sys.path.insert(0, ".")
import chip_smoke as cs
from paddle_tpu_torch import _kernels
from paddle_tpu_torch.nn.functional import lora as tl
from paddle_tpu_torch.nn.functional import paged_attention as pa
from paddle_tpu_torch.nn.functional import stream_linear as sl
from paddle_tpu_torch.quantization.dynamic import dynamic_act_quant

tag, step, out = sys.argv[1], sys.argv[2] == "1", sys.argv[3]
_kernels.build(["paged_attention_q", "paged_backends", "stream_linear",
                "paged_attention", "grouped_gemm", "stream_linear_a8w8"])
gen = torch.Generator(device="cuda")
gen.manual_seed(0)
res = {"tree": tag}
c = cs._decode_case(torch.bfloat16, gen)
P = c["P"]
nxt = cs.cycler(c["L"])

def b1():
    pa.paged_decode_attention_inplace(c["q"], c["nk"], c["nv"], c["kp"],
                                      c["vp"], c["lens"], c["tables"],
                                      pool_base=nxt() * P, pool_pages=P)
# B1's outputs and pools after its append, bf16, at the check's (g, d)
# on inputs of their own generator: one hash over all four
h1, g1 = hashlib.sha256(), torch.Generator(device="cuda")
g1.manual_seed(1)
for g, d in ((1, 128), (2, 64), (4, 256), (1, 96)):
    c1 = cs._decode_case(torch.bfloat16, g1, g=g, d=d)
    out1 = pa.paged_decode_attention_inplace(
        c1["q"], c1["nk"], c1["nv"], c1["kp"], c1["vp"], c1["lens"],
        c1["tables"], pool_base=c1["P"], pool_pages=c1["P"])[0]
    for t in (out1, c1["kp"], c1["vp"]):
        h1.update(t.view(torch.int16).cpu().numpy().tobytes())
    del c1, out1
res["b1_out_sha256"] = h1.hexdigest()[:16]
res["b1_ms"] = cs.time_ms(b1, iters=40)
res["b1_device_ms"] = cs.device_ms(b1, "paged_decode_", iters=40)
b, n_kv, d = c["q"].shape
cap = c["pp"] * cs.PAGE
tables = c["tables"].long()
kd = torch.cat([c["kp"][tables].permute(0, 2, 1, 3, 4).reshape(b, n_kv, cap, d),
                c["nk"][:, :, None]], dim=2).contiguous()
vd = torch.cat([c["vp"][tables].permute(0, 2, 1, 3, 4).reshape(b, n_kv, cap, d),
                c["nv"][:, :, None]], dim=2).contiguous()
pos = torch.arange(cap + 1, device="cuda")
att = (pos[None, :cap] < torch.clamp(c["lens"].long(), max=cap)[:, None]) \
    & (c["tables"] < P).repeat_interleave(cs.PAGE, dim=1)
mask = torch.cat([att, torch.ones_like(att[:, :1])], dim=1)[:, None, None, :]
qd = c["q"][:, :, None, :]
res["b1_sdpa_ms"] = cs.time_ms(
    lambda: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask),
    iters=40)
del kd, vd
# B8 at the backends' rung: absolute ids of each layer's region (row 30's
# id past the region reads its layer's page 0), as chip_smoke times it
local = torch.where(c["tables"] < P, c["tables"], 0)
absolute = [local + l * P for l in range(c["L"])]
nxt = cs.cycler(c["L"])

def b8():
    pa.fused_paged(c["q"], c["kp"], c["vp"], c["lens"], absolute[nxt()])
res["b8_ms"] = cs.time_ms(b8, iters=40)
res["b8_device_ms"] = cs.device_ms(b8, ("fused_",), iters=40)
att = (pos[None, :cap] < c["lens"].long()[:, None])[:, None, None, :]
kg = c["kp"][absolute[1].long()].permute(0, 2, 1, 3, 4).reshape(
    b, n_kv, cap, d).contiguous()
vg = c["vp"][absolute[1].long()].permute(0, 2, 1, 3, 4).reshape(
    b, n_kv, cap, d).contiguous()
res["b8_sdpa_ms"] = cs.time_ms(
    lambda: F.scaled_dot_product_attention(qd, kg, vg, attn_mask=att),
    iters=40)
del kg, vg
nxt = cs.cycler(c["L"])

def b9():
    pa.pallas_paged(c["q"], c["kp"], c["vp"], c["lens"], absolute[nxt()])
res["b9_ms"] = cs.time_ms(b9, iters=40)
res["b9_device_ms"] = cs.device_ms(b9, ("pallas_",), iters=40)
del absolute
# B8's and B6's outputs, bf16, at the check's (g, d) on inputs of their
# own generators: one hash each over all four
for name in ("b8", "b6"):
    hx, gx = hashlib.sha256(), torch.Generator(device="cuda")
    gx.manual_seed(2)
    for g, d in ((1, 128), (2, 64), (4, 256), (1, 96)):
        if name == "b8":
            cx = cs._decode_case(torch.bfloat16, gx, g=g, d=d)
            outx = pa.fused_paged(cx["q"], cx["kp"], cx["vp"], cx["lens"],
                                  cx["tables"] + cx["P"])
        else:
            cx = cs._decode_q_case(torch.bfloat16, gx, g=g, d=d)
            outx = pa.paged_decode_attention_inplace_q(
                *[cx[k] for k in ("q", "nk", "nv", "kq", "ks", "vq", "vs",
                                  "lens", "tables")],
                pool_base=0, pool_pages=cx["P"])[0]
        hx.update(outx.view(torch.int16).cpu().numpy().tobytes())
        del cx, outx
    res[f"{name}_out_sha256_4d"] = hx.hexdigest()[:16]
mem = pa.pool_membership(c["tables"], c["lens"], P, cs.PAGE)
nxt = cs.cycler(c["L"])

def b7():
    pa.stream_paged(c["q"], c["kp"], c["vp"], c["lens"], c["tables"],
                    pool_base=nxt() * P, pool_pages=P, membership=mem)
res["b7_ms"] = cs.time_ms(b7, iters=40)
res["b7_device_ms"] = cs.device_ms(b7, "stream_", iters=40)
for name in ("stream_partial", "stream_merge", "stream_walk"):
    res[f"b7_device_ms_{name}"] = cs.device_ms(b7, name, iters=40)
del c, mem
c = cs._decode_q_case(torch.bfloat16, gen)
nxt = cs.cycler(c["L"])
args = [c[k] for k in ("q", "nk", "nv", "kq", "ks", "vq", "vs", "lens",
                       "tables")]

out6 = pa.paged_decode_attention_inplace_q(*args, pool_base=0,
                                           pool_pages=c["P"])[0]
res["b6_out_sha256"] = hashlib.sha256(
    out6.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]

def b6():
    pa.paged_decode_attention_inplace_q(*args, pool_base=nxt() * c["P"],
                                        pool_pages=c["P"])
res["b6_ms"] = cs.time_ms(b6, iters=40)
res["b6_device_ms"] = cs.device_ms(b6, "paged_decode_q", iters=40)
del c, args
torch.cuda.empty_cache()
L, S, R, T, dt = cs.N_LAYERS, cs.LORA_SLOTS, 16, 8, torch.bfloat16
order, offsets, _ = tl.sort_by_adapter(cs._lora_rows(T, S, gen), S)
b16_ms = b16_dev = b5_dev = b5_ms = 0.0
for name, K, N, act in cs.A8W8_SHAPES:
    a = (torch.randn(L, S, K, R, generator=gen, device="cuda") * 0.02).to(dt)
    bk = (torch.randn(L, S, R, N, generator=gen, device="cuda") * 0.02).to(dt)
    xs = torch.randn(T, K, generator=gen, device="cuda").to(dt)
    nxt = cs.cycler(L)

    def b16():
        l = nxt()
        tl.lora_delta(xs, a[l], bk[l], offsets)
    b16_ms += cs.time_ms(b16, iters=40)
    b16_dev += cs.device_ms(b16, "lora_delta", iters=40)
    del a, bk
    wq, sc = cs._quantized(torch.randn(L, K, N, generator=gen,
                                       device="cuda") * 0.02)
    bias = (torch.randn(L, N, generator=gen, device="cuda") * 0.02).to(dt)
    xq, xsc = dynamic_act_quant(torch.randn(cs.BATCH, K, generator=gen,
                                            device="cuda").to(dt))

    def b5():
        l = nxt()
        sl._stream_linear_a8w8(xq, xsc, wq[l], sc[l], bias[l], act, dt)
    b5_ms += cs.time_ms(b5, iters=40)
    b5_dev += cs.device_ms(b5, ("a8w8_",), iters=40)
    del wq
res["b16_ms_4proj"] = b16_ms
res["b16_device_ms_4proj"] = b16_dev
res["b5_ms_4proj"] = b5_ms
res["b5_device_ms_4proj"] = b5_dev
torch.cuda.empty_cache()
if step:
    model = cs._build_model()
    cs.slice_decode_step(model, out, name=f"decode_step_bf16_{tag}")
    cs.slice_decode_step(model, out, quant="int8", kv_dtype="int8",
                         batch=2 * cs.BATCH, name=f"decode_step_int8kv_{tag}")
    # the stack is int8 now: the A8W8 step, whose B5 share this reads
    cs.slice_decode_step(model, out, quant="a8w8",
                         name=f"decode_step_a8w8_{tag}")
print(json.dumps(res), flush=True)
"""


def _build_variants(names, out_dir: str) -> dict:
    """{name: (library, loaded library)} of the design and each variant."""
    from paddle_tpu_torch import _kernels

    jobs = []
    designs = dict.fromkeys("design_" + VARIANTS[n][1] for n in names)
    for name in list(designs) + list(names):
        design = name.startswith("design_")
        lib = name[len("design_"):] if design else VARIANTS[name][1]
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(_kernels._CSRC):
            if f.endswith(".cuh") or f == f"{lib}.cu":
                with open(os.path.join(_kernels._CSRC, f)) as fh:
                    text = fh.read()
                if f == f"{lib}.cu" and not design:
                    for old, new in VARIANTS[name][2].items():
                        if old not in text:
                            raise SystemExit(f"variant {name}: {old[:60]!r}"
                                             " is not in the source")
                        text = text.replace(old, new)
                with open(os.path.join(d, f), "w") as fh:
                    fh.write(text)
        so = os.path.join(out_dir, f"lib{lib}-{name}.so")
        cmd = [_kernels._nvcc(), *_kernels._FLAGS, "-o", so,
               os.path.join(d, f"{lib}.cu")]
        jobs.append((name, lib, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for name, lib, so, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{(out + err)[-3000:]}")
        handle = ctypes.CDLL(so)
        for fn, argtypes in _kernels._SIGNATURES[lib].items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
        libs[name] = (lib, handle)
    return libs


def _variant_times(cs, names, out_dir: str, rounds: int,
                   b5_caps=(8,)) -> None:
    """Device ms of B1, B5, B6 or B7 (by its variants' library) at the
    rung, for the design and each variant in turns; B5's four projections
    each apart, at each split cap of ``b5_caps`` (``a8w8_plan``'s most
    slices)."""
    import torch

    from paddle_tpu_torch import _kernels
    from paddle_tpu_torch.nn.functional import paged_attention as pa

    libs = _build_variants(names, out_dir)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    c6 = cs._decode_q_case(torch.bfloat16, gen)
    c7 = cs._decode_case(torch.bfloat16, gen)
    mem = pa.pool_membership(c7["tables"], c7["lens"], c7["P"], cs.PAGE)
    c1 = cs._decode_case(torch.bfloat16, gen)
    n1 = cs.cycler(c1["L"])
    n6, n7 = cs.cycler(c6["L"]), cs.cycler(c7["L"])
    args6 = [c6[k] for k in ("q", "nk", "nv", "kq", "ks", "vq", "vs",
                             "lens", "tables")]

    def b6():
        pa.paged_decode_attention_inplace_q(*args6, pool_base=n6() * c6["P"],
                                            pool_pages=c6["P"])

    def b7():
        pa.stream_paged(c7["q"], c7["kp"], c7["vp"], c7["lens"],
                        c7["tables"], pool_base=n7() * c7["P"],
                        pool_pages=c7["P"], membership=mem)

    def b1():
        pa.paged_decode_attention_inplace(
            c1["q"], c1["nk"], c1["nv"], c1["kp"], c1["vp"], c1["lens"],
            c1["tables"], pool_base=n1() * c1["P"], pool_pages=c1["P"])
    from paddle_tpu_torch.nn.functional import stream_linear as sl
    from paddle_tpu_torch.quantization.dynamic import dynamic_act_quant

    L, dt = cs.N_LAYERS, torch.bfloat16
    projs = []
    for _, K, N, act in cs.A8W8_SHAPES:
        wq, sc = cs._quantized(torch.randn(L, K, N, generator=gen,
                                           device="cuda") * 0.02)
        bias = (torch.randn(L, N, generator=gen, device="cuda")
                * 0.02).to(dt)
        xq, xsc = dynamic_act_quant(torch.randn(cs.BATCH, K, generator=gen,
                                                device="cuda").to(dt))
        projs.append((xq, xsc, wq, sc, bias, act))
    n5 = cs.cycler(L)

    def b5_times() -> dict:
        """{projection: device ms a launch, "four": their sum} at each
        cap"""
        out = {}
        for cap in b5_caps:
            sl._A8W8_MAX_SPLIT = cap
            row = {}
            for (name, *_), (xq, xsc, wq, sc, bias, act) in zip(
                    cs.A8W8_SHAPES, projs):
                def one():
                    l = n5()
                    sl._stream_linear_a8w8(xq, xsc, wq[l], sc[l], bias[l],
                                           act, dt)
                row[name] = cs.device_ms(one, cs.B5_KERNEL, iters=40,
                                         per_call=1)
            row["four"] = sum(row.values())
            out[f"cap_{cap}"] = row
        sl._A8W8_MAX_SPLIT = saved_cap
        return out
    saved_cap = sl._A8W8_MAX_SPLIT
    timed = {"paged_attention_q": (b6, cs.B6_KERNEL),
             "paged_backends": (b7, cs.B7_KERNELS),
             "paged_attention": (b1, cs.B1_KERNEL)}
    # launches a call: the profiler's mean a launch times these stays
    # right when it drops some of a long process's events
    per_call = {"paged_attention_q": 1, "paged_backends": 2,
                "paged_attention": 1}
    order = list(libs) + list(reversed(list(libs)))
    for _ in range(rounds):
        for name in order:
            lib, handle = libs[name]
            _kernels._LIBS[lib] = handle
            if lib == "stream_linear_a8w8":
                ms = b5_times()
            else:
                fn, kernel = timed[lib]
                ms = cs.device_ms(fn, kernel, iters=40,
                                  per_call=per_call[lib])
            _emit(json.dumps({"variant": name, "library": lib,
                              "device_ms": ms,
                              "what": VARIANTS[name][0]
                              if name in VARIANTS else "the design"}),
                  out_dir)
    _kernels._LIBS.clear()


def _emit(line: str, out: str) -> None:
    """A result line to stdout and to ``out``/results.jsonl."""
    print(line, flush=True)
    with open(os.path.join(out, "results.jsonl"), "a") as f:
        f.write(line + "\n")


def _run(root: str, tag: str, step: bool, out: str) -> None:
    proc = subprocess.run([sys.executable, "-c", _MEASURE, tag,
                           "1" if step else "0", out], cwd=root,
                          capture_output=True, text=True, timeout=1500)
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            _emit(line, out)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr, flush=True)
        raise SystemExit(f"probe: the {tag} tree failed "
                         f"(exit {proc.returncode})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--variants", default="")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--b5-caps", default="8")
    ap.add_argument("--out", default=os.path.join(
        HERE, "paddle_tpu_torch", "_build", "probe_decode_attn"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe: no CUDA device is visible")
    os.makedirs(args.out, exist_ok=True)
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    _emit(json.dumps({"device": cs.phase_device()}), args.out)
    if args.check:
        cs.phase_build(args.out)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        cs.kernel_paged_attention(gen)
        cs.kernel_paged_attention_q(gen)
        cs.kernel_paged_backends(gen)
        cs.kernel_lora_delta(gen)
        cs.kernel_stream_linear_a8w8(gen)
        torch.cuda.empty_cache()
    if args.variants:
        names = [n for n in args.variants.split(",") if n]
        unknown = set(names) - set(VARIANTS)
        if unknown:
            raise SystemExit(f"probe: unknown variants {sorted(unknown)}")
        _variant_times(cs, names, args.out, args.rounds,
                       tuple(int(c) for c in args.b5_caps.split(",")))
        torch.cuda.empty_cache()
    order = [("this", HERE)]
    if args.parent:
        parent = os.path.abspath(args.parent)
        order = [("parent", parent), ("this", HERE), ("this", HERE),
                 ("parent", parent)]
    for _ in range(args.rounds):
        for tag, root in order:
            _run(root, tag, args.step, os.path.abspath(args.out))


if __name__ == "__main__":
    main()
