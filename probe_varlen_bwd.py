"""Probes of the packed varlen backward kernels B12 and B13 on one card.

    python3 probe_varlen_bwd.py [--variants all|NAME,...]
                                [--packs rung,ragged,short,one_causal]
                                [--out DIR]

Builds ``paddle_tpu_torch/csrc/flash_varlen_packed.cu`` as it stands
("design") and as each named variant (text substitutions of the source:
ablations, and the alternatives that were measured against the design;
``VARIANTS`` below) into libraries of their own, one nvcc each, all
started together. It checks the design's build with
``chip_smoke.kernel_flash_varlen`` (every ``VARLEN_CASES`` case, no
timing), then times B12 (dq) and B13 (dk/dv) by the profiler (device ms
of the kernels alone) on each pack, for every build in turns (design,
variants..., variants reversed, design), inputs and the block map made
once per pack. Packs: the rung (8 causal segments of 4096), the ragged
72-document pack of ``VARLEN_CASES``, 32 causal documents of 1024 and
one causal segment of 32768; h16, d128, bf16. Prints the card's name and
power limit first, then one JSON line per pack and build with both
kernels' device ms and TFLOP/s. Needs one card and nvcc; imports nothing
of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = "flash_varlen_packed"

#: name -> (what it changes, {old text: new text} in flash_varlen_packed.cu)
VARIANTS = {
    "no_mask": (
        "the interior flag forced true: no visibility pass (its cost; "
        "wrong on boundary tiles)",
        {"if (!flags[kst]) {": "if (false) {",
         "if (!flags[st]) {": "if (false) {"}),
    "no_exp": (
        "P = S - lse without the exponential (the exponentials' cost; "
        "wrong values)",
        {"sc[e] = ex2(fmaf(sc[e], sl2, nl2[h])) * (dp[e] - dl[h]);":
         "sc[e] = fmaf(sc[e], sl2, nl2[h]) * (dp[e] - dl[h]);",
         "sc[4 * jj + cc] = ex2(fmaf(sc[4 * jj + cc], sl2, cc & 1 ? nl1 : "
         "nl0));":
         "sc[4 * jj + cc] = fmaf(sc[4 * jj + cc], sl2, cc & 1 ? nl1 : "
         "nl0);"}),
    "heads_fastest": (
        "one block a (head, tile), heads fastest",
        {"  const int hi = blockIdx.y, i = p.order[blockIdx.x];\n"
         "  const int q0 = i * kFwdM, ks = p.start[i], n = 2 * p.len[i];":
         "  const int hi = blockIdx.x, i = p.order[blockIdx.y];\n"
         "  const int q0 = i * kFwdM, ks = p.start[i], n = 2 * p.len[i];",
         "const int hi = blockIdx.y, j = p.order[blockIdx.x];":
         "const int hi = blockIdx.x, j = p.order[blockIdx.y];",
         "kernel<<<dim3(tiles, p.h), kFwdThreads":
         "kernel<<<dim3(p.h, tiles), kFwdThreads"}),
    "dkv_fused_issue": (
        "B13 issues dV's product after dS^T is formed, beside dK's",
        {"    hp::wgmma_fence();\n"
         "    wgmma_xb64<D>(dv, pa, dot);  // dV's product runs while dS^T "
         "is formed\n    hp::wgmma_commit();\n": "",
         "    hp::wgmma_fence();\n    wgmma_xb64<D>(dk, dsa, qt);":
         "    hp::wgmma_fence();\n    wgmma_xb64<D>(dv, pa, dot);\n"
         "    wgmma_xb64<D>(dk, dsa, qt);"}),
}

PACKS = ("rung", "ragged", "short", "one_causal")


def _pack_lens(name: str, cs) -> list:
    return {"rung": cs.VARLEN_LENS, "ragged": cs.VARLEN_CASES[1][1],
            "short": [1024] * 32, "one_causal": [32768]}[name]


def build(names, out_dir: str) -> dict:
    """{build name: loaded library} of the design and each variant."""
    from paddle_tpu_torch import _kernels

    src_dir = str(_kernels._CSRC)
    jobs = {}
    for name in ["design", *names]:
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        for f in os.listdir(src_dir):
            if not f.endswith((".cu", ".cuh")):
                continue
            with open(os.path.join(src_dir, f)) as fh:
                text = fh.read()
            if f == f"{NAME}.cu" and name != "design":
                for old, new in VARIANTS[name][1].items():
                    if old not in text:
                        raise SystemExit(f"variant {name}: {old[:60]!r} is "
                                         "not in the source")
                    text = text.replace(old, new)
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        so = os.path.join(d, f"lib{NAME}.so")
        cmd = [_kernels._nvcc(), *_kernels._FLAGS, "-o", so,
               os.path.join(d, f"{NAME}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True), so)
    libs = {}
    for name, (proc, so) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{(out + err)[-3000:]}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in _kernels._SIGNATURES[NAME].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="all")
    ap.add_argument("--packs", default=",".join(PACKS))
    ap.add_argument("--out", default=os.path.join(HERE, "paddle_tpu_torch",
                                                  "_build", "probe"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_varlen_bwd: no CUDA device is visible")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from paddle_tpu_torch import _kernels
    from paddle_tpu_torch.nn.functional import flash_varlen as fv

    names = list(VARIANTS) if args.variants == "all" else \
        [n for n in args.variants.split(",") if n]
    cs.phase_device()
    t0 = time.perf_counter()
    libs = build(names, args.out)
    print(json.dumps({"built": list(libs), "wall_s":
                      time.perf_counter() - t0}), flush=True)
    _kernels._LIBS[NAME] = libs["design"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cs._varlen_pad_times = lambda gen, d: None
    cs._varlen_times = lambda gen, res: {}
    cs.kernel_flash_varlen(gen)
    h, d, dt = 16, 128, torch.bfloat16
    for pack in args.packs.split(","):
        lens = _pack_lens(pack, cs)
        T, scale, cu = sum(lens), d ** -0.5, cs._cu(lens)
        _kernels._LIBS[NAME] = libs["design"]
        sets = []
        for _ in range(2):
            q, k, v, do = cs._varlen_inputs(gen, T, T, h, d, dt)
            out, lse = fv.packed_fwd(q, k, v, cu, cu, scale=scale,
                                     causal=True)
            sets.append((q, k, v, do, lse,
                         fv.packed_delta(out, do, lse.shape[1])))
        maps = fv.CardMaps(cu, cu, T, T, True)
        nxt = cs.cycler(len(sets))
        bounds = cs._varlen_bounds(T, T, h, d,
                                   cs._varlen_pairs(lens, lens, True), dt)

        def dq():
            q, k, v, do, lse, delta = sets[nxt()]
            fv._varlen_bwd_dq_cuda(q, k, v, do, lse, delta, cu, cu, True,
                                   scale, maps)

        def dkv():
            q, k, v, do, lse, delta = sets[nxt()]
            fv._varlen_bwd_dkv_cuda(q, k, v, do, lse, delta, cu, cu, True,
                                    scale, maps)
        order = list(libs) + list(libs)[::-1]
        for name in order:
            _kernels._LIBS[NAME] = libs[name]
            ms = {"dq": cs.device_ms(dq, "varlen_bwd_dq", iters=10),
                  "dkv": cs.device_ms(dkv, "varlen_bwd_dkv", iters=10)}
            print(json.dumps({
                "pack": pack, "build": name, "tokens": T,
                "documents": len(lens), "dq_device_ms": ms["dq"],
                "dkv_device_ms": ms["dkv"],
                "dq_tflops": bounds["dq"][1] / ms["dq"] / 1e9,
                "dkv_tflops": bounds["dkv"][1] / ms["dkv"] / 1e9,
                "what": VARIANTS[name][0] if name in VARIANTS else
                "the source as it stands"}), flush=True)
        del sets, maps
        torch.cuda.empty_cache()
    _kernels._LIBS[NAME] = libs["design"]


if __name__ == "__main__":
    main()
