"""Probes of the decode attention kernels B6 and B7 on one card.

    python3 probe_decode_attn.py [--check] [--parent DIR] [--step]
                                 [--variants NAME,...] [--rounds N]
                                 [--out DIR]

``--check`` first runs ``chip_smoke.phase_build`` and the B6 and B7-B9
kernel checks (``kernel_paged_attention_q``, ``kernel_paged_backends``)
on this tree. Then, for this tree and, with ``--parent DIR`` (another
tree's root, e.g. the parent commit unpacked by ``git archive`` into a
git-ignored directory), for that tree too, in turns (parent, this, this,
parent; ``--rounds`` times over), one process each:
  - B6 (int8-KV decode attention, bf16) at the int8-KV rung's inputs
    (``chip_smoke._decode_q_case``: b64, 16 kv heads of 128, page 16, 17
    pages a row), alternating over its 2 layers: CUDA events ms a call
    and the profiler's device ms of the kernels named ``paged_decode_q``;
  - B7 (``stream_paged``, bf16) at the decode backends' rung
    (``chip_smoke._decode_case``: b32 g1 d128 over a 545-page region,
    rotating over 4 layers): events ms a call, the device ms of every
    ``stream_`` kernel a call and of each kernel name apart;
  - with ``--step``, the int8-KV decode step (``chip_smoke``'s
    ``slice_decode_step`` on the d2048·L24 stack quantized to int8
    weights and an int8 pool, b64 at context 128): its device ms by
    group, B6's among them.
With ``--variants`` (names of ``VARIANTS`` below: text substitutions
of one kernel source, ablations of the design), each variant and the
design are built into libraries of their own, one nvcc each, all started
together, and timed in this process in turns (design, variants...,
variants reversed, design) by the profiler's device ms of their kernel
at the same inputs. Prints the card's name and power limit first, then
one JSON line per tree, variant and reading. Needs one card and nvcc;
imports nothing of JAX.
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
_MEASURE = r'''
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from paddle_tpu_torch import _kernels
from paddle_tpu_torch.nn.functional import paged_attention as pa

tag, step, out = sys.argv[1], sys.argv[2] == "1", sys.argv[3]
_kernels.build(["paged_attention_q", "paged_backends", "stream_linear",
                "paged_attention"])
gen = torch.Generator(device="cuda")
gen.manual_seed(0)
res = {"tree": tag}
c = cs._decode_q_case(torch.bfloat16, gen)
nxt = cs.cycler(c["L"])
args = [c[k] for k in ("q", "nk", "nv", "kq", "ks", "vq", "vs", "lens",
                       "tables")]

def b6():
    pa.paged_decode_attention_inplace_q(*args, pool_base=nxt() * c["P"],
                                        pool_pages=c["P"])
res["b6_ms"] = cs.time_ms(b6, iters=40)
res["b6_device_ms"] = cs.device_ms(b6, "paged_decode_q", iters=40)
del c, args
c = cs._decode_case(torch.bfloat16, gen)
P = c["P"]
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
torch.cuda.empty_cache()
if step:
    model = cs._build_model()
    cs.slice_decode_step(model, out, quant="int8", kv_dtype="int8",
                         batch=2 * cs.BATCH, name=f"decode_step_int8kv_{tag}")
print(json.dumps(res), flush=True)
'''


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


def _variant_times(cs, names, out_dir: str, rounds: int) -> None:
    """Device ms of B6 or B7 (by its variants' library) at the rung, for
    the design and each variant in turns."""
    import torch

    from paddle_tpu_torch import _kernels
    from paddle_tpu_torch.nn.functional import paged_attention as pa

    libs = _build_variants(names, out_dir)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    c6 = cs._decode_q_case(torch.bfloat16, gen)
    c7 = cs._decode_case(torch.bfloat16, gen)
    mem = pa.pool_membership(c7["tables"], c7["lens"], c7["P"], cs.PAGE)
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
    order = list(libs) + list(reversed(list(libs)))
    for _ in range(rounds):
        for name in order:
            lib, handle = libs[name]
            _kernels._LIBS[lib] = handle
            fn, kernel = ((b6, cs.B6_KERNEL) if lib == "paged_attention_q"
                          else (b7, cs.B7_KERNELS))
            ms = cs.device_ms(fn, kernel, iters=40)
            print(json.dumps({"variant": name, "library": lib,
                              "device_ms": ms,
                              "what": VARIANTS[name][0]
                              if name in VARIANTS else "the design"}),
                  flush=True)
    _kernels._LIBS.clear()


def _run(root: str, tag: str, step: bool, out: str) -> None:
    proc = subprocess.run([sys.executable, "-c", _MEASURE, tag,
                           "1" if step else "0", out], cwd=root,
                          capture_output=True, text=True, timeout=1500)
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            print(line, flush=True)
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
    ap.add_argument("--out", default=os.path.join(
        HERE, "paddle_tpu_torch", "_build", "probe_decode_attn"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe: no CUDA device is visible")
    os.makedirs(args.out, exist_ok=True)
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    cs.phase_device()
    if args.check:
        cs.phase_build(args.out)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        cs.kernel_paged_attention_q(gen)
        cs.kernel_paged_backends(gen)
        torch.cuda.empty_cache()
    if args.variants:
        names = [n for n in args.variants.split(",") if n]
        unknown = set(names) - set(VARIANTS)
        if unknown:
            raise SystemExit(f"probe: unknown variants {sorted(unknown)}")
        _variant_times(cs, names, args.out, args.rounds)
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
