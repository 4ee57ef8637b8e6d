"""Probes of dense flash attention B10 (and B11-B13 beside it) on one card.

    python3 probe_flash_dense.py [--variants all|NAME,...] [--parent DIR]
                                 [--shapes rung,760m,moe] [--check]
                                 [--rounds N] [--out DIR]

Builds ``paddle_tpu_torch/csrc/flash_attention.cu`` and
``flash_varlen_packed.cu`` as they stand ("design") and each named
variant (text substitutions of one of them and the headers it includes,
``VARIANTS`` below: ablations and the alternatives measured against the
design) into libraries of their own, one nvcc each, all started
together; with ``--parent DIR`` (the ``csrc/`` of another tree, e.g. the
parent commit unpacked by ``git archive`` into a git-ignored directory)
also that tree's two. ``--check`` runs
``chip_smoke.kernel_flash_attention``'s cases on the design first. Then
it times B10's three kernels by the profiler (device ms of the kernels
alone, the names of ``chip_smoke.B10_KERNELS`` or, for the parent, the
mma.sync ``flash_*_bf16``) at the training rungs' shapes (bf16, causal,
s1024 h16: the 1.3b rung b4 d128, the 760m rung b8 d96, the MoE rung b4
d64), for every build of that library in turns (parent, design,
variants..., variants reversed, design, parent); with ``--parent`` or a
variant of ``flash_varlen_packed``, B11-B13 at the varlen rung (8 causal
segments of 4096, h16 d128) in the same turns, ``--rounds`` times over
(40 calls a reading). Prints the card's name and power limit
first, then one JSON line per shape and build. Needs one card and nvcc;
imports nothing of JAX.
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

#: name -> (what it changes, the library it builds, {old text: new text}
#: in that library's .cu or a header under csrc/; each old text must occur
#: in one of them)
VARIANTS = {
    "register_store": (
        "the forward stores out from registers, not through shared memory "
        "by TMA", "flash_attention",
        {"  static constexpr bool kTmaStore = true;":
         "  static constexpr bool kTmaStore = false;"}),
    "no_mask": (
        "the interior flag forced true: no mask pass (its cost; wrong on "
        "boundary tiles)", "flash_attention",
        {"if (!flags[st])": "if (false)", "if (!flags[kst])": "if (false)"}),
    "one_step": (
        "every forward block walks one key tile (a block's fixed cost "
        "plus one step; wrong outputs)", "flash_attention",
        {"      n = (seen + step - 1) / step;":
         "      n = K == kFwd ? 1 : (seen + step - 1) / step;"}),
    "unit_a_block": (
        "one block a fold unit (two tiles), the hardware's scheduler "
        "balancing them", "flash_attention",
        {"  p.fold = (units + sms - 1) / sms;": "  p.fold = 1;"}),
    "varlen_grid_constant": (
        "the varlen kernels take their parameters as __grid_constant__ "
        "(PR 13's first design)", "flash_varlen_packed",
        {"const VarlenParams p)": "const __grid_constant__ VarlenParams p)"}),
    "varlen_lse_tested": (
        "B11's lse store behind a row test, as B10's (PR 13's first design "
        "ran both so)", "flash_varlen_packed",
        {"    p.lse[static_cast<int64_t>(hi) * p.tq_pad + row] = v;":
         "    if (row < p.tq_pad)\n"
         "      p.lse[static_cast<int64_t>(hi) * p.tq_pad + row] = v;"}),
}

#: (name, b, s, h, d) of the training rungs' attention
SHAPES = {"rung": (4, 1024, 16, 128), "760m": (8, 1024, 16, 96),
          "moe": (4, 1024, 16, 64)}
OLD_NAMES = {"fwd": "flash_fwd_bf16", "dq": "flash_bwd_dq_bf16",
             "dkv": "flash_bwd_dkv_bf16"}


def _load(so: str, lib: str):
    from paddle_tpu_torch import _kernels

    handle = ctypes.CDLL(so)
    for fn, argtypes in _kernels._SIGNATURES[lib].items():
        getattr(handle, fn).argtypes = argtypes
        getattr(handle, fn).restype = ctypes.c_int
    return handle


def build(names, parent, out_dir: str) -> dict:
    """{build name: {library: loaded library}}: the design's two flash
    libraries, each variant's one, and the parent's two."""
    from paddle_tpu_torch import _kernels

    src_dir = str(_kernels._CSRC)
    jobs = []
    for name, lib in [("design", "flash_attention"),
                      ("design", "flash_varlen_packed"),
                      *((n, VARIANTS[n][1]) for n in names)]:
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        subs = {} if name == "design" else dict(VARIANTS[name][2])
        found = set()
        for f in os.listdir(src_dir):
            if not f.endswith(".cuh") and f != f"{lib}.cu":
                continue
            with open(os.path.join(src_dir, f)) as fh:
                text = fh.read()
            for old, new in subs.items():
                if old in text:
                    found.add(old)
                    text = text.replace(old, new)
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        for old in set(subs) - found:
            raise SystemExit(f"variant {name}: {old[:60]!r} is not in the "
                             "sources")
        jobs.append((name, lib, d))
    if parent:
        jobs += [("parent", lib, parent) for lib in
                 ("flash_attention", "flash_varlen_packed")]
    procs = []
    for name, lib, d in jobs:
        so = os.path.join(out_dir, f"lib{lib}-{name}.so")
        cmd = [_kernels._nvcc(), *_kernels._FLAGS, "-o", so,
               os.path.join(d, f"{lib}.cu")]
        procs.append((name, lib, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for name, lib, so, proc in procs:
        out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name} {lib}:\n"
                             f"{(out + err)[-3000:]}")
        libs.setdefault(name, {})[lib] = _load(so, lib)
    return libs


def _b10_times(cs, gen, libs, shape) -> None:
    from paddle_tpu_torch import _kernels
    from paddle_tpu_torch.nn.functional import attention as at

    b, s, h, d = SHAPES[shape]
    scale, dt = d ** -0.5, torch.bfloat16
    _kernels._LIBS["flash_attention"] = libs["design"]["flash_attention"]
    sets = []
    for _ in range(2):
        q, k, v, do = cs._flash_inputs(gen, b, s, h, d, dt)
        out, lse = at.flash_attention_fwd(q, k, v, True, scale)
        sets.append((q, k, v, do, lse, at.flash_delta(out, do)))
    nxt = cs.cycler(len(sets))
    bounds = cs._flash_bounds(b, s, s, h, d, True, dt)
    order = _order(libs, "flash_attention")

    def fwd():
        q, k, v = sets[nxt()][:3]
        at._flash_fwd_cuda(q, k, v, True, scale)

    def dq():
        q, k, v, do, lse, di = sets[nxt()]
        at._flash_bwd_dq_cuda(q, k, v, do, lse, di, True, scale)

    def dkv():
        q, k, v, do, lse, di = sets[nxt()]
        at._flash_bwd_dkv_cuda(q, k, v, do, lse, di, True, scale)
    for name in order:
        _kernels._LIBS["flash_attention"] = libs[name]["flash_attention"]
        names = OLD_NAMES if name == "parent" else cs.B10_KERNELS
        ms = {n: cs.device_ms(fn, names[n]) for n, fn in
              (("fwd", fwd), ("dq", dq), ("dkv", dkv))}
        print(json.dumps({
            "shape": shape, "bshd": [b, s, h, d], "build": name,
            **{f"{n}_device_ms": v for n, v in ms.items()},
            **{f"{n}_tflops": bounds[n][1] / v / 1e9 if v else None
               for n, v in ms.items()},
            "what": VARIANTS[name][0] if name in VARIANTS else
            "the parent tree" if name == "parent" else
            "the source as it stands"}), flush=True)
    _kernels._LIBS["flash_attention"] = libs["design"]["flash_attention"]


def _order(libs, lib: str) -> list:
    """The builds holding ``lib``, in turns: the parent first and last,
    the design second and second to last, the variants between, forward
    then backward."""
    names = [n for n in libs if lib in libs[n] and n != "parent"]
    order = names + names[::-1]
    return ["parent", *order, "parent"] if "parent" in libs else order


def _varlen_times(cs, gen, libs, rounds: int) -> None:
    from paddle_tpu_torch import _kernels
    from paddle_tpu_torch.nn.functional import flash_varlen as fv

    lens, h, d, dt = cs.VARLEN_LENS, 16, 128, torch.bfloat16
    T, scale, cu = sum(lens), d ** -0.5, cs._cu(lens)
    sets = []
    for _ in range(2):
        q, k, v, do = cs._varlen_inputs(gen, T, T, h, d, dt)
        out, lse = fv.packed_fwd(q, k, v, cu, cu, scale=scale, causal=True)
        sets.append((q, k, v, do, lse, fv.packed_delta(out, do,
                                                       lse.shape[1])))
    maps = fv.CardMaps(cu, cu, T, T, True)
    nxt = cs.cycler(len(sets))

    def fwd():
        q, k, v = sets[nxt()][:3]
        fv._varlen_fwd_cuda(q, k, v, cu, cu, True, scale, maps)

    def dq():
        q, k, v, do, lse, delta = sets[nxt()]
        fv._varlen_bwd_dq_cuda(q, k, v, do, lse, delta, cu, cu, True, scale,
                               maps)

    def dkv():
        q, k, v, do, lse, delta = sets[nxt()]
        fv._varlen_bwd_dkv_cuda(q, k, v, do, lse, delta, cu, cu, True,
                                scale, maps)
    for name in _order(libs, "flash_varlen_packed") * rounds:
        _kernels._LIBS["flash_varlen_packed"] = \
            libs[name]["flash_varlen_packed"]
        print(json.dumps({
            "shape": "varlen_rung", "build": name,
            "fwd_device_ms": cs.device_ms(fwd, cs.B11_KERNEL, iters=40),
            "dq_device_ms": cs.device_ms(dq, cs.B12_KERNEL, iters=40),
            "dkv_device_ms": cs.device_ms(dkv, cs.B13_KERNEL, iters=40),
            "what": VARIANTS[name][0] if name in VARIANTS else
            "the parent tree" if name == "parent" else
            "the source as it stands"}), flush=True)
    _kernels._LIBS["flash_varlen_packed"] = \
        libs["design"]["flash_varlen_packed"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="all")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--rounds", type=int, default=1,
                    help="repeats of the B11-B13 turns")
    ap.add_argument("--out", default=os.path.join(HERE, "paddle_tpu_torch",
                                                  "_build", "probe_dense"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_flash_dense: no CUDA device is visible")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from paddle_tpu_torch import _kernels

    names = list(VARIANTS) if args.variants == "all" else \
        [n for n in args.variants.split(",") if n]
    cs.phase_device()
    t0 = time.perf_counter()
    libs = build(names, args.parent, args.out)
    print(json.dumps({"built": list(libs), "wall_s":
                      time.perf_counter() - t0}), flush=True)
    _kernels._LIBS["flash_attention"] = libs["design"]["flash_attention"]
    _kernels._LIBS["flash_varlen_packed"] = \
        libs["design"]["flash_varlen_packed"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if args.check:
        cs._flash_times = lambda *a, **k: {n: {} for n in
                                           ("fwd", "dq", "dkv")}
        cs._flash_pad_times = lambda gen, d: None
        try:
            cs.kernel_flash_attention(gen)
        except KeyError:
            pass  # the rung's timing rows, left out above
    for shape in args.shapes.split(","):
        _b10_times(cs, gen, libs, shape)
        torch.cuda.empty_cache()
    if args.parent or any(VARIANTS[n][1] == "flash_varlen_packed"
                          for n in names):
        _varlen_times(cs, gen, libs, args.rounds)


if __name__ == "__main__":
    main()
