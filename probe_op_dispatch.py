"""Probe of what the kernels' ``torch.library`` dispatch costs the decode
step, and what it does to the padded flash backward, on one card.

    python3 probe_op_dispatch.py --parent DIR [--rounds N] [--chunks N]
                                 [--out DIR]

For this tree and the tree at ``--parent`` (another tree's root, e.g.
the parent commit unpacked by ``git archive`` into a git-ignored
directory), in turns (parent, this, this, parent; ``--rounds`` times
over), one process each, on the d2048·L24 bf16 decode model
(``chip_smoke._build_model``) at batch 32, context 128: about 170 kernel
launches a step (24 B1, 2 B2, 144 of B3's GEMM and LayerNorm: 50 op
calls, the tail one op a layer). In a tree whose kernels are ops, two
routes share the process: as the wrappers call their ops
(``_kernels.call``, ``route: call``: the implementation itself in plain
eager code) and with every call dispatched (``route: op``). Readings,
one JSON line each:

- ``host_us_per_call`` (ops only): one call of each op of the step
  (B2's GEMM, B3's tail, B1) dispatched (``op``), through
  ``_kernels.call`` (``call``) and to its implementation (``impl``),
  2000 calls at a size the host paces, in turns, synchronized at the
  end of each run;
- ``decode_step`` a route (``chip_smoke.slice_decode_step``): the wall
  of three bare 16-step chunks, and the profiler's device busy ms and
  idle share of a fourth;
- ``decode_chunks``: ``--chunks`` bare 16-step chunks a route, the
  routes alternating chunk by chunk (call, op, op, call, ...): every
  chunk's wall per step, each route's median and quartiles, and the
  median and quartiles of the paired differences (op - call);
- the padded flash timings of ``chip_smoke`` (``flash_attention_d80``,
  ``flash_attention_d200``: B10's public forward and backward at a head
  width padded to a built one; ``flash_varlen_d40``: B11-B13's), once a
  process.

Prints the card's name and power limit first, then every line, each also
appended to ``--out``/results.jsonl. Needs one card and nvcc; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

#: run inside a tree's root: its own chip_smoke and paddle_tpu_torch
_MEASURE = r"""
import contextlib, json, sys, time, numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from paddle_tpu_torch import _kernels
from paddle_tpu_torch.nn.functional import paged_attention as pa
from paddle_tpu_torch.nn.functional import stream_linear as sl

tag, chunks = sys.argv[1], int(sys.argv[2])
ops = hasattr(sl, "_gemm_op")
_kernels.build(["paged_attention", "stream_linear", "flash_attention",
                "flash_varlen_packed"])
emit = cs.emit
route = ["parent"]
cs.emit = lambda obj: emit({"tree": tag, "route": route[0], **obj}
                           if isinstance(obj, dict) else obj)


@contextlib.contextmanager
def routed(r):
    # "op": every wrapper's call dispatched
    route[0] = r
    if r != "op":
        yield
        return
    saved = _kernels.call
    _kernels.call = lambda op, *args: op(*args)
    try:
        yield
    finally:
        _kernels.call = saved


def host_us(fn, n=2000):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def spread(xs):
    q1, q2, q3 = np.percentile(xs, [25, 50, 75])
    return {"median": float(q2), "quartiles": [float(q1), float(q3)]}


if ops:
    # one call of each decode-path op against its implementation, at
    # sizes where the host sets the pace
    bf = torch.bfloat16
    x = torch.randn(32, 256, device="cuda").to(bf)
    w = torch.randn(256, 256, device="cuda").to(bf)
    bias = torch.zeros(256, device="cuda").to(bf)
    h = torch.zeros(32, 256, device="cuda").to(bf)
    one = torch.ones(256, device="cuda")
    gemm = (x, w, bias, None, torch.float32, None)
    tail = (x, h, w, w, w, bias, bias, bias, one, bias, 1e-5, "gelu", None,
            None, None, w, bias, one, bias, None, bf)
    c = cs._decode_case(bf, torch.Generator(device="cuda").manual_seed(0))
    dec = (c["q"], c["nk"], c["nv"], c["kp"], c["vp"], c["lens"],
           c["tables"], 0, c["P"])
    calls = {"stream_gemm": (sl._gemm_op, gemm),
             "stream_layer_tail": (sl._tail_op, tail),
             "paged_decode": (pa._decode_op, dec)}
    for name, (op, args) in calls.items():
        fns = {"op": lambda: op(*args),
               "call": lambda: _kernels.call(op, *args),
               "impl": lambda: _kernels._IMPLS[op](*args)}
        runs = {k: [] for k in fns}
        for which in ("impl", "call", "op", "op", "call", "impl"):
            runs[which].append(host_us(fns[which]))
        emit({"tree": tag, "reading": "host_us_per_call", "name": name,
              **runs})
routes = ("call", "op") if ops else ("parent",)
model = cs._build_model()
for r in routes:
    with routed(r):
        cs.slice_decode_step(model, None)
steps = 16
s = cs._prefilled(model, cs.BATCH, steps, seed=3)


def timed():
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s["eng"]._decode_k_fn(s["w"], s["emb"], s["head"], s["lnf_s"],
                          s["lnf_b"], s["tok"], s["lens"], s["ck"],
                          s["cv"], s["tables"], k=steps)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


timed()
walls = {r: [] for r in routes}
for i in range(chunks):
    for r in routes if i % 2 == 0 else routes[::-1]:
        with routed(r):
            walls[r].append(timed())
line = {"tree": tag, "reading": "decode_chunks", "batch": cs.BATCH,
        "context": cs.PROMPT, "steps": steps,
        "wall_ms_per_step": {r: spread(v) for r, v in walls.items()},
        "wall_ms_per_step_chunks": walls}
if ops:
    line["op_minus_call_ms"] = spread(np.subtract(walls["op"],
                                                  walls["call"]))
emit(line)
del s, model
torch.cuda.empty_cache()
route[0] = routes[0]
gen = torch.Generator(device="cuda").manual_seed(0)
cs._flash_pad_times(gen, 80)
cs._flash_pad_times(gen, 200)
cs._varlen_pad_times(gen, 40)
"""


def _emit(line: str, out: str) -> None:
    print(line, flush=True)
    with open(os.path.join(out, "results.jsonl"), "a") as f:
        f.write(line + "\n")


def _run(root: str, tag: str, chunks: int, out: str) -> None:
    proc = subprocess.run([sys.executable, "-c", _MEASURE, tag, str(chunks)],
                          cwd=root, capture_output=True, text=True,
                          timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            _emit(line, out)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr, flush=True)
        raise SystemExit(f"probe: the {tag} tree failed "
                         f"(exit {proc.returncode})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--chunks", type=int, default=40)
    ap.add_argument("--out", default=os.path.join(
        HERE, "paddle_tpu_torch", "_build", "probe_op_dispatch"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe: no CUDA device is visible")
    os.makedirs(args.out, exist_ok=True)
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    _emit(json.dumps({"device": cs.phase_device()}), args.out)
    parent = os.path.abspath(args.parent)
    for _ in range(args.rounds):
        for tag, root in (("parent", parent), ("this", HERE),
                          ("this", HERE), ("parent", parent)):
            _run(root, tag, args.chunks, os.path.abspath(args.out))


if __name__ == "__main__":
    main()
