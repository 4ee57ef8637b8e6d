"""Small inputs for every kernel op (``_kernels.registered_ops``).

``CASES`` maps a kernel family to a function of a ``torch.Generator``
that returns ``[(op, args), ...]``: CPU tensors at a few rows and heads,
with ``requires_grad`` on the operands of the ops that have a gradient.
``torch.library.opcheck`` takes each case as it is on the CPU (where the
ops run their plain versions) and with its tensors moved to the card
(``chip_smoke.py``'s ``check: custom_ops``), and together the cases
cover every registered op.
"""
from __future__ import annotations

import torch

from .nn.functional import attention as at
from .nn.functional import flash_varlen as fv
from .nn.functional import grouped_gemm as gg
from .nn.functional import lora
from .nn.functional import paged_attention as pa
from .nn.functional import stream_linear as sl

__all__ = ["CASES"]


def _rand(gen, *shape, dtype=torch.float32, grad=False):
    t = torch.randn(*shape, generator=gen).to(dtype)
    return t.requires_grad_(grad)


def _pool(gen, P=8, n_kv=2, ps=16, d=32, dtype=torch.float32):
    return _rand(gen, P, n_kv, ps, d, dtype=dtype)


_I32 = dict(dtype=torch.int32)


def _flash(gen):
    q, k, v = (_rand(gen, 1, 128, 2, 64) for _ in range(3))
    out, lse = at.flash_attention_fwd(q, k, v, True, 0.125)
    do = _rand(gen, *out.shape)
    di = at.flash_delta(out, do)
    qg, kg, vg = (_rand(gen, 1, 128, 2, 64, grad=True) for _ in range(3))
    # head_dim 80: on the card the gradients come back as slices of the
    # kernels' outputs at the built width 96 (``grad_like``)
    q8, k8, v8 = (_rand(gen, 1, 128, 2, 80) for _ in range(3))
    out8, lse8 = at.flash_attention_fwd(q8, k8, v8, False, 0.1)
    do8 = _rand(gen, *out8.shape)
    grads8 = (q8, k8, v8, do8, lse8, at.flash_delta(out8, do8), False, 0.1)
    return [(at._fwd_op, (qg, kg, vg, True, 0.125)),
            (at._fwd_op, (q, k, v, False, 0.125)),
            (at._dq_op, (q, k, v, do, lse, di, True, 0.125)),
            (at._dkv_op, (q, k, v, do, lse, di, True, 0.125)),
            (at._dq_op, grads8), (at._dkv_op, grads8)]


def _varlen(gen):
    q, k, v = (_rand(gen, 100, 2, 64) for _ in range(3))
    cu = torch.tensor([0, 60, 100], **_I32)
    out, lse = fv.packed_fwd(q, k, v, cu, cu, scale=0.125, causal=True)
    do = _rand(gen, 100, 2, 64)
    delta = fv.packed_delta(out, do, lse.shape[1])
    qg, kg, vg = (_rand(gen, 100, 2, 64, grad=True) for _ in range(3))
    shape = (cu, cu, True, 0.125, 128, 128)
    # head_dim 40, padded to 64 on the card (as the flash case's 80)
    q4, k4, v4 = (_rand(gen, 100, 2, 40) for _ in range(3))
    out4, lse4 = fv.packed_fwd(q4, k4, v4, cu, cu, scale=0.15, causal=True)
    do4 = _rand(gen, 100, 2, 40)
    grads4 = (q4, k4, v4, do4, lse4,
              fv.packed_delta(out4, do4, lse4.shape[1]), cu, cu, True, 0.15,
              128, 128)
    return [(fv._fwd_op, (qg, kg, vg, *shape)),
            (fv._dq_op, (q, k, v, do, lse, delta, *shape)),
            (fv._dkv_op, (q, k, v, do, lse, delta, *shape)),
            (fv._dq_op, grads4), (fv._dkv_op, grads4)]


def _prefill(gen):
    q = _rand(gen, 1, 16, 4, 32)
    tables = torch.tensor([[1, 2]], **_I32)
    start = torch.tensor([16], **_I32)
    return [(fv._prefill_op, (q, _pool(gen, P=4), _pool(gen, P=4), tables,
                              start, 2, None))]


def _decode(gen):
    b, n_q, n_kv, d = 2, 4, 2, 32
    q = _rand(gen, b, n_q, d)
    new_k, new_v = _rand(gen, b, n_kv, d), _rand(gen, b, n_kv, d)
    lens = torch.tensor([5, 20], **_I32)
    tables = torch.tensor([[1, 2, 3], [4, 5, 6]], **_I32)
    P, ps = 8, 16
    kq = torch.randint(-127, 128, (P, n_kv, ps, d), generator=gen,
                       dtype=torch.int8)
    vq = torch.randint(-127, 128, (P, n_kv, ps, d), generator=gen,
                       dtype=torch.int8)
    ks, vs = (torch.rand(n_kv, P * ps, generator=gen) for _ in range(2))
    return [(pa._decode_op, (q, new_k, new_v, _pool(gen), _pool(gen), lens,
                             tables, None, None)),
            (pa._decode_q_op, (q, new_k, new_v, kq, ks, vq, vs, lens,
                               tables, 0, 7))]


def _backends(gen):
    b, n_q, d = 2, 4, 128
    q = _rand(gen, b, n_q, d)
    kp, vp = _pool(gen, d=d), _pool(gen, d=d)
    lens = torch.tensor([5, 20], **_I32)
    tables = torch.tensor([[1, 2], [3, 4]], **_I32)
    return [(pa._stream_op, (q, kp, vp, lens, tables, 1, 6, None)),
            (pa._fused_op, (q, kp, vp, lens, tables)),
            (pa._pallas_op, (q, kp, vp, lens, tables))]


def _tail_args(gen, d=64, dff=128, nxt=True):
    att, h = _rand(gen, 4, d), _rand(gen, 4, d)
    w = [_rand(gen, *shape) * 0.1 for shape in ((d, d), (d, dff), (dff, d))]
    vec = [_rand(gen, n) for n in (d, dff, d, d, d)]
    nq = [_rand(gen, d, 3 * d) * 0.1, _rand(gen, 3 * d), _rand(gen, d),
          _rand(gen, d)] if nxt else [None] * 4
    return (att, h, *w, *vec[:3], vec[3], vec[4], 1e-5,
            "gelu", None, None, None, *nq, None, torch.float32)


def _stream(gen):
    x, w = _rand(gen, 4, 64), _rand(gen, 64, 32)
    bias = _rand(gen, 32)
    wq = torch.randint(-127, 128, (64, 32), generator=gen, dtype=torch.int8)
    xq = torch.randint(-127, 128, (4, 64), generator=gen, dtype=torch.int8)
    scale, xs = torch.rand(32, generator=gen), torch.rand(4, generator=gen)
    return [(sl._gemm_op, (x, w, bias, "gelu", None, None)),
            (sl._gemm_op, (x, wq, None, None, torch.bfloat16, scale)),
            (sl._tail_op, _tail_args(gen)),
            (sl._tail_op, _tail_args(gen, nxt=False)),
            (sl._a8w8_op, (xq, xs, wq, scale, bias, "relu",
                           torch.float32))]


def _grouped(gen):
    off = torch.tensor([0, 9, 16], **_I32)
    xg, wg = _rand(gen, 16, 32, grad=True), _rand(gen, 2, 32, 64, grad=True)
    bg = _rand(gen, 2, 64, grad=True)
    x, dz, w = _rand(gen, 16, 32), _rand(gen, 16, 64), _rand(gen, 2, 32, 64)
    return [(gg._gemm_op, (xg, wg, off, bg, "gelu", torch.float32)),
            (gg._dx_op, (dz, w, off, torch.float32)),
            (gg._dw_op, (x, dz, off, 2, torch.float32))]


def _lora(gen):
    off = torch.tensor([0, 9, 12], **_I32)
    return [(lora._lora_op, (_rand(gen, 16, 32), _rand(gen, 2, 32, 8),
                             _rand(gen, 2, 8, 24), off, None))]


CASES = {"flash": _flash, "flash_varlen": _varlen,
         "paged_prefill": _prefill, "paged_decode": _decode,
         "decode_backends": _backends, "stream_linear": _stream,
         "grouped_gemm": _grouped, "lora": _lora}
