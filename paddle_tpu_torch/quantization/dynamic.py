"""Dynamic (per-token) activation quantization for A8W8 serving.

Counterpart of ``paddle_tpu/quantization/dynamic.py``. Each activation
ROW (one token's features) gets a symmetric absmax scale computed on
the fly — no calibration pass, no stored statistics — so the skinny
decode matmuls can run int8 x int8 with int32 accumulation and a single
dequant of the accumulator by ``act_scale (x) per-output-channel
weight_scale``.

Error contract (held by the parity tests): round-to-nearest symmetric
int8 puts each quantized element within ``scale/2`` of its value, where
``scale = absmax(row)/127``, so a K-long dot row is off by at most
``(absmax(row)/254) * sum_k |w_dequant[k, n]|``.

Consumers: ``nn/functional/stream_linear.py`` (the int8-activation
streamed GEMM, kernel ``csrc/stream_linear_a8w8.cu``) and
``incubate/nn/fused_transformer.py`` (the prefill A8W8 products, which
stay PyTorch ops: ``torch._int_mm`` on the card).
"""
from __future__ import annotations

import torch

__all__ = ["ACT_SCALE_EPS", "absmax_scale", "dynamic_act_quant",
           "int8_dot_dequant"]

#: absmax floor so an all-zero token row quantizes to zeros with a
#: finite scale instead of dividing by zero
ACT_SCALE_EPS = 1e-8

#: ``torch._int_mm`` on the card takes more than 16 rows; rows are
#: padded up to a multiple of this
_INT_MM_ROWS = 32


def absmax_scale(amax, eps: float = ACT_SCALE_EPS):
    """The symmetric int8 scale ``max(amax / 127, eps)`` of absmax
    values ``amax`` (fp32), by a true division on either device:
    PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal, which rounds differently from the kernels' (and the
    CPU's) division, so the divisor is a tensor on amax's device."""
    return torch.clamp_min(amax / amax.new_full((), 127.0), eps)


def dynamic_act_quant(x, eps: float = ACT_SCALE_EPS):
    """Per-token symmetric absmax int8 quantization of activations.

    x [..., K] (any float dtype) -> (q int8 [..., K], scale f32 [...])
    with ``q = clip(round(x / scale), -127, 127)`` (round half to even,
    a true division) and ``scale = max(absmax(row) / 127, eps)``.
    Callers count ``quant.act_quant_calls`` where the work executes.
    """
    xf = x.float()
    s = absmax_scale(xf.abs().amax(dim=-1), eps)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127) \
        .to(torch.int8)
    return q, s


def _int32_matmul(x_q, w_q):
    """Exact int8 x int8 -> int32 product of [M, K] and [K, N]: integer
    matmul on the CPU, ``torch._int_mm`` (rows padded) on the card."""
    if x_q.device.type != "cuda":
        return x_q.to(torch.int32) @ w_q.to(torch.int32)
    M = x_q.shape[0]
    Mp = max(-(-M // _INT_MM_ROWS), 1) * _INT_MM_ROWS
    if Mp != M:
        x_q = torch.cat([x_q, x_q.new_zeros(Mp - M, x_q.shape[1])])
    return torch._int_mm(x_q.contiguous(), w_q.contiguous())[:M]


def int8_dot_dequant(x_q, x_scale, w_q, w_scale, bias=None,
                     out_dtype=None):
    """int8 x int8 matmul with int32 accumulation + one dequant.

    x_q [..., K] int8, x_scale [...] f32 (per token), w_q [K, N] int8,
    w_scale [N] f32 (per output channel). The int32 accumulator is
    dequantized once as ``acc * x_scale * w_scale`` (in that order, in
    fp32); bias (full precision) is added after the dequant.
    """
    lead = x_q.shape[:-1]
    acc = _int32_matmul(x_q.reshape(-1, x_q.shape[-1]), w_q)
    acc = acc.reshape(*lead, w_q.shape[-1])
    out = acc.float() * x_scale.float()[..., None] * w_scale.float()
    if bias is not None:
        out = out + bias.float()
    return out if out_dtype is None else out.to(out_dtype)
