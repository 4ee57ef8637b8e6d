"""Weight-streaming linears for skinny (decode-shaped) matmuls.

Counterpart of ``paddle_tpu/nn/functional/stream_linear.py``. The
serving decode step multiplies a few token rows [M <= 64, K] against
large weights [K, N], so every step must read the whole weight stack
from device memory: the weight stream is the bound.

- ``stream_linear`` — one GEMM ``act(x @ w[layer] + bias)`` with fp32
  accumulation; ``w`` may be a stacked [L, K, N] tensor with a layer
  index (the layer's view is passed to the kernel, never copied).
- ``stream_layer_tail`` — the grouped layer tail: O-projection +
  residual + LN2 + FFN + residual, and optionally the next layer's
  LN1 + QKV projection (the cross-layer prefetch of the grouped decode
  loop).

On a CUDA tensor each wrapper launches the kernels of
``csrc/stream_linear.cu``; on a CPU tensor it runs the plain version
beside it (``_stream_linear_plain``, ``_tail_fallback``).

Precision of the tail: the kernel path keeps ``h2`` (the hidden state
after the O-projection residual) in fp32 through LN2, as the TPU
kernel's VMEM scratch does; the plain version follows the JAX
package's ``_tail_fallback`` and rounds ``h2`` to ``h``'s dtype. The
two agree exactly in float32 and within bf16 rounding in bfloat16.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import _kernels

__all__ = ["stream_linear", "stream_layer_tail"]

_ACTIVATIONS = {None: 0, "gelu": 1, "relu": 2}


def _apply_activation(acc, activation):
    if activation == "gelu":
        # the JAX package's gelu is the tanh approximation
        return F.gelu(acc, approximate="tanh")
    if activation == "relu":
        return F.relu(acc)
    return acc


def _ln_f32(h, scale, bias, eps):
    """fp32 layer norm (population variance) matching
    FusedMultiTransformer._ln."""
    h = h.float()
    mu = h.mean(-1, keepdim=True)
    var = h.var(-1, keepdim=True, unbiased=False)
    return (h - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _stream_linear_plain(x, w, layer=None, bias=None, activation=None,
                         out_dtype=None):
    """The JAX package's fallback branch: an fp32-accumulated product
    (bf16 products are exact in fp32), bias and activation on the fp32
    result, then the output dtype."""
    out_dtype = out_dtype or x.dtype
    stacked = w.dim() == 3
    wl = w[layer] if stacked else w
    out = x.float() @ wl.float()
    if bias is not None:
        out = out + (bias[layer] if stacked else bias).float()
    return _apply_activation(out, activation).to(out_dtype)


#: CUDA launches issued without error on behalf of ``stream_linear``
#: (one GEMM per call) and of ``stream_layer_tail`` (its GEMM and
#: LayerNorm launches); plain CPU calls do not count
launches = 0
tail_launches = 0


def _count_launch(what):
    global launches, tail_launches
    if what == "stream_linear":
        launches += 1
    else:
        tail_launches += 1


def _check_cuda(what, x, *tensors, aligned=()):
    """Same device and contiguous; ``aligned`` operands (those copied
    in 16-byte chunks) also 16-byte aligned."""
    for t in (x,) + tensors + tuple(aligned):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{what}: all operands must be on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
    for t in aligned:
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: x and w must be 16-byte aligned")


def _gemm(what, x, w, bias=None, residual=None, activation=None,
          out_dtype=None, out=None):
    """One launch of the CUDA GEMM: out = act(x @ w + bias) + residual.
    ``w`` is 2-D [K, N] (a layer view of a stack is fine)."""
    M, K = x.shape
    N = w.shape[-1]
    if w.dim() != 2 or w.shape[0] != K:
        raise ValueError(f"{what}: x {tuple(x.shape)} does not match w "
                         f"{tuple(w.shape)}")
    if w.dtype != x.dtype:
        raise TypeError(f"{what}: x is {x.dtype} and w {w.dtype}; the "
                        "kernel takes one dtype for both")
    vec = 16 // x.element_size()
    if K % vec or N % vec:
        raise ValueError(f"{what}: K ({K}) and N ({N}) must be multiples "
                         f"of {vec} for {x.dtype}")
    if bias is not None and tuple(bias.shape) != (N,):
        raise ValueError(f"{what}: bias must be [{N}]")
    if residual is not None and tuple(residual.shape) != (M, N):
        raise ValueError(f"{what}: residual must be [{M}, {N}]")
    if activation not in _ACTIVATIONS:
        raise ValueError(f"{what}: activation {activation!r} is not one "
                         "of None, 'gelu', 'relu'")
    if out is None:
        out = torch.empty((M, N), dtype=out_dtype or x.dtype,
                          device=x.device)
    _check_cuda(what, x, bias, residual, out, aligned=(x, w))
    fn = _kernels.lib("stream_linear").ptt_stream_linear
    _kernels.check(fn(
        x.data_ptr(), w.data_ptr(), _kernels.ptr(bias),
        0 if bias is None else _kernels.dtype_code(bias, what),
        _kernels.ptr(residual),
        0 if residual is None else _kernels.dtype_code(residual, what),
        out.data_ptr(), _kernels.dtype_code(out, what),
        _kernels.dtype_code(x, what), M, K, N, _ACTIVATIONS[activation],
        _kernels.stream_ptr(x.device)), what)
    _count_launch(what)
    return out


def _layer_norm(what, x, scale, bias, eps, out_dtype):
    """One launch of the CUDA row LayerNorm (fp32 statistics)."""
    M, D = x.shape
    if tuple(scale.shape) != (D,) or tuple(bias.shape) != (D,):
        raise ValueError(f"{what}: LayerNorm scale/bias must be [{D}]")
    out = torch.empty((M, D), dtype=out_dtype, device=x.device)
    _check_cuda(what, x, scale, bias, out)
    fn = _kernels.lib("stream_linear").ptt_layer_norm
    _kernels.check(fn(
        x.data_ptr(), _kernels.dtype_code(x, what), scale.data_ptr(),
        _kernels.dtype_code(scale, what), bias.data_ptr(),
        _kernels.dtype_code(bias, what), out.data_ptr(),
        _kernels.dtype_code(out, what), M, D, float(eps),
        _kernels.stream_ptr(x.device)), what)
    _count_launch(what)
    return out


def stream_linear(x, w, layer=None, bias=None, scale=None,
                  activation=None, out_dtype=None, act_quant=False,
                  reduce_axis=None):
    """x [M, K] @ w[(L,) K, N] (+ bias) with streamed weights.

    layer: index when w/bias are layer-stacked. activation: None |
    'gelu' | 'relu', fused on the fp32 accumulator. Returns [M, N] in
    out_dtype (default: x.dtype). ``scale`` (int8 weight-only),
    ``act_quant`` (A8W8) and ``reduce_axis`` (tensor parallelism)
    belong to later slices of the port and raise.
    """
    if scale is not None or act_quant:
        raise NotImplementedError(
            "stream_linear: int8 weights (scale=) and A8W8 (act_quant=) "
            "come with the quantized-serving slice of the port")
    if reduce_axis is not None:
        raise NotImplementedError(
            "stream_linear: reduce_axis= comes with the tensor-parallel "
            "serving slice of the port")
    if x.device.type != "cuda":
        return _stream_linear_plain(x, w, layer, bias, activation,
                                    out_dtype)
    stacked = w.dim() == 3
    if stacked:
        if layer is None:
            raise ValueError("stream_linear: a stacked w needs layer=")
        w = w[int(layer)]
        bias = None if bias is None else bias[int(layer)]
    return _gemm("stream_linear", x, w, bias=bias, activation=activation,
                 out_dtype=out_dtype or x.dtype)


def _tail_fallback(att, h, wo, w1, w2, layer, bo, b1, b2, ln2_scale,
                   ln2_bias, eps, activation, qg, out_dtype, stacked):
    """Plain version of the tail, op for op the ungrouped decode path
    (the JAX package's ``_tail_fallback``): products in the compute
    dtype, each partial sum rounded to h's dtype."""
    def at(a):
        return a[layer] if stacked else a

    h2 = (h + att @ at(wo) + at(bo)).to(h.dtype)
    hn = _ln_f32(h2, at(ln2_scale), at(ln2_bias), eps).to(h.dtype)
    ff = _apply_activation((hn @ at(w1) + at(b1)).to(h.dtype), activation)
    h_out = (h2 + ff @ at(w2) + at(b2)).to(h.dtype)
    if qg is None:
        return h_out.to(out_dtype)
    lq = qg.get("layer")

    def atq(a):
        return a[lq] if (stacked and lq is not None) else a

    hn1 = _ln_f32(h_out, atq(qg["ln_s"]), atq(qg["ln_b"]), eps).to(h.dtype)
    qkv = hn1 @ atq(qg["w"]) + atq(qg["b"])
    return h_out.to(out_dtype), qkv.to(out_dtype)


def stream_layer_tail(att, h, wo, w1, w2, layer=None, *, bo, b1, b2,
                      ln2_scale, ln2_bias, epsilon, activation=None,
                      so=None, s1=None, s2=None, next_qkv=None,
                      out_dtype=None, reduce_axis=None):
    """GROUPED layer tail: ``h2 = h + att @ Wo + bo; h_out = h2 +
    FFN(LN2(h2))`` and, with ``next_qkv``, the next layer's
    ``qkv' = LN1'(h_out) @ Wq' + bq'``.

    att [M, Ka], h [M, d]. Weights stacked [L, K, N] with ``layer``, or
    2-D. ``next_qkv``: dict with ``w``, ``b``, ``ln_s``, ``ln_b`` (and
    ``layer`` for the stacked form). Returns ``h_out`` (and ``qkv``
    when ``next_qkv``), in ``out_dtype`` (default: h.dtype). ``so/s1/
    s2`` (int8 weights) and ``reduce_axis`` (tensor parallelism) belong
    to later slices and raise.
    """
    if so is not None or s1 is not None or s2 is not None or (
            next_qkv is not None and next_qkv.get("s") is not None):
        raise NotImplementedError(
            "stream_layer_tail: int8 weight scales come with the "
            "quantized-serving slice of the port")
    if reduce_axis is not None:
        raise NotImplementedError(
            "stream_layer_tail: reduce_axis= comes with the "
            "tensor-parallel serving slice of the port")
    out_dtype = out_dtype or h.dtype
    stacked = wo.dim() == 3
    if (w1.dim() != wo.dim() or w2.dim() != wo.dim()
            or (next_qkv is not None and next_qkv["w"].dim() != wo.dim())):
        raise ValueError("stream_layer_tail: wo/w1/w2 (and next_qkv.w) "
                         "must all be stacked [L, K, N] or all 2-D")
    l = (0 if layer is None else int(layer)) if stacked else None
    if h.device.type != "cuda":
        qg = None
        if next_qkv is not None:
            qg = dict(next_qkv)
            if stacked:
                qg["layer"] = int(qg.get("layer") or 0)
        return _tail_fallback(att, h, wo, w1, w2, l, bo, b1, b2,
                              ln2_scale, ln2_bias, epsilon, activation,
                              qg, out_dtype, stacked)

    def at(a, idx):
        return a[idx] if stacked else a

    what = "stream_layer_tail"
    cdtype = att.dtype
    # 1. O-proj + bo + h -> h2, kept in fp32 through LN2
    h2 = _gemm(what, att, at(wo, l), bias=at(bo, l), residual=h,
               out_dtype=torch.float32)
    # 2. LN2
    hn = _layer_norm(what, h2, at(ln2_scale, l), at(ln2_bias, l),
                     epsilon, cdtype)
    # 3. FFN1 + b1 + activation
    ff = _gemm(what, hn, at(w1, l), bias=at(b1, l), activation=activation,
               out_dtype=cdtype)
    # 4. FFN2 + b2 + h2
    h_out = _gemm(what, ff, at(w2, l), bias=at(b2, l), residual=h2,
                  out_dtype=out_dtype)
    if next_qkv is None:
        return h_out
    # 5. the next layer's LN1' + QKV' + bq'
    lq = (int(next_qkv.get("layer") or 0)) if stacked else None
    hn1 = _layer_norm(what, h_out, at(next_qkv["ln_s"], lq),
                      at(next_qkv["ln_b"], lq), epsilon, cdtype)
    qkv = _gemm(what, hn1, at(next_qkv["w"], lq),
                bias=at(next_qkv["b"], lq), out_dtype=out_dtype)
    return h_out, qkv
