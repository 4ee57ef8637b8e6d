"""Weight-streaming linears for skinny (decode-shaped) matmuls.

Counterpart of ``paddle_tpu/nn/functional/stream_linear.py``. The
serving decode step multiplies a few token rows [M <= 64, K] against
large weights [K, N], so every step must read the whole weight stack
from device memory: the weight stream is the bound.

- ``stream_linear`` — one GEMM ``act(x @ w[layer] * scale + bias)``
  with fp32 accumulation; ``w`` may be a stacked [L, K, N] tensor with
  a layer index (the layer's view is passed to the kernel, never
  copied). With int8 ``w`` and per-output-channel ``scale`` (weight-only
  int8) the kernel converts each weight to fp32 in its inner loop and
  scales the fp32 accumulator. With ``act_quant=True`` (A8W8) x is
  quantized per token (``quantization.dynamic``) and the product runs
  int8 x int8 with int32 accumulation on the int8 tensor cores,
  dequantized once by ``act_scale (x) scale``
  (``csrc/stream_linear_a8w8.cu``), split over K by ``a8w8_plan``.
- ``stream_layer_tail`` — the grouped layer tail: O-projection +
  residual + LN2 + FFN + residual, and optionally the next layer's
  LN1 + QKV projection (the cross-layer prefetch of the grouped decode
  loop); int8 stacks with ``so/s1/s2`` (and ``next_qkv["s"]``) run the
  int8-weight GEMM.

Each wrapper calls its op, ``ptt::stream_gemm``, ``ptt::stream_layer_tail``
(the tail's six launches, one op) or ``ptt::stream_linear_a8w8``: on a CUDA
tensor the op launches the kernels of ``csrc/stream_linear.cu`` (and
``csrc/stream_linear_a8w8.cu``), on a CPU tensor it runs the plain version
(``_stream_linear_plain``, ``_tail_fallback``, ``_stream_linear_a8w8_plain``).
With bf16 x the GEMM runs on the tensor cores and splits K over blocks by
``stream_plan`` (a function of the shapes and the SM count): the fp32 partials
go to a workspace, and the last block of each column tile merges them in split
order, taking its ticket from a counter buffer; both are kept per device and
stream (``_split_buffers``: the counters are zeroed once, and each merge sets
its counter back to 0). The A8W8 GEMM splits alike by ``a8w8_plan``, its int32
partials in the same workspace. ``_split_k_plain`` and ``_a8w8_split_plain``
render the two splits in PyTorch.

Precision of the tail: the kernel path keeps ``h2`` (the hidden state
after the O-projection residual) in fp32 through LN2, and applies int8
scales to the fp32 accumulator, as the TPU kernel does; the plain
version follows the JAX package's ``_tail_fallback`` and rounds ``h2``
(and an int8 product before its scale) to ``h``'s dtype. The two agree
exactly in float32 and within bf16 rounding in bfloat16.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import _kernels
from ...quantization.dynamic import (_int32_matmul, dynamic_act_quant,
                                     int8_dot_dequant)

__all__ = ["stream_linear", "stream_layer_tail", "stream_plan", "a8w8_plan"]

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
                         out_dtype=None, scale=None):
    """The JAX package's fallback branch: an fp32-accumulated product
    (bf16 and int8 weights are exact in fp32), the per-output-channel
    ``scale`` of int8 weights, bias and activation on the fp32 result,
    then the output dtype."""
    out_dtype = out_dtype or x.dtype
    stacked = w.dim() == 3
    wl = w[layer] if stacked else w
    out = x.float() @ wl.float()
    if scale is not None:
        out = out * (scale[layer] if stacked else scale).float()
    if bias is not None:
        out = out + (bias[layer] if stacked else bias).float()
    return _apply_activation(out, activation).to(out_dtype)


def _stream_linear_a8w8_plain(x_q, x_scale, w, scale, layer=None,
                              bias=None, activation=None,
                              out_dtype=torch.float32):
    """Plain version of the A8W8 kernel: x_q [M, K] int8 with per-token
    scales [M] against int8 w [(L,) K, N] with scales [(L,) N]: the
    exact int32 product, ``acc * x_scale * scale + bias``, activation,
    output dtype."""
    stacked = w.dim() == 3

    def at(a):
        return a[layer] if (stacked and a is not None) else a
    out = int8_dot_dequant(x_q, x_scale, at(w), at(scale), bias=at(bias))
    return _apply_activation(out, activation).to(out_dtype)


#: CUDA launches issued without error, by kernel; plain CPU calls do
#: not count. ``launches``: the GEMM of ``stream_linear`` (bf16/f32
#: weights); ``w8_launches``: its int8-weight GEMM; ``tail_launches`` /
#: ``tail_w8_launches``: the GEMM and LayerNorm launches of
#: ``stream_layer_tail`` over float / int8 stacks; ``a8w8_launches``:
#: the int8 x int8 GEMM of ``stream_linear(act_quant=True)``
launches = 0
w8_launches = 0
tail_launches = 0
tail_w8_launches = 0
a8w8_launches = 0

_COUNTERS = {"stream_linear": "launches", "stream_linear_w8": "w8_launches",
             "stream_layer_tail": "tail_launches",
             "stream_layer_tail_w8": "tail_w8_launches",
             "stream_linear_a8w8": "a8w8_launches"}


def _count_launch(what):
    name = _COUNTERS[what]
    globals()[name] += 1


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


def _check_vector(what, name, v, N):
    if v is not None and tuple(v.shape) != (N,):
        raise ValueError(f"{what}: {name} must be [{N}]")


#: the tensor-core GEMM's tiles: a block owns STREAM_BN output columns of
#: up to STREAM_ROWS rows and walks one K slice in STREAM_BK-row k-steps
STREAM_BN, STREAM_BK, STREAM_ROWS = 64, 64, 64
#: the A8W8 GEMM's (B5): 128 columns (32 a warp) of up to STREAM_ROWS rows
A8W8_BN, A8W8_BK = 128, 64
_STREAM_MAX_SPLIT = 16
_A8W8_MAX_SPLIT = 8
_STREAM_MIN_STEPS = 2


def _cdiv(a, b):
    return -(-a // b)


def _split_plan(M: int, K: int, N: int, sms: int, bn: int, bk: int,
                max_split: int) -> tuple:
    """``(split, steps, blocks, workspace)`` of a split-K GEMM whose block
    owns ``bn`` columns of up to STREAM_ROWS rows: ``split`` K slices of
    ``steps`` ``bk``-row k-steps each (the last may be shorter, none is
    empty), so that the (column tile x row block x slice) blocks number
    about two an SM on ``sms`` SMs; at most ``max_split`` slices, each at
    least two k-steps; 1 when the tiles alone fill the card.
    ``workspace`` is the partials' element count (0 with one slice)."""
    tiles = _cdiv(N, bn) * _cdiv(M, STREAM_ROWS)
    ksteps = _cdiv(K, bk)
    want = max(1, min(_cdiv(2 * sms, tiles), ksteps // _STREAM_MIN_STEPS,
                      max_split))
    steps = _cdiv(ksteps, want)
    split = _cdiv(ksteps, steps)
    return split, steps, tiles * split, split * M * N if split > 1 else 0


def stream_plan(M: int, K: int, N: int, sms: int) -> tuple:
    """The split of the bf16 GEMM (``_split_plan`` at 64 x 64 tiles, at
    most 16 slices): fp32 partials."""
    return _split_plan(M, K, N, sms, STREAM_BN, STREAM_BK, _STREAM_MAX_SPLIT)


def a8w8_plan(M: int, K: int, N: int, sms: int) -> tuple:
    """The split of the A8W8 GEMM (``_split_plan`` at 128-column tiles,
    64-row k-steps, at most ``_A8W8_MAX_SPLIT`` slices): int32 partials,
    which the tile's last block reads back, so each slice costs the merge
    time as well."""
    return _split_plan(M, K, N, sms, A8W8_BN, A8W8_BK, _A8W8_MAX_SPLIT)


def _split_k_plain(x, w, split: int, steps: int, drop=None):
    """The split of ``stream_plan`` in PyTorch, f32: per K slice of
    ``steps`` k-steps its partial ``x[:, ks] @ w[ks]``, summed in split
    order. ``drop``: a slice left out (a faulty merge, for controls)."""
    K = x.shape[1]
    span = steps * STREAM_BK
    acc = None
    for s in range(split):
        if s == drop:
            continue
        ks = slice(s * span, min(K, (s + 1) * span))
        part = x[:, ks].float() @ w[ks].float()
        acc = part if acc is None else acc + part
    return acc


def _a8w8_split_plain(x_q, x_scale, w, scale, split: int, steps: int,
                      bias=None, activation=None, out_dtype=torch.float32,
                      drop=None):
    """The split of ``a8w8_plan`` in PyTorch: per K slice of ``steps``
    64-row k-steps its exact int32 partial, the partials summed in split
    order, then the plain version's dequant (``acc * x_scale * scale +
    bias``), activation and output dtype. ``drop``: a slice left out (the
    chip check's control)."""
    K = x_q.shape[1]
    span = steps * A8W8_BK
    acc = torch.zeros(x_q.shape[0], w.shape[1], dtype=torch.int32,
                      device=x_q.device)
    for s in range(split):
        if s != drop:
            ks = slice(s * span, min(K, (s + 1) * span))
            acc += _int32_matmul(x_q[:, ks], w[ks])
    out = acc.float() * x_scale.float()[:, None] * scale.float()
    if bias is not None:
        out = out + bias.float()
    return _apply_activation(out, activation).to(out_dtype)


#: (device, stream) -> [workspace, merge counters] of the split-K GEMM
_SPLIT: dict = {}


_sm_count = _kernels.sm_count


def _split_buffers(device, stream: int, n_ws: int, n_tickets: int):
    """The split-K buffers of one stream of ``device``: an fp32 workspace
    of at least ``n_ws`` elements and at least ``n_tickets`` int32 merge
    counters. Both are kept per stream and grow on demand: launches on
    one stream run in order, so each reuses them; the counters are
    zeroed once, when allocated, and every merge leaves its counter at
    0."""
    bufs = _SPLIT.get((device, stream))
    if bufs is None:
        bufs = _SPLIT[(device, stream)] = [None, None]
    if bufs[0] is None or bufs[0].numel() < n_ws:
        bufs[0] = torch.empty(n_ws, dtype=torch.float32, device=device)
    if bufs[1] is None or bufs[1].numel() < n_tickets:
        bufs[1] = torch.zeros(max(n_tickets, 1024), dtype=torch.int32,
                              device=device)
    return bufs


def _gemm(what, x, w, bias=None, residual=None, activation=None,
          out_dtype=None, out=None, scale=None):
    """One launch of the CUDA GEMM: out = act(x @ w * scale + bias) +
    residual. ``w`` is 2-D [K, N] (a layer view of a stack is fine), of
    x's dtype or int8 with a per-column ``scale``."""
    M, K = x.shape
    N = w.shape[-1]
    if w.dim() != 2 or w.shape[0] != K:
        raise ValueError(f"{what}: x {tuple(x.shape)} does not match w "
                         f"{tuple(w.shape)}")
    if w.dtype == torch.int8:
        if scale is None:
            raise ValueError(f"{what}: int8 weights need their "
                             "per-output-channel scale")
    elif w.dtype != x.dtype:
        raise TypeError(f"{what}: x is {x.dtype} and w {w.dtype}; the "
                        "kernel takes w in x's dtype or int8")
    xvec, wvec = 16 // x.element_size(), 16 // w.element_size()
    if K % xvec or N % wvec:
        raise ValueError(f"{what}: K ({K}) must be a multiple of {xvec} "
                         f"for {x.dtype} and N ({N}) of {wvec} for "
                         f"{w.dtype} weights")
    _check_vector(what, "bias", bias, N)
    _check_vector(what, "scale", scale, N)
    if residual is not None and tuple(residual.shape) != (M, N):
        raise ValueError(f"{what}: residual must be [{M}, {N}]")
    if activation not in _ACTIVATIONS:
        raise ValueError(f"{what}: activation {activation!r} is not one "
                         "of None, 'gelu', 'relu'")
    if out is None:
        out = torch.empty((M, N), dtype=out_dtype or x.dtype,
                          device=x.device)
    _check_cuda(what, x, bias, residual, out, scale, aligned=(x, w))

    def code(t):
        return 0 if t is None else _kernels.dtype_code(t, what)
    stream = _kernels.stream_ptr(x.device)
    split, steps, ws, tickets = 1, 1, None, None
    if x.dtype == torch.bfloat16 and M:
        split, steps, blocks, n_ws = stream_plan(M, K, N,
                                                 _sm_count(x.device))
        if split > 1:
            ws, tickets = _split_buffers(x.device, stream, n_ws,
                                         blocks // split)
    fn = _kernels.lib("stream_linear").ptt_stream_linear
    _kernels.check(fn(
        x.data_ptr(), w.data_ptr(), _kernels.weight_code(w, what),
        _kernels.ptr(scale), code(scale), _kernels.ptr(bias), code(bias),
        _kernels.ptr(residual), code(residual), out.data_ptr(), code(out),
        code(x), M, K, N, _ACTIVATIONS[activation], _kernels.ptr(ws),
        _kernels.ptr(tickets), split, steps, stream), what)
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


def _stream_linear_a8w8(x_q, x_scale, w, scale, bias=None, activation=None,
                        out_dtype=torch.float32):
    """One launch of the CUDA int8 x int8 GEMM (kernel B5): x_q [M, K]
    int8 and x_scale [M] f32 against int8 w [K, N] (a layer view is
    fine) with scale [N] f32; out = act(float(x_q @ w) * x_scale *
    scale + bias) in ``out_dtype``. K is split by ``a8w8_plan``; with
    more than one slice the int32 partials and merge counters are the
    stream's ``_split_buffers``."""
    what = "stream_linear_a8w8"
    M, K = x_q.shape
    N = w.shape[-1]
    if w.dim() != 2 or w.shape[0] != K:
        raise ValueError(f"{what}: x_q {tuple(x_q.shape)} does not match "
                         f"w {tuple(w.shape)}")
    for name, t, dt in (("x_q", x_q, torch.int8), ("w", w, torch.int8),
                        ("x_scale", x_scale, torch.float32),
                        ("scale", scale, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{what}: {name} is {t.dtype}, the kernel "
                            f"takes {dt}")
    if K % 16 or N % 16:
        raise ValueError(f"{what}: K ({K}) and N ({N}) must be multiples "
                         "of 16")
    if tuple(x_scale.shape) != (M,):
        raise ValueError(f"{what}: x_scale must be [{M}]")
    _check_vector(what, "scale", scale, N)
    _check_vector(what, "bias", bias, N)
    if activation not in _ACTIVATIONS:
        raise ValueError(f"{what}: activation {activation!r} is not one "
                         "of None, 'gelu', 'relu'")
    out = torch.empty((M, N), dtype=out_dtype, device=x_q.device)
    _check_cuda(what, x_q, x_scale, scale, bias, out, aligned=(x_q, w))
    stream = _kernels.stream_ptr(x_q.device)
    split, steps, ws, tickets = 1, _cdiv(K, A8W8_BK), None, None
    if M:
        split, steps, blocks, n_ws = a8w8_plan(M, K, N,
                                               _sm_count(x_q.device))
        if split > 1:
            ws, tickets = _split_buffers(x_q.device, stream, n_ws,
                                         blocks // split)
    fn = _kernels.lib("stream_linear_a8w8").ptt_stream_linear_a8w8
    _kernels.check(fn(
        x_q.data_ptr(), x_scale.data_ptr(), w.data_ptr(), scale.data_ptr(),
        _kernels.ptr(bias),
        0 if bias is None else _kernels.dtype_code(bias, what),
        out.data_ptr(), _kernels.dtype_code(out, what), M, K, N,
        _ACTIVATIONS[activation], _kernels.ptr(ws), _kernels.ptr(tickets),
        split, steps, stream), what)
    _count_launch(what)
    return out


def _mm_like(x, w, scale):
    """The matmul of FusedMultiTransformer._mm: a plain product in the
    compute dtype; int8 weights dequantize on the OUTPUT by their
    per-output-channel scales (in the compute dtype)."""
    if w.dtype == torch.int8:
        return (x @ w.to(x.dtype)) * scale.to(x.dtype)
    return x @ w


def _tail_fallback(att, h, wo, w1, w2, layer, so, s1, s2, bo, b1, b2,
                   ln2_scale, ln2_bias, eps, activation, qg, out_dtype,
                   stacked):
    """Plain version of the tail, op for op the ungrouped decode path
    (the JAX package's ``_tail_fallback``): products in the compute
    dtype (``_mm_like``), each partial sum rounded to h's dtype."""
    def at(a):
        return a[layer] if (stacked and a is not None) else a

    h2 = (h + _mm_like(att, at(wo), at(so)) + at(bo)).to(h.dtype)
    hn = _ln_f32(h2, at(ln2_scale), at(ln2_bias), eps).to(h.dtype)
    ff = _apply_activation(
        (_mm_like(hn, at(w1), at(s1)) + at(b1)).to(h.dtype), activation)
    h_out = (h2 + _mm_like(ff, at(w2), at(s2)) + at(b2)).to(h.dtype)
    if qg is None:
        return h_out.to(out_dtype)
    lq = qg.get("layer")

    def atq(a):
        return a[lq] if (stacked and a is not None and lq is not None) \
            else a

    hn1 = _ln_f32(h_out, atq(qg["ln_s"]), atq(qg["ln_b"]), eps).to(h.dtype)
    qkv = _mm_like(hn1, atq(qg["w"]), atq(qg.get("s"))) + atq(qg["b"])
    return h_out.to(out_dtype), qkv.to(out_dtype)


# the ops of B2 (the GEMM), B3 (the layer tail: four GEMMs and two row
# LayerNorms, one op as it is one TPU kernel) and B5: the launches on a
# CUDA tensor, the plain versions above on a CPU tensor

def _on_card(t) -> bool:
    return t.device.type == "cuda"


def _gemm_impl(x, w, bias, activation, out_dtype, scale):
    if _on_card(x):
        return _gemm("stream_linear_w8" if w.dtype == torch.int8
                     else "stream_linear", x, w, bias=bias,
                     activation=activation, out_dtype=out_dtype, scale=scale)
    return _stream_linear_plain(x, w, None, bias, activation, out_dtype,
                                scale=scale)


def _tail_impl(att, h, wo, w1, w2, bo, b1, b2, ln2_scale, ln2_bias, eps,
               activation, so, s1, s2, next_w, next_b, next_ln_s, next_ln_b,
               next_s, out_dtype):
    """B3: ``[h_out]``, or ``[h_out, qkv]`` with ``next_w``: the tail's
    launches (``_gemm``, ``_layer_norm``; ``h2`` stays in fp32 through
    LN2) on a CUDA tensor, ``_tail_fallback`` on a CPU tensor."""
    if not _on_card(att):
        qg = None if next_w is None else {
            "w": next_w, "b": next_b, "ln_s": next_ln_s, "ln_b": next_ln_b,
            "s": next_s}
        outs = _tail_fallback(att, h, wo, w1, w2, None, so, s1, s2, bo, b1,
                              b2, ln2_scale, ln2_bias, eps, activation, qg,
                              out_dtype, False)
        return [outs] if qg is None else list(outs)
    what = "stream_layer_tail_w8" if so is not None else "stream_layer_tail"
    cdtype = att.dtype
    # 1. O-proj (* so) + bo + h -> h2, kept in fp32 through LN2
    h2 = _gemm(what, att, wo, bias=bo, residual=h, out_dtype=torch.float32,
               scale=so)
    # 2. LN2
    hn = _layer_norm(what, h2, ln2_scale, ln2_bias, eps, cdtype)
    # 3. FFN1 (* s1) + b1 + activation
    ff = _gemm(what, hn, w1, bias=b1, activation=activation,
               out_dtype=cdtype, scale=s1)
    # 4. FFN2 (* s2) + b2 + h2
    h_out = _gemm(what, ff, w2, bias=b2, residual=h2, out_dtype=out_dtype,
                  scale=s2)
    if next_w is None:
        return [h_out]
    # 5. the next layer's LN1' + QKV' (* s') + bq'
    hn1 = _layer_norm(what, h_out, next_ln_s, next_ln_b, eps, cdtype)
    return [h_out, _gemm(what, hn1, next_w, bias=next_b,
                         out_dtype=out_dtype, scale=next_s)]


def _tail_fake(att, h, wo, w1, w2, bo, b1, b2, ln2_scale, ln2_bias, eps,
               activation, so, s1, s2, next_w, next_b, next_ln_s, next_ln_b,
               next_s, out_dtype):
    outs = [att.new_empty((att.shape[0], w2.shape[-1]), dtype=out_dtype)]
    if next_w is not None:
        outs.append(att.new_empty((att.shape[0], next_w.shape[-1]),
                                  dtype=out_dtype))
    return outs


def _a8w8_impl(x_q, x_scale, w, scale, bias, activation, out_dtype):
    if _on_card(x_q):
        return _stream_linear_a8w8(x_q, x_scale, w, scale, bias, activation,
                                   out_dtype)
    return _stream_linear_a8w8_plain(x_q, x_scale, w, scale, None, bias,
                                     activation, out_dtype)


_gemm_op = _kernels.define_op(
    "stream_gemm",
    "(Tensor x, Tensor w, Tensor? bias, str? activation, "
    "ScalarType? out_dtype, Tensor? scale) -> Tensor",
    _gemm_impl,
    lambda x, w, bias, activation, out_dtype, scale:
    x.new_empty((x.shape[0], w.shape[-1]), dtype=out_dtype or x.dtype))
_tail_op = _kernels.define_op(
    "stream_layer_tail",
    "(Tensor att, Tensor h, Tensor wo, Tensor w1, Tensor w2, Tensor? bo, "
    "Tensor? b1, Tensor? b2, Tensor ln2_scale, Tensor ln2_bias, float eps, "
    "str? activation, Tensor? so, Tensor? s1, Tensor? s2, Tensor? next_w, "
    "Tensor? next_b, Tensor? next_ln_s, Tensor? next_ln_b, Tensor? next_s, "
    "ScalarType out_dtype) -> Tensor[]",
    _tail_impl, _tail_fake)
_a8w8_op = _kernels.define_op(
    "stream_linear_a8w8",
    "(Tensor x_q, Tensor x_scale, Tensor w, Tensor scale, Tensor? bias, "
    "str? activation, ScalarType out_dtype) -> Tensor", _a8w8_impl,
    lambda x_q, x_scale, w, scale, bias, activation, out_dtype:
    x_q.new_empty((x_q.shape[0], w.shape[-1]), dtype=out_dtype))


def stream_linear(x, w, layer=None, bias=None, scale=None,
                  activation=None, out_dtype=None, act_quant=False,
                  reduce_axis=None):
    """x [M, K] @ w[(L,) K, N] (+ bias) with streamed weights.

    layer: index when w/bias/scale are layer-stacked. scale: int8
    weight-only per-output-channel dequant scales [(L,) N]. activation:
    None | 'gelu' | 'relu', fused on the fp32 accumulator. act_quant:
    A8W8 — quantize x per token (absmax int8 + f32 scale) and run the
    GEMM int8 x int8 with int32 accumulation; needs int8 ``w`` with its
    ``scale``. Returns [M, N] in out_dtype (default: x.dtype).
    ``reduce_axis`` (tensor parallelism) belongs to a later slice of
    the port and raises.
    """
    if reduce_axis is not None:
        raise NotImplementedError(
            "stream_linear: reduce_axis= comes with the tensor-parallel "
            "serving slice of the port")
    out_dtype = out_dtype or x.dtype
    stacked = w.dim() == 3
    if stacked and x.device.type == "cuda" and layer is None:
        raise ValueError("stream_linear: a stacked w needs layer=")
    l = (0 if layer is None else int(layer)) if stacked else None

    def at(a):
        return a[l] if (stacked and a is not None) else a
    if act_quant:
        if w.dtype != torch.int8 or scale is None:
            raise ValueError(
                "stream_linear(act_quant=True) needs int8 weights with "
                "per-output-channel scales (quantize_weight_only_int8)")
        x_q, x_s = dynamic_act_quant(x)
        return _kernels.call(_a8w8_op, x_q, x_s, at(w), at(scale), at(bias),
                             activation, out_dtype)
    return _kernels.call(_gemm_op, x, at(w), at(bias), activation, out_dtype,
                         at(scale))


def stream_layer_tail(att, h, wo, w1, w2, layer=None, *, bo, b1, b2,
                      ln2_scale, ln2_bias, epsilon, activation=None,
                      so=None, s1=None, s2=None, next_qkv=None,
                      out_dtype=None, reduce_axis=None):
    """GROUPED layer tail: ``h2 = h + att @ Wo + bo; h_out = h2 +
    FFN(LN2(h2))`` and, with ``next_qkv``, the next layer's
    ``qkv' = LN1'(h_out) @ Wq' + bq'``.

    att [M, Ka], h [M, d]. Weights stacked [L, K, N] with ``layer``, or
    2-D. ``next_qkv``: dict with ``w``, ``b``, ``ln_s``, ``ln_b`` (and
    ``layer`` for the stacked form, and ``s`` for an int8 ``w``).
    ``so/s1/s2``: per-output-channel scales [(L,) N] of int8 wo/w1/w2 —
    all three or none. Returns ``h_out`` (and ``qkv`` when
    ``next_qkv``), in ``out_dtype`` (default: h.dtype). ``reduce_axis``
    (tensor parallelism) belongs to a later slice and raises.
    """
    scales = (so, s1, s2)
    if any(s is not None for s in scales) and \
            not all(s is not None for s in scales):
        raise ValueError("stream_layer_tail: pass all of so/s1/s2 or "
                         "none (the engine quantizes all four stacks)")
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

    def at(a, idx):
        return a[idx] if (stacked and a is not None) else a

    nq = {}
    if next_qkv is not None:
        lq = (int(next_qkv.get("layer") or 0)) if stacked else None
        nq = {k: at(next_qkv.get(k), lq) for k in ("w", "b", "ln_s", "ln_b",
                                                   "s")}
    outs = _kernels.call(
        _tail_op, att, h, at(wo, l), at(w1, l), at(w2, l), at(bo, l),
        at(b1, l), at(b2, l), at(ln2_scale, l), at(ln2_bias, l),
        float(epsilon), activation, at(so, l), at(s1, l), at(s2, l),
        nq.get("w"), nq.get("b"), nq.get("ln_s"), nq.get("ln_b"),
        nq.get("s"), out_dtype)
    return outs[0] if next_qkv is None else tuple(outs)
