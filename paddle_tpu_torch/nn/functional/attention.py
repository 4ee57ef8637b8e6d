"""Attention functionals: scaled dot-product attention and flash attention.

Counterpart of ``paddle_tpu/nn/functional/attention.py``. Layout: the
Paddle convention ``[batch, seqlen, num_heads, head_dim]``.

``_attention_raw`` routes as the JAX package does, without its TPU
test: the dropout path (an explicit softmax with a Bernoulli keep mask
from a ``torch.Generator``) when ``dropout_p > 0``; else the ``"flash"``
route exactly where ``_use_flash`` admits (no mask, ``head_dim % 8 ==
0``, both sequence lengths ``% 128 == 0``); else the ``"dense"`` route,
the counterpart of the XLA path's ``dot_product_attention``: f32 logits,
probabilities in the input's dtype, plain torch products.

The flash route is ``FlashAttentionFunction``, an autograd function
over kernel B10 (``csrc/flash_attention.cu``): the forward kernel
writes ``out`` and the f32 ``lse`` ``[b, h, s]``, which the backward's
two kernels (dq; dk and dv) read back with ``di = sum(out * dout)``, a
PyTorch reduction. In bf16 at head_dim 64, 96 and 128 the three are the
Hopper kernels ``flash_fwd_wgmma``, ``flash_bwd_dq_wgmma`` and
``flash_bwd_dkv_wgmma``: B11-B13's mainloops (``csrc/flash_wgmma.cuh``)
on a dense walk that needs no block map (``dense_walk``, ``flash_grid``),
reading q, k and v in place as strided views. On a CUDA tensor it
launches the kernels, or raises
(a build or launch failure, a head_dim past 256; a head_dim the
kernels lack below it runs zero-padded to the next built width, exactly);
on a CPU tensor it runs the plain versions ``flash_attention_fwd_plain`` and
``flash_attention_bwd_plain`` (explicit softmax in f32).

``flash_attn_unpadded`` is packed varlen attention over ``cu_seqlens``
segments: ``FLAGS_attn_varlen_backend`` ``auto``/``pallas`` take the
block-skipping kernels B11-B13 (``flash_varlen.flash_varlen_packed``) on
a CUDA tensor and their plain versions on a CPU tensor; ``interpret`` and
``xla`` the plain versions, CPU only; ``dense`` the O(T^2) masked-dense
reference ``_unpadded_dense_raw``, CPU only. A plain value raises for a
CUDA tensor.
"""
from __future__ import annotations

import torch

from ... import _kernels
from ...core.flags import flag
from ...core.generator import default_generator
from . import flash_varlen

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "flash_attn_unpadded", "set_flash_block_sizes",
           "last_attention_backend", "FlashAttentionFunction",
           "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_fwd_plain", "flash_attention_bwd_plain",
           "FLASH_HEAD_DIMS"]

#: head dims the CUDA kernels are built for; another multiple of 8 below
#: 256 runs zero-padded to the next of them, a wider head raises on the
#: card
FLASH_HEAD_DIMS = (64, 96, 128, 256)

#: the stock TPU kernel's finite mask value (-0.7 * float32 max)
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

#: launches of the three CUDA kernels, counted once each has been
#: issued without an error (plain CPU calls do not count)
fwd_launches = 0
dq_launches = 0
dkv_launches = 0

_LAST_BACKEND = [None]


def last_attention_backend():
    """Which route the most recent attention call took: ``"flash"``
    (B10 on the card, its plain versions on the CPU) or ``"dense"`` (the
    plain products, also the dropout path)."""
    return _LAST_BACKEND[0]


def _use_flash(head_dim: int, seq_q: int, seq_k: int,
               has_bias: bool) -> bool:
    """The JAX package's ``_use_pallas`` gate without its TPU test."""
    return (not has_bias and head_dim % 8 == 0 and seq_q % 128 == 0
            and seq_k % 128 == 0)


def _causal_keep(s_q: int, s_k: int, device, offset: int = 0):
    """``[s_q, s_k]`` bool: key j is visible from query i iff ``j <= i +
    offset`` (0: from the top left, as the TPU kernel and the XLA path)."""
    return torch.ones((s_q, s_k), dtype=torch.bool,
                      device=device).tril(offset)


# ---------------------------------------------------------------------
# Plain versions of kernel B10
# ---------------------------------------------------------------------

def _logits(q, k, bias, causal: bool, scale: float, *,
            dtype=torch.float32, offset: int = 0, mask_value=MASK_VALUE,
            drop=None):
    """``[b, h, sq, sk]`` scaled logits in ``dtype`` plus ``bias``; under
    ``causal``, keys past query ``i + offset`` take ``mask_value``
    (``None``: the logits dtype's minimum), as do the (query, key) pairs
    that the bool ``drop`` ``[sq, sk]`` marks."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(dtype), k.to(dtype)) * scale
    if bias is not None:
        s = s + (bias if bias.ndim == 4 else bias[:, None])
    hide = drop
    if causal:
        above = ~_causal_keep(s.shape[-2], s.shape[-1], q.device, offset)
        hide = above if hide is None else above | hide
    if hide is not None:
        s = s.masked_fill(hide, torch.finfo(s.dtype).min
                          if mask_value is None else mask_value)
    return s


def flash_attention_fwd_plain(q, k, v, causal: bool, scale: float, *,
                              drop=None):
    """``(out [b, sq, h, d] in q's dtype, lse [b, h, sq] f32)`` by an
    explicit f32 softmax. ``drop`` (bool ``[sq, sk]``) leaves those
    (query, key) pairs out, as a kernel that skipped them would."""
    s = _logits(q, k, None, causal, scale, drop=drop)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, out, lse, dout, causal: bool,
                              scale: float, *, drop=None):
    """``(dq, dk, dv)`` in q's dtype, in closed form from the f32 ``lse``
    as the kernels compute them: ``P = exp(s - lse)``, ``dV = P^T dO``,
    ``dS = P (dO V^T - di)``, ``dQ = scale dS K``, ``dK = scale dS^T Q``.
    ``drop`` as in the forward: those pairs' ``P`` and ``dS`` are 0."""
    s = _logits(q, k, None, causal, scale, drop=drop)
    p = torch.exp(s - lse[..., None])
    do = dout.float()
    di = flash_delta(out, do)                                 # [b, h, sq]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    ds = p * (dp - di[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


# ---------------------------------------------------------------------
# Kernel B10
# ---------------------------------------------------------------------

#: a launch grid's limits by axis (x, y, z)
_GRID_LIMITS = (2 ** 31 - 1, 65535, 65535)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def flash_grid(kernel: str, dtype, head_dim: int, b: int, sq: int, sk: int,
               h: int, sms: int = 132) -> tuple:
    """The launch grid the C dispatch gives B10's ``kernel`` (``"fwd"``,
    ``"dq"`` or ``"dkv"``) on a card of ``sms`` SMs: the wgmma kernels
    (bf16 at head_dim <= 128) one axis over ``ceil(tiles / 2) * b * h``
    fold units (``dense_walk``; tiles of 128 rows of ``sq``, of ``sk`` for
    dk/dv): the forward and dq a block per ``ceil(units / sms)`` units, at
    most ``sms`` blocks; dk/dv a block a (tile, batch, head); the others
    ``(tiles, h, b)``: 64-row tiles at bf16 d256 (dk/dv with two column
    halves a tile), 32-row tiles in f32."""
    rows = sk if kernel == "dkv" else sq
    if dtype == torch.bfloat16 and head_dim <= 128:
        units = _cdiv(_cdiv(rows, 128), 2) * b * h
        if kernel == "dkv":
            return _cdiv(rows, 128) * b * h, 1
        return _cdiv(units, _cdiv(units, sms)), 1
    if dtype == torch.bfloat16:
        return rows // 64 * (2 if kernel == "dkv" else 1), h, b
    return rows // 32, h, b


def dense_walk(kernel: str, sq: int, sk: int, causal: bool) -> list:
    """B10's walk on the card (bf16 at head_dim <= 128) for one (batch,
    head), as ``DenseWalk`` in ``csrc/flash_attention.cu`` works it out
    from ``(sq, sk, causal)``: one dict per 128-row tile (q rows for
    ``"fwd"`` and ``"dq"``, keys for ``"dkv"``), in the order the grid
    takes them: the forward and dq by fold units, tiles ``nt - 1 - f`` and
    ``f`` of ``nt``, whose causal walks add up to the same length in every
    unit, a block taking a few units one after the other; dk/dv a tile a
    block, the longest causal walks (the lowest k tiles) first: ``r0``, the
    tile's first row; ``steps``, the first row of each step (128-key
    tiles, 64-key sub-tiles, or 64-row q sub-tiles for dk/dv); and
    ``interior``, per step, whether no pair in it is masked (the kernel
    then skips its mask pass). Under causal (top left) q tile ``i``
    visits key tiles ``0 .. min(i, nk - 1)`` and k tile ``j`` the q rows
    from ``128 j`` on; dq and dk/dv stop at ``sk`` or ``sq``."""
    walk = []
    nt = _cdiv(sk if kernel == "dkv" else sq, 128)
    order = range(nt) if kernel == "dkv" else [
        i for f in range(_cdiv(nt, 2)) for i in dict.fromkeys((nt - 1 - f,
                                                               f))]
    if kernel == "dkv":
        for t in order:
            r0, s0 = 128 * t, (2 * t if causal else 0)
            steps = [64 * (s0 + s) for s in range(max(sq // 64 - s0, 0))]
            walk.append({"r0": r0, "steps": steps, "interior": [
                not causal or r0 + 127 <= f for f in steps]})
        return walk
    step = 128 if kernel == "fwd" else 64
    for tile in order:
        r0 = tile * 128
        seen = min(r0 + 128, sk) if causal else sk
        steps = [step * s for s in range(_cdiv(seen, step))]
        walk.append({"r0": r0, "steps": steps, "interior": [
            (not causal or f + step - 1 <= r0)
            and (kernel == "dq" or f + step <= sk) for f in steps]})
    return walk


def _check_operands(what, q, k, v, kernels=("fwd", "dq", "dkv")):
    b, sq, h, d = q.shape
    if k.shape != (b, k.shape[1], h, d) or v.shape != k.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)} "
                         f"and v {tuple(v.shape)} must be [b, s, h, d] "
                         "with one b, h and d")
    if d not in FLASH_HEAD_DIMS:
        raise NotImplementedError(
            f"{what}: head_dim {d}: the CUDA kernel is built for "
            f"{FLASH_HEAD_DIMS} (flash_attention_fwd/bwd pad to them)")
    tile = 64 if q.dtype == torch.bfloat16 else 32
    if sq % tile or k.shape[1] % tile:
        raise ValueError(f"{what}: sequence lengths {sq}, {k.shape[1]} "
                         f"must be multiples of {tile}")
    for t in (k, v):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{what}: q, k and v must share device and "
                             "dtype")
    _kernels.dtype_code(q, what)
    for kernel in kernels:
        rows = k.shape[1] if kernel == "dkv" else sq
        units = _cdiv(_cdiv(rows, 128), 2) * b * h
        if q.dtype == torch.bfloat16 and d <= 128 and units > 2 ** 31 - 1:
            raise ValueError(f"{what}: the {kernel} kernel's {units} fold "
                             "units pass the int32 limit of 2147483647")
        grid = flash_grid(kernel, q.dtype, d, b, sq, k.shape[1], h)
        for axis, (n, limit) in enumerate(zip(grid, _GRID_LIMITS)):
            if n > limit:
                raise ValueError(
                    f"{what}: the {kernel} kernel's grid {grid} has {n} "
                    f"blocks on axis {'xyz'[axis]}, past its limit of "
                    f"{limit}")


def _strided(t):
    """``t`` if its last axis is contiguous and its row, head and batch
    strides keep 16-byte alignment, else a contiguous copy."""
    vec = 16 // t.element_size()
    if (t.stride(3) != 1 or any(s % vec for s in t.stride()[:3])
            or t.data_ptr() % 16):
        t = t.contiguous()
    return t


def _strides(*ts):
    return [s for t in ts for s in (t.stride(0), t.stride(1), t.stride(2))]


def _flash_fwd_cuda(q, k, v, causal, scale):
    what = "flash_attention forward"
    _check_operands(what, q, k, v, ("fwd",))
    fn = _kernels.lib("flash_attention").ptt_flash_fwd
    q, k, v = _strided(q), _strided(k), _strided(v)
    b, sq, h, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _kernels.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), lse.data_ptr(),
                      _kernels.dtype_code(q, what), b, sq, k.shape[1], h,
                      d, *_strides(q, k, v), int(causal), float(scale),
                      _kernels.stream_ptr(q.device)), what)
    global fwd_launches
    fwd_launches += 1
    return out, lse


def _aligned(t):
    """``t``, or a copy if its data does not start on 16 bytes (the
    kernels' bulk copies and tensor maps need it)."""
    return t.clone() if t.data_ptr() % 16 else t


def _bwd_operands(what, q, k, v, dout, lse, di, causal, kernel):
    _check_operands(what, q, k, v, (kernel,))
    lib = _kernels.lib("flash_attention")
    b, sq, h, d = q.shape
    for t, shape in ((dout, (b, sq, h, d)), (lse, (b, h, sq)),
                     (di, (b, h, sq))):
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{what}: dout, lse and di must be contiguous "
                             f"{(b, sq, h, d)}, {(b, h, sq)}, {(b, h, sq)}")
    if dout.dtype != q.dtype or lse.dtype != torch.float32 \
            or di.dtype != torch.float32:
        raise TypeError(f"{what}: dout in q's dtype, lse and di in f32")
    q, k, v = _strided(q), _strided(k), _strided(v)
    head = (_kernels.dtype_code(q, what), b, sq, k.shape[1], h, d,
            *_strides(q, k, v), int(causal))
    return lib, q, k, v, *(_aligned(t) for t in (dout, lse, di)), head


def _flash_bwd_dq_cuda(q, k, v, dout, lse, di, causal, scale):
    """dq by ``ptt_flash_bwd_dq``: one launch."""
    what = "flash_attention backward (dq)"
    lib, q, k, v, dout, lse, di, head = _bwd_operands(what, q, k, v, dout,
                                                      lse, di, causal, "dq")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _kernels.check(lib.ptt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), *head, float(scale),
        _kernels.stream_ptr(q.device)), what)
    global dq_launches
    dq_launches += 1
    return dq


def _flash_bwd_dkv_cuda(q, k, v, dout, lse, di, causal, scale):
    """dk and dv by ``ptt_flash_bwd_dkv``: one launch."""
    what = "flash_attention backward (dk, dv)"
    lib, q, k, v, dout, lse, di, head = _bwd_operands(what, q, k, v, dout,
                                                      lse, di, causal, "dkv")
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _kernels.check(lib.ptt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(), *head,
        float(scale), _kernels.stream_ptr(q.device)), what)
    global dkv_launches
    dkv_launches += 1
    return dk, dv


def flash_delta(out, dout):
    """``di = sum(out * dout)`` over the head dim, f32 ``[b, h, s]``: a
    PyTorch reduction beside the backward kernels, as the TPU kernel
    leaves it to XLA."""
    return (out.float() * dout.float()).sum(-1).transpose(1, 2) \
        .contiguous()


def _flash_bwd_cuda(q, k, v, out, lse, dout, causal, scale):
    """``(dq, dk, dv)``: ``di`` by a PyTorch reduction, then B10's dq and
    dk/dv kernels."""
    dout = dout.to(q.dtype).contiguous()
    lse, di = lse.contiguous(), flash_delta(out, dout)
    dq = _flash_bwd_dq_cuda(q, k, v, dout, lse, di, causal, scale)
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, dout, lse, di, causal, scale)
    return dq, dk, dv


def flash_attention_fwd(q, k, v, causal: bool, scale: float):
    """``(out, lse)``: kernel B10's forward on a CUDA tensor (zero-padded
    to a built head width, ``flash_varlen.padded_fwd``), its plain
    version on a CPU tensor."""
    if q.device.type == "cuda":
        return flash_varlen.padded_fwd(_flash_fwd_cuda, FLASH_HEAD_DIMS,
                                       "flash_attention", q, k, v, causal,
                                       scale)
    return flash_attention_fwd_plain(q, k, v, causal, scale)


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool,
                        scale: float):
    """``(dq, dk, dv)``: kernel B10's two backward kernels on a CUDA
    tensor (zero-padded as the forward), the plain version on a CPU
    tensor."""
    if q.device.type == "cuda":
        return flash_varlen.padded_bwd(_flash_bwd_cuda, FLASH_HEAD_DIMS,
                                       "flash_attention", q, k, v, out, lse,
                                       dout, causal, scale)
    return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal, scale)


class FlashAttentionFunction(torch.autograd.Function):
    """The flash route's autograd function (the JAX package's
    ``_flash_core`` custom VJP): saves ``out`` and ``lse``, and its
    backward runs the dq and dk/dv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


# ---------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------

def _dense_attention(q, k, v, bias, causal: bool, scale: float):
    """Counterpart of the XLA path (``_xla_attention``): f32 logits,
    bias, the finite mask, softmax, probabilities cast to the input's
    dtype, then the value product in that dtype."""
    logits = _logits(q, k, None if bias is None else bias.float(), causal,
                     scale)
    probs = torch.softmax(logits, dim=-1).to(k.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _attention_raw(q, k, v, bias=None, *, causal=False, scale=None,
                   dropout_p=0.0, generator=None):
    head_dim = q.shape[-1]
    scale = scale if scale is not None else head_dim ** -0.5
    if bias is not None and bias.dtype == torch.bool:
        bias = torch.where(bias, 0.0, torch.finfo(q.dtype).min).to(q.dtype)
    if dropout_p > 0.0:
        # dropout on the attention weights: the explicit softmax path
        logits = _logits(q, k, bias, causal, scale, dtype=q.dtype,
                         offset=k.shape[1] - q.shape[1], mask_value=None)
        w = torch.softmax(logits, dim=-1)
        gen = generator if generator is not None \
            else default_generator(q.device)
        keep = torch.rand(w.shape, generator=gen, device=w.device) \
            < 1.0 - dropout_p
        w = w * keep.to(w.dtype) / (1.0 - dropout_p)
        _LAST_BACKEND[0] = "dense"
        return torch.einsum("bhqk,bkhd->bqhd", w, v)
    if _use_flash(head_dim, q.shape[1], k.shape[1], bias is not None):
        _LAST_BACKEND[0] = "flash"
        return FlashAttentionFunction.apply(q, k, v, bool(causal),
                                            float(scale))
    _LAST_BACKEND[0] = "dense"
    return _dense_attention(q, k, v, bias, causal, scale)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None, generator=None):
    """Attention over ``[b, s, h, d]`` tensors (Paddle's signature);
    ``generator`` draws the dropout mask (default: the device's)."""
    p = dropout_p if training else 0.0
    return _attention_raw(query, key, value, attn_mask,
                          causal=bool(is_causal), dropout_p=float(p),
                          generator=generator)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None, generator=None):
    """Paddle ``flash_attention``: returns ``(out, None)``."""
    if return_softmax:
        raise NotImplementedError(
            "return_softmax materialises the attention matrix — "
            "unsupported by the flash path")
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training,
                                       generator=generator)
    return out, None


def _unpadded_dense_raw(q, k, v, cu_q, cu_k, *, scale, causal):
    """The JAX package's legacy dense varlen path, as a plain version:
    the full segment mask and ``[h, total_q, total_k]`` logits in the
    inputs' dtype, O(T^2) memory (the reference for the block-skipping
    kernels, and ``FLAGS_attn_varlen_backend=dense``). Masked logits take
    the dtype's minimum, so a query that sees no key averages every key,
    as in the reference. The scale and the softmax take the reference's
    steps (a scale in the inputs' dtype; ``exp(x - max)`` over its sum
    taken in f32), so bf16 rounds where it does."""
    total_q, total_k = q.shape[0], k.shape[0]
    seg_q, off_q = flash_varlen._seg_pos(cu_q.to(torch.int32), total_q)
    seg_k, off_k = flash_varlen._seg_pos(cu_k.to(torch.int32), total_k)
    mask = seg_q[:, None] == seg_k[None, :]
    if causal:
        mask = mask & (off_q[:, None] >= off_k[None, :])
    logits = torch.einsum("qhd,khd->hqk", q, k) * q.new_tensor(scale)
    logits = torch.where(mask[None], logits, torch.finfo(logits.dtype).min)
    un = torch.exp(logits - logits.amax(-1, keepdim=True).detach())
    w = un / un.float().sum(-1, keepdim=True).to(un.dtype)
    return torch.einsum("hqk,khd->qhd", w, v)


def _unpadded_varlen_raw(q, k, v, cu_q, cu_k, *, scale, causal):
    """Packed varlen attention routed by ``FLAGS_attn_varlen_backend``:
    ``dense`` is the plain O(T^2) path (the CPU only: it raises for a
    CUDA tensor); every other value goes to ``flash_varlen_packed``."""
    backend = flag("attn_varlen_backend")
    if backend == "dense":
        if q.device.type == "cuda":
            raise ValueError(
                "attn_varlen_backend='dense' names the O(T^2) plain path, "
                "which runs on the CPU only; on the card the kernels of "
                "csrc/flash_varlen_packed.cu serve every packing")
        cu_q, cu_k = (torch.as_tensor(c).to(q.device) for c in (cu_q, cu_k))
        return _unpadded_dense_raw(q, k, v, cu_q, cu_k, scale=scale,
                                   causal=causal)
    return flash_varlen.flash_varlen_packed(q, k, v, cu_q, cu_k, scale=scale,
                                            causal=causal, backend=backend)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Paddle ``flash_attn_unpadded``: varlen flash attention over a packed
    batch ``[total_tokens, heads, head_dim]`` whose segments are cut by
    ``cu_seqlens_q``/``cu_seqlens_k``. Returns ``(out, None)``.

    As in the JAX package, ``dropout``, ``max_seqlen_q``/``max_seqlen_k``,
    ``training``, ``return_softmax``, ``fixed_seed_offset`` and
    ``rng_name`` are accepted and ignored: no dropout is applied and no
    softmax is returned. ``cu_seqlens`` stay on the device: no host read
    between them and the kernels' launches."""
    out = _unpadded_varlen_raw(query, key, value, cu_seqlens_q,
                               cu_seqlens_k, scale=float(scale),
                               causal=bool(causal))
    return out, None


def set_flash_block_sizes(block_q=None, block_k=None):
    """A TPU VMEM tile knob; the CUDA kernels' tiles are fixed."""
    raise NotImplementedError(
        "set_flash_block_sizes tunes the TPU kernel's VMEM tiles; the "
        "port's tile tuning comes with the kernel-tuning slice")
