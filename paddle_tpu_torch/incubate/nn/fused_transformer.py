"""Fused transformer decode stack — the LLM-serving compute path.

Counterpart of ``paddle_tpu/incubate/nn/fused_transformer.py``: a
pre-LN GPT stack whose weights are stacked along a leading layer axis
([L, K, N]), with a layer-folded paged KV pool (``PagedKV``) updated in
place by the decode step.

The decode step (``decode_raw``) runs the port's kernels: the fused
KV-append + paged attention (``paged_decode_attention_inplace``, or
``paged_decode_attention_inplace_q`` over an int8 pool; under
``FLAGS_paged_attention_backend`` ``fused``, ``pallas`` or ``xla`` the
write-then-attend pair ``write_kv_pages`` + ``paged_attention``), the QKV
projection (``stream_linear``) and the grouped layer tail
(``stream_layer_tail``); A8W8 runs the ungrouped loop through
``stream_linear(act_quant=True)``. The chunked prefill of the serving
frontend (``prefill_chunk_raw``) attends over the pool in place through
the paged-prefill kernel (``paged_prefill_attention``), or through the
dequantizing dense gather over an int8 pool; its projections, like the
one-shot prefill (``prefill_raw``), are plain PyTorch (``torch._int_mm``
for A8W8 on the card), as the JAX package leaves them to XLA.

Quantization: ``quantize_weight_only_int8`` turns the four matmul
stacks into int8 with per-output-channel scales (``{kind}_scale_woq``
parameters, ``{kind}_scale`` in ``_stack()``); an int8 KV pool keeps
each side as ``(int8 rows, f32 scale plane)``.

MoE: ``moe_num_experts=E`` replaces the dense FFN with a per-layer
expert bank (``gate_weight [L, d, E]``, ``moe_w1 [L, E, d, dff]``,
``moe_b1``, ``moe_w2 [L, E, dff, d]``, ``moe_b2``) served through the
no-drop ragged grouped GEMM (``nn/functional/grouped_gemm.py``, kernel
``csrc/grouped_gemm.cu``); its decode runs the ungrouped layer body
with plain QKV/O products, as the JAX package's does.

Multi-LoRA: ``adapters`` (an ``AdapterBank``'s operands plus the
per-row ``slots``) add one ragged delta launch per target projection
(``nn/functional/lora.py``) to the chunked prefill and to the decode
step, whose adaptered branch runs the four-call per-layer form (the
grouped tail has no join point for a delta). Tensor parallelism comes
with a later slice of the port and raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...core.device import resolve_device
from ...core.flags import flag
from ...core.generator import default_generator
from ...nn.functional.flash_varlen import (_paged_prefill_plain,
                                           paged_prefill_attention)
from ...nn.functional.grouped_gemm import moe_ffn_nodrop
from ...nn.functional.lora import (inverse_order, lora_delta,
                                   sort_by_adapter)
from ...nn.functional.paged_attention import (
    backend_flag, check_stream_head_dim, paged_attention,
    paged_decode_attention_inplace, paged_decode_attention_inplace_q,
    write_kv_pages, write_prefill_kv_pages)
from ...nn.functional.stream_linear import (_apply_activation,
                                            stream_layer_tail, stream_linear)
from ...quantization.dynamic import (absmax_scale, dynamic_act_quant,
                                     int8_dot_dequant)

__all__ = ["qkv_split_rope_fused", "rope_table", "FusedMultiTransformer",
           "PagedKV"]


def rope_table(max_pos: int, head_dim: int, theta: float = 10000.0,
               device=None):
    """Precomputed rotary cos/sin, [max_pos, head_dim//2] each, fp32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    ang = torch.arange(max_pos, dtype=torch.float32,
                       device=device)[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def _apply_rope(x, cos, sin):
    """x: [..., head_dim]; cos/sin broadcastable [..., head_dim//2].
    Half-rotation (GPT-NeoX) convention, fp32 tables, cast back to x's
    dtype."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _split_rope(proj, positions, num_heads, num_kv_heads, head_dim,
                cos_table, sin_table):
    """Head split + rotary embedding over a computed QKV projection."""
    lead = proj.shape[:-1]
    nq, nkv = num_heads, num_kv_heads
    q, k, v = torch.split(
        proj.reshape(*lead, nq + 2 * nkv, head_dim), [nq, nkv, nkv],
        dim=-2)
    # positions past the table clamp to its last row, as the JAX
    # package's gather does (a chunk's padded tail rows can reach them)
    pos = positions.long().clamp(0, cos_table.shape[0] - 1)
    cos = cos_table[pos][..., None, :]   # [.., 1, hd/2]
    sin = sin_table[pos][..., None, :]
    return _apply_rope(q, cos, sin), _apply_rope(k, cos, sin), v


def qkv_split_rope_fused(x, qkv_w, qkv_b, positions, num_heads,
                         num_kv_heads, head_dim, cos_table, sin_table):
    """Fused QKV projection + head split + rotary embedding. x may be
    [b, d_model] (decode) or [b, s, d_model] (prefill); positions
    matches x's token dims. Returns q [.., n_q, hd], k/v [.., n_kv, hd].
    """
    proj = x @ qkv_w
    if qkv_b is not None:
        proj = proj + qkv_b
    return _split_rope(proj, positions, num_heads, num_kv_heads,
                       head_dim, cos_table, sin_table)


class PagedKV(NamedTuple):
    """Layer-folded PAGE-MAJOR paged KV pool: layer ``l``'s logical page
    ``p`` lives at physical page ``l * num_pages + p``; each page is one
    contiguous [n_kv, page_size, head_dim] block. The decode step
    updates the tensors in place. An int8 pool's sides are pairs
    ``(int8 rows, f32 scale plane [n_kv, pages * page_size])``."""
    k: object   # [num_layers * num_pages, n_kv, page_size, head_dim]
    v: object


_STACK_NAMES = ("ln1_scale", "ln1_bias", "qkv_weight", "qkv_bias",
                "out_weight", "out_bias", "ln2_scale", "ln2_bias")
_FFN_NAMES = ("ffn1_weight", "ffn1_bias", "ffn2_weight", "ffn2_bias")
_MOE_NAMES = ("gate_weight", "moe_w1", "moe_b1", "moe_w2", "moe_b2")
#: the matmul stacks that weight-only int8 quantization turns to int8
QUANT_KINDS = ("qkv", "out", "ffn1", "ffn2")


def _later_slice(what: str, slice_name: str):
    return NotImplementedError(
        f"{what} comes with the {slice_name} slice of the port")


class FusedMultiTransformer(nn.Module):
    """Pre-LN GPT-style transformer stack with paged-KV incremental
    decode. Parameters are stacked [num_layers, ...] tensors with the
    JAX package's names and shapes; they carry no gradient (serving).
    ``device=None`` places them on the CUDA card."""

    def __init__(self, embed_dim, num_heads, dim_feedforward, num_layers,
                 num_kv_heads=None, activation="gelu", epsilon=1e-5,
                 rope_theta=10000.0, max_position=32768,
                 moe_num_experts=None, moe_top_k=2, device=None):
        super().__init__()
        device = resolve_device(device)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = embed_dim // num_heads
        self.dim_feedforward = dim_feedforward
        self.num_layers = num_layers
        self.activation = activation
        self.epsilon = epsilon
        self.rope_theta = rope_theta
        self.max_position = max_position
        self.moe_num_experts = int(moe_num_experts) if moe_num_experts \
            else None
        self.moe_top_k = moe_top_k

        L, d, dff = num_layers, embed_dim, dim_feedforward
        qkv_out = (self.num_heads + 2 * self.num_kv_heads) * self.head_dim
        gen = default_generator(device)

        def mk(t):
            return nn.Parameter(t, requires_grad=False)

        def ones(*s):
            return mk(torch.ones(s, device=device))

        def zeros(*s):
            return mk(torch.zeros(s, device=device))

        def normal(*s):
            return mk(torch.randn(s, generator=gen, device=device) * 0.02)

        self.ln1_scale = ones(L, d)
        self.ln1_bias = zeros(L, d)
        self.qkv_weight = normal(L, d, qkv_out)
        self.qkv_bias = zeros(L, qkv_out)
        self.out_weight = normal(L, self.num_heads * self.head_dim, d)
        self.out_bias = zeros(L, d)
        self.ln2_scale = ones(L, d)
        self.ln2_bias = zeros(L, d)
        if self.moe_num_experts:
            E = self.moe_num_experts
            self.gate_weight = normal(L, d, E)
            self.moe_w1 = normal(L, E, d, dff)
            self.moe_b1 = zeros(L, E, dff)
            self.moe_w2 = normal(L, E, dff, d)
            self.moe_b2 = zeros(L, E, d)
        else:
            self.ffn1_weight = normal(L, d, dff)
            self.ffn1_bias = zeros(L, dff)
            self.ffn2_weight = normal(L, dff, d)
            self.ffn2_bias = zeros(L, d)

    # ---------- functional core (raw tensors) ----------

    def _stack(self):
        names = _STACK_NAMES + (_MOE_NAMES if self.moe_num_experts
                                else _FFN_NAMES)
        out = {n: getattr(self, n) for n in names}
        for n in QUANT_KINDS:
            s = getattr(self, f"{n}_scale_woq", None)
            if s is not None:
                out[f"{n}_scale"] = s
        return out

    def add_woq_scales(self):
        """Register the ``{kind}_scale_woq`` [L, N] parameters of an int8
        stack (ones; ``quantize_weight_only_int8`` or a loaded quantized
        state fills them)."""
        for n in QUANT_KINDS:
            if getattr(self, f"{n}_scale_woq", None) is None:
                w = getattr(self, f"{n}_weight")
                self.register_parameter(f"{n}_scale_woq", nn.Parameter(
                    torch.ones(w.shape[0], w.shape[2], device=w.device),
                    requires_grad=False))
        return self

    def quantize_weight_only_int8(self):
        """In-place weight-only int8 quantization of the four matmul
        stacks: symmetric per-output-channel scales ``max(absmax / 127,
        1e-8)`` over K, ``q = clip(round(w / scale), -127, 127)``;
        biases and LNs stay full precision. The products apply the
        scales on their OUTPUTS (``_mm``), so the weight stream halves
        against bf16."""
        if self.moe_num_experts:
            raise NotImplementedError(
                "int8 weight-only quantization of the MoE expert bank "
                "is not supported yet — serve MoE stacks in bf16/f32")
        self.add_woq_scales()
        for n in QUANT_KINDS:
            p = getattr(self, f"{n}_weight")
            w = p.data.float()
            scale = absmax_scale(w.abs().amax(dim=1, keepdim=True))
            p.data = torch.clamp(torch.round(w / scale), -127, 127) \
                .to(torch.int8)                             # [L, K, N]
            getattr(self, f"{n}_scale_woq").data = scale[:, 0, :]
        return self

    def _act(self, x):
        return (F.gelu(x, approximate="tanh") if self.activation == "gelu"
                else F.relu(x))

    @staticmethod
    def _ln(x, scale, bias, eps):
        """LayerNorm with fp32 statistics (population variance); the
        result has the promoted dtype of x and scale, as in JAX."""
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * scale.float() \
            + bias.float()
        return y.to(torch.promote_types(x.dtype, scale.dtype))

    @staticmethod
    def _mm(x, w, scale=None):
        """x @ w; int8 weights dequantize on the OUTPUT by their
        per-output-channel scales, in the compute dtype."""
        if w.dtype == torch.int8:
            return (x @ w.to(x.dtype)) * scale.to(x.dtype)
        return x @ w

    @staticmethod
    def _mm_a8w8(x, w_q, scale):
        """A8W8 product: per-token dynamic int8 activations against the
        int8 weights, int32 accumulation, one dequant by ``act_scale (x)
        scale``. Returns f32 (the caller casts back)."""
        xq, xs = dynamic_act_quant(x)
        return int8_dot_dequant(xq, xs, w_q, scale)

    def _moe_ffn(self, w, hn):
        """The MoE FFN of one layer over normalized hidden ``hn`` (any
        leading dims): flatten to tokens and route them through the
        no-drop ragged grouped-GEMM FFN."""
        lead = hn.shape[:-1]
        y, _probs, _idx, _cnt = moe_ffn_nodrop(
            hn.reshape(-1, self.embed_dim), w["gate_weight"], w["moe_w1"],
            w["moe_b1"], w["moe_w2"], w["moe_b2"], top_k=self.moe_top_k,
            activation=self.activation,
            backend=flag("moe_grouped_backend"))
        return y.reshape(*lead, self.embed_dim)

    @staticmethod
    def _lora_delta_fn(adapters):
        """Per-projection LoRA delta over ONE layer's adapter view
        (``{proj}_a [S, K, R]`` / ``{proj}_b`` banks plus the chunk's
        ``order``/``inv``/``offsets`` from ``sort_by_adapter``). Returns
        f32 ``[.., N]``, or None when the projection has no target;
        base-model tokens (sorted past ``offsets[-1]``) get exact-zero
        rows."""
        backend = flag("lora_delta_backend")

        def delta(x, kind):
            a = adapters.get(f"{kind}_a")
            if a is None:
                return None
            x2 = x.reshape(-1, x.shape[-1])
            d = lora_delta(x2[adapters["order"].long()], a,
                           adapters[f"{kind}_b"], adapters["offsets"],
                           backend=backend)
            d = d[adapters["inv"].long()]
            return d.reshape(*x.shape[:-1], d.shape[-1])

        return delta

    def _layer_body(self, w, h, positions, kv_write, attend, cos_t, sin_t,
                    linear=None, a8w8=False, adapters=None):
        """One pre-LN transformer layer over hidden ``h`` (any leading
        dims). Compute dtype follows h. ``attend`` may return
        (att, ck, cv) — the fused append+attend path, where kv_write is
        None. ``linear(x, kind)`` computes x @ W_kind (* scale) + bias;
        by default through ``_mm``, or ``_mm_a8w8`` with ``a8w8``, plus
        the LoRA delta of ``adapters`` (one layer's view) before the
        bias. An MoE stack's FFN is ``_moe_ffn``."""
        eps = self.epsilon
        if adapters is not None and linear is not None:
            raise ValueError(
                "_layer_body: adapters compose with the default linear "
                "only (the decode loop has its own adaptered branch)")
        if linear is None:
            lora = None if adapters is None \
                else self._lora_delta_fn(adapters)

            def linear(x, kind):
                if a8w8:
                    y = self._mm_a8w8(x, w[f"{kind}_weight"],
                                      w[f"{kind}_scale"])
                else:
                    y = self._mm(x, w[f"{kind}_weight"],
                                 w.get(f"{kind}_scale"))
                if lora is not None:
                    d = lora(x, kind)
                    if d is not None:
                        y = y + d
                return y + w[f"{kind}_bias"]
        hn = self._ln(h, w["ln1_scale"], w["ln1_bias"], eps).to(h.dtype)
        proj = linear(hn, "qkv")
        q, k, v = _split_rope(proj.to(h.dtype), positions, self.num_heads,
                              self.num_kv_heads, self.head_dim, cos_t,
                              sin_t)
        if kv_write is None:
            att, ck, cv = attend(q, k, v, None, None)
        else:
            ck, cv = kv_write(k, v)
            att = attend(q, k, v, ck, cv)
        att = att.reshape(*h.shape[:-1],
                          self.num_heads * self.head_dim).to(h.dtype)
        h = (h + linear(att, "out")).to(h.dtype)
        hn = self._ln(h, w["ln2_scale"], w["ln2_bias"], eps).to(h.dtype)
        if self.moe_num_experts:
            h = (h + self._moe_ffn(w, hn)).to(h.dtype)
            return h, ck, cv
        ff = self._act(linear(hn, "ffn1").to(h.dtype))
        h = (h + linear(ff, "ffn2")).to(h.dtype)
        return h, ck, cv

    @staticmethod
    def _pool_data(side):
        """Page rows of a cache side (an int8 side is a (rows, scale
        plane) pair)."""
        return side[0] if isinstance(side, tuple) else side

    def _pages_per_layer(self, cache: PagedKV) -> int:
        return self._pool_data(cache.k).shape[0] // self.num_layers

    @staticmethod
    def _check_serving_args(weights, a8w8, tp):
        if a8w8 and weights["qkv_weight"].dtype != torch.int8:
            raise ValueError("a8w8 needs an int8 weight stack "
                             "(quantize_weight_only_int8 first)")
        if tp is not None:
            raise _later_slice("tensor-parallel serving", "TP serving")

    def _weights_layer(self, weights, l):
        return {n: a[l] for n, a in weights.items()}

    def prefill_raw(self, weights, x, cache, block_tables, cos_t, sin_t,
                    a8w8=False, tp=None):
        """Prompt pass: x [b, s, d] → (hidden [b, s, d], filled cache).

        Causal dense attention; each layer's K/V written into its
        layer-offset pages of the folded pool (in place). ``cache=None``
        runs the pure dense forward with no KV writes. Ragged batches
        are not masked here — prompts are right-padded to a common
        length (causal attention keeps the real tokens exact).
        ``a8w8``: the four products take per-token dynamic int8
        activations against the int8 stack (``_mm_a8w8``)."""
        if isinstance(weights, (list, tuple)):
            raise ValueError("prefill_raw takes the stacked weight dict")
        self._check_serving_args(weights, a8w8, tp)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        group = self.num_heads // self.num_kv_heads
        scale = self.head_dim ** -0.5
        causal = torch.ones(s, s, dtype=torch.bool,
                            device=x.device).tril()

        def attend(q, k, v, ck, cv):
            kq = k.repeat_interleave(group, dim=-2)
            vq = v.repeat_interleave(group, dim=-2)
            logits = torch.einsum("btnh,bsnh->bnts", q.float(),
                                  kq.float()) * scale
            logits = torch.where(causal, logits,
                                 torch.finfo(torch.float32).min)
            wts = torch.softmax(logits, dim=-1)
            out = torch.einsum("bnts,bsnh->btnh", wts, vq.float())
            return out.to(q.dtype)

        h = x
        if cache is None:
            for l in range(self.num_layers):
                h, _, _ = self._layer_body(
                    self._weights_layer(weights, l), h, positions,
                    lambda k, v: (None, None), attend, cos_t, sin_t,
                    a8w8=a8w8)
            return h, None

        npages = self._pages_per_layer(cache)
        ck, cv = cache.k, cache.v
        for l in range(self.num_layers):
            tbl = block_tables + l * npages
            h, ck, cv = self._layer_body(
                self._weights_layer(weights, l), h, positions,
                lambda k, v: write_prefill_kv_pages(ck, cv, k, v, tbl),
                attend, cos_t, sin_t, a8w8=a8w8)
        return h, PagedKV(ck, cv)

    def prefill_chunk_raw(self, weights, x, cache, block_tables, start,
                          chunk_lens, cos_t, sin_t, a8w8=False, tp=None,
                          adapters=None):
        """CHUNKED prompt pass: x [b, c, d] embeds tokens at positions
        ``start[b] .. start[b]+c-1`` of sequences whose earlier tokens
        (previous chunks, or a shared prefix mapped by the prefix cache)
        are ALREADY in the paged pool. Per layer the chunk's K/V is
        written into its pages first, then its queries attend the cached
        pages plus the in-chunk causal triangle through
        ``paged_prefill_attention`` (the pool read in place).

        ``start``/``chunk_lens``: [b] int32 tensors on x's device —
        position offset and VALID row count (rows ``>= chunk_lens[b]``
        are right-padding; their KV writes go to the scratch page and
        their hidden rows are garbage the caller discards), so the layer
        loop never syncs with the host. An int8 pool takes the dense
        per-chunk gather of the pages instead, dequantized (PyTorch ops,
        XLA in the JAX package), on the card too.
        ``FLAGS_prefill_attention_backend=gather`` takes it for a float
        pool, on the CPU only. ``adapters``: the bank operands
        (``{proj}_a [L, S, K, R]``, ``{proj}_b``) and ``slots`` [b] (a
        slot < 0 is the base model); the chunk's tokens are sorted by
        slot once, and each projection adds its LoRA delta. Returns
        (hidden [b, c, d], cache)."""
        if isinstance(weights, (list, tuple)):
            raise ValueError("prefill_chunk_raw takes the stacked weight "
                             "dict")
        self._check_serving_args(weights, a8w8, tp)
        backend = flag("prefill_attention_backend")
        if backend not in ("auto", "varlen", "gather"):
            raise ValueError(f"FLAGS_prefill_attention_backend={backend!r}:"
                             " valid values are 'auto', 'varlen', "
                             "'gather'")
        quant_pool = isinstance(cache.k, tuple)
        if backend == "gather" and not quant_pool \
                and x.device.type == "cuda":
            raise ValueError(
                "FLAGS_prefill_attention_backend=gather names the plain "
                "dense gather, which runs on the CPU only; on the card a "
                "bf16/f32 pool goes through paged_prefill_attention")
        attend_fn = _paged_prefill_plain if quant_pool or backend == "gather" \
            else paged_prefill_attention
        b, c, _ = x.shape
        start = start.to(torch.int32)
        positions = start.long()[:, None] \
            + torch.arange(c, device=x.device)[None, :]        # [b, c]
        n_kv = self.num_kv_heads
        scale = self.head_dim ** -0.5
        npages = self._pages_per_layer(cache)
        ad_base = None
        if adapters is not None:
            # per-row slots broadcast to per-token and sorted ONCE for
            # the chunk; padding rows inherit their row's slot (their
            # deltas are garbage the caller discards)
            slots_tok = adapters["slots"].to(torch.int32) \
                .repeat_interleave(c)
            order, offsets, _ = sort_by_adapter(
                slots_tok, adapters["qkv_a"].shape[1])
            ad_base = {"order": order, "inv": inverse_order(order),
                       "offsets": offsets}
        ck, cv = cache.k, cache.v
        h = x
        for l in range(self.num_layers):
            tbl = block_tables + l * npages
            ad = None
            if ad_base is not None:
                ad = dict(ad_base)
                ad.update({n: a[l] for n, a in adapters.items()
                           if n.endswith(("_a", "_b"))})

            def kv_write(k, v, tbl=tbl):
                return write_prefill_kv_pages(ck, cv, k, v, tbl,
                                              start=start,
                                              valid_lens=chunk_lens)

            def attend(q, k, v, nck, ncv, tbl=tbl):
                # the chunk's own K/V was just written: key position <=
                # query position covers the prefix pages and the
                # in-chunk triangle
                return attend_fn(q.contiguous(), nck, ncv, tbl, start,
                                 n_kv=n_kv, scale=scale)

            h, ck, cv = self._layer_body(
                self._weights_layer(weights, l), h, positions, kv_write,
                attend, cos_t, sin_t, a8w8=a8w8, adapters=ad)
        return h, PagedKV(ck, cv)

    def decode_raw(self, weights, x, cache: PagedKV, block_tables,
                   seq_lens, cos_t, sin_t, a8w8=False, tp=None,
                   adapters=None):
        """One decode step: x [b, d] token embeddings, seq_lens [b] int32
        = tokens already cached (the new token's position). Returns
        (hidden [b, d], cache) with the pool updated in place; an int8
        pool goes through ``paged_decode_attention_inplace_q``.

        ATTENTION by ``FLAGS_paged_attention_backend`` (bf16/f32 pool):
        ``auto`` the in-place append + attend kernel at every head_dim;
        ``stream`` the same at head_dim % 128 == 0, else it raises;
        ``fused``, ``pallas`` and ``xla`` ``write_kv_pages`` then
        ``paged_attention`` over ``seq_lens + 1`` (kernels B8, B9; ``xla``
        the plain gather, which raises on the card). Every loop below
        attends through the same route.

        GROUPED (``FLAGS_decode_grouped`` auto — except under A8W8 — or
        on): per layer one attention call and one ``stream_layer_tail``
        call; with ``FLAGS_decode_prefetch`` the tail also computes layer
        l+1's LN1 + QKV, otherwise a separate ``stream_linear`` QKV call
        follows it. Int8 stacks stream int8 weights through both.
        UNGROUPED (``off``, and auto under A8W8): the per-projection
        layer body, its products through ``stream_linear`` (A8W8:
        ``act_quant=True``) when A8W8 holds or when the batch is a
        multiple of 8 and ``FLAGS_decode_linear`` is ``stream`` (or
        ``auto`` with int8 weights), plain products otherwise. An MoE
        stack always runs the ungrouped body with plain QKV/O products
        and its expert FFN through the grouped GEMM.

        ADAPTERED (``adapters``: the bank operands ``{proj}_a [L, S, K,
        R]``, ``{proj}_b`` and the per-row ``slots`` [b], < 0 for the base
        model): the rows are sorted by slot once per step, and each layer
        runs the four-call form — per projection ``stream_linear`` with
        an fp32 result and no bias, + the LoRA delta (one
        ``lora_delta`` launch), + bias, then the activation."""
        if isinstance(weights, (list, tuple)):
            raise ValueError(
                "decode_raw takes the stacked weight dict (the JAX "
                "package's unstacked per-layer form is experimental and "
                "not ported)")
        self._check_serving_args(weights, a8w8, tp)
        is_moe = bool(self.moe_num_experts)
        npages = self._pages_per_layer(cache)
        L = self.num_layers
        d_att = self.num_heads * self.head_dim
        ck, cv = cache.k, cache.v
        quantized_kv = isinstance(ck, tuple)
        # FLAGS_paged_attention_backend, as the JAX decode step reads it on
        # the chip: auto and stream keep the in-place kernel (stream at
        # head_dim % 128 == 0 only); fused, pallas and xla write the new
        # token's K/V, then attend through paged_attention. An int8 pool
        # always takes its own kernel.
        write_then_attend = False
        if not quantized_kv:
            backend = backend_flag()
            if backend == "stream":
                check_stream_head_dim(self.head_dim)
            write_then_attend = backend in ("fused", "pallas", "xla")
            lens1 = seq_lens + 1

        def attend_fn(q, k, v, ck, cv, base):
            # v is a strided view of the projection; the kernels take
            # contiguous rows
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            if quantized_kv:
                att, kq, ks, vq, vs = paged_decode_attention_inplace_q(
                    q, k, v, ck[0], ck[1], cv[0], cv[1], seq_lens,
                    block_tables, pool_base=base, pool_pages=npages)
                return att, (kq, ks), (vq, vs)
            if write_then_attend:
                ck, cv = write_kv_pages(ck, cv, k, v, seq_lens,
                                        block_tables + base)
                att = paged_attention(q, ck, cv, lens1, block_tables,
                                      pool_base=base, pool_pages=npages)
                return att, ck, cv
            return paged_decode_attention_inplace(
                q, k, v, ck, cv, seq_lens, block_tables, pool_base=base,
                pool_pages=npages)

        def split_rope(qkv, h):
            return _split_rope(qkv.to(h.dtype), seq_lens, self.num_heads,
                               self.num_kv_heads, self.head_dim, cos_t,
                               sin_t)

        if adapters is not None:
            if is_moe:
                raise NotImplementedError(
                    "adaptered decode composes with the dense stack "
                    "only (no MoE expert-bank form yet)")
            return self._decode_adaptered(weights, x, ck, cv, adapters,
                                          attend_fn, split_rope, a8w8,
                                          npages)

        g_flag = flag("decode_grouped")
        if g_flag not in ("auto", "on", "off"):
            raise ValueError(f"FLAGS_decode_grouped={g_flag!r}: valid "
                             "values are 'auto', 'on', 'off'")
        if not is_moe and (g_flag == "on"
                           or (g_flag == "auto" and not a8w8)):
            prefetch = bool(flag("decode_prefetch"))

            def qkv_at(l, hh):
                hn = self._ln(hh, weights["ln1_scale"][l],
                              weights["ln1_bias"][l],
                              self.epsilon).to(hh.dtype)
                return stream_linear(hn, weights["qkv_weight"], layer=l,
                                     bias=weights["qkv_bias"],
                                     scale=weights.get("qkv_scale"),
                                     out_dtype=hh.dtype)

            def tail(att, h, l):
                nq = None
                if prefetch:
                    nq = dict(w=weights["qkv_weight"],
                              b=weights["qkv_bias"],
                              s=weights.get("qkv_scale"),
                              ln_s=weights["ln1_scale"],
                              ln_b=weights["ln1_bias"],
                              layer=min(l + 1, L - 1))
                return stream_layer_tail(
                    att, h, weights["out_weight"], weights["ffn1_weight"],
                    weights["ffn2_weight"], layer=l,
                    bo=weights["out_bias"], b1=weights["ffn1_bias"],
                    b2=weights["ffn2_bias"],
                    ln2_scale=weights["ln2_scale"],
                    ln2_bias=weights["ln2_bias"], epsilon=self.epsilon,
                    activation=self.activation,
                    so=weights.get("out_scale"),
                    s1=weights.get("ffn1_scale"),
                    s2=weights.get("ffn2_scale"), next_qkv=nq,
                    out_dtype=h.dtype)

            h = x
            qkv = qkv_at(0, x)
            for l in range(L):
                q, k, v = split_rope(qkv, h)
                att, ck, cv = attend_fn(q, k, v, ck, cv, l * npages)
                att = att.reshape(*h.shape[:-1], d_att).to(h.dtype)
                if prefetch:
                    # steady state: one tail call per layer (the last
                    # layer's prefetched QKV is discarded)
                    h, qkv = tail(att, h, l)
                else:
                    h = tail(att, h, l)
                    qkv = qkv_at(min(l + 1, L - 1), h)
            return h, PagedKV(ck, cv)

        lin_flag = flag("decode_linear")
        if lin_flag not in ("auto", "xla", "stream"):
            raise ValueError(f"FLAGS_decode_linear={lin_flag!r}: valid "
                             "values are 'auto', 'xla', 'stream'")
        is_int8 = weights["qkv_weight"].dtype == torch.int8
        use_stream_lin = not is_moe and (a8w8 or (x.shape[0] % 8 == 0 and (
            lin_flag == "stream" or (lin_flag == "auto" and is_int8))))
        h = x
        for l in range(L):
            base = l * npages

            def attend(q, k, v, _ck, _cv, base=base):
                return attend_fn(q, k, v, ck, cv, base)

            linear = None
            if use_stream_lin:
                def linear(xx, kind, l=l):
                    return stream_linear(
                        xx, weights[f"{kind}_weight"], layer=l,
                        bias=weights[f"{kind}_bias"],
                        scale=weights.get(f"{kind}_scale"),
                        act_quant=a8w8, out_dtype=xx.dtype)
            h, ck, cv = self._layer_body(
                self._weights_layer(weights, l), h, seq_lens, None, attend,
                cos_t, sin_t, linear=linear)
        return h, PagedKV(ck, cv)

    def _decode_adaptered(self, weights, x, ck, cv, adapters, attend_fn,
                          split_rope, a8w8, npages):
        """The adaptered decode step (see ``decode_raw``)."""
        backend = flag("lora_delta_backend")
        order, offsets, _ = sort_by_adapter(
            adapters["slots"].to(torch.int32), adapters["qkv_a"].shape[1])
        order, inv = order.long(), inverse_order(order).long()
        d_att = self.num_heads * self.head_dim

        def proj(xx, kind, l, activation=None):
            # fp32 product; bias and activation wait for the delta
            y = stream_linear(xx, weights[f"{kind}_weight"], layer=l,
                              scale=weights.get(f"{kind}_scale"),
                              act_quant=a8w8, out_dtype=torch.float32)
            a4 = adapters.get(f"{kind}_a")
            if a4 is not None:
                y = y + lora_delta(xx[order], a4[l],
                                   adapters[f"{kind}_b"][l], offsets,
                                   backend=backend)[inv]
            y = y + weights[f"{kind}_bias"][l].float()
            return _apply_activation(y, activation)

        h = x
        for l in range(self.num_layers):
            hn = self._ln(h, weights["ln1_scale"][l], weights["ln1_bias"][l],
                          self.epsilon).to(h.dtype)
            q, k, v = split_rope(proj(hn, "qkv", l), h)
            att, ck, cv = attend_fn(q, k, v, ck, cv, l * npages)
            att = att.reshape(*h.shape[:-1], d_att).to(h.dtype)
            h = (h + proj(att, "out", l)).to(h.dtype)
            hn = self._ln(h, weights["ln2_scale"][l], weights["ln2_bias"][l],
                          self.epsilon).to(h.dtype)
            ff = proj(hn, "ffn1", l, self.activation).to(h.dtype)
            h = (h + proj(ff, "ffn2", l)).to(h.dtype)
        return h, PagedKV(ck, cv)

    # ---------- eager module API ----------

    def forward(self, x, cache=None, block_tables=None, seq_lens=None):
        """Prefill when x is [b, s, d] (cache=None → pure dense forward,
        no KV writes), decode step when x is [b, d]."""
        cos_t, sin_t = rope_table(self.max_position, self.head_dim,
                                  self.rope_theta, device=x.device)
        w = self._stack()
        if x.dim() == 3:
            return self.prefill_raw(w, x, cache, block_tables, cos_t,
                                    sin_t)
        return self.decode_raw(w, x, cache, block_tables, seq_lens, cos_t,
                               sin_t)
