"""Fused transformer decode stack — the LLM-serving compute path.

Counterpart of ``paddle_tpu/incubate/nn/fused_transformer.py``: a
pre-LN GPT stack whose weights are stacked along a leading layer axis
([L, K, N]), with a layer-folded paged KV pool (``PagedKV``) updated in
place by the decode step.

The decode step (``decode_raw``) runs the port's kernels: the fused
KV-append + paged attention (``paged_decode_attention_inplace``), the
QKV projection (``stream_linear``) and the grouped layer tail
(``stream_layer_tail``). The chunked prefill of the serving frontend
(``prefill_chunk_raw``) attends over the pool in place through the
paged-prefill kernel (``paged_prefill_attention``); its projections,
like the one-shot prefill (``prefill_raw``), are plain PyTorch, as the
JAX package leaves them to XLA. Tensor parallelism, MoE, LoRA,
A8W8, int8 weights and the int8 KV pool come with later slices of the
port and raise ``NotImplementedError``.
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
from ...nn.functional.paged_attention import (
    paged_decode_attention_inplace, write_prefill_kv_pages)
from ...nn.functional.stream_linear import stream_layer_tail, stream_linear

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
    updates the tensors in place."""
    k: torch.Tensor   # [num_layers * num_pages, n_kv, page_size, head_dim]
    v: torch.Tensor


_STACK_NAMES = ("ln1_scale", "ln1_bias", "qkv_weight", "qkv_bias",
                "out_weight", "out_bias", "ln2_scale", "ln2_bias",
                "ffn1_weight", "ffn1_bias", "ffn2_weight", "ffn2_bias")


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
        if moe_num_experts:
            raise _later_slice("the MoE expert-bank stack", "MoE serving")
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
        self.moe_num_experts = None
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
        self.ffn1_weight = normal(L, d, dff)
        self.ffn1_bias = zeros(L, dff)
        self.ffn2_weight = normal(L, dff, d)
        self.ffn2_bias = zeros(L, d)

    # ---------- functional core (raw tensors) ----------

    def _stack(self):
        return {n: getattr(self, n) for n in _STACK_NAMES}

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
        if w.dtype == torch.int8 or scale is not None:
            raise _later_slice("int8 weight-only matmul",
                               "quantized-serving")
        return x @ w

    def _layer_body(self, w, h, positions, kv_write, attend, cos_t, sin_t,
                    linear=None):
        """One pre-LN transformer layer over hidden ``h`` (any leading
        dims). Compute dtype follows h. ``attend`` may return
        (att, ck, cv) — the fused append+attend path, where kv_write is
        None. ``linear(x, kind)`` computes x @ W_kind + bias."""
        eps = self.epsilon
        if linear is None:
            def linear(x, kind):
                return self._mm(x, w[f"{kind}_weight"]) + w[f"{kind}_bias"]
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
        ff = self._act(linear(hn, "ffn1").to(h.dtype))
        h = (h + linear(ff, "ffn2")).to(h.dtype)
        return h, ck, cv

    def _pages_per_layer(self, cache: PagedKV) -> int:
        return cache.k.shape[0] // self.num_layers

    @staticmethod
    def _check_serving_args(a8w8, tp, adapters=None):
        if a8w8:
            raise _later_slice("A8W8 serving", "quantized-serving")
        if tp is not None:
            raise _later_slice("tensor-parallel serving", "TP serving")
        if adapters is not None:
            raise _later_slice("multi-LoRA decode", "LoRA serving")

    def _weights_layer(self, weights, l):
        return {n: a[l] for n, a in weights.items()}

    def prefill_raw(self, weights, x, cache, block_tables, cos_t, sin_t,
                    a8w8=False, tp=None):
        """Prompt pass: x [b, s, d] → (hidden [b, s, d], filled cache).

        Causal dense attention; each layer's K/V written into its
        layer-offset pages of the folded pool (in place). ``cache=None``
        runs the pure dense forward with no KV writes. Ragged batches
        are not masked here — prompts are right-padded to a common
        length (causal attention keeps the real tokens exact)."""
        self._check_serving_args(a8w8, tp)
        if isinstance(weights, (list, tuple)):
            raise ValueError("prefill_raw takes the stacked weight dict")
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
                    lambda k, v: (None, None), attend, cos_t, sin_t)
            return h, None

        npages = self._pages_per_layer(cache)
        ck, cv = cache.k, cache.v
        for l in range(self.num_layers):
            tbl = block_tables + l * npages
            h, ck, cv = self._layer_body(
                self._weights_layer(weights, l), h, positions,
                lambda k, v: write_prefill_kv_pages(ck, cv, k, v, tbl),
                attend, cos_t, sin_t)
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
        loop never syncs with the host. ``FLAGS_prefill_attention_backend
        =gather`` takes the dense per-chunk gather instead, on the CPU
        only. Returns (hidden [b, c, d], cache)."""
        self._check_serving_args(a8w8, tp, adapters)
        if isinstance(weights, (list, tuple)):
            raise ValueError("prefill_chunk_raw takes the stacked weight "
                             "dict")
        if isinstance(cache.k, tuple):
            raise _later_slice("the int8 KV pool", "quantized-serving")
        backend = flag("prefill_attention_backend")
        if backend not in ("auto", "varlen", "gather"):
            raise ValueError(f"FLAGS_prefill_attention_backend={backend!r}:"
                             " valid values are 'auto', 'varlen', "
                             "'gather'")
        if backend == "gather" and x.device.type == "cuda":
            raise _later_slice(
                "the dense-gather prefill attention on the card "
                "(FLAGS_prefill_attention_backend=gather)",
                "quantized-serving")
        b, c, _ = x.shape
        start = start.to(torch.int32)
        positions = start.long()[:, None] \
            + torch.arange(c, device=x.device)[None, :]        # [b, c]
        n_kv = self.num_kv_heads
        scale = self.head_dim ** -0.5
        npages = self._pages_per_layer(cache)
        attend_fn = _paged_prefill_plain if backend == "gather" \
            else paged_prefill_attention
        ck, cv = cache.k, cache.v
        h = x
        for l in range(self.num_layers):
            tbl = block_tables + l * npages

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
                attend, cos_t, sin_t)
        return h, PagedKV(ck, cv)

    def decode_raw(self, weights, x, cache: PagedKV, block_tables,
                   seq_lens, cos_t, sin_t, a8w8=False, tp=None,
                   adapters=None):
        """One decode step: x [b, d] token embeddings, seq_lens [b] int32
        = tokens already cached (the new token's position). Returns
        (hidden [b, d], cache) with the pool updated in place.

        GROUPED (``FLAGS_decode_grouped`` auto/on): per layer one
        attention call and one ``stream_layer_tail`` call; with
        ``FLAGS_decode_prefetch`` the tail also computes layer l+1's
        LN1 + QKV, otherwise a separate ``stream_linear`` QKV call
        follows it. ``off``: the per-projection layer body with plain
        products, the attention still through the fused kernel."""
        self._check_serving_args(a8w8, tp, adapters)
        if isinstance(weights, (list, tuple)):
            raise ValueError(
                "decode_raw takes the stacked weight dict (the JAX "
                "package's unstacked per-layer form is experimental and "
                "not ported)")
        if isinstance(cache.k, tuple):
            raise _later_slice("the int8 KV pool", "quantized-serving")
        npages = self._pages_per_layer(cache)
        L = self.num_layers
        d_att = self.num_heads * self.head_dim
        ck, cv = cache.k, cache.v

        def attend_fn(q, k, v, ck, cv, base):
            # v is a strided view of the projection; the kernel takes
            # contiguous rows
            return paged_decode_attention_inplace(
                q.contiguous(), k.contiguous(), v.contiguous(), ck, cv,
                seq_lens, block_tables, pool_base=base, pool_pages=npages)

        def split_rope(qkv, h):
            return _split_rope(qkv.to(h.dtype), seq_lens, self.num_heads,
                               self.num_kv_heads, self.head_dim, cos_t,
                               sin_t)

        g_flag = flag("decode_grouped")
        if g_flag in ("auto", "on"):
            prefetch = bool(flag("decode_prefetch"))

            def qkv_at(l, hh):
                hn = self._ln(hh, weights["ln1_scale"][l],
                              weights["ln1_bias"][l],
                              self.epsilon).to(hh.dtype)
                return stream_linear(hn, weights["qkv_weight"], layer=l,
                                     bias=weights["qkv_bias"],
                                     out_dtype=hh.dtype)

            def tail(att, h, l):
                nq = None
                if prefetch:
                    nq = dict(w=weights["qkv_weight"],
                              b=weights["qkv_bias"],
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
                    activation=self.activation, next_qkv=nq,
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
        if g_flag != "off":
            raise ValueError(f"FLAGS_decode_grouped={g_flag!r}: valid "
                             "values are 'auto', 'on', 'off'")

        h = x
        for l in range(L):
            base = l * npages

            def attend(q, k, v, _ck, _cv, base=base):
                return attend_fn(q, k, v, ck, cv, base)

            h, ck, cv = self._layer_body(
                self._weights_layer(weights, l), h, seq_lens, None, attend,
                cos_t, sin_t)
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
