"""Generation engines: prefill + paged-KV decode loop.

Counterpart of ``paddle_tpu/inference/engine.py``. ``GenerationEngine``
prefills a batch of prompts and decodes greedily in chunks of k steps,
each chunk a loop of device work with ONE host sync at its end (the
picked token feeds the next step on the device). The
``ContinuousBatchingEngine`` keeps ``max_batch`` decode slots over one
shared paged KV pool and admits waiting requests as slots free up.

The device is the model's: the CUDA card unless the model was built
with ``device="cpu"``. Sampling, speculative decoding, KV migration and
host-tier spill come with later slices of the port and raise.
"""
from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ..core.device import resolve_device
from ..core.generator import default_generator
from ..incubate.nn.fused_transformer import (
    FusedMultiTransformer, PagedKV, _later_slice, rope_table)
from ..nn.functional.paged_attention import stream_chunk_pages
from ..nn.functional.stream_linear import stream_linear
from ..profiler import stats as _stats
from .kv_cache import BlockKVCacheManager

__all__ = ["FusedCausalLM", "GenerationEngine",
           "ContinuousBatchingEngine", "GenRequest",
           "DEFAULT_DECODE_CHUNK"]

#: decode chunk when the caller names none: one chunk covers a whole
#: bench-length generation, so the host syncs once for it
DEFAULT_DECODE_CHUNK = 128


def _resolve_decode_chunk(decode_chunk) -> int:
    if decode_chunk is None:
        return DEFAULT_DECODE_CHUNK
    return max(int(decode_chunk), 1)


def _round_pool_pages(n: int, page_size: int) -> int:
    """Round a pool size up to a multiple of the stream-chunk page
    count capped at the next power of two >= n — the JAX package's
    rounding, kept identical so both packages account the same pages
    (the engines expose the result as the ``*.pool_pages`` gauge)."""
    chunk = stream_chunk_pages(page_size)
    next_pow2 = 1
    while next_pow2 < n:
        next_pow2 *= 2
    quantum = min(chunk, next_pow2)
    return -(-n // quantum) * quantum


class FusedCausalLM(nn.Module):
    """Minimal GPT-style causal LM over FusedMultiTransformer: token
    embedding (tied lm head) + stack + final LN. ``device=None`` builds
    it on the CUDA card (and raises without one)."""

    def __init__(self, vocab_size, embed_dim, num_heads, dim_feedforward,
                 num_layers, num_kv_heads=None, max_position=32768,
                 rope_theta=10000.0, moe_num_experts=None, moe_top_k=2,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.vocab_size = vocab_size
        self.embed = nn.Parameter(
            torch.randn((vocab_size, embed_dim),
                        generator=default_generator(device),
                        device=device) * 0.02, requires_grad=False)
        self.stack = FusedMultiTransformer(
            embed_dim, num_heads, dim_feedforward, num_layers,
            num_kv_heads=num_kv_heads, max_position=max_position,
            rope_theta=rope_theta, moe_num_experts=moe_num_experts,
            moe_top_k=moe_top_k, device=device)
        self.lnf_scale = nn.Parameter(torch.ones(embed_dim, device=device),
                                      requires_grad=False)
        self.lnf_bias = nn.Parameter(torch.zeros(embed_dim, device=device),
                                     requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _final(self, h):
        h = FusedMultiTransformer._ln(h, self.lnf_scale, self.lnf_bias,
                                      self.stack.epsilon)
        return h @ self.embed.t()

    def forward(self, ids):
        """Plain full-sequence forward: logits [b, s, vocab]; no
        cache."""
        ids = torch.as_tensor(ids, device=self.device)
        x = self.embed[ids.long()]
        st = self.stack
        cos_t, sin_t = rope_table(st.max_position, st.head_dim,
                                  st.rope_theta, device=self.device)
        h, _ = st.prefill_raw(st._stack(), x, None, None, cos_t, sin_t)
        return self._final(h)


class GenerationEngine:
    """Single-batch greedy generation over a FusedCausalLM: prefill the
    prompts, then decode chunks of k steps with one host sync each."""

    def __init__(self, model: FusedCausalLM, page_size: int = 16,
                 max_length: int = 1024, num_pages: Optional[int] = None,
                 decode_chunk: Optional[int] = None, kv_dtype=None,
                 quant: Optional[str] = None, mesh=None,
                 mp_degree: Optional[int] = None,
                 ep_degree: Optional[int] = None):
        self.model = model
        st = model.stack
        self.max_length = max_length
        self.page_size = page_size
        self.decode_chunk = _resolve_decode_chunk(decode_chunk)
        self._init_serving_state(kv_dtype, quant, mesh=mesh,
                                 mp_degree=mp_degree,
                                 ep_degree=ep_degree)
        self._cos, self._sin = rope_table(st.max_position, st.head_dim,
                                          st.rope_theta,
                                          device=self._device)
        self._num_pages = num_pages
        self._mgr = None

    def _init_serving_state(self, kv_dtype, quant=None, mesh=None,
                            mp_degree=None, ep_degree=None):
        """Serving dtype discipline (shared with the continuous engine):
        the compute dtype follows the stack weights, the KV pool follows
        ``kv_dtype`` (default: the compute dtype), and the LM head is a
        pre-transposed [d, vocab] copy in the compute dtype, multiplied
        with fp32 accumulation into fp32 logits."""
        if quant is not None:
            raise _later_slice(f"quant={quant!r}", "quantized-serving")
        if mesh is not None or (mp_degree or 1) > 1 or (ep_degree or 1) > 1:
            raise _later_slice("tensor/expert-parallel serving",
                               "TP serving")
        st = self.model.stack
        self._device = self.model.device
        self._cdtype = st.qkv_weight.dtype
        if isinstance(kv_dtype, str):
            kv_dtype = getattr(torch, kv_dtype)
        self._kv_dtype = kv_dtype or self._cdtype
        self._head_t = self.model.embed.t().contiguous().to(self._cdtype)

    def _weights(self):
        return self.model.stack._stack()

    def _embed(self):
        return self.model.embed

    def _lnf(self):
        return self.model.lnf_scale, self.model.lnf_bias

    # ---------- programs ----------

    def _logits(self, h, head_t, lnf_s, lnf_b):
        """LM head: final LN, then the pre-transposed [d, vocab] product
        through ``stream_linear`` with fp32 logits."""
        hl = FusedMultiTransformer._ln(
            h, lnf_s, lnf_b, self.model.stack.epsilon).to(head_t.dtype)
        return stream_linear(hl, head_t, out_dtype=torch.float32)

    def _prefill_fn(self, weights, embed, head_t, lnf_s, lnf_b, ids,
                    seq_lens, cache_k, cache_v, tables):
        """Prompt pass over a right-padded batch: logits at each
        sequence's own last real position (``seq_lens[b] - 1``)."""
        st = self.model.stack
        x = embed[ids.long()].to(self._cdtype)
        h, cache = st.prefill_raw(weights, x, PagedKV(cache_k, cache_v),
                                  tables, self._cos, self._sin)
        hl = h[torch.arange(h.shape[0], device=h.device),
               seq_lens.long() - 1]
        logits = self._logits(hl, head_t, lnf_s, lnf_b)
        return logits, cache.k, cache.v

    @staticmethod
    def _argmax(logits):
        """Greedy pick as max, equality, min-index: the smallest index
        among ties; an all-NaN row picks 0."""
        V = logits.shape[-1]
        m = logits.max(dim=-1, keepdim=True).values
        idx = torch.arange(V, dtype=torch.int32, device=logits.device)
        cand = torch.where(logits == m, idx[None, :],
                           torch.tensor(V, dtype=torch.int32,
                                        device=logits.device))
        picked = cand.min(dim=-1).values
        return torch.where(picked >= V, torch.zeros_like(picked), picked)

    @staticmethod
    def _pick_token(logits, key=None, sample_cfg=None):
        if sample_cfg is not None:
            raise _later_slice("sampled decoding", "sampling")
        return GenerationEngine._argmax(logits)

    def _decode_k_fn(self, weights, embed, head_t, lnf_s, lnf_b, tok,
                     seq_lens, cache_k, cache_v, tables, *, k):
        """K greedy decode steps: the picked token feeds the next step on
        the device, so nothing syncs with the host. Returns (tokens
        [b, k] on the device, cache_k, cache_v); the pool is updated in
        place."""
        st = self.model.stack
        lens = seq_lens
        ck, cv = cache_k, cache_v
        toks = []
        for _ in range(k):
            x = embed[tok.long()].to(self._cdtype)
            h, cache = st.decode_raw(weights, x, PagedKV(ck, cv), tables,
                                     lens, self._cos, self._sin)
            ck, cv = cache.k, cache.v
            tok = self._pick_token(self._logits(h, head_t, lnf_s, lnf_b))
            toks.append(tok)
            lens = lens + 1
        return torch.stack(toks, dim=1), ck, cv

    # ---------- serving API ----------

    @staticmethod
    def _pad_prompts(input_ids, seq_lens=None):
        """Normalize prompts to (padded [b, s] int array, lens [b]).
        Accepts a rectangular array (all rows real unless seq_lens
        given) or a ragged list of 1-D sequences (right-padded here)."""
        if isinstance(input_ids, torch.Tensor):
            input_ids = input_ids.cpu().numpy()
        if isinstance(input_ids, (list, tuple)) and not np.isscalar(
                input_ids[0]):
            rows = [np.asarray(r).reshape(-1) for r in input_ids]
            lens = np.array([len(r) for r in rows], np.int32)
            s = int(lens.max())
            ids = np.zeros((len(rows), s), rows[0].dtype)
            for i, r in enumerate(rows):
                ids[i, : len(r)] = r
            return ids, lens
        ids = np.asarray(input_ids)
        if seq_lens is None:
            lens = np.full((ids.shape[0],), ids.shape[1], np.int32)
        else:
            lens = np.asarray(seq_lens, np.int32)
        return ids, lens

    def _grow_tables(self, seq_ids, lens, extra, pages_per_seq):
        """On-demand paging: extend each sequence's pages to cover
        ``lens + extra`` tokens; returns the (constant-shape) table."""
        for i, sid in enumerate(seq_ids):
            need = min(self._mgr.pages_needed(int(lens[i]) + extra),
                       pages_per_seq)
            have = len(self._mgr._owned.get(sid, ()))
            if need > have:
                self._mgr.grow(sid, need - have)
        return self._mgr.block_tables(seq_ids, pages_per_seq)

    def generate(self, input_ids, max_new_tokens: int = 32,
                 eos_token_id: Optional[int] = None, seq_lens=None,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0):
        """Greedy decode with per-sequence prompt lengths.

        input_ids: [b, s] array (optionally with ``seq_lens`` marking
        real lengths) or a ragged list of 1-D prompts. Returns
        np.ndarray [b, max(s_i) + max_new_tokens]; row i holds its
        prompt then its generated tokens at columns
        lens[i]..lens[i]+max_new_tokens-1 (tail beyond that is pad/EOS)."""
        if do_sample:
            raise _later_slice("sampled decoding", "sampling")
        ids, lens = self._pad_prompts(input_ids, seq_lens)
        b, s = ids.shape
        if max_new_tokens <= 0:
            return ids.copy()
        st = self.model.stack
        dev = self._device
        if int(lens.max()) + max_new_tokens > self.max_length:
            raise ValueError(
                f"prompt ({int(lens.max())}) + max_new_tokens "
                f"({max_new_tokens}) exceeds engine max_length "
                f"({self.max_length}); raise max_length")
        # the block-table width covers max_length; pages are allocated
        # on demand as sequences grow
        pages_per_seq = -(-self.max_length // self.page_size)
        # +1 for the reserved scratch page 0
        requested = (self._num_pages or b * pages_per_seq) + 1
        self._mgr = BlockKVCacheManager(
            st.num_layers, st.num_kv_heads, st.head_dim, self.page_size,
            num_pages=_round_pool_pages(requested, self.page_size),
            dtype=self._kv_dtype, reserve_scratch=True, device=dev)
        _stats.set_gauge("inference.pool_pages_requested", requested)
        _stats.set_gauge("inference.pool_pages", self._mgr.num_pages)
        for i in range(b):
            self._mgr.allocate(i, int(lens[i]))
        tables = self._mgr.block_tables(range(b), pages_per_seq)
        cache = self._mgr.fresh_cache()

        weights = self._weights()
        embed = self._embed()
        lnf_s, lnf_b = self._lnf()

        _stats.inc("inference.prefills")
        logits, ck, cv = self._prefill_fn(
            weights, embed, self._head_t, lnf_s, lnf_b,
            torch.as_tensor(ids, device=dev),
            torch.as_tensor(lens, device=dev), cache.k, cache.v, tables)

        width = s + max_new_tokens
        out = np.zeros((b, width), ids.dtype)
        out[:, :s] = ids
        finished = np.zeros((b,), bool)

        # first generated token: prefill logits at each row's own last
        # real position
        tok_np = self._pick_token(logits).cpu().numpy().astype(ids.dtype)
        if eos_token_id is not None:
            finished |= tok_np == eos_token_id
        out[np.arange(b), lens] = tok_np
        emitted = 1

        # remaining tokens in chunks: one host sync per chunk
        while emitted < max_new_tokens and not (
                eos_token_id is not None and finished.all()):
            k = min(self.decode_chunk, max_new_tokens - emitted)
            cur = lens + emitted - 1         # per-seq position just fed
            tables = self._grow_tables(range(b), lens + emitted, k,
                                       pages_per_seq)
            _stats.inc("inference.decode_steps", k)
            _stats.set_gauge("inference.kv_pages_in_use",
                             self._mgr.num_pages - self._mgr.free_pages)
            toks, ck, cv = self._decode_k_fn(
                weights, embed, self._head_t, lnf_s, lnf_b,
                torch.as_tensor(out[np.arange(b), cur].astype(np.int32),
                                device=dev),
                torch.as_tensor(cur.astype(np.int32), device=dev), ck, cv,
                tables, k=k)
            toks_np = toks.cpu().numpy()
            for j in range(k):
                col = toks_np[:, j].astype(ids.dtype)
                if eos_token_id is not None:
                    col = np.where(finished, eos_token_id, col)
                    finished |= col == eos_token_id
                out[np.arange(b), lens + emitted] = col
                emitted += 1
        if eos_token_id is not None:
            for i in range(b):
                if finished[i]:
                    e = int(lens[i]) + emitted
                    out[i, e:] = eos_token_id
        for i in range(b):
            self._mgr.free(i)
        return out


class GenRequest:
    """One serving request (continuous batching unit)."""

    # next() on a shared itertools.count is atomic under CPython: ids
    # stay unique when requests are submitted from several threads
    _next_id = itertools.count()

    def __init__(self, prompt, max_new_tokens=32, eos_token_id=None):
        self.id = next(GenRequest._next_id)
        self.prompt = np.asarray(prompt).reshape(-1).astype(np.int32)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.generated: list = []
        self.done = False
        # times the admission loop passed this request over for a later
        # one that fit (bounded by the engine's starvation_bound)
        self._admit_skips = 0

    @property
    def output(self):
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])


class ContinuousBatchingEngine:
    """Continuous-batching serving loop over a FusedCausalLM: a fixed
    pool of ``max_batch`` decode slots shares one paged KV pool;
    finished sequences free their pages and waiting requests are
    admitted mid-stream (their prompt is prefilled into the shared
    cache), so decode shapes stay constant as traffic churns.

    Usage::

        eng = ContinuousBatchingEngine(model, max_batch=4)
        eng.submit([1, 2, 3], max_new_tokens=16)
        finished = eng.run()          # or step() repeatedly
    """

    def __init__(self, model: FusedCausalLM, max_batch: int = 4,
                 page_size: int = 16, max_length: int = 1024,
                 num_pages: Optional[int] = None,
                 decode_chunk: Optional[int] = None,
                 prompt_bucket: int = 16, kv_dtype=None,
                 quant: Optional[str] = None, admit_window: int = 8,
                 starvation_bound: int = 16, mesh=None,
                 mp_degree: Optional[int] = None,
                 ep_degree: Optional[int] = None, speculative=None):
        if speculative:
            raise _later_slice("speculative decoding", "speculation")
        self.model = model
        self.max_batch = int(max_batch)
        self.max_length = int(max_length)
        self.page_size = int(page_size)
        self.decode_chunk = _resolve_decode_chunk(decode_chunk)
        self.prompt_bucket = max(int(prompt_bucket), 1)
        # admission skip-ahead: when the queue head's pages don't fit,
        # up to admit_window later requests are tried instead; a head
        # skipped starvation_bound times pins the queue until it fits
        self.admit_window = max(int(admit_window), 1)
        self.starvation_bound = max(int(starvation_bound), 1)
        self._gen = GenerationEngine.__new__(GenerationEngine)  # share
        self._gen.model = model
        self._gen.max_length = self.max_length
        self._gen.page_size = self.page_size
        self._gen.decode_chunk = self.decode_chunk
        self._gen._init_serving_state(kv_dtype, quant, mesh=mesh,
                                      mp_degree=mp_degree,
                                      ep_degree=ep_degree)
        st = model.stack
        dev = self._gen._device
        self._pages_per_seq = -(-self.max_length // self.page_size)
        requested = (num_pages or self.max_batch * self._pages_per_seq) + 1
        self._mgr = BlockKVCacheManager(
            st.num_layers, st.num_kv_heads, st.head_dim, self.page_size,
            num_pages=_round_pool_pages(requested, self.page_size),
            dtype=self._gen._kv_dtype, reserve_scratch=True, device=dev)
        _stats.set_gauge("serving.pool_pages_requested", requested)
        _stats.set_gauge("serving.pool_pages", self._mgr.num_pages)
        cache = self._mgr.fresh_cache()
        self._ck, self._cv = cache.k, cache.v
        self._cos, self._sin = rope_table(st.max_position, st.head_dim,
                                          st.rope_theta, device=dev)
        self._gen._cos, self._gen._sin = self._cos, self._sin
        self._gen._mgr = self._mgr

        self.waiting: list = []
        self.finished: list = []
        # hooks the serving frontend installs (journal, fault injector,
        # usage ledger); None keeps each a no-op
        self._journal = None
        self._faults = None
        self._usage = None
        # slot state
        self._slots: list = [None] * self.max_batch   # GenRequest or None
        self._lens = np.zeros((self.max_batch,), np.int64)
        self._last_tok = np.zeros((self.max_batch,), np.int64)
        self._spec = None

    # ---------------- public API ----------------

    def submit(self, prompt, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None) -> int:
        req = GenRequest(prompt, max_new_tokens, eos_token_id)
        if len(req.prompt) + req.max_new_tokens > self.max_length:
            raise ValueError("request exceeds engine max_length")
        self.waiting.append(req)
        return req.id

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._slots)

    def step(self):
        """Admit waiting requests into free slots, then run ONE decode
        chunk for the active batch. Returns requests finished this
        step."""
        self._admit()
        if self.num_active == 0:
            return []
        k = self.decode_chunk
        active = [i for i, r in enumerate(self._slots) if r is not None]
        fi = self._faults
        if fi is not None and active:
            fi.fire("decode.step")
        # pages grow on demand, clamped to what the request can still
        # emit — a near-max_length prompt must not over-allocate past
        # the fixed block-table width
        for i in active:
            req = self._slots[i]
            if req is None:
                continue  # preempted by an earlier slot's grow
            remaining = req.max_new_tokens - len(req.generated)
            need = self._mgr.pages_needed(
                int(self._lens[i]) + min(k, max(remaining, 0)))
            need = min(need, self._pages_per_seq)
            have = len(self._mgr._owned.get(("slot", i), ()))
            if need > have and \
                    not self._grow_decode_slot(i, need - have):
                continue  # slot preempted (serving override)
        active = [i for i in active if self._slots[i] is not None]
        if not active:
            return []
        tables = self._mgr.block_tables(
            [("slot", i) for i in range(self.max_batch)],
            self._pages_per_seq, allow_missing=True)
        _stats.inc("serving.decode_steps", k)
        _stats.set_gauge("serving.kv_pages_in_use",
                         self._mgr.num_pages - self._mgr.free_pages)
        _stats.set_gauge("serving.active_slots", len(active))

        cur = np.where([r is not None for r in self._slots],
                       self._lens - 1, 0).astype(np.int64)
        lnf_s, lnf_b = self._gen._lnf()
        dev = self._gen._device
        toks, self._ck, self._cv = self._gen._decode_k_fn(
            self._gen._weights(), self._gen._embed(), self._gen._head_t,
            lnf_s, lnf_b,
            torch.as_tensor(self._last_tok.astype(np.int32), device=dev),
            torch.as_tensor(cur.astype(np.int32), device=dev),
            self._ck, self._cv, tables, k=k)
        toks_np = toks.cpu().numpy()
        # overridable token filter: runs BEFORE any request mutates
        toks_np = self._postprocess_tokens(toks_np, active)

        done_now = []
        for i in active:
            req = self._slots[i]
            cb = getattr(req, "on_token", None)
            consumed = 0
            for j in range(k):
                if req.done:
                    break
                t = int(toks_np[i, j])
                req.generated.append(t)
                consumed += 1
                if cb is not None:
                    cb(req, t)
                if (req.eos_token_id is not None
                        and t == req.eos_token_id) or \
                        len(req.generated) >= req.max_new_tokens:
                    req.done = True
            if req.done:
                # tokens the chunk decoded past req.done: executed but
                # discarded device work (the decode_chunk tuning signal)
                _stats.inc("serving.wasted_decode_tokens", k - consumed)
                u = self._usage
                if u is not None and k > consumed:
                    u.add_tokens(req, wasted=k - consumed)
                self._finish_hook(req, i)
                self._release(i)
                done_now.append(req)
            else:
                self._lens[i] += k
                self._last_tok[i] = int(toks_np[i, k - 1])
        self.finished.extend(done_now)
        return done_now

    def run(self):
        """Drain: step until every submitted request finishes."""
        while self.waiting or self.num_active:
            self.step()
        return self.finished

    # ------- KV migration and host-tier spill (later slices) -------

    def can_migrate(self) -> bool:
        """Page-granular KV export/import comes with the fleet slice of
        the port; callers fall back to preemption-by-recompute."""
        return False

    def can_spill(self) -> bool:
        """Host-DRAM spill/restore comes with the fleet slice."""
        return False

    def export_slot(self, i: int) -> dict:
        raise _later_slice("KV-page migration", "fleet")

    def import_slot(self, i: int, blob: dict) -> bool:
        raise _later_slice("KV-page migration", "fleet")

    # ---------------- internals ----------------

    def _release(self, i: int):
        self._mgr.free(("slot", i))
        self._slots[i] = None
        self._lens[i] = 0
        self._last_tok[i] = 0

    def _postprocess_tokens(self, toks_np, active):
        """Hook over the decode chunk's fetched token matrix, called
        before the per-slot append loop. Base engine: identity."""
        return toks_np

    def _finish_hook(self, req, slot: int):
        """Called once per finished request, BEFORE its pages release:
        journal a finish event when a flight recorder is installed."""
        j = self._journal
        if j is not None:
            j.record("finish", req.id, slot,
                     {"n_tokens": len(req.generated)})

    def _grow_decode_slot(self, i: int, n_pages: int) -> bool:
        """Extend slot ``i``'s pages before a decode chunk; False means
        the slot was vacated instead of grown. The base engine's pool
        is sized for max_batch full-length sequences, so exhaustion
        here is a configuration error and raises."""
        self._mgr.grow(("slot", i), n_pages)
        return True

    def _slot_free(self, i: int) -> bool:
        """Is slot i available for admission?"""
        return self._slots[i] is None

    def _can_admit(self, req) -> bool:
        """Do the pool's free pages cover this request's prompt (+1
        decode token)?"""
        return self._mgr.pages_needed(len(req.prompt) + 1) \
            <= self._mgr.free_pages

    def _pick_waiting(self):
        """Next admissible waiting request, with BOUNDED SKIP-AHEAD:
        when the head's pages don't fit, up to ``admit_window`` later
        requests are tried; once the head has been skipped
        ``starvation_bound`` times the window collapses to the head."""
        if not self.waiting:
            return None
        head = self.waiting[0]
        window = 1 if head._admit_skips >= self.starvation_bound \
            else min(len(self.waiting), self.admit_window)
        for j in range(window):
            req = self.waiting[j]
            if self._can_admit(req):
                if j > 0:
                    for skipped in self.waiting[:j]:
                        skipped._admit_skips += 1
                    _stats.inc("serving.admission_skips", j)
                return self.waiting.pop(j)
        return None

    def _admit(self):
        """Move admissible waiting requests into free slots (skip-ahead
        selection via ``_pick_waiting``)."""
        for i in range(self.max_batch):
            if not self.waiting or not self._slot_free(i):
                continue
            req = self._pick_waiting()
            if req is None:
                break  # nothing in the window fits — retry next step
            self._admit_into(req, i)

    def _admit_into(self, req, i: int):
        """Prefill ``req``'s whole prompt and start it decoding in slot
        ``i`` (prompt padded to a multiple of ``prompt_bucket``)."""
        self._slots[i] = req
        _stats.inc("serving.admitted")
        L = len(req.prompt)
        self._mgr.allocate(("slot", i), L)
        tables = self._mgr.block_tables([("slot", i)],
                                        self._pages_per_seq)
        bs = self.prompt_bucket
        s_pad = -(-L // bs) * bs
        ids = np.zeros((1, s_pad), np.int32)
        ids[0, :L] = req.prompt
        lnf_s, lnf_b = self._gen._lnf()
        dev = self._gen._device
        logits, self._ck, self._cv = self._gen._prefill_fn(
            self._gen._weights(), self._gen._embed(), self._gen._head_t,
            lnf_s, lnf_b, torch.as_tensor(ids, device=dev),
            torch.tensor([L], dtype=torch.int32, device=dev),
            self._ck, self._cv, tables)
        t = int(torch.argmax(logits, dim=-1)[0])
        req.generated.append(t)
        cb = getattr(req, "on_token", None)
        if cb is not None:
            cb(req, t)
        if (req.eos_token_id is not None and t == req.eos_token_id) \
                or req.max_new_tokens <= 1:
            req.done = True
            self._finish_hook(req, i)
            self._release(i)
            self.finished.append(req)
            return
        self._lens[i] = L + 1
        self._last_tok[i] = t
