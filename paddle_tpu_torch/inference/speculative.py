"""Speculative decoding: self-drafting and draft-model speculation with a
batched paged verify pass.

Counterpart of ``paddle_tpu/inference/speculative.py``. A decode step
reads the whole weight stack for one token a row. A cheap DRAFTER
proposes k tokens per active slot, and ONE verify pass — the port's
``FusedMultiTransformer.prefill_chunk_raw`` over the paged pool (the
paged-prefill kernel B4 per layer on the card, the prompt GEMMs, then
the LM head through ``stream_linear`` on ``b * (k + 1)`` rows) — scores
the whole (k+1)-token window, so the stack is read once per accepted
window instead of once per token.

Greedy-token parity holds BY CONSTRUCTION: the verify pass computes the
target model's own greedy picks ``cand[j]`` at every window position;
draft ``d_j`` is accepted iff it EQUALS ``cand[j-1]``, and the round
emits the accepted prefix plus the bonus token ``cand[a]``. Every
emitted token is the verify pass's own pick, whatever the drafter
proposed: a bad drafter costs throughput, never output.

The verify tail (logits, accept prefix, accept-boundary hidden state)
runs on the device; the host reads one ``[b, k+1]`` token matrix and
one ``[b]`` accept length a round. A rejection costs a page-table
truncation (``BlockKVCacheManager.truncate``): the rejected positions'
KV stays as masked-dead data that the next round's window overwrites,
and the over-grown tail pages return to the pool (refcount-aware).

Drafters (one ``Drafter`` interface):

- :class:`DraftModelDrafter` — a small :class:`FusedCausalLM` with its
  own pool of one ``max_length``-token page a slot (rollback = a length
  counter), caught up through its ``prefill_chunk_raw`` and proposing k
  greedy steps through its ``decode_raw``.
- :class:`SelfDraftHeads` — training-free self-drafting heads: head
  ``h`` drafts greedy top-1 from the TARGET's last verified hidden state
  through a fixed seeded residual projection and the target's LM head.
- :class:`ScheduledDrafter` — proposes from a per-request token script
  (the tests' forced schedules; the chip check's replay of a recorded
  greedy stream).

Engine integration: ``ContinuousBatchingEngine(speculative=...)`` (and
so ``ServingEngine``) runs one speculative round in place of the decode
chunk. Telemetry: ``serving.spec_{drafted,accepted,rejected}_tokens``
and ``serving.spec_rounds`` counters, the ``serve.accept_len``
histogram, ``spec.{propose_ms,verify_ms}`` timing histograms and the
``spec.k`` gauge; each round journals a ``spec_verify`` event per slot.
The reference also reports the verify program under a roofline rung
(its ``profiler/roofline``, which the port has not ported); that rung
is left out here. Tensor-parallel speculation comes with the TP serving
slice (the engines raise for ``mesh``/``mp_degree``).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..incubate.nn.fused_transformer import (
    FusedMultiTransformer, PagedKV, rope_table)
from ..nn.functional.stream_linear import stream_linear
from ..profiler import stats as _stats

__all__ = ["Drafter", "DraftModelDrafter", "SelfDraftHeads",
           "ScheduledDrafter", "SpeculativeDecoder",
           "build_speculative_decoder"]


class Drafter:
    """Draft-token source for speculative decoding.

    One instance serves every slot of one engine; ``bind`` is called
    once by the :class:`SpeculativeDecoder` before the first round.
    ``propose`` must be IDEMPOTENT for unchanged engine state: a
    crash-isolated retry re-runs the whole round, and re-proposing must
    rewrite the same drafter state with identical values (``commit`` is
    the only place per-slot progress advances).
    """

    k = 0

    def bind(self, engine, k: int) -> None:
        self.k = int(k)

    def reset(self, slot: int) -> None:
        """Slot reuse/preemption: drop slot state; the next round
        re-drafts from the request's recorded history."""

    def propose(self, engine, active) -> np.ndarray:
        """[max_batch, k] int32 draft tokens continuing each active
        slot's stream past its ``_last_tok`` (rows of inactive slots are
        ignored)."""
        raise NotImplementedError

    def commit(self, slot: int, accepted: int) -> None:
        """A verify round accepted ``accepted`` of this slot's drafts
        (and emitted the bonus token): advance per-slot state."""

    def observe_hidden(self, hidden, active) -> None:
        """Target-model hidden state at each slot's accept boundary
        (``[max_batch, d]``, on the device), from the verify pass — the
        self-drafting heads' input. Called once per round for surviving
        slots."""


class DraftModelDrafter(Drafter):
    """A small FusedCausalLM draft model with its own tiny KV state.

    Each slot owns one ``max_length``-token page of the draft's pool
    (``page_size == max_length``), so rollback after a rejection is a
    per-slot length counter. The drafter keeps ``_lens[slot] <=
    engine._lens[slot] - 1`` (tokens of the request's history present in
    the draft cache); a lag (admission, resume after preemption, the
    fully accepted round's last draft) is closed by bucketed catch-up
    chunks through the draft stack's ``prefill_chunk_raw`` before the
    next propose. The draft model lives on its own device (the target's,
    in every supported setup).
    """

    def __init__(self, model, prompt_bucket: int = 16):
        self.model = model
        self.prompt_bucket = max(int(prompt_bucket), 1)

    def bind(self, engine, k: int) -> None:
        from .kv_cache import BlockKVCacheManager

        self.k = int(k)
        st = self.model.stack
        if self.model.vocab_size != engine.model.vocab_size:
            raise ValueError(
                f"draft model vocab ({self.model.vocab_size}) != target "
                f"vocab ({engine.model.vocab_size})")
        if st.max_position < engine.max_length:
            raise ValueError(
                f"draft model max_position ({st.max_position}) < engine "
                f"max_length ({engine.max_length})")
        dev = self.model.device
        self._B = engine.max_batch
        self._max_len = int(engine.max_length)
        wd = st.qkv_weight.dtype
        self._cdtype = torch.bfloat16 if wd == torch.int8 else wd
        self._cos, self._sin = rope_table(st.max_position, st.head_dim,
                                          st.rope_theta, device=dev)
        self._head_t = self.model.embed.t().contiguous().to(self._cdtype)
        # one max_length page per slot (+ the scratch page)
        self._mgr = BlockKVCacheManager(
            st.num_layers, st.num_kv_heads, st.head_dim,
            page_size=self._max_len, num_pages=self._B + 1,
            dtype=self._cdtype, reserve_scratch=True, device=dev)
        for i in range(self._B):
            self._mgr.allocate(i, 1)
        self._tables = self._mgr.block_tables(range(self._B), 1)
        cache = self._mgr.fresh_cache()
        self._ck, self._cv = cache.k, cache.v
        self._lens = np.zeros((self._B,), np.int64)
        _stats.set_gauge("spec.draft_params",
                         sum(int(p.numel())
                             for p in self.model.parameters()))

    def reset(self, slot: int) -> None:
        self._lens[slot] = 0

    def commit(self, slot: int, accepted: int) -> None:
        # propose wrote k tokens ([last_tok, d_1..d_{k-1}]); they are
        # correct through the fed last_tok plus the accepted prefix
        self._lens[slot] += min(accepted + 1, self.k)

    # ---------- draft programs ----------

    def _catchup_fn(self, weights, embed, ids, start, chunk_lens, ck, cv,
                    tables):
        st = self.model.stack
        x = embed[ids.long()].to(self._cdtype)
        _h, cache = st.prefill_chunk_raw(
            weights, x, PagedKV(ck, cv), tables, start, chunk_lens,
            self._cos, self._sin)
        return cache.k, cache.v

    def _propose_fn(self, weights, embed, head_t, lnf_s, lnf_b, tok, lens,
                    ck, cv, tables, *, k):
        """k greedy draft steps: the picked token feeds the next step on
        the device (the target engine's ``_decode_k_fn`` shape), writing
        the fed tokens' KV into the per-slot pages."""
        from .engine import GenerationEngine

        st = self.model.stack
        toks = []
        for _ in range(k):
            x = embed[tok.long()].to(self._cdtype)
            h, cache = st.decode_raw(weights, x, PagedKV(ck, cv), tables,
                                     lens, self._cos, self._sin)
            ck, cv = cache.k, cache.v
            hl = FusedMultiTransformer._ln(
                h, lnf_s, lnf_b, st.epsilon).to(head_t.dtype)
            tok = GenerationEngine._argmax(
                stream_linear(hl, head_t, out_dtype=torch.float32))
            toks.append(tok)
            lens = lens + 1
        return torch.stack(toks, dim=1), ck, cv              # [B, k]

    # ---------- Drafter API ----------

    def _ensure(self, engine, i: int) -> None:
        """Close any history lag with bucketed catch-up chunks. No-op
        when the slot is already synced, so a retried round re-enters
        idempotently."""
        need = int(engine._lens[i]) - 1
        have = int(self._lens[i])
        if have >= need:
            return
        req = engine._slots[i]
        hist = np.concatenate(
            [req.prompt, np.asarray(req.generated[:-1], np.int32)]) \
            if req.generated else np.asarray(req.prompt, np.int32)
        dev = self.model.device
        w = self.model.stack._stack()
        bs = self.prompt_bucket
        while have < need:
            n = min(need - have, 4 * bs)
            c = -(-n // bs) * bs
            ids = np.zeros((1, c), np.int32)
            ids[0, :n] = hist[have: have + n]
            self._ck, self._cv = self._catchup_fn(
                w, self.model.embed, torch.as_tensor(ids, device=dev),
                torch.tensor([have], dtype=torch.int32, device=dev),
                torch.tensor([n], dtype=torch.int32, device=dev),
                self._ck, self._cv, self._tables[i: i + 1])
            have += n
        self._lens[i] = have

    def propose(self, engine, active) -> np.ndarray:
        for i in active:
            self._ensure(engine, i)
        tok = np.zeros((self._B,), np.int32)
        lens = np.zeros((self._B,), np.int32)
        for i in active:
            tok[i] = engine._last_tok[i]
            lens[i] = self._lens[i]
        dev = self.model.device
        toks, self._ck, self._cv = self._propose_fn(
            self.model.stack._stack(), self.model.embed, self._head_t,
            self.model.lnf_scale, self.model.lnf_bias,
            torch.as_tensor(tok, device=dev),
            torch.as_tensor(lens, device=dev), self._ck, self._cv,
            self._tables, k=self.k)
        return toks.cpu().numpy()


class SelfDraftHeads(Drafter):
    """Self-drafting heads, training-free.

    Head ``h`` drafts position ``+h+1`` as the greedy top-1 of the
    TARGET model's LM head over a fixed seeded residual projection of
    the last verified hidden state (``hidden + hidden @ W_h``, ``W_h ~
    scale * N(0, 1)`` in f32 from a ``torch.Generator`` seeded by
    ``seed``; the JAX package draws them from its own PRNG, so parity
    tests carry its ``_w`` across). No extra weights to stream; the
    acceptance never changes the output.
    """

    def __init__(self, scale: float = 0.02, seed: int = 0):
        self.scale = float(scale)
        self.seed = int(seed)

    def bind(self, engine, k: int) -> None:
        self.k = int(k)
        self._engine = engine
        d = engine.model.stack.embed_dim
        dev = engine.model.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.seed)
        self._w = torch.randn((self.k, d, d), generator=gen,
                              dtype=torch.float32, device=dev) * self.scale
        self._hidden = torch.zeros((engine.max_batch, d),
                                   dtype=torch.float32, device=dev)

    def reset(self, slot: int) -> None:
        self._hidden[slot] = 0.0

    def observe_hidden(self, hidden, active) -> None:
        idx = torch.as_tensor(list(active), dtype=torch.long,
                              device=self._hidden.device)
        self._hidden[idx] = hidden[idx].float()

    def _heads_fn(self, head_t, lnf_s, lnf_b, ws, hidden):
        from .engine import GenerationEngine

        g = self._engine._gen
        toks = []
        for w in ws:
            hh = hidden + hidden @ w
            logits = g._logits(hh.to(g._cdtype), head_t, lnf_s, lnf_b)
            toks.append(GenerationEngine._argmax(logits))
        return torch.stack(toks, dim=1)                     # [B, k]

    def propose(self, engine, active) -> np.ndarray:
        lnf_s, lnf_b = engine._gen._lnf()
        toks = self._heads_fn(engine._gen._head_t, lnf_s, lnf_b, self._w,
                              self._hidden)
        return toks.cpu().numpy()


class ScheduledDrafter(Drafter):
    """Drafts from a per-request token script: ``lookup(req)`` returns
    the request's full expected generated stream; each round proposes
    its next k tokens."""

    def __init__(self, lookup):
        self._lookup = lookup

    def bind(self, engine, k: int) -> None:
        self.k = int(k)
        self._B = engine.max_batch

    def propose(self, engine, active) -> np.ndarray:
        out = np.zeros((self._B, self.k), np.int32)
        for i in active:
            req = engine._slots[i]
            fut = np.asarray(self._lookup(req),
                             np.int32)[len(req.generated):]
            n = min(len(fut), self.k)
            out[i, :n] = fut[:n]
        return out


class SpeculativeDecoder:
    """Per-engine speculative rounds: the drafter, the batched verify
    pass and the accept/rollback bookkeeping. Owned by
    ``ContinuousBatchingEngine`` (``self._spec``); ``run_round`` is the
    decode-slot payload of the scheduler's interleave cycle."""

    def __init__(self, engine, drafter: Drafter, k: int):
        if k < 1:
            raise ValueError(f"spec_k must be >= 1, got {k}")
        self.engine = engine
        self.drafter = drafter
        self.k = int(k)
        drafter.bind(engine, self.k)
        self._rid = [None] * engine.max_batch
        _stats.set_gauge("spec.k", self.k)

    def reset_slot(self, i: int) -> None:
        self._rid[i] = None
        self.drafter.reset(i)

    # ---------- the verify pass ----------

    def _verify_fn(self, weights, embed, head_t, lnf_s, lnf_b, ids, start,
                   chunk_lens, draft, ck, cv, tables, *, k):
        """ONE pass scores the whole (k+1)-token window ``ids[b] =
        [last_tok, d_1..d_k]`` at positions ``start[b]..`` against the
        paged pool (``prefill_chunk_raw``: the cached pages plus the
        in-window causal triangle, masked by absolute position), then the
        verify tail on the device: greedy picks at every window position,
        the accept-prefix length, and the accept-boundary hidden state.
        Rows with ``chunk_lens == 0`` (idle slots) write scratch and are
        ignored."""
        from .engine import GenerationEngine

        g = self.engine._gen
        st = self.engine.model.stack
        x = embed[ids.long()].to(g._cdtype)
        h, cache = st.prefill_chunk_raw(
            weights, x, PagedKV(ck, cv), tables, start, chunk_lens,
            g._cos, g._sin, a8w8=g._a8w8)
        b, c, d = h.shape                                   # c = k + 1
        logits = g._logits(h.reshape(b * c, d), head_t, lnf_s, lnf_b)
        cand = GenerationEngine._argmax(logits).reshape(b, c)
        # draft j (window index j+1) is accepted iff it equals the
        # model's own greedy pick at index j AND its window index is
        # inside the (clamped) valid window
        valid = (torch.arange(k, dtype=torch.int32,
                              device=h.device)[None, :] + 2) \
            <= chunk_lens[:, None]
        match = (draft == cand[:, :-1]) & valid
        acc = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1) \
            .to(torch.int32)
        h_acc = h[torch.arange(b, device=h.device), acc.long()]  # [b, d]
        return cand, acc, h_acc, cache.k, cache.v

    # ---------- one speculative round ----------

    def run_round(self, eng, active, win):
        """Draft + verify + consume for the active decode batch.

        ``win[i]`` is slot i's clamped window length (<= k+1). NO host
        state mutates before the fetched round validates
        (``_postprocess_tokens``), so a crash-isolated retry re-runs the
        round cleanly: propose and catch-up rewrite identical values at
        identical positions. Returns requests finished this round.
        """
        g = eng._gen
        B, k = eng.max_batch, self.k
        mgr = eng._mgr
        dev = g._device
        # (re)bind drafter slots whose request changed: admission or
        # resume after preemption ("resume re-drafts")
        for i in active:
            req = eng._slots[i]
            if self._rid[i] != req.id:
                self.drafter.reset(i)
                self._rid[i] = req.id
        t0 = time.perf_counter()
        draft_np = np.asarray(self.drafter.propose(eng, active), np.int32)
        _stats.observe("spec.propose_ms",
                       (time.perf_counter() - t0) * 1e3)
        ids = np.zeros((B, k + 1), np.int32)
        start = np.zeros((B,), np.int32)
        clens = np.zeros((B,), np.int32)
        for i in active:
            ids[i, 0] = eng._last_tok[i]
            ids[i, 1:] = draft_np[i]
            start[i] = int(eng._lens[i]) - 1
            clens[i] = int(win[i])
        tables = mgr.block_tables(
            [("slot", i) for i in range(B)], eng._pages_per_seq,
            allow_missing=True)
        _stats.set_gauge("serving.kv_pages_in_use",
                         mgr.num_pages - mgr.free_pages)
        _stats.set_gauge("serving.active_slots", len(active))
        # re-stamped per round: benches reset the registry after warmup
        _stats.set_gauge("spec.k", k)
        g._count_a8w8(1)
        lnf_s, lnf_b = g._lnf()
        t0 = time.perf_counter()
        cand, acc, h_acc, eng._ck, eng._cv = self._verify_fn(
            g._weights(), g._embed(), g._head_t, lnf_s, lnf_b,
            torch.as_tensor(ids, device=dev),
            torch.as_tensor(start, device=dev),
            torch.as_tensor(clens, device=dev),
            torch.as_tensor(draft_np, device=dev), eng._ck, eng._cv,
            tables, k=k)
        cand_np, acc_np = cand.cpu().numpy(), acc.cpu().numpy()
        # the fetch above synced the round
        dt = time.perf_counter() - t0
        _stats.observe("spec.verify_ms", dt * 1e3)
        # validation BEFORE any request mutates (serving override:
        # corruption detection): a raise leaves the round retryable
        cand_np = eng._postprocess_tokens(cand_np, active)

        _stats.inc("serving.spec_rounds")
        jr = eng._journal
        u = eng._usage
        done_now = []
        alive = []
        for i in active:
            req = eng._slots[i]
            a = int(acc_np[i])
            _stats.inc("serving.spec_drafted_tokens", k)
            _stats.inc("serving.spec_accepted_tokens", a)
            _stats.inc("serving.spec_rejected_tokens", k - a)
            _stats.observe("serve.accept_len", a)
            if jr is not None:
                jr.record("spec_verify", req.id, i,
                          {"k": k, "accepted": a,
                           "dur_ms": round(dt * 1e3, 3)})
            cb = getattr(req, "on_token", None)
            consumed = 0
            for j in range(a + 1):
                if req.done:
                    break
                t = int(cand_np[i, j])
                req.generated.append(t)
                consumed += 1
                if cb is not None:
                    cb(req, t)
                if (req.eos_token_id is not None
                        and t == req.eos_token_id) or \
                        len(req.generated) >= req.max_new_tokens:
                    req.done = True
            # window tokens decoded past req.done: executed but discarded
            # device work, as the decode chunk's counter
            _stats.inc("serving.wasted_decode_tokens", a + 1 - consumed)
            if u is not None:
                u.add_tokens(req, spec_accepted=a, wasted=a + 1 - consumed)
            if req.done:
                eng._finish_hook(req, i)
                eng._release(i)          # also resets the drafter slot
                done_now.append(req)
            else:
                eng._lens[i] += consumed          # consumed == a + 1
                eng._last_tok[i] = int(cand_np[i, consumed - 1])
                # rejection rollback = page-table truncation: pages grown
                # for the rejected window tail return to the pool
                # (refcount-aware: a shared prefix page only drops a
                # reference)
                mgr.truncate(("slot", i), int(eng._lens[i]) - 1)
                if u is not None:
                    u.set_pages(req, len(mgr._owned.get(("slot", i), ())))
                self.drafter.commit(i, a)
                alive.append(i)
        if alive:
            self.drafter.observe_hidden(h_acc, alive)
        eng.finished.extend(done_now)
        return done_now


def build_speculative_decoder(engine, speculative,
                              spec_k: Optional[int] = None
                              ) -> SpeculativeDecoder:
    """Resolve the engines' ``speculative=`` argument: ``True`` reads
    ``FLAGS_spec_drafter``; ``"self"`` builds the self-drafting heads; a
    :class:`FusedCausalLM` wraps into a :class:`DraftModelDrafter`; a
    :class:`Drafter` instance is used as is. ``spec_k`` defaults to
    ``FLAGS_spec_k``."""
    from ..core.flags import flag as _flag
    from .engine import FusedCausalLM

    k = int(spec_k) if spec_k is not None else int(_flag("spec_k"))
    if speculative is True:
        speculative = str(_flag("spec_drafter"))
    if isinstance(speculative, str):
        if speculative == "self":
            drafter = SelfDraftHeads()
        elif speculative == "draft":
            raise ValueError(
                "speculative='draft' needs a draft model — pass "
                "speculative=DraftModelDrafter(draft_model) (or the "
                "FusedCausalLM itself)")
        else:
            raise ValueError(
                f"speculative={speculative!r}: expected 'self', a "
                "Drafter instance, or a FusedCausalLM draft model")
    elif isinstance(speculative, FusedCausalLM):
        drafter = DraftModelDrafter(speculative)
    elif isinstance(speculative, Drafter):
        drafter = speculative
    else:
        raise ValueError(
            f"speculative={speculative!r}: expected True, 'self', a "
            "Drafter instance, or a FusedCausalLM draft model")
    return SpeculativeDecoder(engine, drafter, k)
