"""SLO-aware serving frontend over the continuous-batching engine.

Counterpart of ``paddle_tpu/serving/scheduler.py``. An async admission
queue feeds a scheduler that interleaves CHUNKED PREFILL with grouped
decode — a 4k-token prompt fills the paged pool in fixed-size chunks
BETWEEN decode chunks, so admitting it never stalls the decode batch
for its whole prompt length — plus prefix/KV reuse
(``serving/prefix_cache.py``) so requests sharing a system prompt map
the prefix's pages instead of recomputing them.

Scheduling policy (``SLOConfig``): admission uses the engine's bounded
skip-ahead ordered by request priority (or deficit-weighted round-robin
over tenants); the prefill-vs-decode interleave is a weighted cycle
derived from the TTFT-vs-TPOT weights. With any decode-ready request
present, at most ``prefill_burst`` consecutive prefill chunks ever run,
so an active request's inter-token stall is BOUNDED by
``prefill_burst * prefill_chunk + decode_chunk`` tokens of device work.

Device path: each prefill chunk is one call of
``FusedMultiTransformer.prefill_chunk_raw`` — per layer the chunk's K/V
written into its pages, then ``paged_prefill_attention`` (the
block-table kernel of ``csrc/flash_varlen.cu`` on the card) over the
cached prefix and the in-chunk triangle — and the LM head on the last
valid row. The argmax fetch of the chunk's token is its one host sync.
Decode chunks are the base engine's (the B1-B3 kernels).

Telemetry: per-request ``serve.{ttft_ms,tpot_ms,queue_wait_ms}``
histograms, ``serving.prefix_{hit,miss,pages_saved}`` and chunk
counters, and per-step phase attribution ``serve.step.*_ms`` on the
injectable serving clock. Every lifecycle transition lands in the
FLIGHT RECORDER (``serving/journal.py``, ``FLAGS_serve_journal``) and
every finish feeds the SLO monitor (``serving/slo.py``). ``run()``
dumps the journal, a stats snapshot and every unserved request to a
JSONL crash artifact on any raise (``crash_dump``).

Failure semantics: one request's failure never takes the loop down.
Per-request ``deadline_ms`` aborts a request wherever it sits; an
exception inside one slot's prefill/decode chunk retries with capped
exponential backoff through the serving clock, then errors out ONLY
the offending request; a progress watchdog preempts/requeues a request
that stopped emitting tokens and kills it on the second trip;
admission sheds with a typed ``ServerOverloaded`` past the inbox,
queue-depth or burn-rate thresholds — after prefill chunks have
already shrunk under pool pressure. All of it is drivable
deterministically by the seeded fault registry in ``serving/faults.py``.

Multi-LoRA (``adapters=``, an ``AdapterBank``): a request's
``adapter_id`` is pinned in the bank at submit and released on every
terminal path; chunks and decode steps that carry an adaptered row add
one ragged LoRA delta launch per target projection
(``lora.grouped_launches`` counts them). Prefix pages are shared only
between requests of one adapter (the JAX package shares them across
adapters).

Left for later slices of the port (each raises ``NotImplementedError``
naming its slice): speculative decoding, the fleet hooks (adoption of a
failed-over request, which re-resolves its adapter) and the host-DRAM
KV tier (``can_spill()`` is False, so prefix eviction releases pages
outright).
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.flags import flag as _flag
from ..incubate.nn.fused_transformer import PagedKV
from ..inference.engine import ContinuousBatchingEngine, FusedCausalLM
from ..profiler import stats as _stats
from . import faults as _faults
from .accounting import UsageLedger
from .faults import (DeadlineExceeded, PoolSizingError, ServerOverloaded,
                     TokenCorruption, WatchdogTimeout)
from .journal import FlightRecorder
from .prefix_cache import PrefixCache
from .request import Request
from .slo import SLOMonitor

__all__ = ["SLOConfig", "ServingEngine"]


class SLOConfig:
    """Scheduler knobs (see module docstring for the policy).

    ``ttft_weight`` / ``tpot_weight``: relative urgency of prefill
    (time-to-first-token) vs decode (time-per-output-token) work; the
    integer interleave cycle is derived from their ratio.
    ``prefill_chunk``: tokens per chunked-prefill call (the stall
    bound's unit). ``admit_window`` / ``starvation_bound``: admission
    skip-ahead reach and its fairness bound. ``prefix_cache``: enable
    prefix/KV reuse; ``prefix_cache_pages`` caps the registered pages
    (None = pool-pressure eviction only). ``ttft_target_ms`` /
    ``tpot_target_ms``: per-request SLO targets (None disables that
    leg); ``goodput_objective`` + ``slo_window`` shape the rolling
    ``slo.goodput`` gauge and its burn rate. ``tenant_fair``:
    DEFICIT-WEIGHTED round-robin over per-tenant queues instead of
    priority-FIFO — each admission round credits every waiting tenant
    ``fair_quantum * weight`` tokens, and the richest tenant's earliest
    admissible request admits and pays its token cost (prompt +
    max_new); ``tenant_weights`` maps tenant -> relative share
    (missing tenants weigh 1.0).
    """

    def __init__(self, ttft_weight: float = 1.0,
                 tpot_weight: float = 1.0, prefill_chunk: int = 256,
                 admit_window: int = 8, starvation_bound: int = 16,
                 prefix_cache: bool = True,
                 prefix_cache_pages: Optional[int] = None,
                 ttft_target_ms: Optional[float] = 1000.0,
                 tpot_target_ms: Optional[float] = 100.0,
                 goodput_objective: float = 0.99,
                 slo_window: int = 256, tenant_fair: bool = False,
                 tenant_weights: Optional[dict] = None,
                 fair_quantum: int = 256):
        if ttft_weight <= 0 or tpot_weight <= 0:
            raise ValueError("SLO weights must be positive")
        self.ttft_weight = float(ttft_weight)
        self.tpot_weight = float(tpot_weight)
        self.prefill_chunk = max(int(prefill_chunk), 1)
        self.admit_window = max(int(admit_window), 1)
        self.starvation_bound = max(int(starvation_bound), 1)
        self.prefix_cache = bool(prefix_cache)
        self.prefix_cache_pages = prefix_cache_pages
        self.ttft_target_ms = None if ttft_target_ms is None \
            else float(ttft_target_ms)
        self.tpot_target_ms = None if tpot_target_ms is None \
            else float(tpot_target_ms)
        if not 0.0 < float(goodput_objective) < 1.0:
            raise ValueError("goodput_objective must be in (0, 1)")
        self.goodput_objective = float(goodput_objective)
        self.slo_window = max(int(slo_window), 1)
        self.tenant_fair = bool(tenant_fair)
        self.tenant_weights = dict(tenant_weights or {})
        self.fair_quantum = max(int(fair_quantum), 1)
        r = self.ttft_weight / self.tpot_weight
        #: consecutive prefill chunks allowed while decoders wait /
        #: decode chunks between prefill opportunities — the weighted
        #: interleave cycle (1:1 → strict alternation)
        self.prefill_burst = max(1, int(round(r)))
        self.decode_burst = max(1, int(round(1.0 / r)))


class _Prefill:
    """Progress of one chunk-prefilling request parked on a slot.

    ``tokens`` is what gets prefilled: the prompt, or — for a request
    preempted out of a decode slot under pool pressure — the prompt
    plus everything already generated, so the final chunk's logits
    yield the NEXT token of the stream (recompute-style resume)."""

    __slots__ = ("req", "pos", "tokens")

    def __init__(self, req: Request, pos: int, tokens):
        self.req = req
        self.pos = pos  # tokens already in the pool
        self.tokens = tokens


class ServingEngine(ContinuousBatchingEngine):
    """Production-shaped serving frontend (see module docstring).

    Usage::

        eng = ServingEngine(model, max_batch=8,
                            slo=SLOConfig(prefill_chunk=256))
        eng.submit([1, 2, 3], max_new_tokens=16,
                   on_token=lambda r, t: push(t))   # any thread
        finished = eng.run()        # or step() on the serving thread

    The device is the model's. Chunk-prefilling requests park on a slot
    under a side page-table key (``("prefill", i)``) so the decode
    batch's slot tables never see their half-filled pages; completion
    rekeys the pages to ``("slot", i)`` and the request joins the
    decode batch with its first token already emitted (from the final
    chunk's logits).
    """

    def __init__(self, model: FusedCausalLM,
                 slo: Optional[SLOConfig] = None, faults=None,
                 adapters=None, **engine_kwargs):
        slo = slo or SLOConfig()
        engine_kwargs.setdefault("admit_window", slo.admit_window)
        engine_kwargs.setdefault("starvation_bound",
                                 slo.starvation_bound)
        super().__init__(model, **engine_kwargs)
        self.slo = slo
        # multi-LoRA adapter bank: None serves the base model only;
        # requests pin their adapter at submit and release it at every
        # terminal path
        self.adapters = adapters
        # deficit-weighted round-robin state (SLOConfig.tenant_fair):
        # tenant -> accumulated token deficit
        self._fair_deficit: Dict[str, float] = {}
        # flight recorder (FLAGS_serve_journal): None when disabled,
        # so every hot-path hook is a single attribute test
        self.journal: Optional[FlightRecorder] = None
        if _flag("serve_journal"):
            self.journal = FlightRecorder(
                int(_flag("serve_journal_events")))
        self._journal = self.journal  # base-engine finish hook
        self.slo_monitor = SLOMonitor(
            ttft_target_ms=slo.ttft_target_ms,
            tpot_target_ms=slo.tpot_target_ms,
            objective=slo.goodput_objective, window=slo.slo_window)
        # usage ledger (FLAGS_usage_ledger): None when disabled
        self.usage: Optional[UsageLedger] = None
        if _flag("usage_ledger"):
            self.usage = UsageLedger()
        self._usage = self.usage  # engine token hooks
        self.last_crash_dump: Optional[str] = None
        self.prefix_cache: Optional[PrefixCache] = None
        if slo.prefix_cache:
            self.prefix_cache = PrefixCache(
                self._mgr, self.page_size, slo.prefix_cache_pages,
                journal=self.journal)
        # the host-DRAM KV tier comes with the fleet slice
        # (can_spill() is False): eviction releases pages outright
        self.host_tier = None
        self._prefilling: Dict[int, _Prefill] = {}
        # async admission: submit() appends here from ANY thread; the
        # scheduler thread drains into the priority-ordered waiting
        # list at each step
        self._inbox: List[Request] = []
        self._inbox_lock = threading.Lock()
        self._arrival = itertools.count()
        self._cycle_pos = 0
        #: scheduler action trace ("prefill"/"decode"), the stall-bound
        #: evidence; cheap (one short str per step)
        self.action_log: List[str] = []
        # crash-isolation bookkeeping: the request/slot a risky phase
        # is operating on (so its failure can be pinned to the
        # offending request), and the decode-chunk retry budget
        self._admitting = None            # (req, slot) mid-_admit_into
        self._prefill_active = None       # (req, slot) mid-chunk
        self._decode_retries = 0
        # fault injection (serving/faults.py): installed on the engine,
        # the page manager (kv.alloc/kv.grow sites + squeeze target)
        # and the prefix cache; None keeps every site one attr test
        self.faults = None
        if faults is not None:
            self.install_faults(faults)

    def install_faults(self, faults) -> None:
        """Arm a :class:`~paddle_tpu_torch.serving.faults.FaultInjector`
        on every wired site — the engine itself (``prefill.dispatch``,
        ``decode.step``, ``journal.dump``), the page manager
        (``kv.alloc``/``kv.grow`` + the squeeze target) and the prefix
        cache (``prefix.insert``)."""
        self.faults = faults
        self._faults = faults             # base-engine decode.step site
        faults.bind(mgr=self._mgr, journal=self.journal)
        self._mgr._faults = faults
        if self.prefix_cache is not None:
            self.prefix_cache._faults = faults

    # ---------------- public API ----------------

    def submit(self, prompt, max_new_tokens: int = 32,
               eos_token_id=None, priority: int = 0,
               on_token=None, deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None,
               adapter_id: Optional[str] = None) -> int:
        """Thread-safe admission (any thread): queue a request, return
        its id. Tokens stream through ``on_token`` as they decode.
        ``deadline_ms`` bounds the request's whole life from arrival;
        ``tenant`` stamps the usage ledger's billing identity;
        ``adapter_id`` routes the request through that LoRA adapter of
        the engine's ``AdapterBank`` (pinned against unload until the
        request terminates). Raises :class:`ServerOverloaded` —
        backpressure to the SUBMITTING thread — when the bounded inbox,
        the queue depth, or the SLO burn rate is past its shed
        threshold; a ``KeyError`` rejects an unknown or draining adapter
        and a ``ValueError`` an adapter on a bank-less engine."""
        req = Request(prompt, max_new_tokens, eos_token_id,
                      priority=priority, on_token=on_token,
                      deadline_ms=deadline_ms, tenant=tenant,
                      adapter_id=adapter_id)
        return self.submit_request(req)

    def submit_request(self, req: Request) -> int:
        if len(req.prompt) + req.max_new_tokens > self.max_length:
            raise ValueError("request exceeds engine max_length")
        self._check_overload(req)
        self._adapter_acquire(req)
        with self._inbox_lock:
            self._inbox.append(req)
        jr = self.journal
        if jr is not None:
            extra = {"prompt_len": int(len(req.prompt)),
                     "max_new": int(req.max_new_tokens)}
            if getattr(req, "tenant", None) is not None:
                extra["tenant"] = req.tenant
            if getattr(req, "adapter_id", None) is not None:
                extra["adapter"] = req.adapter_id
            jr.record("submit", req.id, -1, extra)
        _stats.inc("serve.submitted")
        return req.id

    # ---------------- multi-LoRA lifecycle ----------------

    def _adapter_acquire(self, req: Request) -> None:
        """Pin ``req``'s adapter in the bank and stamp its slot (and its
        prefix-cache salt) on the request. Raises before the request
        enters any queue: ``KeyError`` for an unknown or draining
        adapter, ``ValueError`` on a bank-less engine."""
        name = getattr(req, "adapter_id", None)
        if name is None:
            return
        if self.adapters is None:
            raise ValueError(
                f"request {req.id} names adapter {name!r} but the "
                "engine has no adapter bank")
        if self._spec is not None:
            raise ValueError(
                "adaptered requests don't compose with speculative "
                "decoding (the verify pass has no delta path yet)")
        req._adapter_slot = self.adapters.acquire(name, req.id)
        req._prefix_salt = self.adapters.cache_salt(name)

    def _adapter_release(self, req) -> None:
        """Unpin ``req``'s adapter (idempotent; a no-op for base-model
        requests)."""
        bank = self.adapters
        if bank is not None \
                and getattr(req, "adapter_id", None) is not None:
            bank.release(req.id)

    def _adapter_operands(self, active):
        """Serving override of the decode-chunk adapter hook: when an
        active slot decodes through a bank adapter, the per-slot bank
        slot map (-1 = base model) on the device and the bank's
        operands; a pure-base batch returns ``(None, None)`` and keeps
        the grouped decode."""
        bank = self.adapters
        if bank is None:
            return None, None
        slots = np.full((self.max_batch,), -1, np.int32)
        for i in active:
            req = self._slots[i]
            s = getattr(req, "_adapter_slot", None) \
                if req is not None else None
            if s is not None and s >= 0:
                slots[i] = s
        if not (slots >= 0).any():
            return None, None
        return (torch.as_tensor(slots, device=self._gen._device),
                bank.operands())

    @staticmethod
    def _prefix_salt(req) -> bytes:
        return getattr(req, "_prefix_salt", b"")

    def _check_overload(self, req: Request) -> None:
        """Admission-time overload shedding: reject with a typed
        ``ServerOverloaded`` when (a) the inbox is at its hard bound
        (``FLAGS_serve_inbox_limit``), (b) the queue depth (inbox +
        waiting) crossed ``FLAGS_serve_shed_queue_depth``, or (c) the
        SLO burn-rate gauge crossed ``FLAGS_serve_shed_burn_rate``.
        0 disables each threshold."""
        limit = int(_flag("serve_inbox_limit"))
        depth_cap = int(_flag("serve_shed_queue_depth"))
        with self._inbox_lock:
            inbox = len(self._inbox)
        reason = None
        if limit > 0 and inbox >= limit:
            reason = f"inbox at its bound ({inbox}/{limit})"
        elif depth_cap > 0 and inbox + len(self.waiting) >= depth_cap:
            reason = (f"queue depth {inbox + len(self.waiting)} >= "
                      f"shed threshold {depth_cap}")
        else:
            burn_cap = float(_flag("serve_shed_burn_rate"))
            burn = self.slo_monitor.burn_rate
            if burn_cap > 0 and burn is not None and burn > burn_cap:
                reason = (f"SLO burn rate {burn:.2f} > shed "
                          f"threshold {burn_cap:.2f}")
        if reason is None:
            return
        _stats.inc("serving.shed")
        u = self.usage
        # a shed-at-submit request DID enter the system — close its
        # (empty) usage record so every request emits exactly one
        rec = u.finish(req, "shed") if u is not None else None
        jr = self.journal
        if jr is not None:
            extra = {"reason": reason}
            if rec is not None:
                extra["usage"] = rec
            jr.record("shed", req.id, -1, extra)
        raise ServerOverloaded(
            f"request {req.id} shed at submit: {reason}")

    @property
    def num_prefilling(self) -> int:
        return len(self._prefilling)

    @property
    def queue_depth(self) -> int:
        """Queued-but-not-yet-admitted requests (inbox + waiting)."""
        with self._inbox_lock:
            return len(self._inbox) + len(self.waiting)

    @property
    def has_work(self) -> bool:
        """Anything for ``step()`` to do."""
        return bool(self._inbox or self.waiting or self._prefilling
                    or self.num_active)

    def step(self):
        """One scheduler action: drain admissions (shed-aware), expire
        deadlines, tick the progress watchdog, then run EITHER one
        prefill chunk or one decode chunk per the SLO interleave —
        CRASH-ISOLATED: an exception inside admission or either chunk
        retries with capped exponential backoff and then errors out
        only the offending request (``_recover_*``). Returns requests
        finished this step.

        Each completed step's wall time is ATTRIBUTED into phase
        histograms via the clock seam (``serve.step.{admit,
        prefill_chunk,decode_chunk}_ms`` plus the ``host_overhead_ms``
        residual — see ``_observe_step``); recovery early-returns skip
        attribution so the phase sums stay an exact partition of the
        observed ``total_ms``."""
        ts0 = _faults.now()
        self._drain_inbox()
        self._expire_deadlines()
        try:
            self._admit()
        except Exception as e:
            self._recover_admit(e)
        self.slo_monitor.update_gauges(
            len(self.waiting) + len(self._inbox), self.num_active,
            len(self._prefilling), self.max_batch)
        self._watchdog_tick()
        ts_admit = _faults.now()
        action = self._pick_action()
        if action == "prefill":
            self.action_log.append("prefill")
            try:
                out = self._prefill_step()
            except Exception as e:
                return self._recover_prefill(e)
            tgt, self._prefill_active = self._prefill_active, None
            if tgt is not None:
                tgt[0].n_retries = 0  # chunk landed — budget restored
            ts_work = _faults.now()
            u = self.usage
            if u is not None:
                # the chunk prefilled exactly one request: charge it
                # the SAME float the phase histogram observes below
                u.charge_phase("prefill_chunk",
                               (ts_work - ts_admit) * 1e3,
                               (tgt[0],) if tgt is not None else ())
            self._observe_step(ts0, ts_admit, ts_work,
                               "prefill_chunk")
            return out
        if self.num_active == 0:
            self._observe_step(ts0, ts_admit, ts_admit, None)
            return []
        self.action_log.append("decode")
        before = [(r, len(r.generated))
                  for r in self._slots if r is not None]
        t0 = time.perf_counter()
        try:
            done = super().step()
        except Exception as e:
            return self._recover_decode(e)
        self._decode_retries = 0
        ts_work = _faults.now()
        dt_ms = (time.perf_counter() - t0) * 1e3
        u = self.usage
        advanced = []
        for req, n0 in before:
            emitted = len(req.generated) - n0
            if emitted <= 0:
                continue
            if u is not None:
                advanced.append(req)
                u.add_tokens(req, decode=emitted)
            # the request waited the whole chunk for its tokens, so
            # its streaming gap is dt_ms/emitted — observed once PER
            # TOKEN
            gap = dt_ms / emitted
            for _ in range(emitted):
                _stats.observe("serve.tpot_ms", gap)
        if u is not None:
            # the chunk's time splits over the slots it ADVANCED; a
            # wholly-stalled chunk splits over everyone who was active
            u.charge_phase("decode_chunk", (ts_work - ts_admit) * 1e3,
                           advanced or [r for r, _ in before])
        self._observe_step(ts0, ts_admit, ts_work, "decode_chunk")
        return done

    def _observe_step(self, ts0, ts_admit, ts_work, phase):
        """Per-step serving-time attribution: split the step's wall
        clock into admit (drain + deadline sweep + admission +
        watchdog), the work phase (prefill_chunk / decode_chunk), and
        host_overhead — the RESIDUAL between the work phase's end and
        step exit. admit + phase + host_overhead == total EXACTLY per
        step. All stamps come from the clock seam."""
        if not _stats.is_enabled():
            return
        ts_end = _faults.now()
        _stats.observe("serve.step.admit_ms", (ts_admit - ts0) * 1e3)
        if phase is not None:
            _stats.observe("serve.step.%s_ms" % phase,
                           (ts_work - ts_admit) * 1e3)
        _stats.observe("serve.step.host_overhead_ms",
                       (ts_end - ts_work) * 1e3)
        _stats.observe("serve.step.total_ms", (ts_end - ts0) * 1e3)

    def _finish_hook(self, req, slot: int):
        """Serving finish path (called the moment a request completes,
        before its pages release): stamp t_done, observe the lifetime
        per-token mean, judge the SLO verdict, and journal a
        verdict-rich finish event."""
        req.t_done = _faults.now()
        if getattr(req, "state", None) is None:
            req.state = "ok"
        tpot = getattr(req, "tpot_s", None)
        if tpot is not None:
            _stats.observe("serve.request_tpot_ms", tpot * 1e3)
        v = self.slo_monitor.observe_finish(req)
        self._adapter_release(req)
        u = self.usage
        rec = u.finish(req, "ok") if u is not None else None
        jr = self.journal
        if jr is not None:
            extra = {"n_tokens": len(req.generated),
                     "ttft_ms": v["ttft_ms"],
                     "tpot_ms": v["tpot_ms"],
                     "slo_ok": v["slo_ok"]}
            if getattr(req, "tenant", None) is not None:
                extra["tenant"] = req.tenant
            if getattr(req, "adapter_id", None) is not None:
                extra["adapter"] = req.adapter_id
            if rec is not None:
                extra["usage"] = rec
            jr.record("finish", req.id, slot, extra)

    # ---------------- failure semantics ----------------

    _FAIL_COUNTERS = {"deadline_exceeded": "serving.deadline_exceeded",
                      "shed": "serving.shed",
                      "error": "serving.request_errors"}

    def _fail_request(self, req: Request, slot: int, state: str,
                      exc: BaseException):
        """Terminal failure path: stamp the request's terminal state
        and error, roll it into the SLO window as a miss, journal the
        terminal event, and move it to ``finished``. The error
        surfaces ONLY to this request. Callers remove the request from
        queue/slot structures and free its pages FIRST."""
        req.done = True
        req.state = state
        req.error = exc
        req.t_done = _faults.now()
        self.slo_monitor.observe_error(req)
        self._adapter_release(req)
        u = self.usage
        rec = u.finish(req, state) if u is not None else None
        _stats.inc(self._FAIL_COUNTERS.get(
            state, "serving.request_errors"))
        jr = self.journal
        if jr is not None:
            ev = state if state in ("deadline_exceeded", "shed") \
                else "error"
            extra = {"error": type(exc).__name__,
                     "msg": str(exc)[:200]}
            if rec is not None:
                extra["usage"] = rec
            jr.record(ev, req.id, slot, extra)
        self.finished.append(req)

    def _drop_prefill_slot(self, i: int):
        """Vacate prefill slot ``i`` and free its pages (no requeue)."""
        stt = self._prefilling.pop(i, None)
        if ("prefill", i) in self._mgr._owned:
            self._mgr.free(("prefill", i))
        u = self.usage
        if u is not None and stt is not None:
            u.set_pages(stt.req, 0)

    def _release(self, i: int) -> None:
        """Serving override: close the vacating request's page-second
        integral before the base engine frees slot ``i``'s pages."""
        u = self.usage
        if u is not None:
            req = self._slots[i]
            if req is not None:
                u.set_pages(req, 0)
        super()._release(i)

    def _expire_deadlines(self):
        """Abort every request whose ``deadline_ms`` budget elapsed —
        wherever it sits (waiting list, prefill slot, decode slot) —
        freeing its pages and surfacing ``DeadlineExceeded`` only to
        it. Runs once per scheduler step on the injected clock."""
        now = _faults.now()
        expired = [r for r in self.waiting if r.past_deadline(now)]
        for req in expired:
            self.waiting.remove(req)
            self._fail_request(req, -1, "deadline_exceeded",
                               DeadlineExceeded(
                                   f"request {req.id} exceeded its "
                                   f"{req.deadline_ms}ms deadline in "
                                   "queue"))
        for i in [i for i, s in list(self._prefilling.items())
                  if s.req.past_deadline(now)]:
            req = self._prefilling[i].req
            self._drop_prefill_slot(i)
            self._fail_request(req, i, "deadline_exceeded",
                               DeadlineExceeded(
                                   f"request {req.id} exceeded its "
                                   f"{req.deadline_ms}ms deadline "
                                   "during prefill"))
        for i in range(self.max_batch):
            req = self._slots[i]
            if req is not None and req.past_deadline(now):
                self._release(i)
                self._fail_request(req, i, "deadline_exceeded",
                                   DeadlineExceeded(
                                       f"request {req.id} exceeded "
                                       f"its {req.deadline_ms}ms "
                                       "deadline during decode"))

    def _backoff_ms(self, attempt: int) -> float:
        return min(float(_flag("serve_retry_backoff_ms"))
                   * (2 ** (attempt - 1)),
                   float(_flag("serve_retry_backoff_cap_ms")))

    def _note_retry(self, req, slot: int, exc: BaseException,
                    phase: str) -> bool:
        """Crash-isolation retry bookkeeping: True = a retry is still
        in budget (``FLAGS_serve_step_retries``) and its capped
        exponential backoff has been slept through the serving clock;
        False = the budget is spent and the caller must error the
        request out."""
        budget = int(_flag("serve_step_retries"))
        if req.n_retries >= budget:
            return False
        req.n_retries += 1
        _stats.inc("serving.step_retries")
        u = self.usage
        if u is not None:
            u.add_event(req, retry=1)
        delay_ms = self._backoff_ms(req.n_retries)
        jr = self.journal
        if jr is not None:
            jr.record("retry", req.id, slot,
                      {"phase": phase, "attempt": req.n_retries,
                       "backoff_ms": delay_ms,
                       "error": type(exc).__name__})
        _faults.clock().sleep(delay_ms / 1e3)
        return True

    def _recover_admit(self, e: Exception):
        """An exception inside admission: roll back the half-admitted
        request (its prefill-key pages release), then retry-or-fail
        it. Failures outside any admission propagate to ``run()``'s
        crash dump."""
        if isinstance(e, PoolSizingError):
            raise e
        tgt = self._admitting
        self._admitting = None
        if tgt is None:
            raise e
        req, i = tgt
        self._drop_prefill_slot(i)
        if self._note_retry(req, i, e, "admit"):
            self.waiting.append(req)
            self._sort_waiting()
        else:
            self._fail_request(req, i, "error", e)

    def _recover_prefill(self, e: Exception):
        """An exception inside one slot's prefill chunk: retry it in
        place with backoff, then error out only it. Chunk re-dispatch
        is clean — nothing host-side mutated before the raise, and
        re-running the chunk rewrites the same KV pages with identical
        values."""
        if isinstance(e, PoolSizingError):
            raise e
        tgt = self._prefill_active
        self._prefill_active = None
        if tgt is None:
            raise e
        req, i = tgt
        if self._note_retry(req, i, e, "prefill"):
            return []
        self._drop_prefill_slot(i)
        if self._slots[i] is req:   # failed past the decode handoff
            self._release(i)
        self._fail_request(req, i, "error", e)
        return []

    def _recover_decode(self, e: Exception):
        """An exception inside the decode chunk: not attributable to
        one slot, so retry the whole chunk with backoff; once the
        budget is spent, sacrifice the LEAST-urgent active slot and
        keep serving."""
        if isinstance(e, PoolSizingError):
            raise e
        budget = int(_flag("serve_step_retries"))
        if self._decode_retries < budget:
            self._decode_retries += 1
            _stats.inc("serving.step_retries")
            delay_ms = self._backoff_ms(self._decode_retries)
            jr = self.journal
            if jr is not None:
                jr.record("retry", -1, -1,
                          {"phase": "decode",
                           "attempt": self._decode_retries,
                           "backoff_ms": delay_ms,
                           "error": type(e).__name__})
            _faults.clock().sleep(delay_ms / 1e3)
            return []
        self._decode_retries = 0
        victims = [j for j in range(self.max_batch)
                   if self._slots[j] is not None]
        if not victims:
            raise e
        j = max(victims, key=lambda j: self._urgency(self._slots[j]))
        req = self._slots[j]
        self._release(j)
        self._fail_request(req, j, "error", e)
        return []

    def _watchdog_tick(self):
        """Progress watchdog: a request whose token progress marker
        hasn't moved for ``FLAGS_serve_watchdog_steps`` scheduler
        steps is preempted/requeued (first trip) and failed (second).
        0 disables."""
        n = int(_flag("serve_watchdog_steps"))
        if n <= 0:
            return
        for i, stt in list(self._prefilling.items()):
            self._wd_check(stt.req, ("prefill", stt.pos), i, n, True)
        for i in range(self.max_batch):
            req = self._slots[i]
            if req is not None:
                self._wd_check(req, ("decode", len(req.generated)),
                               i, n, False)

    def _wd_check(self, req, mark, slot: int, n: int,
                  prefilling: bool):
        if req._wd_mark != mark:
            req._wd_mark = mark
            req._wd_steps = 0
            return
        req._wd_steps += 1
        if req._wd_steps < n:
            return
        req._wd_steps = 0
        req._wd_mark = None
        req._wd_trips += 1
        jr = self.journal
        if jr is not None:
            jr.record("watchdog", req.id, slot,
                      {"trip": req._wd_trips,
                       "phase": "prefill" if prefilling else "decode"})
        if req._wd_trips <= 1:
            # first trip: requeue (prefill) / preempt-by-recompute
            # (decode); re-admission is prefix-cache-hot
            _stats.inc("serving.watchdog_preempts")
            if prefilling:
                self._requeue_prefill(slot)
            else:
                self._preempt_slot(slot)
            return
        _stats.inc("serving.watchdog_kills")
        if prefilling:
            self._drop_prefill_slot(slot)
        else:
            self._release(slot)
        self._fail_request(req, slot, "error", WatchdogTimeout(
            f"request {req.id}: no token progress for {n} scheduler "
            "steps twice (one preempt/requeue already spent)"))

    def run(self):
        """Drain: step until every submitted request finishes.

        Crash-dump-on-exception: any raise journals an ``error`` event
        and writes the flight-recorder events + stats snapshot + every
        still-in-flight request to a JSONL artifact (``crash_dump``)
        before propagating. On every exit ``serving.unserved`` counts
        requests that never reached admission."""
        try:
            while (self._inbox or self.waiting or self._prefilling
                   or self.num_active):
                self.step()
        except BaseException as e:
            jr = self.journal
            if jr is not None:
                jr.record("error", -1, -1,
                          {"error": type(e).__name__})
            self.crash_dump(error=e)
            raise
        finally:
            unserved = len(self._inbox) + len(self.waiting)
            if unserved:
                _stats.inc("serving.unserved", unserved)
                u = self.usage
                if u is not None:
                    for req in list(self._inbox) + list(self.waiting):
                        u.finish(req, "unserved")
            if self.journal is not None:
                self.journal.publish_gauges()
        return self.finished

    def crash_dump(self, error=None,
                   path: Optional[str] = None) -> Optional[str]:
        """Post-mortem JSONL artifact: every surviving journal event
        (``type=event`` lines), the full ``stats.snapshot()``
        (``type=stats``), and a ``type=crash`` header naming the error
        and every request still in flight. Written under
        ``FLAGS_serve_journal_dir`` (default: the system temp dir) as
        ``serve_crash_rank<r>_pid<pid>.jsonl``.

        NEVER RAISES: this runs inside ``run()``'s error handling, and
        a failed dump must not mask the original exception. On failure
        it warns on stderr and returns None."""
        import sys

        try:
            return self._crash_dump_impl(error, path)
        except BaseException as dump_err:  # noqa: BLE001 — by design
            print(f"serve: crash dump FAILED ({dump_err!r}) — "
                  "original error preserved", file=sys.stderr)
            return None

    def _crash_dump_impl(self, error, path: Optional[str]) -> str:
        import json
        import os
        import sys
        import tempfile

        f0 = self.faults
        if f0 is not None:
            f0.fire("journal.dump")
        if path is None:
            d = str(_flag("serve_journal_dir")) or tempfile.gettempdir()
            rank = _stats.process_rank()[0]
            path = os.path.join(
                d, f"serve_crash_rank{rank}_pid{os.getpid()}.jsonl")
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        unserved = []
        with self._inbox_lock:
            inbox = list(self._inbox)
        for req in inbox:
            unserved.append({"rid": req.id, "state": "inbox",
                             "prompt_len": int(len(req.prompt))})
        for req in self.waiting:
            unserved.append({"rid": req.id, "state": "waiting",
                             "prompt_len": int(len(req.prompt))})
        for i, stt in sorted(self._prefilling.items()):
            unserved.append({"rid": stt.req.id, "state": "prefilling",
                             "slot": i, "pos": int(stt.pos),
                             "prompt_len": int(len(stt.tokens))})
        for i, req in enumerate(self._slots):
            if req is not None:
                unserved.append({"rid": req.id, "state": "decoding",
                                 "slot": i,
                                 "n_tokens": len(req.generated)})
        events = self.journal.events() if self.journal is not None \
            else []
        with open(path, "w") as f:
            for ev in events:
                f.write(json.dumps({"type": "event", **ev}) + "\n")
            f.write(json.dumps({"type": "stats",
                                "stats": _stats.snapshot()}) + "\n")
            f.write(json.dumps({
                "type": "crash",
                "error": repr(error) if error is not None else None,
                "unserved": unserved,
                "dropped_events": (self.journal.dropped
                                   if self.journal is not None
                                   else 0)}) + "\n")
        self.last_crash_dump = path
        print(f"serve: crash dump -> {path}", file=sys.stderr)
        return path

    # ---------------- admission ----------------

    def _drain_inbox(self):
        """Move submitted requests into the priority-ordered waiting
        list — SHED-AWARE: once the sorted queue is past
        ``FLAGS_serve_shed_queue_depth``, the overflow tail (lowest
        priority, newest arrivals) terminates in the ``shed`` state."""
        with self._inbox_lock:
            newly, self._inbox = self._inbox, []
        for req in newly:
            req._seq = next(self._arrival)
            self.waiting.append(req)
        if newly:
            jr = self.journal
            if jr is not None:
                for req in newly:
                    jr.record("queued", req.id, -1, None)
            self._sort_waiting()
            cap = int(_flag("serve_shed_queue_depth"))
            if cap > 0 and len(self.waiting) > cap:
                overflow = self.waiting[cap:]
                del self.waiting[cap:]
                for req in overflow:
                    self._fail_request(
                        req, -1, "shed", ServerOverloaded(
                            f"request {req.id} shed at drain: queue "
                            f"depth past {cap}"))

    def _sort_waiting(self):
        """Higher priority first; within a level, STABLE adapter
        grouping: requests sharing an adapter sort adjacently, groups
        ordered by their oldest member's arrival and FIFO inside each
        group, so same-adapter requests admit together (a decode chunk
        carries fewer distinct adapters). With no adapters this is the
        priority-FIFO order. The skip-ahead window scans this order."""
        first: Dict[Optional[str], int] = {}
        for r in self.waiting:
            a = getattr(r, "adapter_id", None)
            s = getattr(r, "_seq", r.id)
            if a not in first or s < first[a]:
                first[a] = s
        self.waiting.sort(
            key=lambda r: (-getattr(r, "priority", 0),
                           first[getattr(r, "adapter_id", None)],
                           getattr(r, "_seq", r.id)))

    @staticmethod
    def _tenant_of(req) -> str:
        t = getattr(req, "tenant", None)
        return t if t is not None else "default"

    @staticmethod
    def _admit_cost(req) -> int:
        """DWRR cost of admitting ``req``, in tokens: the prompt it
        will prefill plus the generation budget it may decode."""
        return int(len(req.prompt)) + int(req.max_new_tokens)

    def _pick_waiting(self):
        """Admission pick. Default: the engine's priority-FIFO bounded
        skip-ahead. With ``SLOConfig.tenant_fair``: DEFICIT-WEIGHTED
        round-robin over per-tenant queues; the engine's starvation
        bound is preserved (every pass-over of an earlier arrival bumps
        its ``_admit_skips``, and a head skipped ``starvation_bound``
        times admits next regardless of deficits)."""
        if not self.slo.tenant_fair:
            return super()._pick_waiting()
        if not self.waiting:
            return None
        head = self.waiting[0]
        if head._admit_skips >= self.starvation_bound:
            return self.waiting.pop(0) if self._can_admit(head) \
                else None
        queues: Dict[str, List[Request]] = {}
        for r in self.waiting:
            queues.setdefault(self._tenant_of(r), []).append(r)
        d = self._fair_deficit
        for t in list(d):
            if t not in queues:   # vanished tenant banks no credit
                del d[t]
        w = self.slo.tenant_weights
        for t in queues:
            d[t] = d.get(t, 0.0) \
                + self.slo.fair_quantum * float(w.get(t, 1.0))
        for t in sorted(queues, key=lambda q: (-d[q], q)):
            for r in queues[t][: self.admit_window]:
                if self._can_admit(r):
                    d[t] -= self._admit_cost(r)
                    j = self.waiting.index(r)
                    if j > 0:
                        for skipped in self.waiting[:j]:
                            skipped._admit_skips += 1
                        _stats.inc("serving.admission_skips", j)
                    return self.waiting.pop(j)
        return None

    def _slot_free(self, i: int) -> bool:
        return self._slots[i] is None and i not in self._prefilling

    @staticmethod
    def _admit_tokens(req):
        """What admission will prefill: the prompt, or the recorded
        prompt+generated resume stream of a preempted request."""
        toks = getattr(req, "_resume_tokens", None)
        return req.prompt if toks is None else toks

    def _first_chunk_pages(self, req) -> int:
        """Pages the FIRST prefill chunk needs beyond any prefix hit."""
        toks = self._admit_tokens(req)
        shared = self.prefix_cache.match(toks, self._prefix_salt(req)) \
            if self.prefix_cache is not None else []
        covered = len(shared) * self.page_size
        c = self._chunk_size(len(toks) - covered)
        need = min(self._mgr.pages_needed(covered + c),
                   self._pages_per_seq)
        return need - len(shared)

    def _can_admit(self, req) -> bool:
        need = self._first_chunk_pages(req)
        # pool pressure: evict cold cached prefixes page by page (an
        # evicted entry only frees its page if no live sequence still
        # maps it, so re-check after each drop; match() LRU-touches
        # its chain, so the matched prefix is the LAST thing evicted)
        while need > self._mgr.free_pages \
                and self.prefix_cache is not None \
                and self.prefix_cache.evict(1):
            need = self._first_chunk_pages(req)
        return need <= self._mgr.free_pages

    def _evict_for(self, n_pages: int) -> bool:
        """Free pool pages for an n_pages grow by dropping cold cached
        prefixes; True once the free list covers it."""
        if self.prefix_cache is not None:
            while n_pages > self._mgr.free_pages \
                    and self.prefix_cache.evict(1):
                pass
        return n_pages <= self._mgr.free_pages

    def _admit_into(self, req: Request, i: int):
        """Park ``req`` on slot ``i`` in the chunk-prefill phase: map
        any cached prefix pages and let ``_prefill_step`` fill the
        prompt chunk by chunk. No prefill compute happens at admission
        — admitting a 4k prompt costs a page-table update."""
        self._admitting = (req, i)   # crash-isolation attribution
        now = _faults.now()
        u = self.usage
        if req.t_admitted is None:
            # first admission only — a preempted/requeued request
            # keeps its original marks
            req.t_admitted = now
            arrival = getattr(req, "arrival_time", now)
            _stats.observe("serve.queue_wait_ms",
                           (now - arrival) * 1e3)
            _stats.inc("serving.admitted")
            if u is not None:
                u.note_queue(req, now - arrival)
            self._hook_first_token(req)
        toks = self._admit_tokens(req)
        shared = []
        if self.prefix_cache is not None:
            shared = self.prefix_cache.match(toks, self._prefix_salt(req))
            if shared:
                _stats.inc("serving.prefix_hit")
                _stats.inc("serving.prefix_pages_saved", len(shared))
            else:
                _stats.inc("serving.prefix_miss")
        jr = self.journal
        if jr is not None:
            jr.record("admitted", req.id, i,
                      {"prefix_pages": len(shared),
                       "resume": getattr(req, "_resume_tokens", None)
                       is not None})
        key = ("prefill", i)
        if shared:
            self._mgr.share(key, shared)
            if u is not None:
                u.credit_prefix(req, len(shared))
                u.set_pages(req, len(shared), now=now)
        self._prefilling[i] = _Prefill(
            req, pos=len(shared) * self.page_size, tokens=toks)
        self._admitting = None

    def _hook_first_token(self, req):
        """Wrap the user's on_token with the TTFT stamp (fires exactly
        once, on the first emitted token)."""
        user_cb = getattr(req, "on_token", None)

        def cb(r, t, _u=user_cb):
            if getattr(r, "t_first_token", None) is None:
                r.t_first_token = _faults.now()
                ttft_ms = (r.t_first_token
                           - getattr(r, "arrival_time",
                                     r.t_first_token)) * 1e3
                _stats.observe("serve.ttft_ms", ttft_ms)
                jr = self.journal
                if jr is not None:
                    jr.record("first_token", r.id, -1,
                              {"ttft_ms": round(ttft_ms, 3)})
            if _u is not None:
                _u(r, t)

        req.on_token = cb

    # ---------------- scheduling ----------------

    def _pick_action(self) -> str:
        """Prefill vs decode for this step: the weighted interleave
        cycle, active only under CONTENTION (both phases have work).
        The cycle restarts whenever contention (re)starts, so while any
        request is decode-ready at most ``prefill_burst`` consecutive
        prefill chunks ever run — the stall bound."""
        if not self._prefilling:
            self._cycle_pos = 0
            return "decode"
        if self.num_active == 0:
            self._cycle_pos = 0
            return "prefill"
        cycle = self.slo.prefill_burst + self.slo.decode_burst
        pos = self._cycle_pos % cycle
        self._cycle_pos += 1
        return "prefill" if pos < self.slo.prefill_burst else "decode"

    def _chunk_size(self, remaining: int) -> int:
        """Chunk length for ``remaining`` prompt tokens: full chunks
        while they last, the tail bucket-padded to a multiple of
        ``prompt_bucket``."""
        if remaining >= self.slo.prefill_chunk:
            return self.slo.prefill_chunk
        bs = self.prompt_bucket
        return max(min(-(-remaining // bs) * bs,
                       self.slo.prefill_chunk), 1)

    def _chunk_floor(self) -> int:
        """Smallest chunk graceful degradation may shrink to: one
        page/bucket of tokens, whichever is smaller."""
        return max(1, min(self.prompt_bucket, self.page_size))

    def _shrunk_chunk(self, c: int) -> int:
        """Next smaller chunk size in the degradation chain: half of
        ``c``, rounded up to the floor's multiple, strictly below
        ``c``."""
        floor = self._chunk_floor()
        nxt = -(-(c // 2) // floor) * floor
        return max(min(nxt, c - 1), floor)

    def _postprocess_tokens(self, toks_np, active):
        """Serving override of the decode-chunk token filter: route the
        chunk's token matrix through any scheduled ``decode.step``
        corruption, then validate the whole ACTIVE block before a
        single request mutates — a detected corruption raises
        :class:`TokenCorruption` while the crash-isolated retry is
        still clean."""
        f = self._faults
        if f is not None and active:
            i0 = active[0]
            cur = int(toks_np[i0, 0])
            poked = f.corrupt("decode.step", cur)
            if poked != cur:
                toks_np = np.array(toks_np)   # the fault path only
                toks_np[i0, 0] = poked
        v = self.model.vocab_size
        blk = toks_np[active]
        if blk.size and (int(blk.min()) < 0 or int(blk.max()) >= v):
            raise TokenCorruption(
                f"decode chunk produced token(s) outside [0, {v}) "
                f"for slots {active}")
        return toks_np

    def _urgency(self, req):
        """Sort key: most urgent first (priority, then admission order
        — finish what started first)."""
        return (-getattr(req, "priority", 0), req.t_admitted)

    def _pick_prefilling(self) -> int:
        """Most urgent prefilling slot: priority, then admission
        order."""
        return min(self._prefilling,
                   key=lambda i: self._urgency(self._prefilling[i].req))

    def _chunk_prefill_fn(self, weights, embed, head_t, lnf_s, lnf_b,
                          ids, start, chunk_len, ck, cv, tables,
                          adapter_slots=None, adapter_banks=None):
        """One chunk on the device: prefill ``ids`` at positions
        ``start..`` against the cached prefix + in-chunk causal
        triangle, and return the last VALID position's logits (used
        only by the final chunk; the argmax fetch of every chunk is its
        honest sync). ``start``/``chunk_len`` are [1] int32 device
        tensors, so the layer loop never syncs with the host. With
        adapter operands, every projection adds its LoRA delta (one
        launch per projection per layer)."""
        g = self._gen
        st = self.model.stack
        adapters = None
        if adapter_banks is not None:
            adapters = dict(adapter_banks)
            adapters["slots"] = adapter_slots
        x = embed[ids.long()].to(g._cdtype)
        h, cache = st.prefill_chunk_raw(
            weights, x, PagedKV(ck, cv), tables, start, chunk_len,
            g._cos, g._sin, a8w8=g._a8w8, adapters=adapters)
        hl = h[torch.arange(h.shape[0], device=h.device),
               chunk_len.long() - 1]
        logits = g._logits(hl, head_t, lnf_s, lnf_b)
        return logits, cache.k, cache.v

    def _prefill_step(self):
        """Run ONE prefill chunk for the most urgent prefilling slot;
        on prompt completion the request joins the decode batch with
        its first token emitted. Returns requests finished this step
        (a one-token request can finish straight out of prefill)."""
        i = self._pick_prefilling()
        stt = self._prefilling[i]
        req = stt.req
        self._prefill_active = (req, i)  # crash-isolation attribution
        toks = stt.tokens
        L = len(toks)
        c = self._chunk_size(L - stt.pos)
        n = min(L - stt.pos, c)
        key = ("prefill", i)
        need = min(self._mgr.pages_needed(stt.pos + c),
                   self._pages_per_seq)
        have = len(self._mgr._owned.get(key, ()))
        if need > have and not self._evict_for(need - have):
            # graceful degradation FIRST: shrink this step's chunk
            # until its tail pages fit the squeezed pool
            if _flag("serve_chunk_shrink"):
                c2 = c
                while c2 > self._chunk_floor():
                    c2 = self._shrunk_chunk(c2)
                    need2 = min(self._mgr.pages_needed(stt.pos + c2),
                                self._pages_per_seq)
                    if need2 <= have \
                            or self._evict_for(need2 - have):
                        _stats.inc("serving.chunk_shrinks")
                        c, n = c2, min(L - stt.pos, c2)
                        need = need2
                        break
        if need > have and not self._evict_for(need - have):
            # pool exhausted even after dropping every cold cached
            # prefix (admission only reserved the FIRST chunk's pages)
            if self.num_active > 0:
                # decoders hold the pages and free them as they finish
                # — defer this chunk; the interleave keeps decode going
                _stats.inc("serving.prefill_stalls")
                jr = self._journal
                if jr is not None:
                    jr.record("stall", req.id, i,
                              {"need": need - have})
                return []
            # no decoders to wait for: requeue LESS-urgent prefilling
            # requests (never this one — it would re-admit first and
            # starve the survivor: a livelock) until the pages fit
            while len(self._prefilling) > 1 \
                    and not self._evict_for(need - have):
                victim = max(
                    (j for j in self._prefilling if j != i),
                    key=lambda j: self._urgency(
                        self._prefilling[j].req))
                self._requeue_prefill(victim)
            if not self._evict_for(need - have):
                raise PoolSizingError(
                    f"request {req.id} needs {need} KV pages but the "
                    f"pool can only ever provide "
                    f"{self._mgr.free_pages + have} "
                    f"(num_pages={self._mgr.num_pages}); increase "
                    f"num_pages or cap prompt/generation length")
        if need > have:
            self._mgr.grow(key, need - have)
            u = self.usage
            if u is not None:
                u.set_pages(req, len(self._mgr._owned[key]))
        fi = self.faults
        if fi is not None:
            fi.fire("prefill.dispatch", rid=req.id)
        tables = self._mgr.block_tables([key], self._pages_per_seq)
        ids = np.zeros((1, c), np.int32)
        ids[0, :n] = toks[stt.pos: stt.pos + n]
        self._gen._count_a8w8(1)
        lnf_s, lnf_b = self._gen._lnf()
        dev = self._gen._device
        a_slot = getattr(req, "_adapter_slot", None)
        extra = ()
        if self.adapters is not None and a_slot is not None \
                and a_slot >= 0:
            extra = (torch.tensor([a_slot], dtype=torch.int32, device=dev),
                     self.adapters.operands())
            _stats.inc("lora.grouped_launches",
                       4 * self.model.stack.num_layers)
        logits, self._ck, self._cv = self._chunk_prefill_fn(
            self._gen._weights(), self._gen._embed(),
            self._gen._head_t, lnf_s, lnf_b,
            torch.as_tensor(ids, device=dev),
            torch.tensor([stt.pos], dtype=torch.int32, device=dev),
            torch.tensor([n], dtype=torch.int32, device=dev),
            self._ck, self._cv, tables, *extra)
        tok = int(self._gen._argmax(logits)[0])
        if fi is not None:
            tok = fi.corrupt("prefill.dispatch", tok)
        if not 0 <= tok < self.model.vocab_size:
            # corrupt-and-DETECT: the poisoned token never reaches the
            # request's stream; the raise happens before any host-side
            # mutation, so the crash-isolated retry re-runs this chunk
            raise TokenCorruption(
                f"prefill chunk for request {req.id} produced token "
                f"{tok} outside [0, {self.model.vocab_size})")
        _stats.inc("serve.prefill_chunks")
        _stats.inc("serve.prefill_tokens", n)
        u = self.usage
        if u is not None:
            u.add_tokens(req, prefill=n)
        stt.pos += n
        jr = self._journal
        if jr is not None:
            jr.record("prefill_chunk", req.id, i,
                      {"c": c, "pos": stt.pos, "n": n})
        if stt.pos < L:
            return []
        # prompt complete: emit the next token, join the decode batch
        del self._prefilling[i]
        self._mgr.rekey(key, ("slot", i))
        if self.prefix_cache is not None:
            try:
                self.prefix_cache.insert(
                    toks, self._mgr._owned[("slot", i)],
                    self._prefix_salt(req))
            except Exception:
                # a registration failure (e.g. an injected
                # prefix.insert fault) costs future page reuse, never
                # the request
                _stats.inc("serving.prefix_insert_errors")
        self._slots[i] = req
        req.generated.append(tok)
        if u is not None:
            u.add_tokens(req, decode=1)
        cb = getattr(req, "on_token", None)
        if cb is not None:
            cb(req, tok)
        if (req.eos_token_id is not None and tok == req.eos_token_id) \
                or len(req.generated) >= req.max_new_tokens:
            req.done = True
            self._finish_hook(req, i)
            self._release(i)
            self.finished.append(req)
            return [req]
        if jr is not None:
            jr.record("decode", req.id, i, None)
        self._lens[i] = L + 1
        self._last_tok[i] = tok
        return []

    # ---------------- pool-pressure recovery ----------------

    def _requeue_prefill(self, i: int):
        """Abort slot ``i``'s chunk prefill back to the waiting list,
        freeing its pages (its _resume_tokens, if any, survive)."""
        stt = self._prefilling.pop(i)
        self._mgr.free(("prefill", i))
        _stats.inc("serving.prefill_requeues")
        req = stt.req
        req.n_requeues = getattr(req, "n_requeues", 0) + 1
        u = self.usage
        if u is not None:
            u.set_pages(req, 0)
            u.add_event(req, requeue=1)
        jr = self.journal
        if jr is not None:
            jr.record("requeue", req.id, i, {"pos": int(stt.pos)})
        self.waiting.append(req)
        self._sort_waiting()
        if jr is not None:
            jr.record("queued", req.id, -1, None)
        return []

    def _preempt_slot(self, j: int):
        """Preempt decode slot ``j`` by recomputation: free its pages
        and requeue the request with prompt+generated as its resume
        stream — re-admission chunk-prefills the whole history
        (usually prefix-cache-hot) and the final chunk emits the NEXT
        token, so the user-visible stream just continues."""
        req = self._slots[j]
        req._resume_tokens = np.concatenate(
            [req.prompt, np.asarray(req.generated, np.int32)])
        self._park_preempted_kv(j, req._resume_tokens)
        self._release(j)   # the override closes the page integral
        _stats.inc("serving.preemptions")
        req.n_preempts = getattr(req, "n_preempts", 0) + 1
        u = self.usage
        if u is not None:
            u.add_event(req, preempt=1)
        jr = self.journal
        if jr is not None:
            jr.record("preempt", req.id, j,
                      {"n_generated": len(req.generated)})
        self.waiting.append(req)
        self._sort_waiting()
        if jr is not None:
            jr.record("queued", req.id, -1, None)

    def _park_preempted_kv(self, j: int, resume_toks) -> None:
        """Keep a preempted slot's COMPLETE KV pages reachable: register
        them in the prefix cache under the resume stream's content
        chain before the release, so re-admission maps them and
        re-prefills only the tail. Only positions strictly below
        ``lens-1`` are certainly written between steps, hence the
        (lens-1)//page_size bound."""
        if self.prefix_cache is None:
            return
        n_full = min((int(self._lens[j]) - 1) // self.page_size,
                     len(resume_toks) // self.page_size)
        if n_full <= 0:
            return
        pages = self._mgr._owned.get(("slot", j), [])[:n_full]
        if not pages:
            return
        try:
            self.prefix_cache.insert(resume_toks, pages,
                                     self._prefix_salt(self._slots[j]))
        except Exception:
            # registration is an optimization; an injected
            # prefix.insert fault must never break the preemption
            _stats.inc("serving.prefix_insert_errors")

    def _grow_decode_slot(self, i: int, n_pages: int) -> bool:
        """Serving override of the decode-time grow: under pool
        pressure evict cold cached prefixes first; if the pool is
        STILL exhausted, preempt the LEAST-urgent active slot until
        slot ``i`` fits or is itself the victim."""
        while not self._evict_for(n_pages):
            victim = max(
                (j for j in range(self.max_batch)
                 if self._slots[j] is not None),
                key=lambda j: self._urgency(self._slots[j]))
            self._preempt_slot(victim)
            if victim == i:
                return False
        self._mgr.grow(("slot", i), n_pages)
        u = self.usage
        if u is not None and self._slots[i] is not None:
            u.set_pages(self._slots[i],
                        len(self._mgr._owned[("slot", i)]))
        return True
