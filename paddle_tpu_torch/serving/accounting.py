"""Per-request -> per-tenant usage metering: the serving ledger.

Counterpart of ``paddle_tpu/serving/accounting.py``. Per-tenant quotas
and weighted-fair admission cannot be enforced before usage can be
*measured*, and every engine metric is engine-global: nothing says
which request (or tenant) consumed the device time, the KV pages, or
the queue. The :class:`UsageLedger` closes that gap by partitioning
the scheduler's ``serve.step`` phase attribution (the
``serve.step.{prefill_chunk,decode_chunk,spec_verify,migration}_ms``
stamps) across the requests each phase actually served, and by
integrating KV **page-seconds** per request through every page-count
transition (grow / truncate / preempt / migrate / prefix-share).

Attribution rules
-----------------

- **prefill chunk** -> the one request the chunk prefilled.
- **decode / spec-verify chunk** -> split over the active slots the
  chunk advanced (emitted >= 1 token); if no slot advanced, split
  over every slot that was active when the chunk started. Wasted
  chunk-tail tokens (``serving.wasted_decode_tokens``) are charged —
  as token counts — to the request that finished mid-chunk.
- **migration** -> the migrated request, on the DESTINATION ledger.
- **admit / host overhead** phases are scheduler bookkeeping, not
  work done *for* a request — they are deliberately not attributed.

Conservation is the headline property and it is engineered to be
EXACT, not approximate:

- Every charge call receives the *same float expression from the same
  clock stamps* as the ``serve.step.*_ms`` histogram observation, and
  the ledger accumulates those floats in the same order — so on a
  single engine the ledger's per-phase float totals are **bitwise
  equal** to the histogram totals.
- Per-request shares are kept in **integer nanoseconds**: a chunk's
  ``round(ms * 1e6)`` ns are split with ``divmod`` (the first
  ``remainder`` requests get one extra ns), so the shares *partition*
  the phase total exactly — under any split counts, any summation
  order, chaos, preemption, or fleet failover.

Cardinality bounds: the ledger keys records by request id (one small
``__slots__`` record per request of the run) and exports **bounded**
tenant gauges — ``tenant.{count,max_share}`` plus index-keyed
``tenant.top<i>.device_ms`` for the top-K tenants only — never one
metric key per tenant. Tenant *names* ride in the usage JSONL and the
``serve_top --tenants`` view, not in the metric registry.

Tenant semantics: ``Request(tenant=...)`` stamps the tenant; a
request without one bills to ``default``. A failed-over or migrated
request keeps its rid, so the fleet fold (:func:`fold_records`) sums
its per-replica charges into ONE fleet record — charged exactly once.

Like ``serving/journal.py`` this module is stdlib-only at import time,
so offline tools can load it standalone without importing torch.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

try:  # the serving clock seam (serving/faults.py): page-second
    # integrals follow the same injectable monotonic clock as the
    # step attribution stamps, so ManualClock tests see one timeline.
    from .faults import now as _now
except ImportError:  # standalone load — real monotonic clock
    _now = time.monotonic

__all__ = ["UsageLedger", "WORK_PHASES", "DEFAULT_TENANT",
           "fold_records", "tenant_rollup", "load_usage_jsonl",
           "unattributed_ms"]

#: the serve.step phases the ledger partitions across requests
#: (``admit``/``host_overhead`` are scheduler bookkeeping — excluded)
WORK_PHASES = ("prefill_chunk", "decode_chunk", "spec_verify",
               "migration")

#: tenant billed when ``Request.tenant`` is None
DEFAULT_TENANT = "default"

#: integer count fields carried on every record (summed by the fold)
COUNT_FIELDS = ("prefill_tokens", "decode_tokens",
                "spec_accepted_tokens", "wasted_tokens", "retries",
                "preemptions", "requeues", "prefix_pages_saved")

#: terminal states a usage record can close with (``unserved`` =
#: submitted but never admitted before the serve loop exited)
TERMINAL_STATES = ("ok", "error", "deadline_exceeded", "shed",
                   "unserved")

#: fold precedence when hops disagree (lower wins): a request one
#: replica's admission check shed can still finish ``ok`` on the
#: dispatch retry's next candidate — the completed state is the
#: fleet truth, and ``shed``/``unserved`` only stand when nothing
#: stronger happened anywhere
_STATE_RANK = {"ok": 0, "deadline_exceeded": 1, "error": 2,
               "unserved": 3, "shed": 4, None: 9}


class _ReqUsage:
    """One request's running totals (mutable, ``__slots__``-packed)."""

    __slots__ = ("rid", "tenant", "adapter", "state", "phase_ns",
                 "queue_s", "kv_page_s", "pages", "pages_ts",
                 "prefill_tokens", "decode_tokens",
                 "spec_accepted_tokens", "wasted_tokens", "retries",
                 "preemptions", "requeues", "prefix_pages_saved")

    def __init__(self, rid: int, tenant: str, ts: float,
                 adapter: Optional[str] = None):
        self.rid = rid
        self.tenant = tenant
        self.adapter = adapter
        self.state: Optional[str] = None
        self.phase_ns: Dict[str, int] = {}
        self.queue_s = 0.0
        self.kv_page_s = 0.0
        self.pages = 0
        self.pages_ts = ts
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.spec_accepted_tokens = 0
        self.wasted_tokens = 0
        self.retries = 0
        self.preemptions = 0
        self.requeues = 0
        self.prefix_pages_saved = 0

    @property
    def device_ns(self) -> int:
        return sum(self.phase_ns.values())

    def as_record(self, hop: Optional[int] = None) -> dict:
        d = {"type": "usage", "rid": self.rid, "tenant": self.tenant,
             "state": self.state,
             **({"adapter": self.adapter}
                if self.adapter is not None else {}),
             "phase_ns": dict(self.phase_ns),
             "device_ms": round(self.device_ns / 1e6, 6),
             "queue_s": round(self.queue_s, 9),
             "kv_page_s": round(self.kv_page_s, 9)}
        for f in COUNT_FIELDS:
            d[f] = getattr(self, f)
        if hop is not None:
            d["hop"] = hop
        return d


class UsageLedger:
    """Clock-seam-driven per-request -> per-tenant resource ledger.

    Default-off (``FLAGS_usage_ledger``): the engine holds
    ``usage = None`` and every hook is a single attribute test — zero
    per-step allocations, like the journal when it is off.
    """

    def __init__(self, default_tenant: str = DEFAULT_TENANT,
                 clock=None):
        self.default_tenant = default_tenant
        self._clock = clock if clock is not None else _now
        self._lock = threading.Lock()
        self._recs: Dict[int, _ReqUsage] = {}
        # per-phase conservation counters: float ms accumulated with
        # the histogram's exact values/order, counts, and the integer
        # ns actually partitioned across requests
        self._phase_ms: Dict[str, float] = {}
        self._phase_count: Dict[str, int] = {}
        self._phase_ns: Dict[str, int] = {}
        # defensive: ns charged with an empty target list (should not
        # happen; kept out of any tenant but inside the phase total)
        self._system_ns: Dict[str, int] = {}

    # ---------------- record access ----------------

    def _rec(self, req) -> _ReqUsage:
        rid = int(req.id)
        rec = self._recs.get(rid)
        if rec is None:
            tenant = getattr(req, "tenant", None)
            rec = _ReqUsage(rid, tenant if tenant is not None
                            else self.default_tenant, self._clock(),
                            adapter=getattr(req, "adapter_id", None))
            self._recs[rid] = rec
        return rec

    def record_of(self, rid: int) -> Optional[dict]:
        with self._lock:
            rec = self._recs.get(int(rid))
            return None if rec is None else rec.as_record()

    def records(self, include_open: bool = True,
                hop: Optional[int] = None) -> List[dict]:
        """Every record, rid-ordered. ``include_open=False`` keeps
        only terminally-closed records; ``hop`` stamps the producing
        replica index (the fold's dedup key)."""
        with self._lock:
            recs = [self._recs[r] for r in sorted(self._recs)]
            return [r.as_record(hop) for r in recs
                    if include_open or r.state is not None]

    # ---------------- device-time attribution ----------------

    def charge_phase(self, phase: str, ms: float, reqs) -> None:
        """Attribute one phase observation across ``reqs``.

        ``ms`` MUST be the same float the ``serve.step.<phase>_ms``
        histogram observes (same clock stamps, same expression) — the
        conservation invariant depends on it. The integer-ns split
        partitions ``round(ms * 1e6)`` exactly across the targets."""
        total_ns = round(float(ms) * 1e6)
        with self._lock:
            self._phase_ms[phase] = \
                self._phase_ms.get(phase, 0.0) + float(ms)
            self._phase_count[phase] = \
                self._phase_count.get(phase, 0) + 1
            self._phase_ns[phase] = \
                self._phase_ns.get(phase, 0) + total_ns
            n = len(reqs)
            if n == 0:
                self._system_ns[phase] = \
                    self._system_ns.get(phase, 0) + total_ns
                return
            q, r = divmod(total_ns, n)
            for i, req in enumerate(reqs):
                rec = self._rec(req)
                rec.phase_ns[phase] = rec.phase_ns.get(phase, 0) \
                    + q + (1 if i < r else 0)

    # ---------------- KV page-seconds ----------------

    def set_pages(self, req, n: int, now: Optional[float] = None) \
            -> None:
        """Mark ``req`` as holding ``n`` KV pages from now on,
        integrating ``pages held x elapsed clock`` since the previous
        transition. Called at every page-count change: prefix-share
        at admission (each sharer charged independently), prefill
        grow, decode grow, speculative truncate, preempt/requeue
        free, release, migration import, and crash detach."""
        t = self._clock() if now is None else now
        with self._lock:
            rec = self._rec(req)
            if rec.pages:
                rec.kv_page_s += rec.pages * (t - rec.pages_ts)
            rec.pages = int(n)
            rec.pages_ts = t

    # ---------------- counts ----------------

    def note_queue(self, req, seconds: float) -> None:
        with self._lock:
            self._rec(req).queue_s += float(seconds)

    def add_tokens(self, req, prefill: int = 0, decode: int = 0,
                   spec_accepted: int = 0, wasted: int = 0) -> None:
        with self._lock:
            rec = self._rec(req)
            rec.prefill_tokens += prefill
            rec.decode_tokens += decode
            rec.spec_accepted_tokens += spec_accepted
            rec.wasted_tokens += wasted

    def add_event(self, req, retry: int = 0, preempt: int = 0,
                  requeue: int = 0) -> None:
        with self._lock:
            rec = self._rec(req)
            rec.retries += retry
            rec.preemptions += preempt
            rec.requeues += requeue

    def credit_prefix(self, req, pages: int) -> None:
        with self._lock:
            self._rec(req).prefix_pages_saved += int(pages)

    # ---------------- terminal close ----------------

    def finish(self, req, state: str) -> Optional[dict]:
        """Close ``req``'s record with a terminal state, EXACTLY
        ONCE: a second close is a no-op returning None (the caller
        skips re-journaling). Returns a snapshot dict for the journal
        terminal event; charges from the very chunk that finished the
        request may still land after the close — exports read the
        final accumulated values, the snapshot is as-of-close."""
        t = self._clock()
        with self._lock:
            rec = self._rec(req)
            if rec.state is not None:
                return None
            if rec.pages:   # close the page-second integral
                rec.kv_page_s += rec.pages * (t - rec.pages_ts)
                rec.pages = 0
            rec.pages_ts = t
            rec.state = state
            return rec.as_record()

    # ---------------- conservation / views ----------------

    def attributed_ms(self) -> Dict[str, float]:
        """Per-phase float ms totals, accumulated with the exact
        values (and order) the ``serve.step.*_ms`` histograms saw."""
        with self._lock:
            return dict(self._phase_ms)

    def phase_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._phase_count)

    def phase_ns_totals(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._phase_ns)

    def system_ns_totals(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._system_ns)

    def tenant_totals(self) -> Dict[str, dict]:
        """Per-tenant rollup of every record (open + closed)."""
        return tenant_rollup(self.records(include_open=True))

    def top_tenants(self, k: int) -> List[Tuple[str, int]]:
        """Top-``k`` tenants by attributed device ns, descending."""
        with self._lock:
            by_t: Dict[str, int] = {}
            for rec in self._recs.values():
                by_t[rec.tenant] = by_t.get(rec.tenant, 0) \
                    + rec.device_ns
        return sorted(by_t.items(), key=lambda kv: (-kv[1], kv[0]))[
            :max(int(k), 0)]

    def tenant_count(self) -> int:
        with self._lock:
            return len({r.tenant for r in self._recs.values()})

    def max_share(self) -> float:
        """Largest single tenant's share of attributed device time
        (0.0 before any attribution)."""
        top = self.top_tenants(1)
        with self._lock:
            total = sum(r.device_ns for r in self._recs.values())
        if not top or total <= 0:
            return 0.0
        return top[0][1] / total

    def publish_gauges(self, top_k: int = 4) -> None:
        """Bounded tenant gauges for the Prometheus/timeseries path:
        ``tenant.{count,max_share}`` + index-keyed (NOT name-keyed —
        the cardinality bound) ``tenant.top<i>.device_ms``."""
        from ..profiler import stats as _stats

        with self._lock:
            closed = sum(r.state is not None
                         for r in self._recs.values())
        _stats.set_gauge("usage.records", closed)
        _stats.set_gauge("tenant.count", self.tenant_count())
        _stats.set_gauge("tenant.max_share",
                         round(self.max_share(), 4))
        for i, (_, ns) in enumerate(self.top_tenants(top_k)):
            _stats.set_gauge(f"tenant.top{i}.device_ms",
                             round(ns / 1e6, 3))

    def reset(self) -> None:
        """Forget everything (bench warmup boundary)."""
        with self._lock:
            self._recs.clear()
            self._phase_ms.clear()
            self._phase_count.clear()
            self._phase_ns.clear()
            self._system_ns.clear()

    # ---------------- exporters ----------------

    def dump_jsonl(self, path: str, hop: Optional[int] = None,
                   include_open: bool = True) -> str:
        """Append-only usage JSONL: one ``{"type": "usage", ...}``
        line per request (tools/serve_top.py --tenants offline input;
        tools/trace_merge.py folds multi-replica dumps)."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            for rec in self.records(include_open=include_open,
                                    hop=hop):
                f.write(json.dumps(rec) + "\n")
        return path


# ---------------- module-level fold / rollup helpers ----------------


def load_usage_jsonl(path: str) -> List[dict]:
    """Parse one usage JSONL artifact (``type=usage`` lines only)."""
    out: List[dict] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if d.get("type", "usage") == "usage":
                out.append(d)
    return out


def fold_records(records: Iterable[dict]) -> List[dict]:
    """Fold multi-replica usage records into ONE record per request.

    Dedup on ``(hop, rid)`` (the same replica dump merged twice
    contributes once), then sum per ``(tenant, rid)``: integer
    ``phase_ns`` / token / event counts add exactly, ``queue_s`` and
    ``kv_page_s`` add, and the terminal ``state`` resolves by
    ``_STATE_RANK`` precedence across hops — a failed-over or
    migrated request is charged exactly once fleet-wide."""
    seen = set()
    by_rid: Dict[Tuple[str, int], dict] = {}
    for rec in records:
        key = (rec.get("hop"), rec.get("rid"))
        if key[0] is not None and key in seen:
            continue
        seen.add(key)
        rk = (rec.get("tenant", DEFAULT_TENANT), int(rec["rid"]))
        out = by_rid.get(rk)
        if out is None:
            out = by_rid[rk] = {
                "type": "usage", "rid": rk[1], "tenant": rk[0],
                "state": None, "phase_ns": {}, "queue_s": 0.0,
                "kv_page_s": 0.0, "hops": 0}
            for f in COUNT_FIELDS:
                out[f] = 0
        out["hops"] += 1
        for ph, ns in (rec.get("phase_ns") or {}).items():
            out["phase_ns"][ph] = out["phase_ns"].get(ph, 0) + int(ns)
        out["queue_s"] += float(rec.get("queue_s", 0.0))
        out["kv_page_s"] += float(rec.get("kv_page_s", 0.0))
        for f in COUNT_FIELDS:
            out[f] += int(rec.get(f, 0))
        st = rec.get("state")
        if _STATE_RANK.get(st, 9) < _STATE_RANK.get(out["state"], 9):
            out["state"] = st
        if rec.get("adapter") is not None \
                and out.get("adapter") is None:
            # adapter id rides the fold — a failed-over adaptered
            # request keeps its stamp in the merged fleet view
            out["adapter"] = rec["adapter"]
    folded = [by_rid[k] for k in sorted(by_rid, key=lambda t: t[1])]
    for out in folded:
        out["device_ms"] = round(
            sum(out["phase_ns"].values()) / 1e6, 6)
        out["queue_s"] = round(out["queue_s"], 9)
        out["kv_page_s"] = round(out["kv_page_s"], 9)
    return folded


def tenant_rollup(records: Iterable[dict]) -> Dict[str, dict]:
    """Aggregate (possibly folded) usage records per tenant; the
    ``serve_top --tenants`` table rows. ``waste_share`` = wasted /
    (decode + wasted) tokens — the satellite's per-tenant waste
    surface."""
    by_t: Dict[str, dict] = {}
    for rec in records:
        t = rec.get("tenant", DEFAULT_TENANT)
        agg = by_t.get(t)
        if agg is None:
            agg = by_t[t] = {"tenant": t, "n_requests": 0,
                             "device_ms": 0.0, "device_ns": 0,
                             "queue_s": 0.0, "kv_page_s": 0.0,
                             "states": {}, "adapters": set()}
            for f in COUNT_FIELDS:
                agg[f] = 0
        agg["n_requests"] += 1
        if rec.get("adapter") is not None:
            agg["adapters"].add(rec["adapter"])
        agg["device_ns"] += sum(
            (rec.get("phase_ns") or {}).values())
        agg["queue_s"] += float(rec.get("queue_s", 0.0))
        agg["kv_page_s"] += float(rec.get("kv_page_s", 0.0))
        for f in COUNT_FIELDS:
            agg[f] += int(rec.get(f, 0))
        st = rec.get("state") or "open"
        agg["states"][st] = agg["states"].get(st, 0) + 1
    total_ns = sum(a["device_ns"] for a in by_t.values())
    for agg in by_t.values():
        agg["adapters"] = sorted(agg["adapters"])
        agg["device_ms"] = round(agg["device_ns"] / 1e6, 6)
        agg["share"] = (agg["device_ns"] / total_ns
                        if total_ns > 0 else 0.0)
        den = agg["decode_tokens"] + agg["wasted_tokens"]
        agg["waste_share"] = (agg["wasted_tokens"] / den
                              if den > 0 else 0.0)
    return by_t


def unattributed_ms(*ledgers) -> float:
    """Device time the ``serve.step`` work-phase histograms saw but
    no ledger attributed — an accounting leak; healthy runs report
    exactly ``0.0`` (gated UP with no noise floor by bench_gate).
    Reads the process stats registry, so pass every live ledger
    (fleet: one per replica + the router's)."""
    from ..profiler import stats as _stats

    _, _, hists = _stats.sample_values()
    leak = 0.0
    for phase in WORK_PHASES:
        h = hists.get(f"serve.step.{phase}_ms")
        total = float(h[1]) if h else 0.0
        attributed = sum(
            l.attributed_ms().get(phase, 0.0) for l in ledgers
            if l is not None)
        leak += max(0.0, total - attributed)
    return round(leak, 3)
