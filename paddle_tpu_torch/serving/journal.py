"""Request-lifecycle flight recorder: bounded ring journal + exporters.

Counterpart of ``paddle_tpu/serving/journal.py``. The serving
frontend's aggregate counters/histograms can tell you that p99 TTFT
regressed; they cannot reconstruct WHY request 17 stalled — it was
preempted twice, re-queued behind a burst, and its resume prefill
evicted half the prefix cache. The
flight recorder closes that gap: every lifecycle transition ::

    submit -> queued -> admitted[prefix_pages=k]
           -> prefill_chunk[c,pos]* -> first_token -> decode
           -> {preempt | requeue | stall | evict_trigger}*
           -> finish | error

lands in a bounded in-memory ring as ``(seq, monotonic_ts, event,
request_id, slot, extra)``, written from the scheduler hooks in
``serving/scheduler.py``, ``inference/engine.py`` and
``serving/prefix_cache.py``.

Design constraints:

- **lock-cheap**: ``record`` is one ``itertools.count`` bump (atomic
  under CPython — the GenRequest id-allocation idiom) plus one list
  setitem; no lock is ever taken on the scheduler hot path, and any
  submit-thread race costs at worst one overwritten ring slot.
- **bounded**: the ring holds ``capacity`` events; older events are
  overwritten (``dropped`` counts them) so a week-long serve never
  grows the journal.
- **near-zero when disabled**: the engine holds ``journal = None``
  when ``FLAGS_serve_journal`` is off, so every hook is a single
  attribute test — no event tuples, no extra dicts, nothing.

Exporters: ``dump_jsonl``/``load_jsonl`` (the crash-dump artifact
format, ``tools/serve_top.py``'s offline input) and ``chrome_trace``
— one lane per request with ``pid = process_index``, so
``tools/trace_merge.py`` folds multi-rank serves into one timeline.

This module is deliberately stdlib-only at import time so offline
tools can load it standalone for post-mortems without importing
torch.
"""
from __future__ import annotations

import itertools
import json
import os
import time
from typing import List, Optional

try:  # the serving clock seam (serving/faults.py): journal timestamps
    # follow the same injectable monotonic clock as every lifecycle
    # mark, so ManualClock tests see consistent timelines. The
    # fallback keeps this module loadable STANDALONE (tools/serve_top
    # imports it by file path, outside the package).
    from .faults import now as _now
except ImportError:  # standalone load — real monotonic clock
    _now = time.monotonic

__all__ = ["FlightRecorder", "LIFECYCLE_EVENTS", "chrome_trace",
           "load_jsonl"]

#: the journal's event vocabulary, in canonical lifecycle order — the
#: JAX package's, so journals of both packages read alike. Besides the
#: lifecycle: ``fault`` = an injected-fault fire, ``retry`` = a
#: crash-isolated step backoff, ``watchdog`` = a no-progress trip, the
#: terminal ``deadline_exceeded`` / ``shed``; ``spec_verify`` (one
#: speculative draft+verify round, ``k``/``accepted``/``dur_ms``
#: extras, rendered as a span); the fleet-tier ``failover`` /
#: ``migrate`` / ``handoff`` / ``spill`` / ``restore`` / ``drain``; and
#: ``alert`` (a telemetry alert-rule transition, rid/slot = -1). The
#: fleet and alert events come with later slices of the port; the
#: exporters already render them.
LIFECYCLE_EVENTS = (
    "submit", "queued", "admitted", "prefill_chunk", "first_token",
    "decode", "spec_verify", "preempt", "requeue", "stall",
    "evict_trigger", "fault", "retry", "watchdog",
    "failover", "migrate", "handoff", "spill", "restore",
    "drain", "alert",
    "finish", "error", "deadline_exceeded", "shed",
)


class FlightRecorder:
    """Bounded ring-buffer journal of request-lifecycle events."""

    __slots__ = ("capacity", "_ring", "_ctr")

    def __init__(self, capacity: int = 4096):
        self.capacity = max(int(capacity), 1)
        self._ring: list = [None] * self.capacity
        self._ctr = itertools.count()

    # ---------------- recording (hot path) ----------------

    def record(self, ev: str, rid: int = -1, slot: int = -1,
               extra: Optional[dict] = None) -> None:
        """Append one event. ``rid=-1`` marks engine-level events
        (pool eviction, crash); ``extra`` is a small dict of fields
        (page counts, chunk position, ttft) or None."""
        i = next(self._ctr)
        self._ring[i % self.capacity] = (
            i, _now(), ev, rid, slot, extra)

    # ---------------- reading ----------------

    @property
    def recorded(self) -> int:
        """Events ever recorded (including overwritten ones)."""
        seqs = [e[0] for e in self._ring if e is not None]
        return (max(seqs) + 1) if seqs else 0

    @property
    def dropped(self) -> int:
        """Events overwritten by ring wrap-around."""
        return max(0, self.recorded - self.capacity)

    def events(self, rid: Optional[int] = None) -> List[dict]:
        """Surviving events in recording order, as flat dicts
        (``seq``/``ts``/``ev``/``rid``/``slot`` + any extra fields),
        optionally filtered to one request's lane."""
        out = []
        for entry in sorted(e for e in self._ring if e is not None):
            seq, ts, ev, r, slot, extra = entry
            if rid is not None and r != rid:
                continue
            d = {"seq": seq, "ts": round(ts, 6), "ev": ev, "rid": r,
                 "slot": slot}
            if extra:
                d.update(extra)
            out.append(d)
        return out

    def tail(self, n: int) -> List[dict]:
        """The last ``n`` surviving events (crash-dump view)."""
        return self.events()[-max(int(n), 0):]

    def clear(self) -> None:
        """Drop every event and restart the sequence (bench warmup)."""
        self._ring = [None] * self.capacity
        self._ctr = itertools.count()

    # ---------------- exporters ----------------

    def dump_jsonl(self, path: str) -> str:
        """Write the surviving events as ``{"type": "event", ...}``
        JSONL lines (the ``tools/serve_top.py`` offline format). The
        target directory is created if missing — a journal dump is
        usually the LAST thing a dying serve does, and must not fail
        on a fresh artifact directory."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            for d in self.events():
                f.write(json.dumps({"type": "event", **d}) + "\n")
        return path

    def publish_gauges(self) -> None:
        """Publish ``journal.{events,dropped}`` gauges to the stats
        registry (called at run()/bench exit, not per event — the
        ring itself never touches a metric lock)."""
        from ..profiler import stats as _stats

        _stats.set_gauge("journal.events", self.recorded)
        _stats.set_gauge("journal.dropped", self.dropped)


def load_jsonl(path: str):
    """Parse a journal / crash-dump JSONL artifact.

    Returns ``(events, extras)``: the ``type=event`` lines in sequence
    order, and every other line (``stats`` snapshot, ``crash`` header)
    keyed by its type."""
    events: List[dict] = []
    extras: dict = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            t = d.pop("type", "event")
            if t == "event":
                events.append(d)
            else:
                extras[t] = d
    events.sort(key=lambda d: d.get("seq", 0))
    return events, extras


#: lifecycle transitions that OPEN a phase span on a request's lane
#: (``failover`` re-queues the request on the surviving replica's
#: lane; ``migrate``/``handoff`` land it straight in decode — no
#: prefill replay. ``spill``/``restore`` are engine-level rid=-1
#: instants: host-tier page traffic, not a request phase)
_PHASE_OF = {"submit": "queued", "queued": "queued",
             "admitted": "prefill", "decode": "decode",
             "failover": "queued", "migrate": "decode",
             "handoff": "decode"}
#: transitions that CLOSE whatever phase is open
_CLOSERS = ("preempt", "requeue", "finish", "error",
            "deadline_exceeded", "shed")


def chrome_trace(events: List[dict], process_index: int = 0) -> dict:
    """Chrome-trace view of a journal: ONE LANE PER REQUEST.

    ``pid = process_index`` (the producing rank) and ``metadata``
    carries the same stamp, so ``tools/trace_merge.py`` folds
    multi-rank serve journals into one fleet timeline exactly like
    profiler traces. Each request renders as ``tid = rid + 1`` (lane
    0 is the engine: pool evictions, crash events) with:

    - ``"X"`` phase spans — ``queued`` / ``prefill`` / ``decode`` —
      delimited by the lifecycle transitions (a preempted request
      shows decode → queued → prefill → decode across its lane);
    - ``"i"`` instant marks for every journal event, carrying its
      extra fields (chunk position, prefix pages, ttft) as args.
    """
    pid = int(process_index)
    out: List[dict] = [
        {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": f"rank {pid} serve"}},
        {"name": "process_sort_index", "ph": "M", "pid": pid, "tid": 0,
         "args": {"sort_index": pid}},
        {"name": "thread_name", "ph": "M", "pid": pid, "tid": 0,
         "args": {"name": "engine"}},
    ]
    by_rid: dict = {}
    for e in events:
        by_rid.setdefault(int(e.get("rid", -1)), []).append(e)
    for rid in sorted(by_rid):
        evs = sorted(by_rid[rid], key=lambda d: d.get("seq", 0))
        tid = rid + 1 if rid >= 0 else 0
        if rid >= 0:
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"name": f"req {rid}"}})
            out.append({"name": "thread_sort_index", "ph": "M",
                        "pid": pid, "tid": tid,
                        "args": {"sort_index": tid}})
        open_name = None
        t0 = 0.0
        last_ts = None
        for e in evs:
            ts = float(e["ts"]) * 1e6  # chrome trace wants µs
            last_ts = ts
            ev = e["ev"]
            phase = _PHASE_OF.get(ev)
            if rid >= 0 and phase is not None:
                if open_name != phase:
                    if open_name is not None:
                        out.append({"name": open_name, "ph": "X",
                                    "pid": pid, "tid": tid, "ts": t0,
                                    "dur": max(ts - t0, 0.0),
                                    "cat": "serve",
                                    "args": {"rid": rid}})
                    open_name, t0 = phase, ts
            elif rid >= 0 and ev in _CLOSERS and open_name is not None:
                out.append({"name": open_name, "ph": "X", "pid": pid,
                            "tid": tid, "ts": t0,
                            "dur": max(ts - t0, 0.0), "cat": "serve",
                            "args": {"rid": rid}})
                open_name = None
            args = {k: v for k, v in e.items()
                    if k not in ("seq", "ts", "ev", "rid", "slot")}
            args["rid"] = rid
            if ev == "spec_verify" and "dur_ms" in args:
                # the verify round is journaled at COMPLETION with its
                # wall time — render a proper duration span ending at
                # ts instead of an instant mark
                dur = max(float(args["dur_ms"]) * 1e3, 0.0)
                out.append({"name": "spec_verify", "ph": "X",
                            "pid": pid, "tid": tid, "ts": ts - dur,
                            "dur": dur, "cat": "serve", "args": args})
                continue
            out.append({"name": ev, "ph": "i", "pid": pid, "tid": tid,
                        "ts": ts, "s": "t", "cat": "serve",
                        "args": args})
        if open_name is not None and last_ts is not None:
            # phase still open at journal end (live dump mid-serve)
            out.append({"name": open_name, "ph": "X", "pid": pid,
                        "tid": tid, "ts": t0,
                        "dur": max(last_ts - t0, 0.0), "cat": "serve",
                        "args": {"rid": rid}})
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "metadata": {"process_index": pid,
                         "source": "paddle_tpu_torch.serving.journal"}}
