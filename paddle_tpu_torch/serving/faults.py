"""Deterministic fault injection + the serving clock seam.

Counterpart of ``paddle_tpu/serving/faults.py``, the whole module: the
same sites, kinds, schedules and seeded RNG, so one plan fires the same
sequence in both packages.

A serving stack's recovery paths (eviction, stall/requeue, preemption,
retry, shed) are exactly the code that never runs in a green test
suite. This module makes them DRIVABLE: a seeded, scheduled fault
registry with named sites wired into the serving hot path, and the one
injectable monotonic clock every serving/SLO/journal timestamp routes
through, so deadline/backoff/watchdog behavior is tested by advancing
a number instead of sleeping.

Sites (each a named choke point; the owner calls ``fire()`` with its
per-site hit counter advancing once per call):

- ``kv.alloc`` / ``kv.grow`` — page-pool allocation and on-demand
  growth (``inference/kv_cache.py``);
- ``prefill.dispatch`` — one chunk-prefill program dispatch
  (``serving/scheduler.py``; ``corrupt`` specs poke the chunk's
  emitted token);
- ``decode.step`` — one continuous-batching decode chunk
  (``inference/engine.py``; ``corrupt`` specs poke the token matrix
  BEFORE any request state mutates, so detection → retry is clean);
- ``prefix.insert`` — prefix-cache registration
  (``serving/prefix_cache.py``; failures are absorbed, never fatal);
- ``journal.dump`` — crash-dump/journal export (``crash_dump`` must
  never let a failed dump mask the original exception);
- ``router.dispatch`` — one fleet-router dispatch attempt
  (``serving/router.py``; a raise counts against the chosen
  replica's circuit breaker and the router retries a healthy peer);
- ``replica.step`` — one fleet replica's scheduler step (the
  ``kill``/``hang`` kinds live here: a kill crashes the replica's
  serve loop, a hang wedges it long enough to miss heartbeats);
- ``replica.heartbeat`` — a replica's per-loop heartbeat stamp (a
  raise SUPPRESSES that beat, so the health checker's
  missed-beat → suspect → dead machine is drivable without killing
  the replica).

Fault kinds per scheduled hit:

- ``raise``   — raise :class:`InjectedFault` (or a caller-supplied
  exception instance) at the site;
- ``delay``   — sleep ``delay_ms`` through the injected clock (a
  ManualClock makes this a pure time-warp);
- ``corrupt`` — corrupt the site's value (token id) so the stack's
  DETECTION (token-range validation) fires, not a silent wrong
  answer;
- ``squeeze`` — seize ``pages`` free pool pages under a fault-owned
  key (deterministic pool exhaustion: the engine's REAL recovery
  paths — cold-prefix eviction, prefill stall/requeue,
  preemption-by-recompute — engage on the genuine free-list state);
- ``release`` — free every squeezed page;
- ``kill``    — raise :class:`ReplicaKilled` at the site (the fleet
  replica serve loop treats it as a process crash: the loop exits,
  heartbeats stop, and the router fails its requests over);
- ``hang``    — sleep ``delay_ms`` (default 30 s) through the
  injected clock: the replica wedges mid-step, misses beats, and the
  health checker walks it suspect → dead while it sleeps (a
  ManualClock makes the wedge a pure time-warp).

Scheduling is deterministic: ``at`` (hit index or indices), ``every``
(every k-th hit), ``times`` (max fires), and ``p`` (per-hit
probability from a privately seeded RNG — deterministic given the
seed, since the scheduler thread is the only caller). The injector
logs every fire in ``fired`` so a chaos bench can print the schedule
it actually executed.

Everything here is stdlib-only at import time (the journal's
standalone loaders must keep working), and the hot-path cost when no
injector is installed is a single attribute test per site — the
FLAGS_serve_journal discipline.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "Clock", "ManualClock", "now", "clock", "set_clock", "use_clock",
    "FaultSpec", "FaultInjector", "InjectedFault", "TokenCorruption",
    "DeadlineExceeded", "ServerOverloaded", "WatchdogTimeout",
    "PoolSizingError", "ReplicaKilled", "FleetOverloaded",
    "TenantQuotaExceeded",
]


# ---------------------------------------------------------------------
# typed serving errors (the failure-semantics vocabulary — see README)
# ---------------------------------------------------------------------

class InjectedFault(RuntimeError):
    """Raised by a scheduled ``raise`` fault at a named site."""

    def __init__(self, site: str, hit: int, message: str = ""):
        super().__init__(
            message or f"injected fault at {site!r} (hit {hit})")
        self.site = site
        self.hit = hit


class TokenCorruption(RuntimeError):
    """Detected out-of-range token out of a decode/prefill program —
    the corrupt-and-DETECT leg: the validator raises this instead of
    letting a poisoned token into a request's stream."""


class DeadlineExceeded(RuntimeError):
    """A request outlived its ``deadline_ms``; surfaced only to that
    request (``req.error``), never to the serve loop."""


class ServerOverloaded(RuntimeError):
    """Typed admission rejection: the inbox is at its bound, the queue
    is past ``FLAGS_serve_shed_queue_depth``, or the SLO burn rate is
    past ``FLAGS_serve_shed_burn_rate``. Raised to the SUBMITTING
    thread — backpressure, not a serve-loop failure."""


class WatchdogTimeout(RuntimeError):
    """A request made no token progress for ``FLAGS_serve_watchdog_steps``
    scheduler steps twice in a row (one preempt/requeue was already
    spent on it)."""


class PoolSizingError(RuntimeError):
    """Configuration error: a request's pages can NEVER fit the pool,
    even with the prefix cache drained and every peer evicted. Not
    retryable — propagates out of ``run()`` with sizing guidance."""


class ReplicaKilled(RuntimeError):
    """A fleet replica's serve loop died — raised by a scheduled
    ``kill`` fault at ``replica.step`` (the simulated process crash)
    or recorded by :meth:`FleetRouter.kill`. The router detects it,
    marks the replica dead, and FAILS OVER its in-flight requests to
    healthy peers (serving/router.py)."""

    def __init__(self, site: str = "replica.step", hit: int = -1,
                 message: str = ""):
        super().__init__(
            message or f"replica killed at {site!r} (hit {hit})")
        self.site = site
        self.hit = hit


class FleetOverloaded(ServerOverloaded):
    """Router-tier overload shedding: the fleet-wide dispatch queue
    (queued-not-yet-admitted requests across every replica) is past
    ``FLAGS_fleet_dispatch_queue``, or no replica is dispatchable
    (every one dead/draining or circuit-open). Raised to the
    SUBMITTING thread BEFORE any replica admits — a subclass of
    :class:`ServerOverloaded` so producers catch both the same way."""


class TenantQuotaExceeded(ServerOverloaded):
    """Router-tier per-tenant quota shedding: the tenant is past its
    ``FLAGS_tenant_quota_rps`` request rate or its
    ``FLAGS_tenant_quota_tokens`` rolling token budget (fed by the
    usage ledger). Raised to the SUBMITTING thread before any replica
    admits — one tenant's burst backpressures that tenant alone. A
    subclass of :class:`ServerOverloaded` so producers catch both the
    same way."""

    def __init__(self, tenant: str, kind: str = "rate",
                 message: str = ""):
        super().__init__(
            message or f"tenant {tenant!r} over its {kind} quota")
        self.tenant = tenant
        self.kind = kind


# ---------------------------------------------------------------------
# the clock seam
# ---------------------------------------------------------------------

class Clock:
    """Injectable monotonic clock: the single time source for serving
    lifecycle marks (arrival/admitted/first-token/done), journal
    timestamps, deadlines, and retry backoff sleeps."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class ManualClock(Clock):
    """Test clock: ``now()`` returns a number you advance; ``sleep``
    advances it (a backoff under ManualClock is a pure time-warp, so
    deadline/watchdog/backoff tests are deterministic and instant)."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._t

    def sleep(self, seconds: float) -> None:
        self.advance(seconds)

    def advance(self, seconds: float) -> float:
        with self._lock:
            self._t += max(float(seconds), 0.0)
            return self._t


_CLOCK: Clock = Clock()


def clock() -> Clock:
    """The installed serving clock."""
    return _CLOCK


def set_clock(c: Optional[Clock]) -> Clock:
    """Install a clock (None restores the real monotonic clock);
    returns the previously installed one."""
    global _CLOCK
    prev = _CLOCK
    _CLOCK = c if c is not None else Clock()
    return prev


class use_clock:
    """``with use_clock(ManualClock()) as clk: ...`` — scoped install."""

    def __init__(self, c: Clock):
        self._c = c
        self._prev: Optional[Clock] = None

    def __enter__(self) -> Clock:
        self._prev = set_clock(self._c)
        return self._c

    def __exit__(self, *exc) -> None:
        set_clock(self._prev)


def now() -> float:
    """``clock().now()`` — the timestamp every serving/SLO/journal
    mark routes through."""
    return _CLOCK.now()


# ---------------------------------------------------------------------
# fault registry
# ---------------------------------------------------------------------

#: the named-site vocabulary (sites outside it still work — the list
#: documents what the stack wires today)
FAULT_SITES = ("kv.alloc", "kv.grow", "prefill.dispatch",
               "decode.step", "prefix.insert", "journal.dump",
               "router.dispatch", "replica.step", "replica.heartbeat")

_KINDS = ("raise", "delay", "corrupt", "squeeze", "release", "kill",
          "hang")

#: a ``hang`` spec with no explicit delay_ms wedges this long — far
#: past any heartbeat budget, so the health checker always sees the
#: replica miss its beats (a ManualClock turns the wedge into a pure
#: time-warp)
DEFAULT_HANG_MS = 30_000.0


class FaultSpec:
    """One scheduled fault: WHERE (site), WHAT (kind), WHEN (at /
    every / p, capped by times)."""

    __slots__ = ("site", "kind", "at", "every", "times", "p",
                 "delay_ms", "exc", "pages", "value", "fires")

    def __init__(self, site: str, kind: str = "raise", at=None,
                 every: Optional[int] = None, times: int = 1,
                 p: Optional[float] = None, delay_ms: float = 0.0,
                 exc: Optional[BaseException] = None, pages: int = 0,
                 value: Optional[int] = None):
        if kind not in _KINDS:
            raise ValueError(
                f"fault kind {kind!r}: expected one of {_KINDS}")
        if at is None and every is None and p is None:
            at = 0  # default: the site's first hit
        self.site = site
        self.kind = kind
        self.at = ({int(at)} if isinstance(at, int)
                   else None if at is None else {int(x) for x in at})
        self.every = None if every is None else max(int(every), 1)
        self.times = int(times)
        self.p = p
        if kind == "hang" and not delay_ms:
            delay_ms = DEFAULT_HANG_MS
        self.delay_ms = float(delay_ms)
        self.exc = exc
        self.pages = int(pages)
        self.value = value
        self.fires = 0  # fires so far (capped by times)

    def scheduled(self, hit: int, rng: random.Random) -> bool:
        """Does this spec fire on the site's ``hit``-th invocation?
        The rng draw happens for every probed hit of a ``p`` spec, so
        the sequence is deterministic under a fixed seed."""
        if 0 <= self.times <= self.fires:
            return False
        due = False
        if self.at is not None and hit in self.at:
            due = True
        if self.every is not None and (hit + 1) % self.every == 0:
            due = True
        if self.p is not None and rng.random() < self.p:
            due = True
        return due

    def describe(self) -> dict:
        return {"site": self.site, "kind": self.kind,
                "at": sorted(self.at) if self.at else None,
                "every": self.every, "times": self.times, "p": self.p,
                "delay_ms": self.delay_ms, "pages": self.pages}


class FaultInjector:
    """Seeded, scheduled fault registry (see module docstring).

    Usage::

        inj = (FaultInjector(seed=0)
               .add("kv.grow", kind="raise", at=2)
               .add("decode.step", kind="corrupt", at=5)
               .add("decode.step", kind="squeeze", pages=6, at=3)
               .add("decode.step", kind="release", at=9))
        eng = ServingEngine(model, faults=inj)

    Sites call :meth:`fire` once per invocation (raise/delay/squeeze/
    release kinds execute there) and value-producing sites additionally
    route their value through :meth:`corrupt` / :meth:`corrupt_array`
    (corrupt kinds apply to the SAME hit ``fire`` just counted). The
    engine binds its page manager and journal at install so squeezes
    work the real free list and every fire lands on the flight
    recorder's timeline as a ``fault`` event.
    """

    #: out-of-range sentinel a ``corrupt`` spec pokes into a token
    #: stream when no explicit ``value`` is given — far outside any
    #: vocab so range validation always detects it
    CORRUPT_TOKEN = -(1 << 30)

    def __init__(self, specs=(), seed: int = 0):
        self._specs: List[FaultSpec] = []
        self._hits: Dict[str, int] = {}
        self._rng = random.Random(seed)
        self.seed = seed
        #: every executed fault action: {site, hit, kind, ...}
        self.fired: List[dict] = []
        self._mgr = None
        self._journal = None
        self._squeezed: List[Any] = []  # fault-owned page-list keys
        for s in specs:
            if isinstance(s, FaultSpec):
                self._specs.append(s)
            else:  # (site, kind, kwargs) tuples for declarative plans
                site, kind, kw = s
                self._specs.append(FaultSpec(site, kind, **kw))

    # -------------- plan construction --------------

    def add(self, site: str, kind: str = "raise", **kw) -> "FaultInjector":
        self._specs.append(FaultSpec(site, kind, **kw))
        return self

    def bind(self, mgr=None, journal=None) -> "FaultInjector":
        """Attach the live page manager (squeeze target) and flight
        recorder (fault events). The engine calls this at install."""
        if mgr is not None:
            self._mgr = mgr
        if journal is not None:
            self._journal = journal
        return self

    def plan(self) -> List[dict]:
        """The declared schedule (for bench output/logging)."""
        return [s.describe() for s in self._specs]

    def hits(self, site: str) -> int:
        """Invocations seen at ``site`` so far."""
        return self._hits.get(site, 0)

    @property
    def squeezed_pages(self) -> int:
        if self._mgr is None:
            return 0
        return sum(len(self._mgr._owned.get(k, ()))
                   for k in self._squeezed)

    # -------------- site entry points --------------

    def fire(self, site: str, rid: int = -1) -> None:
        """One site invocation: bump the hit counter and execute every
        scheduled raise/delay/squeeze/release spec. ``raise`` specs
        execute LAST so delays/squeezes on the same hit still land."""
        hit = self._hits.get(site, 0)
        self._hits[site] = hit + 1
        to_raise: Optional[BaseException] = None
        for spec in self._specs:
            if spec.site != site or spec.kind == "corrupt":
                continue
            if not spec.scheduled(hit, self._rng):
                continue
            spec.fires += 1
            self._log(site, hit, spec.kind, rid)
            if spec.kind in ("delay", "hang"):
                clock().sleep(spec.delay_ms / 1e3)
            elif spec.kind == "squeeze":
                self._squeeze(spec.pages)
            elif spec.kind == "release":
                self._release_squeezed()
            elif spec.kind == "kill":
                to_raise = spec.exc if spec.exc is not None \
                    else ReplicaKilled(site, hit)
            elif spec.kind == "raise":
                to_raise = spec.exc if spec.exc is not None \
                    else InjectedFault(site, hit)
        if to_raise is not None:
            raise to_raise

    def corrupt(self, site: str, value: int) -> int:
        """Route a site's produced value (token id) through any
        ``corrupt`` spec scheduled for the site's LAST counted hit."""
        hit = self._hits.get(site, 0) - 1
        if hit < 0:
            return value
        for spec in self._specs:
            if spec.site != site or spec.kind != "corrupt":
                continue
            if not spec.scheduled(hit, self._rng):
                continue
            spec.fires += 1
            self._log(site, hit, "corrupt", -1)
            value = self.CORRUPT_TOKEN if spec.value is None \
                else spec.value
        return value

    def corrupt_array(self, site: str, arr) -> None:
        """In-place corruption of a token matrix (decode chunk): poke
        cell [0, 0] — the validator scans the whole array, so where
        the poison lands is immaterial."""
        poked = self.corrupt(site, int(arr.flat[0]) if arr.size else 0)
        if arr.size and poked != int(arr.flat[0]):
            arr.flat[0] = poked

    def release_all(self) -> None:
        """Return every squeezed page to the pool (test teardown)."""
        self._release_squeezed(log=False)

    # -------------- internals --------------

    def _log(self, site: str, hit: int, kind: str, rid: int) -> None:
        entry = {"site": site, "hit": hit, "kind": kind}
        self.fired.append(entry)
        jr = self._journal
        if jr is not None:
            jr.record("fault", rid, -1, dict(entry))
        try:  # lazy + best-effort: the injector must work standalone
            from ..profiler import stats as _stats

            _stats.inc("serving.faults_injected")
        except ImportError:  # standalone import of this file
            pass

    def _squeeze(self, n_pages: int) -> None:
        """Deterministic pool exhaustion: seize up to n free pages
        under a fault-owned key, straight off the free list (never
        through ``allocate`` — the injector must not trip its own
        ``kv.alloc`` site)."""
        mgr = self._mgr
        if mgr is None:
            return
        take = min(int(n_pages), len(mgr._free))
        if take <= 0:
            return
        pages = [mgr._free.pop() for _ in range(take)]
        for p in pages:
            mgr._refs[p] = 1
        key = ("__fault__", len(self._squeezed))
        mgr._owned[key] = pages
        self._squeezed.append(key)

    def _release_squeezed(self, log: bool = True) -> None:
        mgr = self._mgr
        if mgr is None:
            return
        for key in self._squeezed:
            if key in mgr._owned:
                mgr.free(key)
        self._squeezed = []
