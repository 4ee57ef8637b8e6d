"""Process-wide runtime metrics registry: counters, gauges, histograms.

Counterpart of ``paddle_tpu/profiler/stats.py``: the engines and the
serving frontend write ``inference.*``, ``serving.*``, ``serve.*``,
``slo.*``, ``journal.*``, ``usage.*`` and ``tenant.*`` names through
``inc``, ``set_gauge`` and ``observe``; ``counter(name).value`` /
``gauge(name).value`` / ``histogram(name).summary()`` read them,
``snapshot()`` returns every metric as plain dicts (the crash-dump
artifact embeds it), and ``reset`` zeroes them.

- near-zero cost when disabled: every mutation checks one module-level
  bool before touching the metric (``disable()`` turns the whole
  registry into no-ops);
- thread-safe: each metric guards its state with one lock;
- histograms keep count/total/min/max, powers-of-2 buckets and a
  bounded, deterministically seeded reservoir of raw samples, so
  percentiles are exact up to ``RESERVOIR_SIZE`` observations.

The hit-rate helpers of the JAX package's eager tape have no tape here
to read and are not part of this module.
"""
from __future__ import annotations

import math
import os
import random
import threading
import time
from typing import Dict, Optional

__all__ = [
    "Counter", "Gauge", "Histogram", "counter", "gauge", "histogram",
    "inc", "set_gauge", "observe", "snapshot", "reset", "enable",
    "disable", "is_enabled", "timed", "sample_values",
]

_ENABLED = True
_REGISTRY_LOCK = threading.Lock()
_COUNTERS: Dict[str, "Counter"] = {}
_GAUGES: Dict[str, "Gauge"] = {}
_HISTOGRAMS: Dict[str, "Histogram"] = {}


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def is_enabled() -> bool:
    return _ENABLED


class Counter:
    """Monotonic event counter."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Last-written instantaneous value (pool pages in use, ...)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._value = float(v)

    def inc(self, n=1) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._value += n

    def dec(self, n=1) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0


class Histogram:
    """Streaming distribution summary: count/total/min/max, powers-of-2
    buckets, and a bounded RESERVOIR of raw samples (exact percentiles
    until the ``RESERVOIR_SIZE + 1``-th observation, then Vitter's
    Algorithm R with a per-instance seeded RNG, so every snapshot is
    deterministic for a given observation sequence)."""

    __slots__ = ("name", "count", "total", "min", "max", "_buckets",
                 "_samples", "_rng", "_lock")

    #: bucket upper bounds double from 1
    N_BUCKETS = 32
    #: reservoir capacity (0 falls back to the bucket estimator)
    RESERVOIR_SIZE = 4096

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._buckets = [0] * self.N_BUCKETS
        self._samples: list = []
        self._rng = random.Random(0x5EED)
        self._lock = threading.Lock()

    def observe(self, v) -> None:
        if not _ENABLED:
            return
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            b = 0
            edge = 1.0
            while v > edge and b < self.N_BUCKETS - 1:
                edge *= 2.0
                b += 1
            self._buckets[b] += 1
            if len(self._samples) < self.RESERVOIR_SIZE:
                self._samples.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self.RESERVOIR_SIZE:
                    self._samples[j] = v

    @property
    def avg(self) -> float:
        return self.total / self.count if self.count else 0.0

    @staticmethod
    def _quantile_sorted(s, q: float):
        """Empirical q-quantile of a sorted sample (the ceil(qN)-th
        order statistic — an OBSERVED value, never an interpolation)."""
        idx = min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))
        return round(s[idx], 3)

    def _bucket_percentile_locked(self, q: float):
        """Bucket-derived estimate (linear within the winning bucket,
        clamped to min/max), used only when the reservoir is off."""
        if not self.count:
            return None
        target = q * self.count
        cum = 0
        for b, n in enumerate(self._buckets):
            if not n:
                continue
            prev, cum = cum, cum + n
            if cum >= target:
                lo = 0.0 if b == 0 else 2.0 ** (b - 1)
                hi = 2.0 ** b
                est = lo + (hi - lo) * (target - prev) / n
                lo_clamp = self.min if self.min is not None else est
                hi_clamp = self.max if self.max is not None else est
                return round(min(max(est, lo_clamp), hi_clamp), 3)
        return self.max

    def _percentile_locked(self, q: float):
        if not self.count:
            return None
        if self._samples:
            return self._quantile_sorted(sorted(self._samples), q)
        return self._bucket_percentile_locked(q)

    def percentile(self, q: float):
        """q-quantile (q in [0, 1]); None before any observation."""
        with self._lock:
            return self._percentile_locked(q)

    def summary(self) -> dict:
        with self._lock:
            buckets = [[(1.0 if b == 0 else 2.0 ** b), n]
                       for b, n in enumerate(self._buckets) if n]
            if self._samples:
                s = sorted(self._samples)
                p50, p90, p99 = (self._quantile_sorted(s, q)
                                 for q in (0.50, 0.90, 0.99))
            else:
                p50, p90, p99 = (self._bucket_percentile_locked(q)
                                 for q in (0.50, 0.90, 0.99))
            return {
                "count": self.count,
                "total": round(self.total, 3),
                "avg": round(self.avg, 3),
                "min": self.min,
                "max": self.max,
                "p50": p50,
                "p90": p90,
                "p99": p99,
                "buckets": buckets,
            }

    def _reset(self) -> None:
        with self._lock:
            self.count = 0
            self.total = 0.0
            self.min = None
            self.max = None
            self._buckets = [0] * self.N_BUCKETS
            self._samples = []
            self._rng = random.Random(0x5EED)


def counter(name: str) -> Counter:
    c = _COUNTERS.get(name)
    if c is None:
        with _REGISTRY_LOCK:
            c = _COUNTERS.setdefault(name, Counter(name))
    return c


def gauge(name: str) -> Gauge:
    g = _GAUGES.get(name)
    if g is None:
        with _REGISTRY_LOCK:
            g = _GAUGES.setdefault(name, Gauge(name))
    return g


def histogram(name: str) -> Histogram:
    h = _HISTOGRAMS.get(name)
    if h is None:
        with _REGISTRY_LOCK:
            h = _HISTOGRAMS.setdefault(name, Histogram(name))
    return h


def inc(name: str, n: int = 1) -> None:
    if _ENABLED:
        counter(name).inc(n)


def set_gauge(name: str, v) -> None:
    if _ENABLED:
        gauge(name).set(v)


def observe(name: str, v) -> None:
    if _ENABLED:
        histogram(name).observe(v)


class timed:
    """Context manager observing its wall time (µs) into a histogram::

        with stats.timed("serve.some_us"):
            ...
    """

    __slots__ = ("_name", "_t0")

    def __init__(self, name: str):
        self._name = name
        self._t0 = None

    def __enter__(self):
        if _ENABLED:
            self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None and _ENABLED:
            observe(self._name,
                    (time.perf_counter_ns() - self._t0) / 1e3)
        return False


def process_rank() -> tuple:
    """(rank, world size) of this process: ``torch.distributed``'s when
    a process group is initialised, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank()), int(dist.get_world_size())
    return 0, 1


def _process_meta() -> dict:
    """Rank stamp for multi-process aggregation: which process produced
    this snapshot."""
    pi, pc = process_rank()
    return {"process_index": pi, "process_count": pc, "pid": os.getpid()}


def _registered():
    """Consistent copy of the registry's metric lists (taken under the
    registry lock, so a pass racing a registering writer never iterates
    a mutating dict)."""
    with _REGISTRY_LOCK:
        return (sorted(_COUNTERS.items()), sorted(_GAUGES.items()),
                sorted(_HISTOGRAMS.items()))


def snapshot(prefix: Optional[str] = None) -> dict:
    """JSON-able view of every metric (optionally name-prefixed):
    ``{"meta": {...}, "counters": {...}, "gauges": {...},
    "histograms": {...}}`` — ``meta`` stamps the producing rank."""
    def keep(name):
        return prefix is None or name.startswith(prefix)

    counters, gauges, hists = _registered()
    return {
        "meta": _process_meta(),
        "counters": {n: c.value for n, c in counters
                     if keep(n) and c.value},
        "gauges": {n: g.value for n, g in gauges if keep(n)},
        "histograms": {n: h.summary() for n, h in hists
                       if keep(n) and h.count},
    }


def sample_values(prefix: Optional[str] = None):
    """One lock-cheap pass: ``(counters, gauges, histograms)`` plain
    dicts, histograms as their ``(count, total)`` pair only."""
    def keep(name):
        return prefix is None or name.startswith(prefix)

    counters, gauges, hists = _registered()
    hv = {}
    for n, h in hists:
        if not keep(n):
            continue
        with h._lock:
            if h.count:
                hv[n] = (h.count, h.total)
    return ({n: c.value for n, c in counters if keep(n) and c.value},
            {n: g.value for n, g in gauges if keep(n)},
            hv)


def reset() -> None:
    """Zero every metric; registered objects stay valid."""
    counters, gauges, hists = _registered()
    for _, c in counters:
        c._reset()
    for _, g in gauges:
        g._reset()
    for _, h in hists:
        h._reset()
