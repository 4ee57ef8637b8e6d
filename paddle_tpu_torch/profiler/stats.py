"""Process-wide counters and gauges (the subset the engines write).

Counterpart of ``paddle_tpu/profiler/stats.py``: the engines bump
``inference.*`` and ``serving.*`` names through ``inc`` and
``set_gauge``; ``counter(name).value`` / ``gauge(name).value`` read
them and ``reset`` clears them.
Histograms, timers and exporters come with the profiler slice.
"""
from __future__ import annotations

import threading
from typing import Dict

__all__ = ["Counter", "Gauge", "counter", "gauge", "inc", "set_gauge",
           "reset"]

_LOCK = threading.Lock()
_COUNTERS: Dict[str, "Counter"] = {}
_GAUGES: Dict[str, "Gauge"] = {}


class Counter:
    """Monotonic event counter."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-written instantaneous value (pool pages in use, ...)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, v) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value


def counter(name: str) -> Counter:
    c = _COUNTERS.get(name)
    if c is None:
        with _LOCK:
            c = _COUNTERS.setdefault(name, Counter(name))
    return c


def gauge(name: str) -> Gauge:
    g = _GAUGES.get(name)
    if g is None:
        with _LOCK:
            g = _GAUGES.setdefault(name, Gauge(name))
    return g


def inc(name: str, n: int = 1) -> None:
    counter(name).inc(n)


def set_gauge(name: str, v) -> None:
    gauge(name).set(v)


def reset() -> None:
    """Zero every metric; registered objects stay valid."""
    with _LOCK:
        counters = list(_COUNTERS.values())
        gauges = list(_GAUGES.values())
    for c in counters:
        with c._lock:
            c._value = 0
    for g in gauges:
        g._value = 0.0
