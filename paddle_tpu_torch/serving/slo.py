"""SLO goodput monitor: per-request verdicts + rolling service health.

Counterpart of ``paddle_tpu/serving/slo.py``.

Consumes the request-lifecycle stream online (the scheduler feeds it
each finished request as its ``finish`` journal event is recorded) and
turns the raw TTFT/TPOT readings into service-level accounting:

- **per-request verdict**: TTFT and TPOT each judged against the
  ``SLOConfig`` targets (``ttft_target_ms`` / ``tpot_target_ms``); a
  request with no TPOT reading (single-token generations) passes that
  leg vacuously. The verdict is stamped back onto the request
  (``req.slo_ok``) and into the journal's ``finish`` event, so offline
  tools never re-derive it.
- **rolling goodput** (``slo.goodput`` gauge): fraction of the last
  ``slo_window`` finished requests meeting BOTH targets — the number
  the serve bench reports as ``serve_goodput`` and
  ``tools/bench_gate.py`` gates (direction "down").
- **burn rate** (``slo.burn_rate`` gauge): SRE-style error-budget
  burn over the same window — ``(1 - goodput) / (1 - objective)``;
  1.0 means the miss rate exactly consumes the budget implied by
  ``goodput_objective``, >1 means the budget is burning down.
- **load gauges**: ``slo.queue_depth`` (inbox + waiting) and
  ``slo.slot_occupancy`` ((decoding + prefilling) / max_batch),
  refreshed by the scheduler every step — the live dashboard's
  (``tools/serve_top.py``) pressure row.

Counters: ``slo.{finished,ok,ttft_miss,tpot_miss,errors}`` (errors =
requests that ended in a failure terminal state — deadline, shed,
step error — each rolled into the goodput window as a miss).
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Optional

from ..profiler import stats as _stats

__all__ = ["SLOMonitor"]


class SLOMonitor:
    """Online TTFT/TPOT verdicts + rolling goodput/burn-rate gauges."""

    def __init__(self, ttft_target_ms: Optional[float] = 1000.0,
                 tpot_target_ms: Optional[float] = 100.0,
                 objective: float = 0.99, window: int = 256,
                 tenant_windows_max: Optional[int] = None):
        self.ttft_target_ms = ttft_target_ms
        self.tpot_target_ms = tpot_target_ms
        if not 0.0 < float(objective) < 1.0:
            raise ValueError("goodput objective must be in (0, 1)")
        self.objective = float(objective)
        self._window: deque = deque(maxlen=max(int(window), 1))
        # per-tenant rolling windows: created lazily on
        # the first finish carrying a non-None req.tenant, bounded by
        # tenant_windows_max (overflow tenants share "__other__") —
        # the no-tenant default path never allocates any of this
        if tenant_windows_max is None:
            from ..core.flags import flag as _flag
            tenant_windows_max = int(_flag("usage_tenants_max"))
        self.tenant_windows_max = max(int(tenant_windows_max), 1)
        self._tenant_windows: dict = {}
        self._lock = threading.Lock()

    # ---------------- verdicts ----------------

    def verdict(self, ttft_ms: Optional[float],
                tpot_ms: Optional[float]):
        """(ttft_ok, tpot_ok) against the targets; a missing reading
        or a disabled (None) target passes that leg vacuously."""
        ttft_ok = (ttft_ms is None or self.ttft_target_ms is None
                   or ttft_ms <= self.ttft_target_ms)
        tpot_ok = (tpot_ms is None or self.tpot_target_ms is None
                   or tpot_ms <= self.tpot_target_ms)
        return ttft_ok, tpot_ok

    def observe_finish(self, req) -> dict:
        """Judge one finished request, roll the goodput window, and
        publish the ``slo.*`` metrics. Stamps ``req.slo_ok`` and
        returns the verdict dict the journal's finish event records."""
        ttft = getattr(req, "ttft_s", None)
        tpot = getattr(req, "tpot_s", None)
        ttft_ms = None if ttft is None else ttft * 1e3
        tpot_ms = None if tpot is None else tpot * 1e3
        ttft_ok, tpot_ok = self.verdict(ttft_ms, tpot_ms)
        ok = ttft_ok and tpot_ok
        with self._lock:
            self._window.append(ok)
            good = sum(self._window) / len(self._window)
            self._roll_tenant(req, ok)
        _stats.inc("slo.finished")
        if ok:
            _stats.inc("slo.ok")
        if not ttft_ok:
            _stats.inc("slo.ttft_miss")
        if not tpot_ok:
            _stats.inc("slo.tpot_miss")
        _stats.set_gauge("slo.goodput", round(good, 4))
        _stats.set_gauge("slo.burn_rate", round(self._burn(good), 3))
        req.slo_ok = ok
        return {"ttft_ms": None if ttft_ms is None
                else round(ttft_ms, 3),
                "tpot_ms": None if tpot_ms is None
                else round(tpot_ms, 3),
                "ttft_ok": ttft_ok, "tpot_ok": tpot_ok, "slo_ok": ok}

    def observe_error(self, req) -> None:
        """Roll a FAILED request (deadline/shed/step error)
        into the goodput window as a miss: a request the service
        dropped is by definition not good throughput, whatever its
        latencies were before it died. Stamps ``req.slo_ok = False``
        and publishes the same rolling gauges as a finish."""
        with self._lock:
            self._window.append(False)
            good = sum(self._window) / len(self._window)
            self._roll_tenant(req, False)
        _stats.inc("slo.finished")
        _stats.inc("slo.errors")
        _stats.set_gauge("slo.goodput", round(good, 4))
        _stats.set_gauge("slo.burn_rate", round(self._burn(good), 3))
        req.slo_ok = False

    # ---------------- per-tenant windows ----------------

    def _roll_tenant(self, req, ok: bool) -> None:
        """Roll the verdict into the request's tenant window (lock
        held by the caller). Requests without a tenant cost exactly
        one attribute read; past ``tenant_windows_max`` tenants the
        overflow shares one ``__other__`` window — the cardinality
        bound. Publishes the worst tenant's rolling goodput as the
        ``tenant.min_goodput`` gauge (the fairness dashboard row)."""
        t = getattr(req, "tenant", None)
        if t is None:
            return
        w = self._tenant_windows.get(t)
        if w is None:
            if len(self._tenant_windows) >= self.tenant_windows_max:
                t = "__other__"
                w = self._tenant_windows.get(t)
            if w is None:
                w = self._tenant_windows[t] = deque(
                    maxlen=self._window.maxlen)
        w.append(ok)
        worst = min(sum(win) / len(win)
                    for win in self._tenant_windows.values() if win)
        _stats.set_gauge("tenant.min_goodput", round(worst, 4))

    def tenant_goodputs(self) -> dict:
        """Rolling goodput per tenant window (only tenants that have
        finished at least one request appear)."""
        with self._lock:
            return {t: sum(w) / len(w)
                    for t, w in self._tenant_windows.items() if w}

    def tenant_burn_rates(self) -> dict:
        return {t: self._burn(g)
                for t, g in self.tenant_goodputs().items()}

    @property
    def tenant_min_goodput(self):
        """Worst tenant's rolling goodput (None before any tenant-
        stamped finish)."""
        g = self.tenant_goodputs()
        return min(g.values()) if g else None

    # ---------------- rolling views ----------------

    def _burn(self, goodput: float) -> float:
        return (1.0 - goodput) / max(1.0 - self.objective, 1e-9)

    @property
    def goodput(self) -> Optional[float]:
        """Rolling fraction of finished requests meeting both targets
        (None before any finish)."""
        with self._lock:
            if not self._window:
                return None
            return sum(self._window) / len(self._window)

    @property
    def burn_rate(self) -> Optional[float]:
        g = self.goodput
        return None if g is None else self._burn(g)

    def update_gauges(self, queue_depth: int, active: int,
                      prefilling: int, slots: int) -> None:
        """Refresh the load gauges (scheduler, once per step)."""
        _stats.set_gauge("slo.queue_depth", queue_depth)
        _stats.set_gauge("slo.slot_occupancy",
                         (active + prefilling) / max(slots, 1))

    def reset(self) -> None:
        """Forget the rolling windows (bench warmup boundary)."""
        with self._lock:
            self._window.clear()
            self._tenant_windows.clear()
