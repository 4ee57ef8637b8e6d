"""Serving request: the admission unit of the SLO-aware frontend.

Counterpart of ``paddle_tpu/serving/request.py``.

Extends the continuous-batching :class:`GenRequest` with what a real
service needs per request: an arrival timestamp (Poisson load, queue-
wait accounting), a priority (admission ordering), a streaming token
callback (tokens reach the caller as they decode, not at drain), the
SLO lifecycle marks (admitted / first token / done) the scheduler
stamps so TTFT/TPOT are measured per request, not per batch, and the
failure-semantics surface: an optional per-request
``deadline_ms``, a TERMINAL ``state``, and the ``error`` that ended a
request that didn't finish cleanly.

Every timestamp routes through the injectable serving clock
(``serving/faults.py``), so deadline/TTFT behavior is deterministic
under a ``ManualClock``.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..inference.engine import GenRequest
from . import faults as _faults

__all__ = ["Request"]


class Request(GenRequest):
    """One request through the serving frontend.

    ``priority``: higher admits first (FIFO within a priority level;
    the admission skip-ahead's starvation bound still applies).
    ``on_token(req, token)``: called on the scheduler thread for every
    generated token, including the first one emitted by the final
    prefill chunk — the streaming surface.
    ``arrival_time``: serving-clock time at construction unless the
    caller replays recorded traffic with its own timestamps.
    ``deadline_ms``: wall budget from ARRIVAL; once exceeded the
    scheduler aborts the request wherever it is (queue, prefill slot,
    decode slot), frees its pages, and surfaces
    :class:`~paddle_tpu_torch.serving.faults.DeadlineExceeded` only to this
    request (``state == "deadline_exceeded"``, ``error`` set).

    Terminal ``state`` values: ``"ok"`` (finished cleanly),
    ``"error"`` (step failure after retries, watchdog kill),
    ``"deadline_exceeded"``, ``"shed"`` (overload rejection at drain);
    None while in flight.
    """

    def __init__(self, prompt, max_new_tokens: int = 32,
                 eos_token_id=None, priority: int = 0,
                 on_token: Optional[Callable] = None,
                 arrival_time: Optional[float] = None,
                 deadline_ms: Optional[float] = None,
                 tenant: Optional[str] = None,
                 adapter_id: Optional[str] = None):
        super().__init__(prompt, max_new_tokens, eos_token_id)
        self.priority = int(priority)
        self.on_token = on_token
        # usage-metering identity: None bills to the
        # ledger's default tenant; stamped into journal events and
        # the per-request usage record
        self.tenant = tenant
        # batched multi-LoRA: name of the adapter this request
        # decodes through (None = base model). Adapters come with the
        # LoRA slice of the port; the scheduler refuses a request
        # that names one.
        self.adapter_id = adapter_id
        self._adapter_slot: Optional[int] = None
        self.arrival_time = _faults.now() if arrival_time is None \
            else float(arrival_time)
        self.deadline_ms = None if deadline_ms is None \
            else float(deadline_ms)
        # SLO lifecycle marks (serving-clock seconds), stamped by the
        # scheduler: admission, first emitted token, completion
        self.t_admitted: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_done: Optional[float] = None
        # pool-pressure lifecycle counts (scheduler-stamped) + the
        # SLO verdict (serving/slo.py, stamped at finish) — the
        # per-request JSONL serve_bench emits reads these directly
        self.n_preempts = 0
        self.n_requeues = 0
        self.slo_ok: Optional[bool] = None
        # failure semantics: terminal state + the error
        # that ended a request that didn't finish cleanly, and the
        # crash-isolation retry/watchdog bookkeeping
        self.state: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.n_retries = 0
        self._wd_mark = None          # (phase, progress) watchdog mark
        self._wd_steps = 0            # steps since the mark moved
        self._wd_trips = 0            # watchdog firings (2nd = fatal)

    # ---- derived SLO readings (None until the mark exists) ----

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.t_admitted is None:
            return None
        return self.t_admitted - self.arrival_time

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token, from ARRIVAL (queue wait included —
        the number the user experiences, not the scheduler's)."""
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival_time

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean time per output token after the first."""
        if self.t_done is None or self.t_first_token is None \
                or len(self.generated) < 2:
            return None
        return (self.t_done - self.t_first_token) \
            / (len(self.generated) - 1)

    # ---- failure semantics ----

    def past_deadline(self, now: Optional[float] = None) -> bool:
        """Has this request's deadline budget elapsed (False when no
        deadline is set)?"""
        if self.deadline_ms is None:
            return False
        if now is None:
            now = _faults.now()
        return (now - self.arrival_time) * 1e3 > self.deadline_ms
