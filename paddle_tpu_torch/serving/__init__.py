"""paddle_tpu_torch.serving — SLO-aware request-serving frontend.

Counterpart of the JAX package's ``serving`` package: the layer between
user traffic and the continuous-batching engine. Async admission with
priorities and bounded skip-ahead, CHUNKED PREFILL interleaved with
decode (each chunk through the paged-prefill kernel of
``csrc/flash_varlen.cu`` on the card), prefix/KV-cache reuse across
requests sharing a system prompt, per-request TTFT/TPOT/queue-wait
telemetry, a request-lifecycle flight recorder (``journal.py``), an SLO
goodput monitor (``slo.py``), usage metering (``accounting.py``) and
the seeded fault-injection registry with the hardening that survives it
(``faults.py``: deadlines, crash-isolated retries, watchdog, overload
shedding), all on one injectable clock.

Batched multi-LoRA serving: an ``AdapterBank`` of ``LoRAAdapter``s
(``adapters.py``) passed as ``ServingEngine(adapters=...)``, one adapter
per request (``submit(adapter_id=...)``), each delta through the ragged
LoRA kernel of ``csrc/grouped_gemm.cu`` on the card.

The fleet router and the host-DRAM KV tier come with later slices of
the port.
"""
from __future__ import annotations

from .accounting import UsageLedger
from .adapters import TARGET_PROJECTIONS, AdapterBank, LoRAAdapter
from .faults import (Clock, DeadlineExceeded, FaultInjector, FaultSpec,
                     FleetOverloaded, InjectedFault, ManualClock,
                     PoolSizingError, ReplicaKilled, ServerOverloaded,
                     TenantQuotaExceeded, TokenCorruption,
                     WatchdogTimeout, set_clock, use_clock)
from .journal import FlightRecorder
from .prefix_cache import PrefixCache
from .request import Request
from .scheduler import ServingEngine, SLOConfig
from .slo import SLOMonitor

__all__ = ["AdapterBank", "LoRAAdapter", "TARGET_PROJECTIONS",
           "Request", "PrefixCache", "ServingEngine", "SLOConfig",
           "FlightRecorder", "SLOMonitor", "UsageLedger",
           "FaultInjector", "FaultSpec", "Clock", "ManualClock",
           "set_clock", "use_clock", "InjectedFault", "TokenCorruption",
           "DeadlineExceeded", "ServerOverloaded", "WatchdogTimeout",
           "PoolSizingError", "ReplicaKilled", "FleetOverloaded",
           "TenantQuotaExceeded"]
