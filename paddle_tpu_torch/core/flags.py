"""Flags registry (the subset the ported slices read).

A copy of ``paddle_tpu/core/flags.py``'s surface for the flags the
serving and training slices read: ``define_flag`` with a default and a doc,
``FLAGS_<name>`` (or ``PADDLE_TPU_<NAME>``) in the environment
overrides the default at definition, and ``set_flags`` / ``get_flags``
change and read values at run time. The names and default values match
the JAX package's, so one deployment setting selects the same decode
loop and the same serving policy in both.
"""
from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["define_flag", "set_flags", "get_flags", "flag", "env_var_for"]

_FLAGS: Dict[str, dict] = {}


def _coerce(value, proto):
    if isinstance(proto, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(proto, int):
        return int(value)
    if isinstance(proto, float):
        return float(value)
    return value


def env_var_for(name: str) -> str:
    """The deployment-convention env override for a flag name."""
    return "PADDLE_TPU_" + name.upper()


def define_flag(name: str, default: Any, doc: str = "") -> None:
    if name in _FLAGS:
        return
    env = os.environ.get(f"FLAGS_{name}")
    if env is None:
        env = os.environ.get(env_var_for(name))
    value = _coerce(env, default) if env is not None else default
    _FLAGS[name] = {"default": default, "value": value, "doc": doc}


def _key(name: str) -> str:
    key = name[len("FLAGS_"):] if name.startswith("FLAGS_") else name
    if key not in _FLAGS:
        raise ValueError(f"unknown flag {name!r}")
    return key


def set_flags(flags: Dict[str, Any]) -> None:
    for name, value in flags.items():
        key = _key(name)
        _FLAGS[key]["value"] = _coerce(value, _FLAGS[key]["default"])


def get_flags(flags) -> Dict[str, Any]:
    if isinstance(flags, str):
        flags = [flags]
    return {name: _FLAGS[_key(name)]["value"] for name in flags}


def flag(name: str):
    """Fast internal read."""
    return _FLAGS[name]["value"]


define_flag("decode_grouped", "auto",
            "grouped decode: the layer tail (O-proj + LN2 + FFN, "
            "nn/functional/stream_linear.py stream_layer_tail) as one "
            "call and the QKV projection carried between layers: auto "
            "| on (grouped) | off (the per-projection layer body)")
define_flag("decode_prefetch", True,
            "with grouped decode, compute layer l+1's LN1 + QKV "
            "projection inside layer l's tail call (one tail call per "
            "layer); off = a separate stream_linear QKV call per layer")
define_flag("decode_linear", "auto",
            "UNGROUPED decode matmul path (used when decode_grouped "
            "is off): auto (stream for int8 weights, plain products "
            "over the layer's weights for bf16/f32) | xla (plain "
            "products) | stream (the weight-streaming GEMM, "
            "nn/functional/stream_linear.py); A8W8 always streams")
define_flag("paged_attention_backend", "auto",
            "decode paged-attention backend "
            "(nn/functional/paged_attention.py): auto (decode_raw: the "
            "in-place append + attend kernel of csrc/paged_attention.cu "
            "at every head_dim; the public paged_attention: stream on "
            "the card when head_dim % 128 == 0 and a layer region is "
            "given, else fused; the plain gather on the CPU) | stream "
            "(the pool-streaming kernel of csrc/paged_backends.cu; "
            "decode_raw keeps the in-place kernel; head_dim % 128 == 0) "
            "| fused (the per-sequence paged kernel) | pallas (the "
            "stock-style paged kernel, compute blocks of pages) | xla "
            "(the plain gather: the CPU only; raises on the card). On "
            "the CPU every value runs its kernel's plain version")
define_flag("prefill_attention_backend", "auto",
            "chunked-prefill attention over the paged pool "
            "(nn/functional/flash_varlen.py paged_prefill_attention): "
            "auto | varlen (the block-table kernel of "
            "csrc/flash_varlen.cu on the card reading pages in place, "
            "its plain version on the CPU) | gather (the dense "
            "per-chunk gather of the pages, PyTorch ops on either "
            "device — also the forced path of the int8 KV pool)")
define_flag("attn_varlen_backend", "auto",
            "flash_attn_unpadded packed varlen flash-attention backend "
            "(nn/functional/flash_varlen.py): auto | pallas (the "
            "block-skipping kernels of csrc/flash_varlen_packed.cu on "
            "the card, their plain versions on the CPU) | interpret | "
            "xla (the plain tile walks: the CPU only; raise on the "
            "card) | dense (the O(T^2) masked-dense reference: the CPU "
            "only; raises on the card)")
define_flag("moe_grouped_backend", "auto",
            "no-drop MoE ragged grouped-GEMM backend "
            "(nn/functional/grouped_gemm.py): auto | pallas | interpret "
            "(the kernel of csrc/grouped_gemm.cu on the card, its plain "
            "version on the CPU) | xla (the plain walk: the CPU only; "
            "raises on the card)")
define_flag("lora_delta_backend", "auto",
            "batched multi-LoRA ragged delta-GEMM backend "
            "(nn/functional/lora.py lora_delta): auto | pallas | "
            "interpret (the kernel of csrc/grouped_gemm.cu on the card, "
            "its plain version on the CPU) | xla (the plain walk: the "
            "CPU only; raises on the card)")
define_flag("serve_journal", True,
            "request-lifecycle flight recorder for the serving "
            "frontend (serving/journal.py): every lifecycle "
            "transition (submit/queued/admitted/prefill_chunk/"
            "first_token/decode/preempt/requeue/stall/evict_trigger/"
            "finish/error) lands in a bounded in-memory ring, dumped "
            "as a JSONL artifact on any run() exception; off = the "
            "scheduler holds no recorder and every hook is a single "
            "attribute test (zero journal allocations)")
define_flag("serve_journal_events", 4096,
            "flight-recorder ring capacity in events; older events "
            "are overwritten once the ring wraps (the journal.dropped "
            "gauge counts them)")
define_flag("serve_journal_dir", "",
            "directory for serving crash-dump artifacts "
            "(serve_crash_rank<r>_pid<pid>.jsonl, written by "
            "ServingEngine.run() on any raise); empty = the system "
            "temp dir")
define_flag("serve_step_retries", 2,
            "crash-isolated stepping (serving/scheduler.py): retries "
            "granted to one request's prefill chunk / one decode "
            "chunk after an exception, each with capped exponential "
            "backoff, before the OFFENDING request alone errors out "
            "(state='error') while the serve loop keeps going")
define_flag("serve_retry_backoff_ms", 5.0,
            "base backoff between crash-isolated step retries; "
            "attempt k sleeps min(base * 2^(k-1), "
            "serve_retry_backoff_cap_ms) through the injectable "
            "serving clock (serving/faults.py — a ManualClock makes "
            "backoff a pure time-warp in tests)")
define_flag("serve_retry_backoff_cap_ms", 500.0,
            "cap on the exponential step-retry backoff")
define_flag("serve_watchdog_steps", 256,
            "progress watchdog: a request whose token progress "
            "(prefill position / generated count) hasn't moved for "
            "this many scheduler steps is preempted/requeued once, "
            "then failed on a second trip — the serve loop never "
            "hangs behind a wedged slot; 0 disables")
define_flag("serve_inbox_limit", 4096,
            "hard bound on the ServingEngine submit inbox; a full "
            "inbox rejects submit() with the typed ServerOverloaded "
            "(backpressure to the producer thread); 0 = unbounded")
define_flag("serve_shed_queue_depth", 0,
            "overload shedding: queue depth (inbox + waiting) at "
            "which admission rejects with ServerOverloaded and "
            "_drain_inbox sheds the sorted queue's overflow tail "
            "(lowest priority, newest first) into the 'shed' "
            "terminal state; 0 disables")
define_flag("serve_shed_burn_rate", 0.0,
            "overload shedding on service health: reject submits "
            "with ServerOverloaded while the rolling SLO burn-rate "
            "gauge (serving/slo.py) exceeds this; 0 disables")
define_flag("kv_host_tier_bytes", 0,
            "host-DRAM KV tier capacity per engine in bytes; the tier "
            "comes with the fleet slice of the port, so any value "
            "leaves it off here (eviction releases pages outright)")
define_flag("usage_ledger", False,
            "per-request -> per-tenant usage metering "
            "(serving/accounting.py UsageLedger): partitions every "
            "serve.step work phase across the requests it served and "
            "integrates KV page-seconds per request; off = the "
            "engine holds usage=None and every hook is one attribute "
            "test (zero per-step allocations)")
define_flag("usage_tenants_max", 64,
            "cardinality bound on per-tenant SLO goodput windows "
            "(serving/slo.py): tenants past this roll into the "
            "__other__ window instead of growing state unboundedly")
define_flag("serve_chunk_shrink", True,
            "graceful degradation under pool pressure: before a "
            "prefill chunk stalls/requeues for pages, shrink it "
            "(halving, page/bucket-aligned) until its tail pages fit "
            "the squeezed pool — tokens keep flowing at reduced "
            "chunk size instead of the request parking")
