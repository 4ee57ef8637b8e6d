"""Flags registry (the decode-path subset).

A copy of ``paddle_tpu/core/flags.py``'s surface for the two flags the
serving slice reads: ``define_flag`` with a default and a doc,
``FLAGS_<name>`` (or ``PADDLE_TPU_<NAME>``) in the environment
overrides the default at definition, and ``set_flags`` / ``get_flags``
change and read values at run time. The names and values match the
JAX package's, so one deployment setting selects the same decode loop
in both.
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
