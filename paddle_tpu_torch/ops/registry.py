"""The op inventory (counterpart of ``paddle_tpu/ops/registry.py``).

Every function of ``ops`` is registered here under the JAX package's
name, with the JAX package's ``methods=`` list: the tensor methods the
JAX package attaches, which the port reaches through the function of
the same name (``core/tensor.py``). ``register_op`` returns the function
wrapped so that each call bumps the ``op.<name>`` counter of
``profiler.stats`` (what ``op_call_counts`` reads) and, for an op the
JAX package dispatches through its eager path (``amp=True``), passes the
tensor operands (and lists of them) through the AMP hook under the op's
name, as that dispatch casts them (``amp/auto_cast.py``).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence

import torch

from ..amp.auto_cast import _STATE as _AMP, _amp_cast
from ..amp.debugging import _op_stats
from ..profiler import stats as _stats

__all__ = ["OpDef", "register_op", "get_op", "all_ops", "op_call_counts",
           "inplace_ops"]


class OpDef:
    __slots__ = ("name", "fn", "methods", "differentiable", "inplace_of",
                 "tags")

    def __init__(self, name: str, fn: Callable, methods: Sequence[str] = (),
                 differentiable: bool = True,
                 inplace_of: Optional[str] = None, tags: Sequence[str] = ()):
        self.name = name
        self.fn = fn
        self.methods = tuple(methods)
        self.differentiable = differentiable
        self.inplace_of = inplace_of
        self.tags = tuple(tags)


_REGISTRY: Dict[str, OpDef] = {}


def _cast(name, a):
    if torch.is_tensor(a):
        return _amp_cast(name, a)[0]
    if isinstance(a, (list, tuple)) and a and all(torch.is_tensor(t)
                                                  for t in a):
        return type(a)(_amp_cast(name, *a))
    return a


def register_op(name: str, fn: Callable, methods: Sequence[str] = (),
                differentiable: bool = True, inplace_of: Optional[str] = None,
                tags: Sequence[str] = (), amp: bool = False) -> Callable:
    """Register ``fn`` as op ``name``; returns it wrapped to count its
    calls (and, with ``amp``, to pass its operands through the AMP
    hook)."""
    counter = _stats.counter(f"op.{name}")

    @functools.wraps(fn)
    def op(*args, **kwargs):
        counter.inc()
        if amp and (_AMP.enabled or _op_stats["enabled"]):
            args = tuple(_cast(name, a) for a in args)
            kwargs = {k: _cast(name, v) for k, v in kwargs.items()}
        return fn(*args, **kwargs)

    _REGISTRY[name] = OpDef(name, op, methods, differentiable, inplace_of,
                            tags)
    return op


def get_op(name: str) -> OpDef:
    return _REGISTRY[name]


def all_ops() -> Dict[str, OpDef]:
    return dict(_REGISTRY)


def inplace_ops() -> Dict[str, OpDef]:
    """The registered in-place family (``inplace_of`` set)."""
    return {n: d for n, d in _REGISTRY.items() if d.inplace_of}


def op_call_counts(include_unused: bool = False) -> Dict[str, int]:
    """How many times each registered op was called in this process
    (the ``op.<name>`` counters); with ``include_unused`` the ops never
    called appear as 0."""
    counts = _stats.snapshot()["counters"]
    out = {}
    for name in _REGISTRY:
        n = counts.get(f"op.{name}", 0)
        if n or include_unused:
            out[name] = n
    return out
