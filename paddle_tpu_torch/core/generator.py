"""Seeded random generators, one ``torch.Generator`` per device.

Counterpart of ``paddle_tpu/core/generator.py`` (the reference's
per-device stateful ``Generator``, paddle/phi/core/generator.h). JAX
splits a functional key per draw; here each device has one stateful
``torch.Generator`` that ``seed()`` reseeds. The two packages draw
different numbers from the same seed, so parity tests make their
inputs with numpy and carry weights across with ``convert``.
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["seed", "default_generator"]

_SEED = 0
_GENERATORS: Dict[str, torch.Generator] = {}


def _key(device) -> str:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def default_generator(device="cpu") -> torch.Generator:
    """The default generator of ``device``, created on first use and
    seeded with the current global seed."""
    k = _key(device)
    g = _GENERATORS.get(k)
    if g is None:
        g = torch.Generator(device=k)
        g.manual_seed(_SEED)
        _GENERATORS[k] = g
    return g


def seed(value: int) -> None:
    """Mirror of ``paddle.seed``: reseed every device's default
    generator (generators made later start from ``value`` too)."""
    global _SEED
    _SEED = int(value)
    for g in _GENERATORS.values():
        g.manual_seed(_SEED)

