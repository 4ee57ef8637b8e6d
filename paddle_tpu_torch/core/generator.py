"""Seeded random generators, one ``torch.Generator`` per device.

Counterpart of ``paddle_tpu/core/generator.py`` (the reference's
per-device stateful ``Generator``, paddle/phi/core/generator.h). JAX
splits a functional key per draw; here each device has one stateful
``torch.Generator`` that ``seed()`` reseeds. The two packages draw
different numbers from the same seed, so parity tests make their
inputs with numpy and carry weights across with ``convert``.

``get_rng_state`` returns the seed and every device generator's state;
``set_rng_state`` puts them back, so the draws made after it repeat.
``Generator`` is a seeded generator of one device that a caller owns.
The tensor-parallel RNG tracker of the JAX module (``RNGStatesTracker``,
``get_rng_tracker``, ``rng_state``) comes with the distributed training
slice (ROADMAP.md A10).
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["seed", "default_generator", "Generator", "get_rng_state",
           "set_rng_state"]

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



def get_rng_state() -> dict:
    """The global seed and a copy of the state of every device
    generator made so far."""
    return {"seed": _SEED,
            "states": {k: g.get_state() for k, g in _GENERATORS.items()}}


def set_rng_state(state: dict) -> None:
    """Put back what ``get_rng_state`` returned: the draws that follow
    repeat those that followed it."""
    global _SEED
    _SEED = int(state["seed"])
    for k, s in state["states"].items():
        default_generator(k).set_state(s)


class Generator:
    """A seeded generator of one device, owned by the caller (Paddle's
    ``Generator``): ``manual_seed``, ``initial_seed``, ``get_state`` and
    ``set_state``; ``generator`` is the ``torch.Generator`` a torch
    sampling call takes."""

    def __init__(self, seed: int = 0, device="cpu"):
        self.generator = torch.Generator(device=_key(device))
        self.manual_seed(seed)

    def manual_seed(self, seed: int) -> "Generator":
        self.generator.manual_seed(int(seed))
        return self

    def initial_seed(self) -> int:
        return self.generator.initial_seed()

    def get_state(self):
        return self.generator.get_state()

    def set_state(self, state) -> None:
        self.generator.set_state(state)
