"""Device resolution for the port's entry points.

Every entry point (``FusedCausalLM``, the engines through their model,
``BlockKVCacheManager``, ``bench.build_model`` and ``bench.run_config``,
``TrainStep`` through its model, ``to_tensor`` and the tensor-creating
ops) runs on the current place: the one ``set_device`` set
(``core/place.py``), else the CUDA card. Without a card, and without
``set_device("cpu")`` or ``device="cpu"``, it raises: nothing falls
back to the CPU quietly.
"""
from __future__ import annotations

import torch

from . import place as _place

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` → the current place: the one ``set_device`` set, else
    ``cuda`` (raises when no card is visible); a ``Place``, a string or
    a ``torch.device`` is taken as the caller's explicit choice."""
    if device is None:
        if _place._current_place is None:
            _place.current_place()          # raises without a card
            return torch.device("cuda")
        return _place._current_place.torch_device()
    if isinstance(device, _place.Place):
        return device.torch_device()
    return torch.device(device)
