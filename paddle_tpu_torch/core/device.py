"""Device resolution for the port's entry points.

Every entry point (``FusedCausalLM``, the engines through their model,
``BlockKVCacheManager``, ``bench.build_model`` and ``bench.run_config``,
and ``TrainStep`` through its model) runs on the CUDA card unless the
caller asks for the CPU with ``device="cpu"``. Without a card and without that
request it raises: nothing falls back to the CPU quietly.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda`` (raises when no card is visible); anything
    else is taken as the caller's explicit choice."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
