"""Regularizers (counterpart of ``paddle_tpu/regularizer.py``): L1 and
L2 weight decay added to a parameter's gradient at optimizer time,
``grad + coeff * sign(param)`` and ``grad + coeff * param``, in the
gradient's dtype."""
from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay", "WeightDecayRegularizer"]


class WeightDecayRegularizer:
    def __call__(self, param: torch.Tensor,
                 grad: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class L1Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, param, grad):
        return grad + self.coeff * torch.sign(param)


class L2Decay(WeightDecayRegularizer):
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __call__(self, param, grad):
        return grad + self.coeff * param
