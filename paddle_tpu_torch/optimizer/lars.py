"""LARS, layer-wise adaptive rate scaling for large-batch SGD
(counterpart of ``paddle_tpu/optimizer/lars.py``)."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["Lars"]


class Lars(Optimizer):
    """Per-parameter trust ratio:

        local_lr = lr * lars_coeff * ||p|| /
                   (||g|| + lars_weight_decay * ||p|| + epsilon)
        v        = momentum * v + local_lr * (g + lars_weight_decay * p)
        p       -= v

    A parameter whose Paddle name (``p.param_name``) contains an entry of
    ``exclude_from_weight_decay`` skips both the decay term and the trust
    ratio: plain momentum SGD. Norms are taken in f32 and stay on the
    device.
    """

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005,
                 parameters=None, epsilon=0.0,
                 exclude_from_weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._lars_coeff = float(lars_coeff)
        self._lars_wd = float(lars_weight_decay)
        self._epsilon = float(epsilon)
        self._exclude = list(exclude_from_weight_decay or [])

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p.detach())}

    def _per_param_hyper(self, p):
        h = super()._per_param_hyper(p)
        name = getattr(p, "param_name", None) or ""
        h["lars_mask"] = 0.0 if any(s in name for s in self._exclude) \
            else 1.0
        return h

    def _rule(self, p, g, state, hyper):
        mask = hyper["lars_mask"]
        wd = self._lars_wd * mask
        local_lr = torch.full((), hyper["lr"], dtype=torch.float32,
                              device=p.device)
        if mask > 0:
            p_norm = torch.sqrt(torch.sum(torch.square(p.float())))
            g_norm = torch.sqrt(torch.sum(torch.square(g.float())))
            trust = self._lars_coeff * p_norm / (
                g_norm + wd * p_norm + self._epsilon)
            local_lr = local_lr * torch.where(
                (p_norm > 0) & (g_norm > 0), trust, torch.ones_like(trust))
        v = self._momentum * state["velocity"] + \
            local_lr.to(p.dtype) * (g + wd * p)
        return p - v, {"velocity": v}
