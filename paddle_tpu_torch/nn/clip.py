"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``).

A clip object maps a list of ``(param, grad)`` pairs to a new one, as
the optimizer calls it after the regularizers and before the update
rule; a parameter whose ``need_clip`` is False, or a ``None`` gradient,
passes through. Norms are summed in f32 and the scale stays a 0-d
tensor on the gradients' device: clipping reads nothing back to the
host. A scaled gradient is computed in f32 and cast back to its own
dtype, as the JAX package's ``(g * scale).astype(g.dtype)`` promotes.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_", "clip_grad_value_"]


def _clipped(p) -> bool:
    return getattr(p, "need_clip", True)


def _norm_sq(g: torch.Tensor) -> torch.Tensor:
    return g.float().square().sum()


def _scaled(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.float() * scale).to(g.dtype)


def _scale_for(norm: torch.Tensor, clip_norm: float,
               floor: float) -> torch.Tensor:
    """``min(clip_norm / max(norm, floor), 1)`` as a device tensor."""
    return torch.clamp(clip_norm / torch.clamp(norm, min=floor), max=1.0)


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Each element into ``[min, max]`` (``min`` defaults to ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, g) if g is None or not _clipped(p)
                else (p, torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled to a 2-norm of at most ``clip_norm``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None or not _clipped(p):
                out.append((p, g))
                continue
            norm = torch.sqrt(_norm_sq(g))
            out.append((p, _scaled(g, _scale_for(norm, self.clip_norm,
                                                  1e-12))))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every clipped gradient scaled by one factor, so that their joint
    2-norm is at most ``clip_norm``."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def global_norm(self, grads) -> torch.Tensor:
        """The joint 2-norm of ``grads``, each squared and summed in f32,
        the sums added in order."""
        return torch.sqrt(sum(_norm_sq(g) for g in grads))

    def __call__(self, params_grads):
        clippable = [g for p, g in params_grads
                     if g is not None and _clipped(p)]
        if not clippable:
            return params_grads
        scale = _scale_for(self.global_norm(clippable), self.clip_norm,
                           1e-12)
        return [(p, g) if g is None or not _clipped(p)
                else (p, _scaled(g, scale)) for p, g in params_grads]


def _as_list(parameters):
    return [parameters] if torch.is_tensor(parameters) else list(parameters)


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale the ``.grad`` of ``parameters`` in place so that their joint
    ``norm_type``-norm is at most ``max_norm``; returns the norm before
    clipping (a device tensor)."""
    parameters = _as_list(parameters)
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.pow(sum(g.float().abs().pow(norm_type).sum()
                              for g in grads), 1.0 / norm_type)
    scale = _scale_for(total, max_norm, 1e-6)
    for g in grads:
        g.copy_(_scaled(g, scale))
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """Clamp the ``.grad`` of ``parameters`` into ``[-clip_value,
    clip_value]`` in place."""
    for p in _as_list(parameters):
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)
