"""Common functionals (counterpart of
``paddle_tpu/nn/functional/common.py``): ``linear``, ``embedding`` and
``dropout``, the ones the training path calls."""
from __future__ import annotations

import torch

from ...core.generator import default_generator

__all__ = ["linear", "embedding", "dropout"]


def linear(x, weight, bias=None, name=None):
    """``x @ weight (+ bias)``; ``weight`` is ``[in, out]`` (Paddle's
    layout)."""
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` at the integer ids ``x``; rows at
    ``padding_idx`` come out zero."""
    out = torch.nn.functional.embedding(x.long(), weight)
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0.0)
    return out


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """Paddle's dropout: keep with probability ``1 - p`` (one mask over
    the ``axis`` dims when given, broadcast over the rest), scaled by
    ``1 / (1 - p)`` in ``upscale_in_train`` mode; ``downscale_in_infer``
    scales by ``1 - p`` at inference instead. ``generator`` draws the
    mask (default: the device's)."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    gen = generator if generator is not None else default_generator(x.device)
    keep = (torch.rand(shape, generator=gen, device=x.device)
            < 1.0 - p).to(x.dtype)
    if mode == "upscale_in_train":
        return x * keep / (1.0 - p)
    return x * keep
