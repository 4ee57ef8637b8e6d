"""Parameter initializers (counterpart of ``paddle_tpu/nn/initializer.py``):
the defaults that ``Linear``, ``Embedding`` and ``LayerNorm`` use.

Each draws in f32 from the device's ``torch.Generator``
(``core.generator.default_generator``) and casts to the requested
dtype: the JAX package's distributions, not its bits (parity tests carry
weights across with ``convert.load_jax_params``).
"""
from __future__ import annotations

import math

import torch

from ..core.generator import default_generator

__all__ = ["Initializer", "Constant", "Normal", "XavierNormal",
           "to_dtype"]


def to_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or a Paddle dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).replace("paddle.", "")
    aliases = {"bf16": "bfloat16", "fp32": "float32", "fp16": "float16"}
    return getattr(torch, aliases.get(name, name))


def _fan_in_out(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        # a Linear weight is stored [in, out] (Paddle's layout)
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


class Initializer:
    """``init(shape, dtype, device)`` → a new tensor."""

    def __call__(self, shape, dtype="float32", device="cpu"):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, dtype="float32", device="cpu"):
        return torch.full(tuple(shape), self.value, dtype=to_dtype(dtype),
                          device=device)


def _normal_f32(shape, device):
    return torch.randn(tuple(shape), generator=default_generator(device),
                       device=device, dtype=torch.float32)


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype="float32", device="cpu"):
        return (_normal_f32(shape, device) * self.std + self.mean) \
            .to(to_dtype(dtype))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype="float32", device="cpu"):
        fi, fo = _fan_in_out(tuple(int(s) for s in shape))
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return (_normal_f32(shape, device) * std).to(to_dtype(dtype))
