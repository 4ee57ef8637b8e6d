"""Parameter initializers (counterpart of ``paddle_tpu/nn/initializer.py``):
the defaults that ``Linear``, ``Embedding``, ``LayerNorm``, the
convolution layers (Kaiming-uniform weights, uniform biases) and the MoE
gate and expert bank use.

Each draws in f32 from the device's ``torch.Generator``
(``core.generator.default_generator``) and casts to the requested
dtype: the JAX package's distributions, not its bits (parity tests carry
weights across with ``convert.load_jax_params``).
"""
from __future__ import annotations

import math

import torch

from ..core.generator import default_generator

__all__ = ["Initializer", "Constant", "Normal", "Uniform", "XavierNormal",
           "XavierUniform", "KaimingNormal", "KaimingUniform",
           "calculate_gain", "to_dtype"]


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


def _uniform_f32(shape, low, high, device):
    u = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    return u.uniform_(low, high, generator=default_generator(device))


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype="float32", device="cpu"):
        return _uniform_f32(shape, self.low, self.high, device) \
            .to(to_dtype(dtype))


def calculate_gain(nonlinearity: str, param=None) -> float:
    """The recommended gain of a nonlinearity (the JAX package's
    table)."""
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "conv1d_transpose": 1.0, "conv2d_transpose": 1.0,
        "conv3d_transpose": 1.0, "tanh": 5.0 / 3.0,
        "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    if nonlinearity not in gains:
        raise ValueError(f"unsupported nonlinearity: {nonlinearity}")
    return gains[nonlinearity]


class _Kaiming(Initializer):
    def __init__(self, fan_in=None, negative_slope: float = 0.0,
                 nonlinearity: str = "relu"):
        self.fan_in = fan_in
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def _scale(self, shape, num: float) -> float:
        """``gain * sqrt(num / fan_in)``."""
        fi = self.fan_in if self.fan_in is not None else _fan_in_out(
            tuple(int(s) for s in shape))[0]
        return calculate_gain(self.nonlinearity, self.negative_slope) * \
            math.sqrt(num / fi)


class KaimingNormal(_Kaiming):
    def __call__(self, shape, dtype="float32", device="cpu"):
        return (_normal_f32(shape, device) * self._scale(shape, 1.0)) \
            .to(to_dtype(dtype))


class KaimingUniform(_Kaiming):
    """Uniform in ``±gain * sqrt(3 / fan_in)``."""

    def __call__(self, shape, dtype="float32", device="cpu"):
        lim = self._scale(shape, 3.0)
        return _uniform_f32(shape, -lim, lim, device).to(to_dtype(dtype))


class _Xavier(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def _fan_sum(self, shape) -> int:
        """``fan_in + fan_out``, either overridden by the constructor."""
        fi, fo = _fan_in_out(tuple(int(s) for s in shape))
        return (self.fan_in if self.fan_in is not None else fi) + \
            (self.fan_out if self.fan_out is not None else fo)


class XavierNormal(_Xavier):
    def __call__(self, shape, dtype="float32", device="cpu"):
        std = self.gain * math.sqrt(2.0 / self._fan_sum(shape))
        return (_normal_f32(shape, device) * std).to(to_dtype(dtype))


class XavierUniform(_Xavier):
    """Uniform in ``±gain * sqrt(6 / (fan_in + fan_out))``, the fans by
    the JAX package's rule (``_fan_in_out``: a 3-D ``[E, d, d_ff]`` bank
    has fan_in ``d * d_ff`` and fan_out ``E * d_ff``)."""

    def limit(self, shape) -> float:
        return self.gain * math.sqrt(6.0 / self._fan_sum(shape))

    def __call__(self, shape, dtype="float32", device="cpu"):
        lim = self.limit(shape)
        return _uniform_f32(shape, -lim, lim, device).to(to_dtype(dtype))
