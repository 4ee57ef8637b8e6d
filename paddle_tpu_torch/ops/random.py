"""Random ops (counterpart of ``paddle_tpu/ops/random.py``).

Every draw comes from the port's generator for the device it lands on
(``core.generator.default_generator``), never from torch's global
state, so ``seed`` and ``get_rng_state``/``set_rng_state`` govern it. A
tensor made from a shape lands on the current place; one made like
another, or filled in place, on that tensor's device. The two packages
draw different numbers from one seed; what they share is each
distribution, the shapes, the dtypes and the determinism of a seed.

The in-place forms (``uniform_``, ``normal_``, ``exponential_``) are
torch's in-place ops: torch refuses them on a leaf that requires a
gradient, where the JAX package rebinds the tensor.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtype import get_default_dtype, to_torch_dtype
from ..core.generator import default_generator
from .registry import register_op

__all__ = [
    "uniform", "uniform_", "normal", "normal_", "standard_normal", "randn",
    "rand", "randint", "randint_like", "randperm", "bernoulli", "poisson",
    "multinomial", "exponential_", "rand_like", "randn_like",
    "gumbel_softmax",
]


def _dt(dtype):
    return to_torch_dtype(get_default_dtype() if dtype is None else dtype)


def _shape(shape):
    if torch.is_tensor(shape):
        return tuple(int(s) for s in shape.tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s.item() if torch.is_tensor(s) else s) for s in shape)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    """U[min, max); a nonzero ``seed`` draws from a generator of its
    own seeded with it."""
    dev = resolve_device()
    gen = default_generator(dev)
    if seed:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
    u = torch.rand(_shape(shape), generator=gen, device=dev, dtype=_dt(dtype))
    return u * (float(max) - float(min)) + float(min)


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    return x.uniform_(float(min), float(max),
                      generator=default_generator(x.device))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    if torch.is_tensor(mean) or torch.is_tensor(std):
        ref = mean if torch.is_tensor(mean) else std
        out_shape = torch.broadcast_shapes(tuple(np.shape(mean)),
                                           tuple(np.shape(std)))
        eps = torch.randn(out_shape, generator=default_generator(ref.device),
                          device=ref.device, dtype=_dt(None))
        return mean + std * eps
    dev = resolve_device()
    eps = torch.randn(_shape(shape), generator=default_generator(dev),
                      device=dev, dtype=_dt(None))
    return mean + std * eps


def normal_(x, mean=0.0, std=1.0, name=None):
    return x.normal_(float(mean), float(std),
                     generator=default_generator(x.device))


def standard_normal(shape, dtype=None, name=None):
    dev = resolve_device()
    return torch.randn(_shape(shape), generator=default_generator(dev),
                       device=dev, dtype=_dt(dtype))


def randn(shape, dtype=None, name=None):
    return standard_normal(shape, dtype)


def rand(shape, dtype=None, name=None):
    dev = resolve_device()
    return torch.rand(_shape(shape), generator=default_generator(dev),
                      device=dev, dtype=_dt(dtype))


def _randint(low, high, shape, dtype, dev):
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), _shape(shape),
                         generator=default_generator(dev), device=dev,
                         dtype=to_torch_dtype(dtype))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    return _randint(low, high, shape, dtype, resolve_device())


def randint_like(x, low=0, high=None, dtype=None, name=None):
    return _randint(low, high, tuple(x.shape), dtype or x.dtype, x.device)


def randperm(n, dtype="int64", name=None):
    dev = resolve_device()
    return torch.randperm(int(n), generator=default_generator(dev),
                          device=dev).to(to_torch_dtype(dtype))


def bernoulli(x, p=None, name=None):
    """A 0/1 draw of each probability in ``x`` (in ``x``'s dtype), or
    with ``p`` one of ``p`` in f32, shaped like ``p``."""
    if p is None:
        return torch.bernoulli(x, generator=default_generator(x.device))
    probs = torch.full(np.shape(p), float(p), dtype=torch.float32,
                       device=x.device) if not torch.is_tensor(p) else \
        p.float()
    return torch.bernoulli(probs, generator=default_generator(x.device))


def poisson(x, name=None):
    return torch.poisson(x, generator=default_generator(x.device))


def multinomial(x, num_samples=1, replacement=False, name=None):
    return torch.multinomial(x, int(num_samples), bool(replacement),
                             generator=default_generator(x.device))


def exponential_(x, lam=1.0, name=None):
    return x.exponential_(float(lam), generator=default_generator(x.device))


def rand_like(x, dtype=None, name=None):
    return torch.rand(tuple(x.shape), generator=default_generator(x.device),
                      device=x.device, dtype=_dt(dtype or x.dtype))


def randn_like(x, dtype=None, name=None):
    return torch.randn(tuple(x.shape), generator=default_generator(x.device),
                       device=x.device, dtype=_dt(dtype or x.dtype))


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    u = torch.rand(x.shape, generator=default_generator(x.device),
                   device=x.device, dtype=x.dtype)
    g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    y = torch.softmax((x + g) / temperature, dim=axis)
    if hard:
        ax = axis % y.ndim
        one_hot = torch.nn.functional.one_hot(
            y.argmax(ax), y.shape[ax]).to(y.dtype).movedim(-1, ax)
        # straight-through estimator
        return one_hot + y - y.detach()
    return y


def _truncated_normal(shape, mean, std, a, b, dtype, dev):
    """``mean + std * z``, z a standard normal cut to ``[a, b]``, by the
    inverse CDF of a uniform draw (f32, then cast)."""
    lo = 0.5 * (1 + math.erf(a / math.sqrt(2)))
    hi = 0.5 * (1 + math.erf(b / math.sqrt(2)))
    u = torch.rand(_shape(shape), generator=default_generator(dev),
                   device=dev, dtype=torch.float32) * (hi - lo) + lo
    z = (torch.erfinv(2 * u - 1) * math.sqrt(2)).clamp(a, b)
    return (mean + std * z).to(dtype)


for _n in __all__:
    globals()[_n] = register_op(_n, globals()[_n], tags=("random",),
                                differentiable=_n == "gumbel_softmax",
                                amp=_n == "gumbel_softmax")
