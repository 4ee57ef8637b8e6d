"""Activation functionals (counterpart of
``paddle_tpu/nn/functional/activation.py``): the ``gelu`` the training
path calls."""
from __future__ import annotations

import torch.nn.functional as F

__all__ = ["gelu"]


def gelu(x, approximate=False, name=None):
    """GELU; ``approximate=False`` (the default, as in the JAX package)
    is the exact erf form, ``True`` the tanh approximation."""
    return F.gelu(x, approximate="tanh" if approximate else "none")
