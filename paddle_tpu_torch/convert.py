"""Carry weights from the JAX package's models into the port's.

``load_jax_params(model, params)`` takes the JAX model's
``state_dict()`` as numpy arrays (``{name: np.asarray(p._data)}``) and
copies each into the port's parameter of the same name. The port's
``nn.Module``s keep the JAX package's parameter names and shapes
(``embed``, ``stack.qkv_weight``, ``lnf_scale``, ...), so the two
packages then compute the same function from the same numbers.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["load_jax_params"]


def _to_torch(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # numpy has no native bfloat16: move the raw 16-bit patterns
        return torch.from_numpy(arr.view(np.uint16).astype(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # a writable copy


def load_jax_params(model: torch.nn.Module,
                    params: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Copy every array of ``params`` into ``model``'s parameter of the
    same name, on the parameter's device, keeping the array's dtype.
    Raises on a name the model lacks, a shape mismatch, or a model
    parameter that ``params`` leaves unset."""
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(params))
    unknown = sorted(set(params) - set(own))
    if missing or unknown:
        raise KeyError(f"load_jax_params: names differ — missing "
                       f"{missing}, unknown {unknown}")
    for name, arr in params.items():
        p = own[name]
        t = _to_torch(arr)
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"load_jax_params: {name} is "
                             f"{tuple(t.shape)}, the model's "
                             f"{tuple(p.shape)}")
        p.data = t.to(p.device)
    return model
