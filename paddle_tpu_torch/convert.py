"""Carry weights from the JAX package's models into the port's.

``load_jax_params(model, params)`` takes the JAX model's
``state_dict()`` as numpy arrays (``{name: np.asarray(p._data)}``) and
copies each into the port's parameter of the same name. The port's
``nn.Module``s keep the JAX package's parameter names and shapes
(``embed``, ``stack.qkv_weight``, ``lnf_scale``, ...), so the two
packages then compute the same function from the same numbers. A stack
quantized by the JAX package (``quantize_weight_only_int8``) carries
int8 weights and ``stack.{qkv,out,ffn1,ffn2}_scale_woq`` [L, N] f32
scales; the port's stack creates those parameters when it meets them.
An MoE stack carries ``stack.gate_weight`` and ``stack.moe_{w,b}{1,2}``
by the same names.

``load_jax_adapter(adapter)`` makes a port ``LoRAAdapter`` of a JAX
``LoRAAdapter``'s numpy arrays (its B already scaled), so a port bank
serves the same adapters as a JAX bank without regenerating them.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["load_jax_params", "load_jax_adapter"]


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
    quantized = {n.rpartition(".")[0] for n in params
                 if n.endswith("_scale_woq")}
    for prefix, mod in model.named_modules():
        if prefix in quantized and hasattr(mod, "add_woq_scales"):
            mod.add_woq_scales()
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


def load_jax_adapter(adapter):
    """The port's ``LoRAAdapter`` holding the arrays of a JAX
    ``LoRAAdapter`` (name, rank, and per projection ``(A [L, K, r], B
    [L, r, N])`` with the alpha scale already folded into B)."""
    from .serving.adapters import LoRAAdapter

    return LoRAAdapter(adapter.name, adapter.rank,
                       {p: (np.asarray(a), np.asarray(b))
                        for p, (a, b) in adapter.weights.items()})
