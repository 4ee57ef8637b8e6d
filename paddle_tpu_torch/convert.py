"""Carry weights from the JAX package's models into the port's.

``load_jax_params(model, params)`` takes the JAX model's
``state_dict()`` as numpy arrays (``{name: np.asarray(p._data)}``) and
copies each into the port's parameter or persistable buffer of the same
name. The port's
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

``load_jax_optimizer_state(optimizer, state, jax_model, model)`` carries
a JAX optimizer's ``state_dict()`` into a port optimizer. Its keys hold
the JAX parameters' Paddle names (``"linear_7.weight_moment1"``), which
come from a process-wide counter: a port model built in the same
process has other indices. Each key is placed through the structured
path both models share (``blocks.0.qkv.weight``).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

__all__ = ["load_jax_params", "load_jax_adapter",
           "load_jax_optimizer_state"]


def _to_torch(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # numpy has no native bfloat16: move the raw 16-bit patterns
        return torch.from_numpy(arr.view(np.uint16).astype(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))  # a writable copy


def load_jax_params(model: torch.nn.Module,
                    params: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Copy every array of ``params`` into ``model``'s parameter or
    persistable buffer (BN's ``_mean`` and ``_variance``) of the same
    name, on its device. Raises on a name the model lacks, a shape
    mismatch, or a parameter or buffer that ``params`` leaves unset.

    An array of the tensor's own dtype is copied into it in place, so
    the tensor keeps its storage, which a ``jit.to_static`` program
    captured as a CUDA graph reads. An array of another dtype (int8
    weights of a quantized stack) rebinds the tensor to new storage of
    the array's dtype; a ``to_static`` program that captured the old
    storage sees it moved and captures itself again at its next call."""
    quantized = {n.rpartition(".")[0] for n in params
                 if n.endswith("_scale_woq")}
    for prefix, mod in model.named_modules():
        if prefix in quantized and hasattr(mod, "add_woq_scales"):
            mod.add_woq_scales()
    own = dict(model.named_parameters())
    own.update((k, v) for k, v in model.state_dict(keep_vars=True).items()
               if k not in own)
    missing = sorted(set(own) - set(params))
    unknown = sorted(set(params) - set(own))
    if missing or unknown:
        raise KeyError(f"load_jax_params: names differ — missing "
                       f"{missing}, unknown {unknown}")
    with torch.no_grad():
        for name, arr in params.items():
            p = own[name]
            t = _to_torch(arr)
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"load_jax_params: {name} is "
                                 f"{tuple(t.shape)}, the model's "
                                 f"{tuple(p.shape)}")
            if t.dtype == p.dtype:
                p.copy_(t)
            else:
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


def load_jax_optimizer_state(optimizer, state: Mapping, jax_model,
                             model: torch.nn.Module) -> None:
    """``optimizer.set_state_dict`` of a JAX optimizer's ``state`` (numpy
    arrays and Python scalars, keyed ``"{paddle name}_{key}"``), each
    key renamed from the JAX parameter's Paddle name to the Paddle name
    (``param_name``) of the port parameter at the same structured path
    of ``model``; ``"LR_Scheduler"`` and ``"global_step"`` are carried
    as they are. Raises ``KeyError`` on a key that names no parameter of
    ``jax_model``, or a path ``model`` lacks."""
    own = dict(model.named_parameters())
    renamed = {}
    for path, jp in jax_model.named_parameters():
        if path not in own:
            raise KeyError(f"load_jax_optimizer_state: the port model has "
                           f"no parameter {path!r}")
        renamed[jp.name] = own[path].param_name
    # longest name first: "linear_1.w" must not take "linear_1.w_2"'s keys
    names = sorted(renamed, key=len, reverse=True)
    out = {}
    for key, value in state.items():
        if key in ("LR_Scheduler", "global_step"):
            out[key] = value
            continue
        jname = next((n for n in names if key.startswith(n + "_")), None)
        if jname is None:
            raise KeyError(f"load_jax_optimizer_state: {key!r} names no "
                           "parameter of the JAX model")
        out[renamed[jname] + key[len(jname):]] = value
    optimizer.set_state_dict(out)
