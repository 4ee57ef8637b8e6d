"""Tensor creation ops (counterpart of ``paddle_tpu/ops/creation.py``).

A tensor made from a shape lands on the current place (``set_device``,
else the card); one made like another tensor on that tensor's device.
Without a dtype, a float takes the default dtype and ``arange`` of ints
int64, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.dtype import get_default_dtype, to_torch_dtype
from ..core.tensor import to_tensor
from .registry import register_op

__all__ = [
    "zeros", "ones", "full", "empty", "zeros_like", "ones_like", "full_like",
    "empty_like", "arange", "linspace", "logspace", "eye", "tril", "triu",
    "diag", "diagflat", "meshgrid", "assign", "clone", "numel",
    "to_tensor", "tril_indices", "triu_indices", "one_hot",
]


def _dt(dtype):
    return to_torch_dtype(get_default_dtype() if dtype is None else dtype)


def _t(x):
    return x if torch.is_tensor(x) else to_tensor(x)


def _shape(shape):
    if torch.is_tensor(shape):
        return tuple(int(s) for s in shape.tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def _item(v):
    return v.item() if torch.is_tensor(v) else v


def zeros(shape, dtype=None, name=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype),
                       device=resolve_device())


def ones(shape, dtype=None, name=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype),
                      device=resolve_device())


def full(shape, fill_value, dtype=None, name=None):
    fill_value = _item(fill_value)
    if dtype is None:
        # a float fill takes the default dtype; an int int64, a bool bool
        dt = _dt(None) if isinstance(fill_value, float) else (
            torch.bool if isinstance(fill_value, bool) else torch.int64)
    else:
        dt = _dt(dtype)
    return torch.full(_shape(shape), fill_value, dtype=dt,
                      device=resolve_device())


def empty(shape, dtype=None, name=None):
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    x = _t(x)
    return torch.zeros_like(x, dtype=_dt(dtype) if dtype else None)


def ones_like(x, dtype=None, name=None):
    x = _t(x)
    return torch.ones_like(x, dtype=_dt(dtype) if dtype else None)


def full_like(x, fill_value, dtype=None, name=None):
    x = _t(x)
    return torch.full_like(x, _item(fill_value),
                           dtype=_dt(dtype) if dtype else None)


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    start, end, step = _item(start), _item(end), _item(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = ("int64" if all(isinstance(v, (int, np.integer))
                                for v in (start, end, step))
                 else get_default_dtype())
    return torch.arange(start, end, step, dtype=_dt(dtype),
                        device=resolve_device())


def linspace(start, stop, num, dtype=None, name=None):
    return torch.linspace(float(_item(start)), float(_item(stop)),
                          int(_item(num)), dtype=_dt(dtype),
                          device=resolve_device())


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    return torch.logspace(float(_item(start)), float(_item(stop)),
                          int(_item(num)), base=float(base), dtype=_dt(dtype),
                          device=resolve_device())


def eye(num_rows, num_columns=None, dtype=None, name=None):
    n = int(num_rows)
    m = n if num_columns is None else int(num_columns)
    return torch.eye(n, m, dtype=_dt(dtype), device=resolve_device())


def tril(x, diagonal=0, name=None):
    return torch.tril(_t(x), int(diagonal))


def triu(x, diagonal=0, name=None):
    return torch.triu(_t(x), int(diagonal))


def diag(x, offset=0, padding_value=0, name=None):
    x = _t(x)
    out = torch.diag(x, int(offset))
    if x.ndim == 1 and padding_value != 0:
        off = torch.diag(torch.ones_like(x, dtype=torch.bool), int(offset))
        out = torch.where(off, out, torch.full_like(out, padding_value))
    return out


def diagflat(x, offset=0, name=None):
    return torch.diagflat(_t(x), int(offset))


def meshgrid(*args, **kwargs):
    tensors = args[0] if len(args) == 1 and isinstance(args[0],
                                                       (list, tuple)) \
        else args
    return list(torch.meshgrid(*tensors, indexing="ij"))


def assign(x, output=None):
    """A copy of ``x`` (a tensor, or an array-like taken as numpy takes
    it); with ``output``, copied into it in place (torch refuses that for
    a leaf that requires a gradient)."""
    src = x if torch.is_tensor(x) else to_tensor(np.asarray(x))
    out = src.clone()
    if output is not None:
        return output.copy_(out)
    return out


def clone(x, name=None):
    return assign(x)


def numel(x, name=None):
    x = _t(x)
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


def tril_indices(row, col, offset=0, dtype="int64"):
    return torch.tril_indices(int(row), int(col), int(offset),
                              device=resolve_device()).to(_dt(dtype))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return torch.triu_indices(int(row), int(col), int(offset),
                              device=resolve_device()).to(_dt(dtype))


def one_hot(x, num_classes, name=None):
    return torch.nn.functional.one_hot(_t(x).long(), int(num_classes)) \
        .to(_dt(None))


_AMP = ("tril", "triu", "diag", "diagflat", "assign", "one_hot")
for _name in __all__:
    if _name not in ("to_tensor", "clone"):
        globals()[_name] = register_op(_name, globals()[_name],
                                       tags=("creation",),
                                       amp=_name in _AMP)
clone = register_op("clone", clone, methods=["clone"], tags=("creation",),
                    amp=True)
