"""The port's tensor (counterpart of ``paddle_tpu/core/tensor.py``).

A port tensor is a ``torch.Tensor`` and a parameter a
``torch.nn.Parameter``: no subclass and no patched method. Paddle's
method semantics clash with torch's (``transpose(perm)`` against
``transpose(dim0, dim1)``, ``split(num_or_sections)`` against
``split(split_size)``), and the port's ``nn`` is written in torch's
idiom, so a tensor's methods stay torch's and Paddle's meaning lives in
the functions of ``ops`` (``paddle.transpose(x, perm)``). The JAX
package attaches its registered methods to its ``Tensor``; the port
reaches each of them through the function of the same name.

Paddle's ``stop_gradient`` is ``not requires_grad``; ``to_tensor``
makes a tensor that stops the gradient unless told otherwise, as in
Paddle.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .dtype import get_default_dtype, to_torch_dtype

__all__ = ["Tensor", "Parameter", "to_tensor"]

Tensor = torch.Tensor
Parameter = torch.nn.Parameter


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "u" and arr.dtype.itemsize > 1:
        to_torch_dtype(arr.dtype)               # raises, naming the type
    return torch.from_numpy(np.array(arr, copy=True, order="C"))


def to_tensor(data, dtype=None, place=None,
              stop_gradient: bool = True) -> torch.Tensor:
    """``paddle.to_tensor``: a new tensor holding ``data`` on ``place``
    (a ``Place``, a device string or a ``torch.device``; the current
    place when None, which raises without a card unless
    ``set_device("cpu")`` was called).

    A Python int gives int64, a Python float the default dtype, and a
    numpy array or a tensor keeps its dtype, as in the JAX package.
    Complex tensors stay on the card: it supports them, where the JAX
    package keeps complex tensors on the host because the TPU has none.
    """
    device = resolve_device(place)
    if torch.is_tensor(data):
        t = data.detach().clone()
    else:
        arr = np.asarray(data)
        t = _from_numpy(arr)
        # a Python float takes the default float dtype
        if arr.dtype == np.float64 and not isinstance(data, np.ndarray) \
                and dtype is None:
            t = t.to(to_torch_dtype(get_default_dtype()))
    t = t.to(device=device,
             dtype=to_torch_dtype(dtype) if dtype is not None else None)
    if not stop_gradient:
        t.requires_grad_(True)
    return t
