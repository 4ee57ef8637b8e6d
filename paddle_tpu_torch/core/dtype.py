"""Dtypes of the port (counterpart of ``paddle_tpu/core/dtype.py``).

``DType`` names a dtype as Paddle does (``paddle.float32``) and maps it
onto a ``torch.dtype`` (``to_torch_dtype``). A ``DType`` compares equal
to its name, to its ``torch.dtype`` and to the numpy dtype of the same
name, so ``t.dtype == paddle.float32`` holds for a torch tensor ``t``.

The defaults are the JAX package's, which runs with 64-bit types on: a
Python int makes int64, a Python float the default dtype (float32 until
``set_default_dtype``), and a numpy array keeps its dtype.

torch has no unsigned 16-, 32- or 64-bit type that its operators
support in full, so ``uint16``, ``uint32`` and ``uint64`` exist as names
and ``to_torch_dtype`` raises a ``TypeError`` that names them: nothing
casts to another type quietly.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "DType", "dtype", "convert_dtype", "to_torch_dtype",
    "set_default_dtype", "get_default_dtype",
    "float16", "float32", "float64", "bfloat16",
    "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64",
    "bool_", "complex64", "complex128",
]


class DType:
    """A framework dtype: hashable, equal to its name, its torch dtype
    and its numpy dtype."""

    __slots__ = ("name", "torch_dtype")

    _registry: dict = {}

    def __init__(self, name: str, torch_dtype):
        self.name = name
        #: None where torch does not support the type in full
        self.torch_dtype = torch_dtype
        DType._registry[name] = self

    def __eq__(self, other):
        if isinstance(other, DType):
            return self.name == other.name
        try:
            return self.name == convert_dtype(other).name
        except (TypeError, ValueError):
            return NotImplemented

    def __hash__(self):
        return hash(self.name)

    def __repr__(self):
        return f"paddle_tpu_torch.{self.name}"

    @property
    def is_floating_point(self) -> bool:
        return self.name in ("float16", "float32", "float64", "bfloat16")

    @property
    def is_integer(self) -> bool:
        return self.name.startswith(("int", "uint"))

    @property
    def is_complex(self) -> bool:
        return self.name.startswith("complex")

    @property
    def itemsize(self) -> int:
        if self.torch_dtype is not None:
            return self.torch_dtype.itemsize
        return int(self.name[4:]) // 8


float16 = DType("float16", torch.float16)
float32 = DType("float32", torch.float32)
float64 = DType("float64", torch.float64)
bfloat16 = DType("bfloat16", torch.bfloat16)
int8 = DType("int8", torch.int8)
int16 = DType("int16", torch.int16)
int32 = DType("int32", torch.int32)
int64 = DType("int64", torch.int64)
uint8 = DType("uint8", torch.uint8)
uint16 = DType("uint16", None)
uint32 = DType("uint32", None)
uint64 = DType("uint64", None)
bool_ = DType("bool", torch.bool)
complex64 = DType("complex64", torch.complex64)
complex128 = DType("complex128", torch.complex128)

_ALIASES = {
    "float": "float32",
    "double": "float64",
    "half": "float16",
    "int": "int32",
    "long": "int64",
    "bool_": "bool",
}


def convert_dtype(d) -> DType:
    """Any dtype-like (a ``DType``, a name, a ``torch.dtype``, a numpy
    dtype or scalar type) as a ``DType``."""
    if d is None:
        raise TypeError("dtype must not be None")
    if isinstance(d, DType):
        return d
    if isinstance(d, str):
        name = _ALIASES.get(d, d)
        if name in DType._registry:
            return DType._registry[name]
    elif isinstance(d, torch.dtype):
        name = str(d).rpartition(".")[2]
        if name in DType._registry:
            return DType._registry[name]
        raise TypeError(f"unsupported dtype: {d!r}")
    try:
        name = np.dtype(d).name
    except TypeError:
        raise TypeError(f"unsupported dtype: {d!r}") from None
    if name in DType._registry:
        return DType._registry[name]
    raise TypeError(f"unsupported dtype: {d!r}")


def to_torch_dtype(d) -> torch.dtype:
    """The ``torch.dtype`` of a dtype-like; a ``TypeError`` naming the
    type where torch does not support it in full (uint16, uint32,
    uint64)."""
    if isinstance(d, torch.dtype):
        return d
    dt = convert_dtype(d)
    if dt.torch_dtype is None:
        raise TypeError(
            f"dtype {dt.name}: torch has no unsigned {dt.name[4:]}-bit type "
            "that its operators support in full, so the port refuses it "
            "rather than cast to another type")
    return dt.torch_dtype


#: what ``set_default_dtype`` controls
_default_dtype = float32


def set_default_dtype(d) -> None:
    global _default_dtype
    d = convert_dtype(d)
    if not d.is_floating_point:
        raise TypeError(f"default dtype must be floating point, got {d}")
    _default_dtype = d


def get_default_dtype() -> DType:
    return _default_dtype


dtype = DType  # paddle exposes `paddle.dtype` as the type itself
