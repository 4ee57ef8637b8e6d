"""InputSpec (counterpart of ``paddle_tpu/static/input_spec.py``): the
shape and dtype of one input of a saved program (``jit.save``)."""
from __future__ import annotations

from ..core.dtype import convert_dtype

__all__ = ["InputSpec"]


class InputSpec:
    """``shape`` (a ``None`` or ``-1`` dim is free: ``jit.save`` fixes it
    to 1), ``dtype`` (any dtype-like, kept as the port's ``DType``),
    ``name``."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=False):
        self.shape = tuple(-1 if s is None else int(s) for s in shape)
        self.dtype = convert_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(tensor.shape, tensor.dtype,
                   name or getattr(tensor, "param_name", None))

    @classmethod
    def from_numpy(cls, ndarray, name=None):
        return cls(ndarray.shape, str(ndarray.dtype), name)

    def batch(self, batch_size):
        self.shape = (batch_size,) + self.shape
        return self

    def unbatch(self):
        self.shape = self.shape[1:]
        return self

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype.name}, "
                f"name={self.name})")
