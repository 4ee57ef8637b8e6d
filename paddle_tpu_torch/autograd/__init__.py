"""Autograd's user API (counterpart of ``paddle_tpu/autograd``), on
``torch.autograd``.

``grad`` keeps Paddle's rules: ``retain_graph`` defaults to
``create_graph``; an input that receives no gradient raises unless
``allow_unused`` (then its gradient is None); no ``.grad`` is touched;
and no gradient flows back through the tensors of ``no_grad_vars``
(the JAX package accepts them and ignores them).

``PyLayer`` is a ``torch.autograd.Function`` with Paddle's context
(``PyLayerContext``: ``save_for_backward`` and ``saved_tensor()``):
``forward(ctx, *args, **kwargs)`` runs without recording, and
``backward(ctx, *grads)`` returns one gradient for each tensor argument
of ``forward``, in order (``None`` for one that needs none).
"""
from __future__ import annotations

import inspect
from typing import List, Optional

import torch
from torch.autograd.function import BackwardCFunction, FunctionMeta

__all__ = [
    "backward", "grad", "no_grad", "enable_grad", "set_grad_enabled",
    "is_grad_enabled", "PyLayer", "PyLayerContext",
]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled


def _listify(x):
    if x is None:
        return None
    if torch.is_tensor(x):
        return [x]
    return list(x)


def backward(tensors, grad_tensors=None, retain_graph=False):
    torch.autograd.backward(_listify(tensors), _listify(grad_tensors),
                            retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None, name=None) -> List[Optional[torch.Tensor]]:
    """``paddle.grad``: the gradients of ``outputs`` with respect to
    ``inputs``, without touching any ``.grad``."""
    outputs, inputs = _listify(outputs), _listify(inputs)
    grad_outputs = _listify(grad_outputs)
    retain = bool(create_graph) if retain_graph is None \
        else bool(retain_graph)
    # no gradient flows back through no_grad_vars: a hook zeroes what
    # reaches each of them for this call
    handles = [v.register_hook(torch.zeros_like)
               for v in (_listify(no_grad_vars) or []) if v.requires_grad]
    try:
        grads = torch.autograd.grad(outputs, inputs, grad_outputs,
                                    retain_graph=retain,
                                    create_graph=create_graph,
                                    allow_unused=True)
    finally:
        for h in handles:
            h.remove()
    if not allow_unused and any(g is None for g in grads):
        raise RuntimeError(
            "one of the input tensors receives no gradient; pass "
            "allow_unused=True to get None for it")
    return list(grads)


class PyLayerContext:
    """Paddle's context methods on a ``PyLayer``'s ``ctx``."""

    def saved_tensor(self):
        return self.saved_tensors


class _PyLayerMeta(FunctionMeta):
    """Gives each ``PyLayer`` a context with Paddle's methods and maps
    its ``backward``'s gradients (one per tensor argument) onto every
    argument of ``forward``."""

    def __init__(cls, name, bases, attrs):
        if "forward" in attrs:
            user_fwd = attrs["forward"].__func__ if isinstance(
                attrs["forward"], staticmethod) else attrs["forward"]

            def forward(ctx, *args):
                ctx._tensor_args = [torch.is_tensor(a) for a in args]
                return user_fwd(ctx, *args)

            forward.__signature__ = inspect.signature(user_fwd)
            cls.forward = staticmethod(forward)
        if "backward" in attrs:
            user_bwd = attrs["backward"].__func__ if isinstance(
                attrs["backward"], staticmethod) else attrs["backward"]

            def backward(ctx, *grads):
                out = user_bwd(ctx, *grads)
                out = iter(out if isinstance(out, (tuple, list))
                           else (out,))
                return tuple(next(out, None) if is_t else None
                             for is_t in ctx._tensor_args)

            cls.backward = staticmethod(backward)
        super().__init__(name, bases, attrs)
        cls._backward_cls = type(name + "Backward",
                                 (BackwardCFunction, PyLayerContext),
                                 {"_forward_cls": cls})


class PyLayer(torch.autograd.Function, metaclass=_PyLayerMeta):
    """A user-defined op: subclass with static ``forward(ctx, ...)`` and
    ``backward(ctx, *grads)``, then call ``apply``."""

    @classmethod
    def apply(cls, *args, **kwargs):
        if kwargs:
            bound = inspect.signature(cls.forward).bind(None, *args,
                                                        **kwargs)
            bound.apply_defaults()
            args = bound.args[1:]
        return super().apply(*args)
