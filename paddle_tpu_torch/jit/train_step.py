"""``TrainStep``: forward, loss, backward and optimizer step in one call
(counterpart of ``paddle_tpu/jit/train_step.py``).

The JAX package compiles the whole step into one XLA program with
donated buffers; PyTorch runs it eagerly: the forward and the loss under
autograd (and, with ``amp_level``, under ``amp.auto_cast`` at that level
and ``amp_dtype``), ``backward()``, then the step's gradient transforms
as the JAX package's compiled step applies them, the optimizer's
in-place update, and the gradients dropped again, so they live only
inside the step. The transforms mirror the compiled step, which differs
from the eager ``Optimizer.step`` in two ways: a global ``weight_decay``
regularizer applies to every parameter (a parameter's own regularizer
only when the optimizer has none, or decays decoupled), and the clip
covers every gradient (``need_clip`` is not read). The learning rate is
the optimizer's at the call (an LR scheduler is stepped by the caller).
The call returns the 0-d loss on the device without waiting for it (no
host sync); reading it (``float(loss)``) is what waits.

``donate=True`` (the default) updates the parameters in place, as the
JAX step donates their buffers. With ``donate=False`` the step writes
each updated parameter into new storage and leaves the old storage as
it was, so a tensor the caller kept (``p.detach()``) keeps its values;
the new parameters equal those of an in-place step.

While a step runs its forward, loss and backward, ``in_train_step()``
is true: what the JAX package skips under the step's trace (the MoE
layer's data-dependent telemetry, a host read) is skipped there too.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from ..amp.auto_cast import auto_cast
from ..nn.clip import (ClipGradByGlobalNorm, ClipGradByNorm,
                       ClipGradByValue)
from ..regularizer import WeightDecayRegularizer

__all__ = ["TrainStep", "in_train_step"]

#: > 0 while a TrainStep runs its forward, loss and backward
_step_depth = 0


def in_train_step() -> bool:
    """True inside a ``TrainStep``'s forward, loss and backward (the JAX
    package's step runs them under a trace)."""
    return _step_depth > 0


class TrainStep:
    """``loss = loss_fn(*model(*inputs), *labels)`` and the optimizer
    step; ``step(inputs, labels)`` returns the loss tensor, and the
    parameters and optimizer state are updated in place.
    ``first_call_seconds`` is the host wall time of the first call (the
    kernels' first build included)."""

    def __init__(self, model, loss_fn: Callable, optimizer,
                 in_sharding=None, donate: bool = True,
                 amp_level: Optional[str] = None,
                 amp_dtype: str = "bfloat16"):
        if in_sharding is not None:
            raise NotImplementedError(
                "TrainStep(in_sharding=...) comes with the distributed "
                "training slice of the port")
        self._donate = bool(donate)
        self._amp_level = amp_level if amp_level in ("O1", "O2") else None
        self._amp_dtype = amp_dtype
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.first_call_seconds = None

    def roofline(self, wall_s_per_step: float):
        """The XLA cost-model roofline has no counterpart yet."""
        raise NotImplementedError(
            "TrainStep.roofline comes with the profiler slice of the port "
            "(ROADMAP.md queue A item 11)")

    def _apply_regularizers(self, params, grads):
        """The compiled step's regularizers: the optimizer's coupled
        ``weight_decay`` on every gradient, else each parameter's own."""
        opt = self.optimizer
        wd = opt._weight_decay
        if wd is None or opt._decoupled_wd():
            return [g if getattr(p, "regularizer", None) is None
                    else p.regularizer(p.detach(), g)
                    for p, g in zip(params, grads)]
        if isinstance(wd, WeightDecayRegularizer):
            return [wd(p.detach(), g) for p, g in zip(params, grads)]
        return grads

    def _clip_grads(self, grads):
        """The compiled step's clip: the optimizer's ``grad_clip`` over
        every gradient (pairs without a parameter, so no ``need_clip``
        is read)."""
        clip = self.optimizer._grad_clip
        if clip is None:
            return grads
        if not isinstance(clip, (ClipGradByValue, ClipGradByNorm,
                                 ClipGradByGlobalNorm)):
            raise NotImplementedError(f"grad clip {type(clip)} in "
                                      "TrainStep")
        return [g for _, g in clip([(None, g) for g in grads])]

    def __call__(self, inputs, labels=()):
        if torch.is_tensor(inputs):
            inputs = [inputs]
        if torch.is_tensor(labels):
            labels = [labels]
        t0 = time.perf_counter() if self.first_call_seconds is None \
            else None
        opt = self.optimizer
        opt.clear_grad()
        global _step_depth
        _step_depth += 1
        try:
            with auto_cast(enable=self._amp_level is not None,
                           level=self._amp_level or "O1",
                           dtype=self._amp_dtype):
                out = self.model(*inputs)
                outs = out if isinstance(out, (list, tuple)) else (out,)
                loss = self.loss_fn(*outs, *labels)
            loss.backward()
        finally:
            _step_depth -= 1
        params = [p for p in opt._parameter_list
                  if p.requires_grad and p.grad is not None]
        with torch.no_grad():
            grads = self._apply_regularizers(params,
                                             [p.grad for p in params])
            grads = self._clip_grads(grads)
            if not self._donate:
                for p in params:
                    p.data = p.data.clone()
            opt._apply_updates(list(zip(params, grads)))
        opt._global_step += 1
        opt.clear_grad()
        if t0 is not None:
            self.first_call_seconds = time.perf_counter() - t0
        return loss.detach()
