"""``TrainStep``: forward, loss, backward and optimizer step in one call
(counterpart of ``paddle_tpu/jit/train_step.py``).

The JAX package compiles the whole step into one XLA program with
donated buffers; PyTorch runs it eagerly: the forward and the loss under
autograd, ``backward()``, the optimizer's in-place update, and the
gradients dropped again, so they live only inside the step. The call
returns the 0-d loss on the device without waiting for it (no host
sync); reading it (``float(loss)``) is what waits.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

__all__ = ["TrainStep"]


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
        if not donate:
            raise NotImplementedError(
                "TrainStep(donate=False) (a step that keeps the old "
                "parameters) comes with the to_static slice of the port; "
                "the eager step updates in place")
        if amp_level is not None or amp_dtype != "bfloat16":
            raise NotImplementedError(
                "TrainStep(amp_level=..., amp_dtype=...) (autocast around "
                "the step) comes with the AMP-O1 slice of the port; O2 is "
                "amp.decorate")
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.first_call_seconds = None

    def roofline(self, wall_s_per_step: float):
        """The XLA cost-model roofline has no counterpart yet."""
        raise NotImplementedError(
            "TrainStep.roofline comes with the profiler slice of the port "
            "(ROADMAP.md queue A item 11)")

    def __call__(self, inputs, labels=()):
        if torch.is_tensor(inputs):
            inputs = [inputs]
        if torch.is_tensor(labels):
            labels = [labels]
        t0 = time.perf_counter() if self.first_call_seconds is None \
            else None
        opt = self.optimizer
        opt.clear_grad()
        out = self.model(*inputs)
        outs = out if isinstance(out, (list, tuple)) else (out,)
        loss = self.loss_fn(*outs, *labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        if t0 is not None:
            self.first_call_seconds = time.perf_counter() - t0
        return loss.detach()
