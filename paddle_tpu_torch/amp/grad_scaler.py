"""Dynamic loss scaling (counterpart of ``paddle_tpu/amp/grad_scaler.py``):
``AmpScaler`` and ``GradScaler``.

``scale(loss)`` multiplies the loss by the current scale; ``step``
unscales every gradient of the optimizer in place (``p.grad *= 1 /
scale``) and checks them for NaN/Inf with one host read for all of
them, then runs the optimizer's step unless one was found; ``update``
moves the scale by the JAX package's rule: ``decr_every_n_nan_or_inf``
steps with an overflow in a row multiply it by ``decr_ratio`` (not
below 1), ``incr_every_n_steps`` clean steps in a row by
``incr_ratio``. bf16 training needs no scaling; ``enable=False`` passes
everything through.
"""
from __future__ import annotations

from enum import Enum

import torch

from .auto_cast import _amp_cast

__all__ = ["GradScaler", "AmpScaler", "OptimizerState"]


class OptimizerState(Enum):
    INIT = 0
    UNSCALED = 1
    STEPPED = 2


class AmpScaler:
    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n_nan_or_inf = decr_every_n_nan_or_inf
        self._use_dynamic = use_dynamic_loss_scaling
        self._incr_count = 0
        self._decr_count = 0
        self._found_inf = False
        self._opt_states = {}

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._use_dynamic

    def scale(self, var):
        if not self._enable:
            return var
        var, = _amp_cast("amp_scale", var)
        return var * self._scale

    @torch.no_grad()
    def _unscale(self, optimizer):
        if not self._enable:
            return
        inv = 1.0 / self._scale
        finite = []
        for p in optimizer._parameter_list:
            if p.grad is None:
                continue
            p.grad.mul_(inv)
            finite.append(torch.isfinite(p.grad).all())
        # one reduction and one host read for every gradient
        self._found_inf = bool(finite) and not bool(
            torch.stack(finite).all())

    def unscale_(self, optimizer):
        self._unscale(optimizer)
        self._opt_states[id(optimizer)] = OptimizerState.UNSCALED

    @torch.no_grad()
    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if self._opt_states.get(id(optimizer)) != OptimizerState.UNSCALED:
            self._unscale(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._opt_states[id(optimizer)] = OptimizerState.STEPPED

    def update(self):
        if not self._enable or not self._use_dynamic:
            self._opt_states.clear()
            return
        if self._found_inf:
            self._decr_count += 1
            self._incr_count = 0
            if self._decr_count >= self._decr_every_n_nan_or_inf:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._decr_count = 0
        else:
            self._incr_count += 1
            self._decr_count = 0
            if self._incr_count >= self._incr_every_n_steps:
                self._scale = self._scale * self._incr_ratio
                self._incr_count = 0
        self._found_inf = False
        self._opt_states.clear()

    def minimize(self, optimizer, loss):
        """``step`` then ``update``; the caller has run
        ``scale(loss).backward()``."""
        self.step(optimizer)
        self.update()

    # ----- getters and setters -----
    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def get_incr_ratio(self):
        return self._incr_ratio

    def set_incr_ratio(self, v):
        self._incr_ratio = v

    def get_decr_ratio(self):
        return self._decr_ratio

    def set_decr_ratio(self, v):
        self._decr_ratio = v

    def get_incr_every_n_steps(self):
        return self._incr_every_n_steps

    def set_incr_every_n_steps(self, v):
        self._incr_every_n_steps = v

    def get_decr_every_n_nan_or_inf(self):
        return self._decr_every_n_nan_or_inf

    def set_decr_every_n_nan_or_inf(self, v):
        self._decr_every_n_nan_or_inf = v

    def state_dict(self):
        return {
            "scale": self._scale,
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every_n_steps,
            "decr_every_n_nan_or_inf": self._decr_every_n_nan_or_inf,
            "incr_count": self._incr_count,
            "decr_count": self._decr_count,
            "use_dynamic_loss_scaling": self._use_dynamic,
        }

    def load_state_dict(self, state):
        self._scale = state["scale"]
        self._incr_ratio = state["incr_ratio"]
        self._decr_ratio = state["decr_ratio"]
        self._incr_every_n_steps = state["incr_every_n_steps"]
        self._decr_every_n_nan_or_inf = state["decr_every_n_nan_or_inf"]
        self._incr_count = state.get("incr_count", 0)
        self._decr_count = state.get("decr_count", 0)
        self._use_dynamic = state.get("use_dynamic_loss_scaling", True)


class GradScaler(AmpScaler):
    """The user-facing scaler: ``AmpScaler`` as it is."""
