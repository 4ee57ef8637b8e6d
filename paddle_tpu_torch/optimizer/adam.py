"""Adam and AdamW (counterpart of ``paddle_tpu/optimizer/adam.py``): the
per-parameter rules of the JAX package, in the compute dtype of the
parameter they are given (f32 for a master weight or an upcast bf16
parameter), moments stored in ``moment_dtype``."""
from __future__ import annotations

import torch

from .optimizer import Optimizer

__all__ = ["Adam", "AdamW"]


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None,
                 moment_dtype=None, stochastic_rounding=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, stochastic_rounding)
        if amsgrad:
            raise NotImplementedError(
                "amsgrad comes with the optimizers slice of the port")
        if lazy_mode:
            raise NotImplementedError(
                "lazy_mode (updating only the rows a sparse gradient "
                "touches) comes with the optimizers slice of the port")
        if use_multi_tensor:
            raise NotImplementedError(
                "use_multi_tensor (a fused multi-tensor update) comes with "
                "the optimizer-kernel slice of the port")
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        if moment_dtype in ("bfloat16", "bf16"):
            self._moment_dtype = torch.bfloat16
        elif moment_dtype not in (None, "float32", "fp32"):
            raise ValueError(f"unsupported moment_dtype {moment_dtype!r}")

    def _lowprec_state_keys(self):
        if self._moment_dtype is None:
            return frozenset()
        return frozenset({"moment1", "moment2"})

    def _init_state(self, p):
        md = self._moment_dtype or p.dtype
        return {
            "moment1": torch.zeros(p.shape, dtype=md, device=p.device),
            "moment2": torch.zeros(p.shape, dtype=md, device=p.device),
            "beta1_pow": torch.ones((), dtype=torch.float32,
                                    device=p.device),
            "beta2_pow": torch.ones((), dtype=torch.float32,
                                    device=p.device),
        }

    def _rule(self, p, g, state, hyper):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        cd = p.dtype  # compute dtype (f32 master / upcast param)
        m1 = b1 * state["moment1"].to(cd) + (1 - b1) * g
        m2 = b2 * state["moment2"].to(cd) + (1 - b2) * g * g
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        m1_hat = m1 / (1 - b1p).to(cd)
        m2_hat = m2 / (1 - b2p).to(cd)
        new_p = p - hyper["lr"] * m1_hat / (torch.sqrt(m2_hat) + eps)
        return new_p, {"moment1": self._moment_store(m1),
                       "moment2": self._moment_store(m2),
                       "beta1_pow": b1p, "beta2_pow": b2p}


class AdamW(Adam):
    """Decoupled weight decay: ``p *= 1 - lr * coeff`` before the Adam
    rule, skipped for parameters whose Paddle name (``p.param_name``)
    ``apply_decay_param_fun`` rejects (the no-decay mask)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None, moment_dtype=None, stochastic_rounding=False):
        if not isinstance(weight_decay, (int, float)):
            raise NotImplementedError(
                "a regularizer object as AdamW weight_decay comes with "
                "the regularizer slice of the port")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, name=name,
                         moment_dtype=moment_dtype,
                         stochastic_rounding=stochastic_rounding)
        self._coeff = float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _hyper(self):
        h = super()._hyper()
        h["coeff"] = self._coeff
        return h

    def _per_param_hyper(self, p):
        h = super()._per_param_hyper(p)
        fun = self._apply_decay_param_fun
        masked = fun is not None and not fun(p.param_name)
        h["wd_mask"] = 0.0 if masked else 1.0
        if self._lr_ratio is not None:
            h["lr_mult"] = h["lr_mult"] * float(self._lr_ratio(p))
        return h

    def _rule(self, p, g, state, hyper):
        p = p * (1.0 - hyper["lr"] * hyper["coeff"] * hyper["wd_mask"])
        return super()._rule(p, g, state, hyper)
