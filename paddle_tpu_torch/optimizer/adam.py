"""The Adam family (counterpart of ``paddle_tpu/optimizer/adam.py``):
``Adam`` (with ``amsgrad``), ``AdamW``, ``Adamax`` and ``Lamb``, the
per-parameter rules of the JAX package in the compute dtype of the
parameter they are given (f32 for a master weight or an upcast bf16
parameter), Adam's moments stored in ``moment_dtype``.

``lazy_mode`` is accepted and runs the dense update, as the JAX package
does: a gradient here is dense, so every row is updated.
"""
from __future__ import annotations

import torch

from ..regularizer import L2Decay
from .optimizer import Optimizer

__all__ = ["Adam", "AdamW", "Adamax", "Lamb"]


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 use_multi_tensor=False, amsgrad=False, name=None,
                 moment_dtype=None, stochastic_rounding=False):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision, stochastic_rounding)
        if use_multi_tensor:
            raise NotImplementedError(
                "use_multi_tensor (one fused update of every parameter) "
                "comes with the fused multi-tensor kernel of ROADMAP.md "
                "A3")
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._amsgrad = amsgrad
        if moment_dtype in ("bfloat16", "bf16"):
            self._moment_dtype = torch.bfloat16
        elif moment_dtype not in (None, "float32", "fp32"):
            raise ValueError(f"unsupported moment_dtype {moment_dtype!r}")

    def _lowprec_state_keys(self):
        if self._moment_dtype is None:
            return frozenset()
        return frozenset({"moment1", "moment2", "moment2_max"})

    def _init_state(self, p):
        md = self._moment_dtype or p.dtype
        st = {
            "moment1": torch.zeros(p.shape, dtype=md, device=p.device),
            "moment2": torch.zeros(p.shape, dtype=md, device=p.device),
            "beta1_pow": torch.ones((), dtype=torch.float32,
                                    device=p.device),
            "beta2_pow": torch.ones((), dtype=torch.float32,
                                    device=p.device),
        }
        if self._amsgrad:
            st["moment2_max"] = torch.zeros(p.shape, dtype=md,
                                            device=p.device)
        return st

    def _rule(self, p, g, state, hyper):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        cd = p.dtype  # compute dtype (f32 master / upcast param)
        m1 = b1 * state["moment1"].to(cd) + (1 - b1) * g
        m2 = b2 * state["moment2"].to(cd) + (1 - b2) * g * g
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        m1_hat = m1 / (1 - b1p).to(cd)
        if self._amsgrad:
            m2_max = torch.maximum(state["moment2_max"].to(cd), m2)
            m2_hat = m2_max / (1 - b2p).to(cd)
        else:
            m2_hat = m2 / (1 - b2p).to(cd)
        new_p = p - hyper["lr"] * m1_hat / (torch.sqrt(m2_hat) + eps)
        st = {"moment1": self._moment_store(m1),
              "moment2": self._moment_store(m2),
              "beta1_pow": b1p, "beta2_pow": b2p}
        if self._amsgrad:
            st["moment2_max"] = self._moment_store(m2_max)
        return new_p, st


class Adamax(Optimizer):
    """Adam with an infinity-norm second moment: ``m = b1 m + (1 - b1)
    g``, ``u = max(|g|, b2 u + eps)``, ``p -= lr / (1 - b1^t) * m / u``;
    ``u`` has no bias correction."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _init_state(self, p):
        return {
            "moment": torch.zeros_like(p.detach()),
            "inf_norm": torch.zeros_like(p.detach()),
            "beta1_pow": torch.ones((), dtype=torch.float32,
                                    device=p.device),
        }

    def _rule(self, p, g, state, hyper):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m = b1 * state["moment"] + (1 - b1) * g
        u = torch.maximum(torch.abs(g), b2 * state["inf_norm"] + eps)
        b1p = state["beta1_pow"] * b1
        lr_t = hyper["lr"] / (1 - b1p).to(p.dtype)
        new_p = p - lr_t * m / u
        return new_p, {"moment": m, "inf_norm": u, "beta1_pow": b1p}


class AdamW(Adam):
    """Decoupled weight decay: ``p *= 1 - lr * coeff`` before the Adam
    rule, skipped for parameters whose Paddle name (``p.param_name``)
    ``apply_decay_param_fun`` rejects (the no-decay mask).
    ``weight_decay`` is a float or an ``L2Decay`` (its ``coeff``);
    anything else decays by 0.01, as in the JAX package."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, amsgrad=False,
                 name=None, moment_dtype=None, stochastic_rounding=False):
        coeff = weight_decay if isinstance(weight_decay, float) else (
            weight_decay.coeff if isinstance(weight_decay, L2Decay)
            else 0.01)
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         amsgrad=amsgrad, name=name,
                         moment_dtype=moment_dtype,
                         stochastic_rounding=stochastic_rounding)
        self._coeff = float(coeff)
        self._apply_decay_param_fun = apply_decay_param_fun
        self._lr_ratio = lr_ratio

    def _decoupled_wd(self):
        return True

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


class Lamb(Optimizer):
    """LAMB: Adam's update plus ``lamb_weight_decay * p``, scaled per
    parameter by the trust ratio ``||p|| / ||r||``."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._wd = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_state(self, p):
        return {
            "moment1": torch.zeros_like(p.detach()),
            "moment2": torch.zeros_like(p.detach()),
            "beta1_pow": torch.ones((), dtype=torch.float32,
                                    device=p.device),
            "beta2_pow": torch.ones((), dtype=torch.float32,
                                    device=p.device),
        }

    def _rule(self, p, g, state, hyper):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m1 = b1 * state["moment1"] + (1 - b1) * g
        m2 = b2 * state["moment2"] + (1 - b2) * g * g
        b1p = state["beta1_pow"] * b1
        b2p = state["beta2_pow"] * b2
        m1_hat = m1 / (1 - b1p)
        m2_hat = m2 / (1 - b2p)
        r = m1_hat / (torch.sqrt(m2_hat) + eps) + self._wd * p
        p_norm = torch.sqrt(torch.sum(torch.square(p)))
        r_norm = torch.sqrt(torch.sum(torch.square(r)))
        trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                            torch.ones_like(p_norm))
        new_p = p - hyper["lr"] * trust * r
        return new_p, {"moment1": m1, "moment2": m2, "beta1_pow": b1p,
                       "beta2_pow": b2p}
