"""Optimizer base (counterpart of ``paddle_tpu/optimizer/optimizer.py``).

Every optimizer defines a per-parameter ``_rule(p, g, state, hyper) ->
(new_p, new_state)`` over tensors, and ``step()`` applies it parameter
by parameter, as the JAX package's ``_update_arrays`` does inside its
one compiled update:

- the learning rate times the parameter's ``lr_mult``
  (``p.optimize_attr["learning_rate"]``);
- with ``_multi_precision`` (AMP O2 ``master_weight``), a bf16/fp16
  parameter gets a lazy f32 master weight, the rule runs on it, and its
  moments are f32 unless the optimizer stores them below f32 on purpose
  (``moment_dtype``);
- with ``stochastic_rounding`` and no master, a bf16 parameter is
  upcast to f32 for the rule and written back with
  ``stochastic_round_bf16``, fed uint16 noise that ``torch.randint``
  draws from the optimizer's own generator on the parameter's device;
- else the rule's result is cast to the parameter's dtype.

The update writes parameters and state in place (``copy_``), where the
JAX package donates their buffers to its compiled update.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

__all__ = ["Optimizer", "stochastic_round_bf16", "SR_SEED"]

#: seed of an optimizer's stochastic-rounding generators (one per device)
SR_SEED = 0


def stochastic_round_bf16(x: torch.Tensor,
                          noise: torch.Tensor) -> torch.Tensor:
    """f32 → bf16 with stochastic rounding, bit for bit the JAX
    package's formula ``((bits(x) + noise) >> 16)`` for the uint16
    ``noise`` given (any integer tensor of values in [0, 65536)).

    For a finite f32, the int32 view plus such noise never overflows,
    and the arithmetic shift of the sum is the upper half of the
    unsigned sum read as a signed int16: the bf16 bits."""
    bits = x.float().contiguous().view(torch.int32)
    rounded = (bits + noise.to(torch.int32)) >> 16
    return rounded.to(torch.int16).view(torch.bfloat16)


class Optimizer:
    """Base optimizer over a list of ``torch.nn.Parameter``s."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False, stochastic_rounding=False):
        if parameters is None:
            raise ValueError(
                "parameters must be provided (dygraph-style optimizer)")
        self._parameter_list = list(parameters)
        if self._parameter_list and isinstance(self._parameter_list[0],
                                               dict):
            raise NotImplementedError(
                "parameter groups come with the optimizer-groups slice "
                "of the port")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                "LR schedulers come with the LR-scheduler slice of the "
                "port")
        if weight_decay is not None:
            raise NotImplementedError(
                "coupled (L2) weight decay comes with the regularizer "
                "slice of the port; AdamW decays decoupled")
        if grad_clip is not None:
            raise NotImplementedError(
                "gradient clipping comes with the grad-clip slice of the "
                "port")
        self._learning_rate = float(learning_rate)
        self._accumulators: Dict[int, Dict[str, Any]] = {}
        self._global_step = 0
        self._multi_precision = multi_precision
        self._stochastic_rounding = stochastic_rounding
        self._sr_generators: Dict[torch.device, torch.Generator] = {}
        # storage dtype of the moment accumulators (None = the
        # parameter's; bf16 halves their memory, the rule runs in f32)
        self._moment_dtype = None

    # ---------------- lr ----------------
    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value: float):
        self._learning_rate = float(value)

    # ---------------- state ----------------
    def _state_for(self, p) -> Dict[str, Any]:
        key = id(p)
        if key not in self._accumulators:
            st = self._init_state(p)
            if self._multi_precision and p.dtype in (torch.float16,
                                                     torch.bfloat16):
                exempt = self._lowprec_state_keys()
                st = {k: (v.float() if k not in exempt
                          and torch.is_tensor(v) and v.is_floating_point()
                          else v)
                      for k, v in st.items()}
            self._accumulators[key] = st
        return self._accumulators[key]

    def _init_state(self, p) -> Dict[str, Any]:
        return {}

    def _lowprec_state_keys(self) -> frozenset:
        """State keys stored below f32 on purpose (``_moment_dtype``),
        exempt from the master-weight f32 upcast."""
        return frozenset()

    def _moment_store(self, arr: torch.Tensor) -> torch.Tensor:
        if self._moment_dtype is not None:
            return arr.to(self._moment_dtype)
        return arr

    def _hyper(self) -> Dict[str, Any]:
        return {"lr": self.get_lr()}

    def _per_param_hyper(self, p) -> Dict[str, float]:
        attr = getattr(p, "optimize_attr", None) or {}
        return {"lr_mult": attr.get("learning_rate", 1.0)}

    def _rule(self, p, g, state, hyper):
        raise NotImplementedError

    def _sr_noise(self, p) -> torch.Tensor:
        """uint16 noise (as int32) for ``p``'s stochastic rounding, from
        this optimizer's generator on ``p``'s device."""
        gen = self._sr_generators.get(p.device)
        if gen is None:
            gen = torch.Generator(device=p.device)
            gen.manual_seed(SR_SEED)
            self._sr_generators[p.device] = gen
        return torch.randint(0, 1 << 16, p.shape, generator=gen,
                             device=p.device, dtype=torch.int32)

    # ---------------- step ----------------
    def _update(self, p, g, st, hyper, pp):
        """One parameter's update, in place: the JAX package's
        ``_update_arrays`` for one ``(p, g, state)``."""
        h = dict(hyper)
        h.update(pp)
        h["lr"] = h["lr"] * h.pop("lr_mult", 1.0)
        st = dict(st)
        if self._multi_precision and "_master" not in st and p.dtype in (
                torch.float16, torch.bfloat16):
            st["_master"] = p.detach().float()        # lazy O2 master
        master = st.pop("_master", None)
        sr = (self._stochastic_rounding and master is None
              and p.dtype == torch.bfloat16)
        p_eff = master if master is not None else (
            p.detach().float() if sr else p.detach())
        g_eff = g.to(p_eff.dtype)
        new_p, nst = self._rule(p_eff, g_eff, st, h)
        if master is not None:
            nst = dict(nst)
            nst["_master"] = new_p
        if sr:
            p.data.copy_(stochastic_round_bf16(new_p, self._sr_noise(p)))
        else:
            p.data.copy_(new_p.to(p.dtype))
        self._accumulators[id(p)] = nst

    @torch.no_grad()
    def step(self):
        hyper = self._hyper()
        for p in self._parameter_list:
            if not p.requires_grad or p.grad is None:
                continue
            self._update(p, p.grad, self._state_for(p), hyper,
                         self._per_param_hyper(p))
        self._global_step += 1

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def state_dict(self):
        raise NotImplementedError(
            "optimizer checkpoints come with the checkpoint slice of the "
            "port")

    set_state_dict = state_dict
