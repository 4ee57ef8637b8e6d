"""Optimizer base and the SGD family (counterpart of
``paddle_tpu/optimizer/optimizer.py``).

Every optimizer defines a per-parameter ``_rule(p, g, state, hyper) ->
(new_p, new_state)`` over tensors. ``step()`` takes the parameters that
have a gradient, in the JAX package's order:

1. regularizers: a parameter's own ``p.regularizer`` first, else the
   optimizer's ``weight_decay`` (a float is ``L2Decay``; AdamW decays
   decoupled, in its rule, and applies only the parameters' own);
2. ``grad_clip`` over the regularized gradients (``nn.clip``);
3. the rule, parameter by parameter, as the JAX package's
   ``_update_arrays`` does inside its one compiled update:

- the learning rate (a float, or an ``LRScheduler``'s current value
  read as a Python float) times the parameter's ``lr_mult``
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
``parameters`` may be a list of groups (``[{"params": [...]}, ...]``),
which are flattened in order; as in the JAX package, a group's other
keys are kept and not applied. ``state_dict`` keys state by the
parameter's Paddle name (``p.param_name``): ``"{name}_{key}"``, the f32
master as ``"{name}__master"``, plus ``"LR_Scheduler"`` and
``"global_step"``.
"""
from __future__ import annotations

import warnings
from collections import OrderedDict
from typing import Any, Dict

import torch

from ..convert import _to_torch
from ..regularizer import L2Decay, WeightDecayRegularizer
from .lr import LRScheduler

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adadelta",
           "RMSProp", "Rprop", "stochastic_round_bf16", "SR_SEED"]

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


def _param_key(p) -> str:
    name = getattr(p, "param_name", None)
    if name is None:
        raise ValueError("an optimizer checkpoint keys state by each "
                         "parameter's Paddle name (p.param_name), and a "
                         "parameter has none")
    return name


def _restored(v, like: torch.Tensor):
    """A checkpoint value as the state holds it: a tensor or array copied
    onto ``like``'s device in its own dtype, anything else as it is."""
    if torch.is_tensor(v):
        return v.detach().to(like.device, copy=True)
    if hasattr(v, "shape") and hasattr(v, "dtype"):
        return _to_torch(v).to(like.device)
    return v


class Optimizer:
    """Base optimizer over ``torch.nn.Parameter``s (or groups of them)."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False, stochastic_rounding=False):
        if parameters is None:
            raise ValueError(
                "parameters must be provided (dygraph-style optimizer)")
        parameters = list(parameters)
        if parameters and isinstance(parameters[0], dict):
            self._param_groups, self._parameter_list = [], []
            for group in parameters:
                g = dict(group)
                g["params"] = list(g.pop("params"))
                self._parameter_list.extend(g["params"])
                self._param_groups.append(g)
        else:
            self._parameter_list = parameters
            self._param_groups = [{"params": self._parameter_list}]
        self._learning_rate = learning_rate
        if isinstance(weight_decay, float):
            weight_decay = L2Decay(weight_decay)
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
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
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value: float):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler: LRScheduler):
        self._learning_rate = scheduler

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

    def _decoupled_wd(self) -> bool:
        return False

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

    def _regularize(self, params_grads):
        """Each gradient plus its parameter's own regularizer, else the
        optimizer's coupled ``weight_decay``."""
        wd = self._weight_decay
        coupled = isinstance(wd, WeightDecayRegularizer) \
            and not self._decoupled_wd()
        out = []
        for p, g in params_grads:
            reg = getattr(p, "regularizer", None)
            if reg is None and coupled:
                reg = wd
            out.append((p, g if reg is None else reg(p.detach(), g)))
        return out

    def _apply_updates(self, params_grads):
        """The rule for every ``(param, grad)``, at this step's
        learning rate."""
        hyper = self._hyper()
        for p, g in params_grads:
            self._update(p, g, self._state_for(p), hyper,
                         self._per_param_hyper(p))

    def _apply_optimize(self, params_grads):
        params_grads = self._regularize(params_grads)
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._apply_updates(params_grads)

    @torch.no_grad()
    def step(self):
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.requires_grad and p.grad is not None]
        if params_grads:
            self._apply_optimize(params_grads)
        self._global_step += 1

    @torch.no_grad()
    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """``step()``: the gradients come from ``loss.backward()``, which
        the caller has run."""
        self.step()
        return None, None

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # ---------------- checkpointing ----------------
    def state_dict(self):
        """Copies of every state tensor, keyed ``"{name}_{key}"``, with
        the scheduler's state and the step count."""
        sd = OrderedDict()
        for p in self._parameter_list:
            st = self._accumulators.get(id(p))
            if not st:
                continue
            name = _param_key(p)
            for k, v in st.items():
                sd[f"{name}_{k}"] = v.detach().clone() \
                    if torch.is_tensor(v) else v
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        sd["global_step"] = self._global_step
        return sd

    def set_state_dict(self, state_dict):
        """Restore a ``state_dict()`` (tensors, or numpy arrays, copied
        onto each parameter's device). A parameter whose keys are partly
        missing keeps fresh state for them and warns; keys of no
        parameter warn; an O2 master absent from the checkpoint is
        derived from the parameter at the next step."""
        self._global_step = int(state_dict.get("global_step", 0))
        consumed = {"global_step"}
        if "LR_Scheduler" in state_dict:
            consumed.add("LR_Scheduler")
            if isinstance(self._learning_rate, LRScheduler):
                self._learning_rate.set_state_dict(
                    state_dict["LR_Scheduler"])
        for p in self._parameter_list:
            name = _param_key(p)
            st = self._init_state(p)
            found, missing = False, []
            for k in list(st):
                sk = f"{name}_{k}"
                if sk in state_dict:
                    st[k] = _restored(state_dict[sk], p)
                    consumed.add(sk)
                    found = True
                else:
                    missing.append(sk)
            mk = f"{name}__master"
            if mk in state_dict:
                st["_master"] = _restored(state_dict[mk], p)
                consumed.add(mk)
                found = True
            if found:
                self._accumulators[id(p)] = st
                if missing:
                    warnings.warn(
                        f"optimizer state for '{name}' partially restored;"
                        f" missing keys: {missing}")
        unexpected = [k for k in state_dict if k not in consumed]
        if unexpected:
            warnings.warn(
                f"optimizer set_state_dict: unexpected keys {unexpected[:8]}"
                + ("..." if len(unexpected) > 8 else ""))

    set_dict = set_state_dict


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _rule(self, p, g, state, hyper):
        return p - hyper["lr"] * g, state


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p.detach())}

    def _rule(self, p, g, state, hyper):
        v = self._momentum * state["velocity"] + g
        if self._use_nesterov:
            new_p = p - hyper["lr"] * (g + self._momentum * v)
        else:
            new_p = p - hyper["lr"] * v
        return new_p, {"velocity": v}


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._init_val = initial_accumulator_value

    def _init_state(self, p):
        return {"moment": torch.full_like(p.detach(), self._init_val)}

    def _rule(self, p, g, state, hyper):
        m = state["moment"] + g * g
        new_p = p - hyper["lr"] * g / (torch.sqrt(m) + self._epsilon)
        return new_p, {"moment": m}


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._rho = rho

    def _init_state(self, p):
        return {"avg_squared_grad": torch.zeros_like(p.detach()),
                "avg_squared_update": torch.zeros_like(p.detach())}

    def _rule(self, p, g, state, hyper):
        rho, eps = self._rho, self._epsilon
        asg = rho * state["avg_squared_grad"] + (1 - rho) * g * g
        update = g * torch.sqrt(state["avg_squared_update"] + eps) / \
            torch.sqrt(asg + eps)
        asu = rho * state["avg_squared_update"] + (1 - rho) * update * update
        return p - hyper["lr"] * update, \
            {"avg_squared_grad": asg, "avg_squared_update": asu}


class Rprop(Optimizer):
    """Resilient backpropagation: a per-element step size that grows by
    ``etas[1]`` (capped at ``learning_rate_range[1]``) while consecutive
    gradient signs agree and shrinks by ``etas[0]`` (floored at
    ``learning_rate_range[0]``) when they flip, which also suppresses
    that element's update for the step. ``learning_rate`` seeds the step
    sizes; the rule never reads the scalar lr again."""

    def __init__(self, learning_rate=0.001,
                 learning_rate_range=(1e-5, 50.0), parameters=None,
                 etas=(0.5, 1.2), grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, None, grad_clip,
                         name, multi_precision)
        self._lr_min, self._lr_max = map(float, learning_rate_range)
        self._eta_n, self._eta_p = map(float, etas)
        if not (0.0 < self._eta_n < 1.0 < self._eta_p):
            raise ValueError(f"etas must satisfy 0<eta-<1<eta+: {etas}")

    def _init_state(self, p):
        return {"prev_grad": torch.zeros_like(p.detach()),
                "learning_rate": torch.full_like(p.detach(), self.get_lr())}

    def _rule(self, p, g, state, hyper):
        prod = g * state["prev_grad"]
        lr = state["learning_rate"].to(p.dtype)
        lr = torch.where(prod > 0,
                         torch.clamp(lr * self._eta_p, max=self._lr_max),
                         torch.where(prod < 0,
                                     torch.clamp(lr * self._eta_n,
                                                 min=self._lr_min), lr))
        g_eff = torch.where(prod < 0, torch.zeros_like(g), g)
        new_p = p - lr * torch.sign(g_eff)
        return new_p, {"prev_grad": g_eff, "learning_rate": lr}


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _init_state(self, p):
        st = {"mean_square": torch.zeros_like(p.detach()),
              "momentum": torch.zeros_like(p.detach())}
        if self._centered:
            st["mean_grad"] = torch.zeros_like(p.detach())
        return st

    def _rule(self, p, g, state, hyper):
        rho, eps = self._rho, self._epsilon
        ms = rho * state["mean_square"] + (1 - rho) * g * g
        if self._centered:
            mg = rho * state["mean_grad"] + (1 - rho) * g
            denom = torch.sqrt(ms - mg * mg + eps)
        else:
            denom = torch.sqrt(ms + eps)
        mom = self._momentum * state["momentum"] + hyper["lr"] * g / denom
        new_state = {"mean_square": ms, "momentum": mom}
        if self._centered:
            new_state["mean_grad"] = mg
        return p - mom, new_state
