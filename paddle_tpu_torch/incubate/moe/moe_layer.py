"""Mixture-of-Experts layer (counterpart of
``paddle_tpu/incubate/moe/moe_layer.py``).

Two formulations, with the JAX package's names, shapes and parameter
names:

- **no-drop ragged** (``capacity_factor=None`` on the stacked
  ``ExpertFFN``): ``nn.functional.grouped_gemm.moe_ffn_nodrop`` — fp32
  router, tokens stable-sorted by expert, two ragged grouped GEMMs
  (kernel B14 forward; B14's backward mode and B15 in the backward on
  the card), scatter-combine. No capacity, no dropped token;
- **capacity-factor (GShard einsum)**: top-k gate, capacity-bounded
  one-hot dispatch/combine tensors ``[T, E, C]``, einsum dispatch, the
  stacked expert FFN as two batched products (or a list of per-expert
  layers, the generic path), einsum combine. Over-capacity assignments
  drop (``moe.dropped_tokens``). Plain torch ops: no kernel.

Routing runs in fp32 on every path. ``aux_loss`` is the GShard
load-balance loss ``E * sum(mean prob * top-1 fraction)`` times the
gate's weight. Expert parallelism (``ep_mesh=``) comes with the
tensor/expert-parallel slice (ROADMAP A8).

Telemetry. An eager forward stamps ``moe.dropped_tokens``,
``moe.tokens_per_expert`` and ``moe.imbalance`` in
``profiler.stats``; that reads the expert counts back to the host. The
JAX package skips it under a trace, so its compiled ``TrainStep`` never
does it; the port's eager ``TrainStep`` marks its step
(``jit.train_step.in_train_step``) and the layer stamps nothing there,
so a training step does not sync on it once per layer.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as TF

from ...core.device import resolve_device
from ...core.flags import flag
from ...jit.train_step import in_train_step
from ...nn import initializer as I
from ...nn.functional.grouped_gemm import moe_ffn_nodrop
from ...nn.layer_base import Layer, LayerList
from ...profiler import stats as _stats

__all__ = ["MoELayer", "NaiveGate", "GShardGate", "SwitchGate",
           "ExpertFFN"]


def _stamping() -> bool:
    return _stats.is_enabled() and not in_train_step()


def _count_dropped(drop) -> None:
    """``moe.dropped_tokens`` += this forward's dropped assignments (a
    device read) on an eager forward outside a training step."""
    if _stamping():
        _stats.inc("moe.dropped_tokens", int(drop))


def _stamp_moe_stats(counts) -> None:
    """Each expert's assignment count into the
    ``moe.tokens_per_expert`` histogram and ``moe.imbalance`` = max /
    mean load (1.0 = balanced), on an eager forward outside a training
    step (a device read)."""
    if not _stamping():
        return
    c = [float(v) for v in counts.reshape(-1).tolist()]
    if not c:
        return
    for v in c:
        _stats.observe("moe.tokens_per_expert", v)
    mean = sum(c) / len(c)
    _stats.set_gauge("moe.imbalance", max(c) / mean if mean > 0 else 0.0)


def _act(h, activation):
    # the JAX package's gelu default: the tanh approximation
    return TF.gelu(h, approximate="tanh") if activation == "gelu" \
        else TF.relu(h)


class BaseGate(Layer):
    def __init__(self, d_model: int, num_experts: int, top_k: int):
        super().__init__()
        self.d_model = d_model
        self.num_experts = num_experts
        self.top_k = top_k
        self.weight = self.create_parameter(
            shape=[d_model, num_experts],
            default_initializer=I.XavierUniform())


class NaiveGate(BaseGate):
    """Top-k softmax gate, no auxiliary loss."""

    aux_loss_weight = 0.0


class GShardGate(BaseGate):
    """GShard gate: top-2 and the load-balancing aux loss."""

    def __init__(self, d_model, num_experts, top_k=2, capacity_factor=1.25):
        super().__init__(d_model, num_experts, top_k)
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = 1e-2


class SwitchGate(BaseGate):
    """Switch Transformer gate: top-1."""

    def __init__(self, d_model, num_experts, top_k=1, capacity_factor=1.25):
        super().__init__(d_model, num_experts, top_k)
        self.capacity_factor = capacity_factor
        self.aux_loss_weight = 1e-2


class ExpertFFN(Layer):
    """Stacked-expert FFN: ``w1 [E, d, d_hidden]``, ``b1 [E, 1,
    d_hidden]``, ``w2 [E, d_hidden, d]``, ``b2 [E, 1, d]``, so the bank is
    two batched (or ragged grouped) products."""

    def __init__(self, num_experts, d_model, d_hidden, activation="gelu"):
        super().__init__()
        self.w1 = self.create_parameter(
            shape=[num_experts, d_model, d_hidden],
            default_initializer=I.XavierUniform())
        self.b1 = self.create_parameter(
            shape=[num_experts, 1, d_hidden], is_bias=True)
        self.w2 = self.create_parameter(
            shape=[num_experts, d_hidden, d_model],
            default_initializer=I.XavierUniform())
        self.b2 = self.create_parameter(
            shape=[num_experts, 1, d_model], is_bias=True)
        self.activation = activation


def _top_k(probs, k: int):
    """The first ``k`` of a stable descending sort: ties to the lower
    index, as the JAX package's ``lax.top_k``."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _gshard_dispatch(probs, E: int, K: int, capacity: int):
    """GShard top-K dispatch with capacity, differentiable through the
    combine weights. Returns ``(combine, dispatch, aux, dropped,
    counts)``: ``[T, E, C]`` in probs' dtype, the load-balance loss,
    the int count of assignments the capacity dropped, and each expert's
    routed assignments (int32 ``[E]``, before the bound). Pass ``k``'s
    slots continue after pass ``k-1``'s (a running per-expert base); the
    slot bookkeeping runs in fp32."""
    T = probs.shape[0]
    topk_val, topk_idx = _top_k(probs, K)
    topk_val = topk_val / topk_val.sum(-1, keepdim=True)
    combine = torch.zeros((T, E, capacity), dtype=probs.dtype,
                          device=probs.device)
    dispatch = torch.zeros_like(combine)
    base = torch.zeros(E, dtype=torch.float32, device=probs.device)
    dropped = torch.zeros((), dtype=torch.int32, device=probs.device)
    for k in range(K):
        onehot = TF.one_hot(topk_idx[:, k], E).float()         # [T, E]
        pos_in_e = (torch.cumsum(onehot, 0) - 1 + base[None]) * onehot
        pos = pos_in_e.sum(-1).to(torch.int32)                  # [T]
        keep = pos < capacity
        dropped = dropped + (T - keep.sum(dtype=torch.int32))
        cap_onehot = TF.one_hot(pos.clamp(0, capacity - 1).long(),
                                capacity).to(probs.dtype)       # [T, C]
        mask = onehot.to(probs.dtype) * keep[:, None].to(probs.dtype)
        disp_k = mask[:, :, None] * cap_onehot[:, None, :]      # [T, E, C]
        dispatch = dispatch + disp_k
        combine = combine + disp_k * topk_val[:, k][:, None, None]
        base = base + onehot.sum(0)
    aux = _aux_loss(probs, topk_idx[:, 0], E)
    return combine, dispatch, aux, dropped, base.to(torch.int32)


def _aux_loss(probs, top1, E: int):
    """GShard load balance: ``E * sum_e(mean prob_e * top-1 share_e)``."""
    me = probs.mean(0)
    ce = TF.one_hot(top1.long(), E).to(probs.dtype).mean(0)
    return (me * ce).sum() * E


class MoELayer(Layer):
    """The JAX package's ``MoELayer``: ``experts`` an ``ExpertFFN`` (or
    ``num_experts``/``d_hidden`` to build one: the stacked path) or a
    list of per-expert layers (the generic path); ``gate`` a gate or one
    of ``"naive"``, ``"gshard"``, ``"switch"``; ``capacity_factor=None``
    the no-drop path. Its parameters are made on ``device`` (the card
    unless ``"cpu"``); ``moe_group``, ``mp_group`` and
    ``recompute_interval`` are accepted and unused, as there."""

    def __init__(self, d_model: int, experts=None, gate="gshard",
                 num_experts: Optional[int] = None, top_k: int = 2,
                 d_hidden: Optional[int] = None, capacity_factor=1.25,
                 moe_group=None, mp_group=None, recompute_interval=0,
                 ep_mesh=None, name=None, device=None):
        super().__init__()
        if ep_mesh is not None:
            raise NotImplementedError(
                "MoELayer(ep_mesh=...) (the all_to_all expert-parallel "
                "dispatch) comes with the tensor/expert-parallel slice of "
                "the port (ROADMAP A8)")
        with torch.device(resolve_device(device)):
            if isinstance(experts, (list, LayerList)):
                self.experts = LayerList(list(experts))
                num_experts = len(self.experts)
                self.stacked = None
            else:
                if num_experts is None:
                    raise ValueError("MoELayer: pass num_experts (or an "
                                     "ExpertFFN or a list of experts)")
                self.stacked = experts if isinstance(experts, ExpertFFN) \
                    else ExpertFFN(num_experts, d_model,
                                   d_hidden or 4 * d_model)
                self.experts = None
            if isinstance(gate, str):
                gate_cls = {"naive": NaiveGate, "gshard": GShardGate,
                            "switch": SwitchGate}[gate]
                if gate_cls is SwitchGate:
                    top_k = 1
                self.gate = gate_cls(d_model, num_experts, top_k) \
                    if gate_cls is NaiveGate else \
                    gate_cls(d_model, num_experts, top_k=top_k,
                             capacity_factor=capacity_factor)
            else:
                self.gate = gate
        self.num_experts = num_experts
        self.d_model = d_model
        self.top_k = self.gate.top_k
        self.capacity_factor = getattr(self.gate, "capacity_factor",
                                       capacity_factor)
        self.aux_loss: Optional[torch.Tensor] = None

    def _set_aux(self, aux):
        w = getattr(self.gate, "aux_loss_weight", 0.0)
        self.aux_loss = aux * w if w else aux

    def _nodrop_forward(self, x):
        """The no-drop stacked path: fp32 router, stable sort by expert,
        the ragged grouped-GEMM FFN, scatter-combine."""
        E, st = self.num_experts, self.stacked
        y, probs, topk_idx, counts = moe_ffn_nodrop(
            x.reshape(-1, self.d_model), self.gate.weight, st.w1,
            st.b1.reshape(E, -1), st.w2, st.b2.reshape(E, -1),
            top_k=self.top_k, activation=st.activation,
            backend=flag("moe_grouped_backend"))
        self._set_aux(_aux_loss(probs, topk_idx[:, 0], E))
        # no-drop by construction: the counter moves by exactly 0
        _count_dropped(0)
        _stamp_moe_stats(counts)
        return y.reshape(x.shape)

    def forward(self, x):
        orig_shape = x.shape
        d = self.d_model
        tokens = math.prod(orig_shape[:-1])
        E, K = self.num_experts, self.top_k
        if self.capacity_factor is None:
            if self.stacked is None:
                raise ValueError(
                    "no-drop MoE (capacity_factor=None) needs the "
                    "stacked ExpertFFN form — heterogeneous per-expert "
                    "Layers still route through the capacity-bounded "
                    "dispatch")
            return self._nodrop_forward(x)
        capacity = max(int(math.ceil(tokens * K * self.capacity_factor
                                     / E)), 1)
        xt = x.reshape(tokens, d)
        probs = torch.softmax(xt.float() @ self.gate.weight.float(), -1)
        combine, dispatch, aux, drop, cnt = _gshard_dispatch(
            probs, E, K, capacity)
        combine, dispatch = combine.to(xt.dtype), dispatch.to(xt.dtype)
        exp_in = torch.einsum("tec,td->ecd", dispatch, xt)     # [E, C, d]
        if self.stacked is not None:
            st = self.stacked
            h = _act(exp_in @ st.w1 + st.b1, st.activation)
            exp_out = h @ st.w2 + st.b2
        else:
            exp_out = torch.stack([expert(exp_in[e]) for e, expert
                                   in enumerate(self.experts)], 0)
        out = torch.einsum("tec,ecd->td", combine, exp_out)
        self._set_aux(aux)
        _count_dropped(drop)
        _stamp_moe_stats(cnt)
        return out.reshape(orig_shape)
