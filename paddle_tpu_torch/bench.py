"""The GPT training rung of the port (counterpart of the root ``bench.py``'s
``build_model`` / ``run_config``): GPT-3 1.3B pretraining tokens/s on one
H100.

``build_model`` makes the root bench's GPT (token + position embeddings,
pre-LN blocks of causal attention and a GELU MLP, a final LN and an
untied LM head) with the JAX model's parameter names, on the card unless
``device="cpu"``. ``run_config`` trains it through ``TrainStep`` in AMP
O2 (bf16 parameters, f32 norms) with AdamW and the rung's options, and
returns tokens/s, the parameter count, FLOPs per token
(``6N + 12·L·s·d``) and the step's figures, MFU among them, against
``H100_PEAK_BF16``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import nn
from .amp import decorate
from .core.device import resolve_device
from .core.generator import seed
from .distributed.fleet.recompute import recompute as _recompute
from .jit import TrainStep
from .nn import functional as F
from .optimizer import AdamW

__all__ = ["VOCAB", "_FAST", "LADDER", "S2048", "H100_PEAK_BF16",
           "build_model", "make_train_step", "rung_batch", "run_config",
           "flops_per_token"]

#: the root bench's recipe for the 1.3B rung on one chip: bf16 moments,
#: master-free stochastic-rounding updates, no recompute, bf16 logits
#: into the cross entropy
_FAST = {"moment_dtype": "bfloat16", "stochastic_rounding": True,
         "no_master": True, "remat": "none", "ce_bf16": True}
#: (name, d_model, n_layers, n_heads, seq, batch, options)
LADDER = [
    ("gpt3-1.3b", 2048, 24, 16, 1024, 4, dict(_FAST)),
    ("gpt-760m", 1536, 24, 16, 1024, 8, dict(_FAST)),
    ("gpt-350m", 1024, 24, 16, 1024, 8, dict(_FAST)),
]
#: the canonical GPT-3 1.3B context: the same tokens a step as the s1024
#: rung (b * s = 4096)
S2048 = ("gpt3-1.3b-s2048", 2048, 24, 16, 2048, 2, dict(_FAST))
VOCAB = 51200
#: dense bf16 tensor-core peak of one H100 SXM, FLOP/s (NVIDIA H100 data
#: sheet; it assumes the 700 W power limit)
H100_PEAK_BF16 = 989e12


class Block(nn.Layer):
    """Pre-LN transformer block: causal attention, then a GELU MLP."""

    def __init__(self, d_model, n_heads):
        super().__init__()
        self.n_heads = n_heads
        self.ln1 = nn.LayerNorm(d_model)
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.proj = nn.Linear(d_model, d_model)
        self.ln2 = nn.LayerNorm(d_model)
        self.fc1 = nn.Linear(d_model, 4 * d_model)
        self.fc2 = nn.Linear(4 * d_model, d_model)

    def forward(self, x):
        b, s, d = x.shape
        qkv = self.qkv(self.ln1(x)).reshape(
            b, s, 3, self.n_heads, d // self.n_heads)
        # strided views of one [b, s, 3, h, hd] tensor: the flash kernels
        # read them in place
        q, k, v = qkv.unbind(2)
        att = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        x = x + self.proj(att.reshape(b, s, d))
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x))))


class GPT(nn.Layer):
    def __init__(self, d_model, n_layers, n_heads, seq, recompute):
        super().__init__()
        self.recompute = recompute
        self.embed = nn.Embedding(VOCAB, d_model)
        self.pos = nn.Embedding(seq, d_model)
        self.blocks = nn.LayerList([Block(d_model, n_heads)
                                    for _ in range(n_layers)])
        self.norm = nn.LayerNorm(d_model)
        self.head = nn.Linear(d_model, VOCAB, bias_attr=False)

    def forward(self, ids, pos_ids):
        h = self.embed(ids) + self.pos(pos_ids)
        for blk in self.blocks:
            h = _recompute(blk, h) if self.recompute else blk(h)
        return self.head(self.norm(h))


def build_model(d_model, n_layers, n_heads, seq, recompute=True,
                remat="full", device=None):
    """The root bench's GPT in f32 on ``device`` (the card unless
    ``"cpu"``). ``remat``: ``"full"`` recomputes each block in the
    backward (when ``recompute``), ``"none"`` keeps every activation;
    ``"dots"`` (a JAX checkpoint policy) is not ported."""
    if remat == "dots":
        raise NotImplementedError(
            "remat='dots' (the saveable-dots checkpoint policy) comes with "
            "the selective-recompute slice of the port")
    if remat not in ("full", "none"):
        raise ValueError(f"remat must be 'full' or 'none', not {remat!r}")
    dev = resolve_device(device)
    with torch.device(dev):
        return GPT(d_model, n_layers, n_heads, seq,
                   recompute and remat != "none")


def flops_per_token(n_params: int, n_layers: int, seq: int,
                    d_model: int) -> int:
    """``6N + 12·L·s·d``: the dense parameters forward and backward plus
    the attention score and value products."""
    return 6 * n_params + 12 * n_layers * seq * d_model


def make_train_step(d_model, n_layers, n_heads, seq, opt_kwargs=None,
                    device=None):
    """``(model, TrainStep)`` as ``run_config`` builds them, from seed 0:
    AdamW (lr 1e-4, decay 0.01) with the rung's options, AMP O2 bf16,
    master weights unless ``no_master``; the loss is the cross entropy
    of the ``[b*s, VOCAB]`` logits, cast to f32 first unless
    ``ce_bf16``."""
    opt_kwargs = dict(opt_kwargs or {})
    master = not opt_kwargs.pop("no_master", False)
    remat = opt_kwargs.pop("remat", "full")
    ce_bf16 = opt_kwargs.pop("ce_bf16", False)
    seed(0)
    model = build_model(d_model, n_layers, n_heads, seq, remat=remat,
                        device=device)
    opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01,
                **opt_kwargs)
    model, opt = decorate(model, opt, level="O2", dtype="bfloat16",
                          master_weight=master)

    def loss_fn(logits, labels):
        flat = logits.reshape(-1, VOCAB)
        if not ce_bf16:
            flat = flat.float()
        return F.cross_entropy(flat, labels.reshape(-1))

    return model, TrainStep(model, loss_fn, opt)


def rung_batch(batch, seq, device):
    """``([ids, pos], [labels])`` of the root bench, from
    ``numpy.random.RandomState(0)``."""
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, VOCAB, (batch, seq)))
    pos = torch.from_numpy(np.tile(np.arange(seq), (batch, 1)))
    labels = torch.from_numpy(rng.randint(0, VOCAB, (batch, seq)))
    return ([ids.to(device), pos.to(device)], [labels.to(device)])


def run_config(name, d_model, n_layers, n_heads, seq, batch, steps,
               opt_kwargs=None, device=None):
    """Train the rung: one first step (the kernels' build included), then
    two windows of ``steps`` steps, the faster one timed (host clock,
    ended by reading the loss). Returns ``(tokens_per_sec, n_params,
    flops_per_token, stats)``, ``stats`` holding ``mfu`` (against
    ``H100_PEAK_BF16``), ``step_ms``, ``first_call_s`` and the final
    loss."""
    dev = resolve_device(device)
    model, step = make_train_step(d_model, n_layers, n_heads, seq,
                                  opt_kwargs, dev)
    inputs, labels = rung_batch(batch, seq, dev)
    float(step(inputs, labels))
    dt = float("inf")
    for _window in range(2):
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step(inputs, labels)
        final = float(loss)
        dt = min(dt, time.perf_counter() - t0)
    if not np.isfinite(final):
        raise RuntimeError(f"{name}: non-finite loss")
    n_params = sum(p.numel() for p in model.parameters())
    tokens_per_sec = steps * batch * seq / dt
    fpt = flops_per_token(n_params, n_layers, seq, d_model)
    stats = {"mfu": tokens_per_sec * fpt / H100_PEAK_BF16,
             "step_ms": dt / steps * 1e3,
             "first_call_s": step.first_call_seconds, "loss": final}
    return tokens_per_sec, n_params, fpt, stats
