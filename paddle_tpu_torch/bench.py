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

``run_attn_varlen_bench`` is the root bench's ``--attn-varlen`` rung: a
32,768-token causal pack through the packed varlen flash kernel (B11).

``build_moe_model`` / ``run_moe_train_bench`` are the root bench's
``--moe-train`` rung: the GPT with each block's FFN a no-drop
``MoELayer`` (GShard gate, top-2, ``capacity_factor=None``), trained in
AMP O2 with AdamW (bf16 moments, f32 master weights) through the ragged
grouped GEMM forward (B14) and backward (B14's backward mode, B15) and
flash attention (B10); MFU charges the activated FLOPs (the dense
parameters plus ``top_k / E`` of the expert banks).

``make_bert_train_step`` / ``run_bert_bench`` are the root bench's
``--bert`` rung: BERT-base pretraining (``text.models``, d768, 12
layers, 12 heads, dff 3072, vocab 30,522) at batch 32 of 512 tokens, no
attention mask and no attention dropout, so each layer's attention takes
the flash route (B10), in AMP O2 bf16 with AdamW (bf16 moments).

``build_bert_infer_model`` / ``run_bert_infer_bench`` are BERT-base
inference through the deployment path: the bf16 ``BertModel`` saved by
``jit.save`` at batch 32 of 384 tokens (B10's route), loaded by
``inference.create_predictor`` and timed by ``run()``.

``python -m paddle_tpu_torch.bench
--attn-varlen|--moe-train|--bert|--bert-infer [--device cpu]`` prints a
rung's JSON line.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import nn
from .amp import decorate
from .core.device import resolve_device
from .core.generator import seed
from .core.place import device_guard
from .distributed.fleet.recompute import checkpoint_policies
from .distributed.fleet.recompute import recompute as _recompute
from .jit import TrainStep
from .nn import functional as F
from .optimizer import AdamW
from .profiler import stats as _stats

__all__ = ["VOCAB", "_FAST", "LADDER", "S2048", "H100_PEAK_BF16",
           "build_model", "make_train_step", "rung_batch", "run_config",
           "flops_per_token", "run_attn_varlen_bench", "build_moe_model",
           "make_moe_train_step", "moe_nodrop_pin", "run_moe_train_bench",
           "moe_param_counts", "moe_flops_per_token", "BERT_VOCAB",
           "make_bert_train_step", "bert_batch", "run_bert_bench",
           "BERT_INFER_BATCH", "BERT_INFER_SEQ", "build_bert_infer_model",
           "bert_infer_batch", "run_bert_infer_bench", "main"]

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
    """Pre-LN transformer block: causal attention, then a GELU MLP, or
    with ``num_experts`` a no-drop MoE FFN (``moe``, the root bench's
    MoE block: GShard gate, ``d_hidden = 4 * d_model``)."""

    def __init__(self, d_model, n_heads, num_experts=None, top_k=2,
                 device=None):
        super().__init__()
        self.n_heads = n_heads
        self.ln1 = nn.LayerNorm(d_model)
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.proj = nn.Linear(d_model, d_model)
        self.ln2 = nn.LayerNorm(d_model)
        self.moe = None
        if num_experts:
            from .incubate.moe import MoELayer

            self.moe = MoELayer(d_model, num_experts=num_experts,
                                gate="gshard", top_k=top_k,
                                d_hidden=4 * d_model, capacity_factor=None,
                                device=device)
        else:
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
        h = self.ln2(x)
        if self.moe is not None:
            return x + self.moe(h)
        return x + self.fc2(F.gelu(self.fc1(h)))


class GPT(nn.Layer):
    def __init__(self, d_model, n_layers, n_heads, seq, recompute,
                 num_experts=None, top_k=2, device=None, remat_policy=None):
        super().__init__()
        self.recompute = recompute
        self.remat_policy = remat_policy
        self.embed = nn.Embedding(VOCAB, d_model)
        self.pos = nn.Embedding(seq, d_model)
        self.blocks = nn.LayerList([Block(d_model, n_heads, num_experts,
                                          top_k, device)
                                    for _ in range(n_layers)])
        self.norm = nn.LayerNorm(d_model)
        self.head = nn.Linear(d_model, VOCAB, bias_attr=False)

    def forward(self, ids, pos_ids):
        h = self.embed(ids) + self.pos(pos_ids)
        for blk in self.blocks:
            h = _recompute(blk, h, policy=self.remat_policy) \
                if self.recompute else blk(h)
        return self.head(self.norm(h))


def build_model(d_model, n_layers, n_heads, seq, recompute=True,
                remat="full", device=None):
    """The root bench's GPT in f32 on ``device`` (the card unless
    ``"cpu"``). ``remat``: ``"full"`` recomputes each block in the
    backward (when ``recompute``), ``"dots"`` keeps each block's linear
    products and recomputes the rest
    (``checkpoint_policies.dots_with_no_batch_dims_saveable``),
    ``"none"`` keeps every activation."""
    if remat not in ("full", "dots", "none"):
        raise ValueError(
            f"remat must be 'full', 'dots' or 'none', not {remat!r}")
    policy = checkpoint_policies.dots_with_no_batch_dims_saveable \
        if remat == "dots" else None
    dev = resolve_device(device)
    with torch.device(dev):
        return GPT(d_model, n_layers, n_heads, seq,
                   recompute and remat != "none", remat_policy=policy)


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


def run_attn_varlen_bench(device=None):
    """The varlen flash-attention rung of the root bench: a long causal
    pack through ``flash_varlen_packed``'s forward, one warm-up call (the
    kernels' build included) and ``iters`` timed calls (host clock ended
    by a synchronise). On the card: 16 heads of 128 in bf16, 8 segments
    of 4096 (T = 32,768), 20 calls; on the CPU (only when asked for):
    2 heads of 64 in f32, 4 segments of 512, 3 calls. Returns
    ``(tokens_per_sec, peak_bytes, total_tokens, backend)``:
    ``peak_bytes`` is ``torch.cuda.max_memory_allocated()`` over the timed
    calls, inputs included (O(T·d): a dense path would need a ``[h, T,
    T]`` f32 logits tensor, 68.7 GB at the rung), None on the CPU;
    ``backend`` is ``"cuda"`` (kernel B11) or ``"plain"``."""
    from .nn.functional.flash_varlen import flash_varlen_packed

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        h, d, dtype = 16, 128, torch.bfloat16
        lens, iters = [4096] * 8, 20
    else:
        h, d, dtype = 2, 64, torch.float32
        lens, iters = [512] * 4, 3
    total = int(sum(lens))
    cu = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)])
                          .astype(np.int32)).to(dev)
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(total, h, d).astype(np.float32)) \
        .to(dev, dtype)

    def call():
        return flash_varlen_packed(q, q, q, cu, cu, causal=True)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    call()
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = call()
    sync()
    dt = time.perf_counter() - t0
    if not torch.isfinite(out[:8].float()).all():
        raise RuntimeError("attn-varlen bench: non-finite output")
    peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    return iters * total / dt, peak, total, "cuda" if on_card else "plain"


def build_moe_model(d_model, n_layers, n_heads, seq, num_experts,
                    top_k=2, device=None):
    """The root bench's GPT-MoE in f32 on ``device`` (the card unless
    ``"cpu"``): the GPT with each block's dense FFN a no-drop
    ``MoELayer`` (``capacity_factor=None``), no recompute."""
    dev = resolve_device(device)
    with torch.device(dev):
        return GPT(d_model, n_layers, n_heads, seq, False, num_experts,
                   top_k, dev)


def moe_param_counts(model, d_model, n_layers, num_experts, top_k=2):
    """``(n_params, n_active)`` by the root bench's formula: the expert
    banks (``w1``, ``b1``, ``w2``, ``b2`` of every block) count
    ``top_k / E`` toward the activated parameters."""
    n_params = sum(p.numel() for p in model.parameters())
    dff = 4 * d_model
    bank = n_layers * num_experts * (2 * d_model * dff + dff + d_model)
    return n_params, n_params - bank + bank * top_k // num_experts


def make_moe_train_step(d_model, n_layers, n_heads, seq, num_experts,
                        top_k=2, device=None):
    """``(model, TrainStep)`` of the MoE rung, from seed 0: AdamW (lr
    1e-4, decay 0.01, bf16 moments), AMP O2 bf16 with f32 master
    weights, the cross entropy of the bf16 ``[b*s, VOCAB]`` logits."""
    seed(0)
    model = build_moe_model(d_model, n_layers, n_heads, seq, num_experts,
                            top_k, device)
    opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01,
                moment_dtype="bfloat16")
    model, opt = decorate(model, opt, level="O2", dtype="bfloat16")

    def loss_fn(logits, labels):
        return F.cross_entropy(logits.reshape(-1, VOCAB), labels.reshape(-1))

    return model, TrainStep(model, loss_fn, opt)


def moe_nodrop_pin(model, inputs) -> None:
    """One eager forward without gradient: it stamps the ``moe.*``
    routing telemetry, which a ``TrainStep`` skips, and raises if
    ``moe.dropped_tokens`` moved (the no-drop mode dropped a token)."""
    drop0 = _stats.counter("moe.dropped_tokens").value
    with torch.no_grad():
        model(*inputs)
    if _stats.counter("moe.dropped_tokens").value != drop0:
        raise RuntimeError("moe-train rung: no-drop mode dropped tokens "
                           "(moe.dropped_tokens moved)")


def run_moe_train_bench(d_model, n_layers, n_heads, seq, batch,
                        num_experts, top_k=2, steps=8, device=None):
    """The no-drop MoE training rung (``make_moe_train_step``): the
    no-drop pin (``moe_nodrop_pin``), one step (the kernels' build
    included), then ``steps`` steps timed on the host clock, ended by
    reading the loss. Returns ``(tokens_per_s, mfu, n_active,
    n_params)``; MFU charges ``6 * n_active + 12 * L * s * d`` FLOPs a
    token against ``H100_PEAK_BF16``, and is None on the CPU."""
    dev = resolve_device(device)
    model, step = make_moe_train_step(d_model, n_layers, n_heads, seq,
                                      num_experts, top_k, dev)
    inputs, labels = rung_batch(batch, seq, dev)
    moe_nodrop_pin(model, inputs)
    float(step(inputs, labels))
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(inputs, labels)
    final = float(loss)
    dt = time.perf_counter() - t0
    if not np.isfinite(final):
        raise RuntimeError("moe-train rung: non-finite loss")
    n_params, n_active = moe_param_counts(model, d_model, n_layers,
                                          num_experts, top_k)
    tps = steps * batch * seq / dt
    mfu = tps * moe_flops_per_token(n_active, n_layers, seq, d_model) \
        / H100_PEAK_BF16 if dev.type == "cuda" else None
    return tps, mfu, n_active, n_params


def moe_flops_per_token(n_active: int, n_layers: int, seq: int,
                        d_model: int) -> int:
    """The root bench's activated FLOPs a token: ``6 * n_active + 12 *
    L * s * d``."""
    return 6 * n_active + 12 * n_layers * seq * d_model


#: bert-base's vocabulary (bert-base-uncased)
BERT_VOCAB = 30522


def make_bert_train_step(seq=512, device=None, amp="O2"):
    """``(model, TrainStep)`` of the BERT rung on ``device``, from seed
    0: ``BertForPretraining(bert_base(max_position_embeddings=seq,
    attention_probs_dropout_prob=0.0))``, its criterion, AdamW (lr 1e-4,
    decay 0.01, bf16 moments), and with ``amp="O2"`` the model decorated
    to bf16 (f32 master weights); ``amp=None`` keeps it all in f32. The
    model's forward makes its position ids on the current place: call
    the step inside ``device_guard(device)``."""
    from .text.models import (BertForPretraining, BertPretrainingCriterion,
                              bert_base)

    dev = resolve_device(device)
    seed(0)
    with torch.device(dev), device_guard(dev):
        model = BertForPretraining(bert_base(
            max_position_embeddings=seq, attention_probs_dropout_prob=0.0))
    opt = AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01,
                moment_dtype="bfloat16")
    if amp == "O2":
        model, opt = decorate(model, opt, level="O2", dtype="bfloat16")
    return model, TrainStep(model, BertPretrainingCriterion(), opt)


def bert_batch(batch, seq, device):
    """``([ids, token_types], [mlm_labels, nsp_labels])`` of the root
    bench's BERT rung, from ``numpy.random.RandomState(0)``: 15% of the
    positions labelled for the masked LM (-100 elsewhere)."""
    rng = np.random.RandomState(0)
    ids = rng.randint(0, BERT_VOCAB, (batch, seq))
    types = rng.randint(0, 2, (batch, seq))
    mlm = np.where(rng.rand(batch, seq) < 0.15,
                   rng.randint(0, BERT_VOCAB, (batch, seq)), -100)
    nsp = rng.randint(0, 2, (batch,))
    return ([torch.from_numpy(a).to(device) for a in (ids, types)],
            [torch.from_numpy(a).to(device) for a in (mlm, nsp)])


def run_bert_bench(batch=32, seq=512, steps=8, device=None, warmup=2):
    """The BERT rung (``make_bert_train_step``): ``warmup`` steps (the
    kernels' build included), then ``steps`` steps timed on the host
    clock, ended by reading the loss. Returns ``(tokens_per_s, mfu,
    stats)``: MFU charges ``6 * N + 12 * L * s * d`` FLOPs a token against
    ``H100_PEAK_BF16`` (None on the CPU); ``stats`` holds ``step_ms``,
    ``n_params``, ``first_call_s`` and the losses."""
    dev = resolve_device(device)
    model, step = make_bert_train_step(seq, dev)
    inputs, labels = bert_batch(batch, seq, dev)
    with device_guard(dev):
        losses = [float(step(inputs, labels)) for _ in range(warmup)]
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step(inputs, labels)
        losses.append(float(loss))
        dt = time.perf_counter() - t0
    if not np.isfinite(losses).all():
        raise RuntimeError(f"bert rung: non-finite loss {losses}")
    n_params = sum(p.numel() for p in model.parameters())
    tps = steps * batch * seq / dt
    mfu = tps * flops_per_token(n_params, 12, seq, 768) / H100_PEAK_BF16 \
        if dev.type == "cuda" else None
    return tps, mfu, {"step_ms": dt / steps * 1e3, "n_params": n_params,
                      "first_call_s": step.first_call_seconds,
                      "losses": losses}


#: the BERT inference rung's batch and length: 32 sequences of 384
#: tokens, the BERT paper's SQuAD length (3 x 128: B10's route)
BERT_INFER_BATCH, BERT_INFER_SEQ = 32, 384


def build_bert_infer_model(device=None, dtype=torch.bfloat16, **geometry):
    """The BERT inference rung's model, from seed 0: ``text.models``'s
    ``BertModel`` at bert-base's geometry (``bert_base``; ``geometry``
    overrides it, e.g. for a CPU-sized run) in ``dtype``, in eval mode,
    on ``device``."""
    from .text.models import BertModel, bert_base

    dev = resolve_device(device)
    seed(0)
    with torch.device(dev), device_guard(dev):
        model = BertModel(**geometry) if geometry else bert_base()
    return model.to(dtype).eval()


def bert_infer_batch(batch, seq, vocab=BERT_VOCAB):
    """``(input_ids, token_type_ids)`` int64 numpy arrays of the rung,
    from ``numpy.random.RandomState(1)``."""
    rng = np.random.RandomState(1)
    return (rng.randint(0, vocab, (batch, seq)).astype(np.int64),
            rng.randint(0, 2, (batch, seq)).astype(np.int64))


def run_bert_infer_bench(batch=BERT_INFER_BATCH, seq=BERT_INFER_SEQ, runs=10,
                         warmup=2, device=None, model=None, counters=None):
    """BERT inference through the deployment path: ``model`` (default
    ``build_bert_infer_model(device)``) saved by ``jit.save`` with
    ``InputSpec([batch, seq], "int64")`` for ``input_ids`` and
    ``token_type_ids`` into a temporary directory, loaded by
    ``inference.Config`` -> ``create_predictor`` (the card, or the CPU
    after ``disable_gpu()`` when ``device`` is the CPU), then
    ``warmup`` runs and ``runs`` timed ones, each ended by
    ``copy_to_cpu`` of both outputs, and as many eager ``no_grad``
    forwards of the model ended alike (``inference.to_host``).
    ``counters`` (a function returning the kernels' launch counts) is
    read around the save and the timed runs. Returns a dict:
    ``export_s``, ``artifact_mb``, ``run_ms`` (per run), ``eager_ms``,
    ``seqs_per_s``, ``tokens_per_s`` (by the median run), ``outputs`` (the last
    run's, numpy), ``predictor``, ``model``, the input arrays, and with
    ``counters`` the launch deltas ``save_launches`` and ``run_launches`` (all
    timed runs)."""
    import os
    import tempfile

    from . import jit
    from .inference import Config, create_predictor, to_host
    from .static import InputSpec

    dev = resolve_device(device)
    if model is None:
        model = build_bert_infer_model(dev)
    model.eval()
    ids, types = bert_infer_batch(batch, seq,
                                  model.embeddings.word_embeddings
                                  .weight.shape[0])

    def delta(before):
        after = counters()
        return {k: after[k] - before.get(k, 0) for k in after
                if after[k] != before.get(k, 0)}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bert")
        before = counters() if counters else None
        t0 = time.perf_counter()
        jit.save(model, path, input_spec=[
            InputSpec([batch, seq], "int64", "input_ids"),
            InputSpec([batch, seq], "int64", "token_type_ids")])
        export_s = time.perf_counter() - t0
        stats = {"save_launches": delta(before)} if counters else {}
        artifact_mb = sum(os.path.getsize(path + ext)
                          for ext in (".pdmodel", ".pdiparams")) / 1e6
        config = Config(path)
        if dev.type != "cuda":
            config.disable_gpu()
        predictor = create_predictor(config)
    for name, arr in zip(predictor.get_input_names(), (ids, types)):
        predictor.get_input_handle(name).copy_from_cpu(arr)

    def run():
        predictor.run()
        return [predictor.get_output_handle(n).copy_to_cpu()
                for n in predictor.get_output_names()]

    for _ in range(warmup):
        run()
    before = counters() if counters else None
    run_ms = []
    for _ in range(runs):
        t0 = time.perf_counter()
        outputs = run()
        run_ms.append((time.perf_counter() - t0) * 1e3)
    if counters:
        stats["run_launches"] = delta(before)
    tid, ttype = (torch.from_numpy(a).to(dev) for a in (ids, types))
    eager_ms = []
    with torch.no_grad(), device_guard(dev):
        for i in range(warmup + runs):
            t0 = time.perf_counter()
            [to_host(o) for o in model(tid, ttype)]
            if i >= warmup:
                eager_ms.append((time.perf_counter() - t0) * 1e3)
    median = float(np.median(run_ms)) / 1e3
    stats.update({"export_s": export_s, "artifact_mb": artifact_mb,
                  "run_ms": run_ms, "eager_ms": eager_ms,
                  "seqs_per_s": batch / median,
                  "tokens_per_s": batch * seq / median,
                  "outputs": outputs, "predictor": predictor, "model": model,
                  "inputs": (ids, types)})
    return stats


def main(argv=None) -> None:
    """The port's bench kinds (so far ``--attn-varlen``, ``--moe-train``,
    ``--bert`` and ``--bert-infer``), one JSON line each; ``--device
    cpu`` runs the CPU-sized geometry."""
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.bench")
    kind = ap.add_mutually_exclusive_group(required=True)
    kind.add_argument("--attn-varlen", action="store_true",
                      help="the packed varlen flash-attention rung")
    kind.add_argument("--moe-train", action="store_true",
                      help="the no-drop MoE training rung")
    kind.add_argument("--bert", action="store_true",
                      help="the BERT-base pretraining rung")
    kind.add_argument("--bert-infer", action="store_true",
                      help="BERT-base inference: jit.save -> predictor")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the CPU geometry (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if args.bert_infer:
        # the card: bert-base at b32 s384; the CPU: a smoke geometry
        if dev.type == "cuda":
            stats = run_bert_infer_bench(device=dev)
        else:
            stats = run_bert_infer_bench(
                batch=2, seq=128, runs=1, warmup=1, device=dev,
                model=build_bert_infer_model(
                    dev, torch.float32, vocab_size=128, hidden_size=64,
                    num_hidden_layers=2, num_attention_heads=4,
                    intermediate_size=128))
        print(json.dumps({
            "bert_infer_tokens_per_sec": stats["tokens_per_s"],
            "bert_infer_run_ms": float(np.median(stats["run_ms"])),
            "bert_infer_eager_ms": float(np.median(stats["eager_ms"])),
            "bert_infer_export_s": stats["export_s"],
            "bert_infer_artifact_mb": stats["artifact_mb"],
            "device": name}))
        return
    if args.bert:
        # the card: the root rung (b32, s512); the CPU: a smoke geometry
        geo = dict(batch=32, seq=512) if dev.type == "cuda" else \
            dict(batch=2, seq=128, steps=1, warmup=1)
        tps, mfu, stats = run_bert_bench(**geo, device=dev)
        print(json.dumps({"bert_tokens_per_sec": tps, "bert_mfu": mfu,
                          "bert_step_ms": stats["step_ms"],
                          "bert_params": stats["n_params"],
                          "device": name}))
        return
    if args.moe_train:
        # the card: the root rung's ~1B-parameter 8-expert model; the
        # CPU: the root bench's smoke geometry
        geo = (dict(d_model=1024, n_layers=12, n_heads=16, seq=1024,
                    batch=4, num_experts=8) if dev.type == "cuda" else
               dict(d_model=64, n_layers=2, n_heads=4, seq=64, batch=2,
                    num_experts=4, steps=2))
        tps, mfu, n_active, n_params = run_moe_train_bench(**geo,
                                                           device=dev)
        snap = _stats.snapshot("moe.")
        print(json.dumps({
            "moe_train_tokens_per_sec": tps, "moe_train_mfu": mfu,
            "moe_train_params": n_params,
            "moe_train_activated_params": n_active,
            "moe_train_telemetry": {k: snap[k] for k in
                                    ("counters", "gauges", "histograms")},
            "device": name}))
        return
    tps, peak, total, backend = run_attn_varlen_bench(dev)
    print(json.dumps({
        "attn_varlen_tokens_per_sec": tps, "attn_varlen_peak_bytes": peak,
        "attn_varlen_total_tokens": total, "attn_varlen_backend": backend,
        "device": name}))


if __name__ == "__main__":
    main()
