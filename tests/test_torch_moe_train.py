"""Parity of the port's MoE training rung with the root bench's.

The GPT with a no-drop MoE FFN in every block is built at the root
bench's CPU geometry of ``--moe-train`` (d_model 64, 2 layers, 4 heads,
seq 64, batch 2, 4 experts, top-2, the rung's vocab of 51200) by the
root ``bench.build_moe_model`` (JAX) and by
``paddle_tpu_torch.bench.build_moe_model``; the JAX weights are carried
over with ``load_jax_params`` and both see the root bench's batch
(``RandomState(0)``).

- Before any float is compared, every layer's router picks the same
  experts on both sides, and every token's top-3 probabilities are
  apart by at least 1e-5 (far above the f32 difference of the two
  routers' inputs), so no near-tie can flip a route.
- f32: logits and loss within 1e-5 of the largest value; every gradient
  within 1e-4 of its largest value (as the dense rung's test: sums over
  the 51200-wide head in another order). The JAX gradients come from one
  JAX ``TrainStep`` with SGD at learning rate 1e3, ``g = (p0 - p1) /
  1e3``, so the JAX step is compiled once rather than taped eagerly.
- 3 AdamW steps (lr 1e-3) through each ``TrainStep``: losses within
  1e-5 relative.
- AMP O2 with the rung's options (bf16 moments, f32 master weights, bf16
  logits into the cross entropy): the 3-step loss trajectory within 1e-4
  of the loss (bf16 rounding at other places).
"""
import math
import os
import sys

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.nn.functional import grouped_gemm as jgg
from paddle_tpu_torch import bench as tbench
from paddle_tpu_torch.amp import decorate as t_decorate
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.incubate.moe import moe_layer as tmoe
from paddle_tpu_torch.jit import TrainStep as TTrainStep
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import AdamW as TAdamW

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import bench as jbench  # noqa: E402  (the root bench: the JAX rung)

D, L, H, S, B, E, TOPK = 64, 2, 4, 64, 2, 4, 2
VOCAB = jbench.VOCAB
STEPS, LR, SGD_LR = 3, 1e-3, 1e3
MARGIN = 1e-5


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, VOCAB, (B, S))
    pos = np.tile(np.arange(S), (B, 1))
    labels = rng.randint(0, VOCAB, (B, S))
    return ids, pos, labels


def _jax_model():
    paddle.seed(0)
    return jbench.build_moe_model(D, L, H, S, E, TOPK)


def _params(jmodel):
    return {n: np.array(p._data) for n, p in jmodel.state_dict().items()}


def _port_model(params):
    model = tbench.build_moe_model(D, L, H, S, E, TOPK, device="cpu")
    load_jax_params(model, {n: a.copy() for n, a in params.items()})
    return model


def _jax_loss(logits, labels):
    return JF.cross_entropy(logits.reshape([-1, VOCAB]),
                            labels.reshape([-1]))


def _port_loss(logits, labels):
    return TF.cross_entropy(logits.reshape(-1, VOCAB), labels.reshape(-1))


@pytest.fixture(scope="module")
def runs():
    ids, pos, labels = _batch()
    jin = [paddle.to_tensor(ids), paddle.to_tensor(pos)]
    jlab = paddle.to_tensor(labels)
    tin = [torch.from_numpy(ids), torch.from_numpy(pos)]
    tlab = torch.from_numpy(labels)
    jmodel = _jax_model()
    params = _params(jmodel)
    out = {"params": params, "jax": {}, "port": {}}
    # JAX: logits and each layer's routes from one compiled forward
    routes = []

    def record(probs, idx):
        routes.append((np.asarray(probs), np.asarray(idx)))

    real = jgg.moe_ffn_nodrop

    def recording(*a, **k):
        res = real(*a, **k)
        jax.debug.callback(record, res[1], res[2])
        return res
    jgg.moe_ffn_nodrop = recording
    try:
        out["jax"]["logits"] = np.asarray(
            paddle.jit.to_static(jmodel)(*jin)._data)
    finally:
        jgg.moe_ffn_nodrop = real
    out["jax"]["routes"] = routes
    # JAX: loss and gradients from one SGD step, g = (p0 - p1) / lr
    jstep = paddle.jit.TrainStep(
        jmodel, _jax_loss, paddle.optimizer.SGD(
            SGD_LR, parameters=jmodel.parameters()))
    out["jax"]["loss"] = float(jstep(jin, [jlab]).numpy())
    out["jax"]["grads"] = {n: (params[n] - np.asarray(p._data)) / SGD_LR
                           for n, p in jmodel.state_dict().items()}
    # port: routes, logits, loss and gradients by torch.autograd
    tmodel = _port_model(params)
    troutes = []
    treal = tmoe.moe_ffn_nodrop

    def trecording(*a, **k):
        res = treal(*a, **k)
        troutes.append((res[1].detach().numpy(), res[2].numpy()))
        return res
    tmoe.moe_ffn_nodrop = trecording
    try:
        tlogits = tmodel(*tin)
    finally:
        tmoe.moe_ffn_nodrop = treal
    tloss = _port_loss(tlogits, tlab)
    tloss.backward()
    out["port"].update(
        routes=troutes, logits=tlogits.detach().numpy(),
        loss=float(tloss.detach()),
        grads={n: p.grad.numpy() for n, p in tmodel.named_parameters()})
    # 3 AdamW steps through each TrainStep, from the same weights
    jmodel = _jax_model()
    jstep = paddle.jit.TrainStep(jmodel, _jax_loss, paddle.optimizer.AdamW(
        LR, parameters=jmodel.parameters(), weight_decay=0.01))
    out["jax"]["losses"] = [float(jstep(jin, [jlab]).numpy())
                            for _ in range(STEPS)]
    tmodel = _port_model(params)
    tstep = TTrainStep(tmodel, _port_loss, TAdamW(
        LR, parameters=tmodel.parameters(), weight_decay=0.01))
    out["port"]["losses"] = [float(tstep(tin, [tlab]))
                             for _ in range(STEPS)]
    return out


def test_parameter_names_counts_and_activated_match_jax(runs):
    params = runs["params"]
    tmodel = _port_model(params)
    shapes = {n: tuple(p.shape) for n, p in tmodel.named_parameters()}
    assert shapes == {n: a.shape for n, a in params.items()}
    n_params, n_active = tbench.moe_param_counts(tmodel, D, L, E, TOPK)
    bank = sum(a.size for n, a in params.items() if ".moe.stacked." in n)
    assert n_params == sum(a.size for a in params.values())
    assert n_active == n_params - bank + bank * TOPK // E
    # the root's formula: E * (w1 + b1 + w2 + b2) a block
    assert bank == L * E * (2 * D * 4 * D + 4 * D + D)


def test_routes_equal_jax_with_a_margin(runs):
    """Each layer's top-k experts are JAX's, and no token's top-3
    probabilities lie within MARGIN of each other."""
    jr, tr = runs["jax"]["routes"], runs["port"]["routes"]
    assert len(jr) == len(tr) == L
    for (jp, ji), (tp, ti) in zip(jr, tr):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_allclose(tp, jp, atol=1e-6)
        top = -np.sort(-tp, axis=-1)[:, :TOPK + 1]
        assert float(np.diff(-top, axis=-1).min()) >= MARGIN


def test_f32_logits_and_loss_match_jax(runs):
    j, t = runs["jax"], runs["port"]
    scale = float(np.abs(j["logits"]).max())
    assert float(np.abs(t["logits"] - j["logits"]).max()) <= 1e-5 * scale
    assert math.isclose(t["loss"], j["loss"], rel_tol=1e-5)


def test_f32_every_gradient_matches_jax(runs):
    j, t = runs["jax"]["grads"], runs["port"]["grads"]
    assert set(j) == set(t) and len(j) == 4 + 13 * L + 1
    for name in j:
        scale = max(float(np.abs(j[name]).max()), 1e-30)
        err = float(np.abs(t[name] - j[name]).max())
        assert err <= 1e-4 * scale, f"grad {name}: {err} > 1e-4 x {scale}"


def test_f32_three_step_losses_match_jax(runs):
    np.testing.assert_allclose(runs["port"]["losses"],
                               runs["jax"]["losses"], rtol=1e-5)


def test_o2_loss_trajectory_matches_jax(runs):
    """The rung's recipe: AdamW lr 1e-4, decay 0.01, bf16 moments, O2
    with f32 master weights, bf16 logits into the cross entropy."""
    ids, pos, labels = _batch()
    jmodel = _jax_model()
    jopt = paddle.optimizer.AdamW(1e-4, parameters=jmodel.parameters(),
                                  weight_decay=0.01, moment_dtype="bfloat16")
    jmodel, jopt = paddle.amp.decorate(jmodel, jopt, level="O2",
                                       dtype="bfloat16")
    tmodel = _port_model(runs["params"])
    topt = TAdamW(1e-4, parameters=tmodel.parameters(), weight_decay=0.01,
                  moment_dtype="bfloat16")
    tmodel, topt = t_decorate(tmodel, topt, level="O2", dtype="bfloat16")
    assert topt._multi_precision
    jstep = paddle.jit.TrainStep(jmodel, _jax_loss, jopt)
    tstep = TTrainStep(tmodel, _port_loss, topt)
    jin = [paddle.to_tensor(ids), paddle.to_tensor(pos)]
    tin = [torch.from_numpy(ids), torch.from_numpy(pos)]
    jl = [float(jstep(jin, [paddle.to_tensor(labels)]).numpy())
          for _ in range(STEPS)]
    tl = [float(tstep(tin, [torch.from_numpy(labels)]))
          for _ in range(STEPS)]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    jparams = dict(jmodel.named_parameters())
    for name, p in tmodel.named_parameters():
        assert str(p.dtype).split(".")[-1] == str(jparams[name]._data.dtype)


def test_moe_train_cli_prints_the_root_keys(capsys):
    tbench.main(["--moe-train", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    import json

    row = json.loads(line)
    for key in ("moe_train_tokens_per_sec", "moe_train_mfu",
                "moe_train_params", "moe_train_activated_params",
                "moe_train_telemetry"):
        assert key in row
    assert row["device"] == "cpu" and row["moe_train_mfu"] is None
    assert row["moe_train_tokens_per_sec"] > 0
    # the eager pin's forward stamped the routing telemetry: 4 experts
    hist = row["moe_train_telemetry"]["histograms"]["moe.tokens_per_expert"]
    assert hist["count"] >= 2 * 4
