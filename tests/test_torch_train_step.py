"""Parity of the port's GPT training step with the JAX package's.

A tiny GPT (d_model 64, 2 layers, 4 heads, seq 128, the rung's vocab of
51200) is built by the root ``bench.build_model`` (JAX) and by
``paddle_tpu_torch.bench.build_model``; the JAX weights are carried over
with ``load_jax_params``, and both see the same seeded numpy batch. The
sequence is a multiple of 128, so the port takes the flash route (its
plain versions on the CPU) where the JAX package, off the TPU, takes
``_xla_attention``.

- f32: logits and loss within 1e-5 of the largest value, every
  gradient within 1e-4 of its largest value (the gradients sum over
  the 51200-wide head in another order), and every parameter after 3
  AdamW steps (lr 1e-3) through ``TrainStep`` within 1% of the 3e-3
  that 3 Adam steps can move it: Adam divides each gradient by its own
  running RMS, so entries whose gradient is near zero (the key bias,
  whose gradient is zero in exact arithmetic) move by normalised
  rounding noise.
- AMP O2 with the rung's options (bf16 moments, master-free stochastic
  rounding, bf16 cross entropy): the dtype of every parameter and
  moment equal to JAX's, and the 3-step loss trajectory within 1e-4 of
  the loss (bf16 rounding at other places, and stochastic-rounding
  noise from other generators: 8e-6 measured; each step moves the loss
  by ~7e-3 of itself).
- ``remat="full"`` (recompute through ``torch.utils.checkpoint``)
  against ``"none"``: the same loss and gradients, bit for bit.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import bench as tbench
from paddle_tpu_torch.amp import decorate as t_decorate
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.jit import TrainStep as TTrainStep
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.optimizer import AdamW as TAdamW

# tiny cases: torch's intra-op threads would only contend with the other
# test workers
torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import bench as jbench  # noqa: E402  (the root bench: the JAX rung)

D, L, H, S, B = 64, 2, 4, 128, 2
VOCAB = jbench.VOCAB
STEPS = 3
LR = 1e-3


def _batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, VOCAB, (B, S))
    pos = np.tile(np.arange(S), (B, 1))
    labels = rng.randint(0, VOCAB, (B, S))
    return ids, pos, labels


def _jax_model(remat="none"):
    paddle.seed(0)
    return jbench.build_model(D, L, H, S, remat=remat)


def _port_model(jmodel, remat="none"):
    model = tbench.build_model(D, L, H, S, remat=remat, device="cpu")
    load_jax_params(model, {n: np.asarray(p._data)
                            for n, p in jmodel.state_dict().items()})
    return model


def _jax_loss_fn(ce_bf16):
    def loss_fn(logits, labels):
        flat = logits.reshape([-1, VOCAB])
        if not ce_bf16:
            flat = flat.astype("float32")
        return JF.cross_entropy(flat, labels.reshape([-1]))
    return loss_fn


def _port_loss_fn(ce_bf16):
    def loss_fn(logits, labels):
        flat = logits.reshape(-1, VOCAB)
        if not ce_bf16:
            flat = flat.float()
        return TF.cross_entropy(flat, labels.reshape(-1))
    return loss_fn


def _close(got, want, tol, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    limit = tol * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= limit, f"{what}: {err} > {limit}"


@pytest.fixture(scope="module")
def f32_runs():
    """One forward/backward and 3 AdamW steps on each side, in f32."""
    ids, pos, labels = _batch()
    jmodel = _jax_model()
    tmodel = _port_model(jmodel)
    out = {}
    # logits, loss and gradients by each package's autograd
    jin = [paddle.to_tensor(ids), paddle.to_tensor(pos)]
    jlab = paddle.to_tensor(labels)
    jlogits = jmodel(*jin)
    jloss = _jax_loss_fn(False)(jlogits, jlab)
    jloss.backward()
    out["jax"] = {"logits": np.asarray(jlogits._data),
                  "loss": float(jloss.numpy()),
                  "grads": {n: np.asarray(p.grad._data)
                            for n, p in jmodel.named_parameters()}}
    for p in jmodel.parameters():
        p.clear_gradient()
    tin = [torch.from_numpy(ids), torch.from_numpy(pos)]
    tlab = torch.from_numpy(labels)
    tlogits = tmodel(*tin)
    tloss = _port_loss_fn(False)(tlogits, tlab)
    tloss.backward()
    out["port"] = {"logits": tlogits.detach().numpy(),
                   "loss": float(tloss.detach()),
                   "grads": {n: p.grad.numpy()
                             for n, p in tmodel.named_parameters()},
                   "backend": tattn.last_attention_backend()}
    tmodel.zero_grad(set_to_none=True)
    # 3 AdamW steps through each TrainStep
    jopt = paddle.optimizer.AdamW(LR, parameters=jmodel.parameters(),
                                  weight_decay=0.01)
    jstep = paddle.jit.TrainStep(jmodel, _jax_loss_fn(False), jopt)
    topt = TAdamW(LR, parameters=tmodel.parameters(), weight_decay=0.01)
    tstep = TTrainStep(tmodel, _port_loss_fn(False), topt)
    out["jax"]["losses"] = [float(jstep(jin, [jlab]).numpy())
                            for _ in range(STEPS)]
    out["port"]["losses"] = [float(tstep(tin, [tlab]))
                             for _ in range(STEPS)]
    out["jax"]["params"] = {n: np.asarray(p._data)
                            for n, p in jmodel.named_parameters()}
    out["port"]["params"] = {n: p.detach().numpy()
                             for n, p in tmodel.named_parameters()}
    return out


def test_f32_logits_and_loss_match_jax(f32_runs):
    j, t = f32_runs["jax"], f32_runs["port"]
    assert t["backend"] == "flash"
    _close(t["logits"], j["logits"], 1e-5, "logits")
    assert abs(t["loss"] - j["loss"]) <= 1e-5 * abs(j["loss"])


def test_f32_every_gradient_matches_jax(f32_runs):
    j, t = f32_runs["jax"]["grads"], f32_runs["port"]["grads"]
    assert set(j) == set(t) and len(j) == 4 + 12 * L + 1
    for name in j:
        _close(t[name], j[name], 1e-4, f"grad {name}")


def test_f32_params_after_three_steps_match_jax(f32_runs):
    j, t = f32_runs["jax"], f32_runs["port"]
    np.testing.assert_allclose(t["losses"], j["losses"], rtol=1e-5)
    for name in j["params"]:
        err = np.abs(t["params"][name] - j["params"][name]).max()
        assert err <= 1e-2 * LR * STEPS, f"param {name}: {err}"


def test_o2_fast_dtypes_and_loss_trajectory_match_jax():
    opts = dict(tbench._FAST)
    ids, pos, labels = _batch()
    jmodel = _jax_model(remat=opts["remat"])
    tmodel = _port_model(jmodel, remat=opts["remat"])
    kw = {"moment_dtype": opts["moment_dtype"],
          "stochastic_rounding": opts["stochastic_rounding"]}
    jopt = paddle.optimizer.AdamW(LR, parameters=jmodel.parameters(),
                                  weight_decay=0.01, **kw)
    jmodel, jopt = paddle.amp.decorate(jmodel, jopt, level="O2",
                                       dtype="bfloat16", master_weight=False)
    topt = TAdamW(LR, parameters=tmodel.parameters(), weight_decay=0.01,
                  **kw)
    tmodel, topt = t_decorate(tmodel, topt, level="O2", dtype="bfloat16",
                              master_weight=False)
    assert topt._multi_precision is False
    jstep = paddle.jit.TrainStep(jmodel, _jax_loss_fn(True), jopt)
    tstep = TTrainStep(tmodel, _port_loss_fn(True), topt)
    jin = [paddle.to_tensor(ids), paddle.to_tensor(pos)]
    tin = [torch.from_numpy(ids), torch.from_numpy(pos)]
    jl = [float(jstep(jin, [paddle.to_tensor(labels)]).numpy())
          for _ in range(STEPS)]
    tl = [float(tstep(tin, [torch.from_numpy(labels)]))
          for _ in range(STEPS)]
    assert tstep.first_call_seconds is not None
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    # each step moves the loss by far more than the limit
    assert min(abs(a - b) for a, b in zip(jl, jl[1:])) > 10e-4 * jl[0]
    jparams = dict(jmodel.named_parameters())
    for name, p in tmodel.named_parameters():
        jp = jparams[name]
        assert str(p.dtype).split(".")[1] == str(jp._data.dtype), name
        want = "float32" if ".ln" in name or name.startswith("norm") \
            else "bfloat16"
        assert str(jp._data.dtype) == want, name
        jst = jopt._accumulators[id(jp)]
        tst = topt._accumulators[id(p)]
        assert set(jst) == set(tst), name
        for k in jst:
            assert str(tst[k].dtype).split(".")[1] == \
                str(jst[k].dtype), (name, k)


def test_remat_full_equals_none_bitwise():
    ids, pos, labels = _batch()
    jmodel = _jax_model()
    runs = []
    for remat in ("none", "full"):
        model = _port_model(jmodel, remat=remat)
        logits = model(torch.from_numpy(ids), torch.from_numpy(pos))
        loss = _port_loss_fn(False)(logits, torch.from_numpy(labels))
        loss.backward()
        runs.append((loss.detach(),
                     {n: p.grad for n, p in model.named_parameters()}))
    assert torch.equal(runs[0][0], runs[1][0])
    for name, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][name]), name


def test_load_jax_params_names_a_missing_or_extra_param():
    jmodel = _jax_model()
    params = {n: np.asarray(p._data)
              for n, p in jmodel.state_dict().items()}
    model = tbench.build_model(D, L, H, S, remat="none", device="cpu")
    with pytest.raises(KeyError, match="blocks.1.fc2.bias"):
        load_jax_params(model, {n: a for n, a in params.items()
                                if n != "blocks.1.fc2.bias"})
    with pytest.raises(KeyError, match="blocks.2.qkv.weight"):
        load_jax_params(model, {**params, "blocks.2.qkv.weight":
                                params["blocks.1.qkv.weight"]})
    # a bf16 state dict keeps its dtype
    bf = {n: a.astype(jnp.bfloat16) if a.ndim == 2 else a
          for n, a in params.items()}
    load_jax_params(model, bf)
    assert model.head.weight.dtype == torch.bfloat16
    assert model.norm.weight.dtype == torch.float32
    np.testing.assert_array_equal(
        model.head.weight.detach().float().numpy(),
        bf["head.weight"].astype(np.float32))


def test_entry_points_run_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbench.build_model(D, 1, H, S)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbench.run_config("tiny", D, 1, H, S, B, 1)


def test_unported_options_name_their_slice():
    with pytest.raises(NotImplementedError, match="selective-recompute"):
        tbench.build_model(D, 1, H, S, remat="dots", device="cpu")
    model = tbench.build_model(D, 1, H, S, remat="none", device="cpu")
    opt = TAdamW(1e-3, parameters=model.parameters())
    step = TTrainStep(model, _port_loss_fn(False), opt)
    with pytest.raises(NotImplementedError, match="profiler"):
        step.roofline(1.0)
    with pytest.raises(NotImplementedError, match="distributed"):
        TTrainStep(model, _port_loss_fn(False), opt, in_sharding=object())
    with pytest.raises(NotImplementedError, match="AMP-O1"):
        TTrainStep(model, _port_loss_fn(False), opt, amp_level="O1")
    with pytest.raises(NotImplementedError, match="AMP-O1"):
        TTrainStep(model, _port_loss_fn(False), opt, amp_dtype="float16")
    with pytest.raises(NotImplementedError, match="to_static"):
        TTrainStep(model, _port_loss_fn(False), opt, donate=False)


def test_run_config_on_the_cpu_reports_the_rung_figures():
    tps, n, fpt, stats = tbench.run_config(
        "tiny", D, L, H, S, B, 1, dict(tbench._FAST), device="cpu")
    assert n == 51200 * D + S * D + L * (12 * D * D + 13 * D) + 2 * D \
        + D * 51200
    assert fpt == 6 * n + 12 * L * S * D
    assert tps > 0 and np.isfinite(stats["loss"])
    assert stats["mfu"] == pytest.approx(tps * fpt / tbench.H100_PEAK_BF16)
