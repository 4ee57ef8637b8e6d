"""Parity of the port's LR schedulers, gradient clipping and regularizers
with the JAX package's.

- Every one of the 19 schedulers: its value over 12 steps equal to the
  JAX scheduler's (exact: both are the same Python float arithmetic),
  and a ``state_dict`` taken after 5 steps, loaded into a fresh
  scheduler, goes on with the same 7 values.
- An optimizer driven by a scheduler reads its current value each step;
  ``set_lr`` raises under a scheduler in both packages.
- Each clip class on ``(param, grad)`` lists (one parameter with
  ``need_clip=False``), ``clip_grad_norm_`` (the 2-norm and the
  inf-norm) and ``clip_grad_value_``: gradients within 1e-6 of the
  largest value (f32 sums in another order), ``need_clip=False`` and
  ``None`` gradients untouched bitwise.
- ``L1Decay`` and ``L2Decay`` on a gradient, and a ``ParamAttr``'s
  regularizer and ``need_clip`` on a layer's parameter.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import clip as jclip
from paddle_tpu.core.tensor import Parameter as JParam
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg

# tiny cases: torch's intra-op threads would only contend with the other
# test workers
torch.set_num_threads(1)

STEPS = 12


def _plateau_metric(i):
    return [3.0, 2.0, 2.5, 2.4, 2.6, 2.7, 2.8, 1.0, 1.5, 1.6, 1.7, 1.8][i]


SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=4),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([3, 7], [0.1, 0.05, 0.01]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.1, gamma=0.3),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.1, gamma=0.5),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.1, decay_steps=5,
                                                   power=2.0),
    "PolynomialDecay_cycle": lambda m: m.PolynomialDecay(
        0.1, decay_steps=4, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(0.1, warmup_steps=4,
                                             start_lr=0.0, end_lr=0.1),
    "LinearWarmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.1, T_max=6, eta_min=0.01),
        warmup_steps=3, start_lr=0.001, end_lr=0.1),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.1, gamma=0.8),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.1, [2, 5, 9], gamma=0.5),
    "StepDecay": lambda m: m.StepDecay(0.1, step_size=3, gamma=0.3),
    "LambdaDecay": lambda m: m.LambdaDecay(0.1, lambda e: 0.9 ** e),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(0.1, patience=1,
                                                   factor=0.5),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(0.1, T_max=5),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.1, lambda e: 0.95),
    "OneCycleLR": lambda m: m.OneCycleLR(0.1, total_steps=10),
    "OneCycleLR_linear": lambda m: m.OneCycleLR(
        0.1, total_steps=10, anneal_strategy="linear"),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=3,
                                     mode="triangular2"),
    "CyclicLR_exp": lambda m: m.CyclicLR(0.01, 0.1, step_size_up=2,
                                         step_size_down=4,
                                         mode="exp_range", exp_gamma=0.9),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.1, T_0=3, T_mult=2, eta_min=0.001),
    "LinearLR": lambda m: m.LinearLR(0.1, total_steps=6),
    "ConstantLR": lambda m: m.ConstantLR(0.1, factor=0.5, total_steps=4),
}


def _walk(sched, start, stop):
    out = []
    for i in range(start, stop):
        out.append(sched())
        if type(sched).__name__ == "ReduceOnPlateau":
            sched.step(_plateau_metric(i))
        else:
            sched.step()
    return out


def test_every_scheduler_is_ported():
    assert sorted(topt.lr.__all__) == sorted(paddle.optimizer.lr.__all__)
    assert len(topt.lr.__all__) == 19
    names = {k.split("_")[0] for k in SCHEDULERS}
    assert names == set(topt.lr.__all__) - {"LRScheduler"}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_values_and_state_dict_match_jax(name):
    make = SCHEDULERS[name]
    want = _walk(make(paddle.optimizer.lr), 0, STEPS)
    got = _walk(make(topt.lr), 0, STEPS)
    assert got == want
    assert len(set(got)) > 1
    t = make(topt.lr)
    _walk(t, 0, 5)
    sd = t.state_dict()
    j = make(paddle.optimizer.lr)
    _walk(j, 0, 5)
    assert sd == j.state_dict()
    fresh = make(topt.lr)
    fresh.set_state_dict(sd)
    assert _walk(fresh, 5, STEPS) == want[5:]


def test_optimizer_under_a_scheduler_matches_jax():
    rng = np.random.RandomState(0)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    gs = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(4)]
    jp = JParam(jnp.asarray(w))
    tp = torch.nn.Parameter(torch.from_numpy(w.copy()))
    js = paddle.optimizer.lr.StepDecay(0.1, step_size=2, gamma=0.5)
    ts = topt.lr.StepDecay(0.1, step_size=2, gamma=0.5)
    jopt = paddle.optimizer.SGD(js, parameters=[jp])
    jopt._jit_update = jopt._update_arrays
    t_opt = topt.SGD(ts, parameters=[tp])
    lrs = []
    for g in gs:
        jp.grad = JTensor(jnp.asarray(g))
        tp.grad = torch.from_numpy(g)
        lrs.append((jopt.get_lr(), t_opt.get_lr()))
        jopt.step()
        t_opt.step()
        js.step()
        ts.step()
    assert [a for a, _ in lrs] == [b for _, b in lrs] == [0.1, 0.1, 0.05,
                                                          0.05]
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp._data),
                               rtol=0, atol=1e-6)
    for opt in (jopt, t_opt):
        with pytest.raises(RuntimeError, match="LRScheduler"):
            opt.set_lr(0.3)
    t_opt.set_lr_scheduler(topt.lr.ConstantLR(1.0, factor=0.25))
    assert t_opt.get_lr() == 0.25
    plain = topt.SGD(0.1, parameters=[tp])
    plain.set_lr(0.2)
    assert plain.get_lr() == 0.2


# ---------------------------------------------------------------------
# clipping
# ---------------------------------------------------------------------

SHAPES = [(6, 5), (5,), (3, 4), (7,)]


def _pairs(seed=0):
    rng = np.random.RandomState(seed)
    ps = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    gs = [rng.standard_normal(s).astype(np.float32) * 2.0 for s in SHAPES]
    jps = [JParam(jnp.asarray(p)) for p in ps]
    tps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in ps]
    for lst in (jps, tps):
        lst[1].need_clip = False
    jpg = [(p, JTensor(jnp.asarray(g))) for p, g in zip(jps, gs)]
    tpg = [(p, torch.from_numpy(g.copy())) for p, g in zip(tps, gs)]
    jpg[3], tpg[3] = (jps[3], None), (tps[3], None)
    return jpg, tpg, gs


CLIPS = {
    "value": lambda m: m.ClipGradByValue(0.5, -0.3),
    "value_symmetric": lambda m: m.ClipGradByValue(1.0),
    "norm": lambda m: m.ClipGradByNorm(1.5),
    "global_norm": lambda m: m.ClipGradByGlobalNorm(2.0),
    "global_norm_loose": lambda m: m.ClipGradByGlobalNorm(1e3),
}


@pytest.mark.parametrize("name", sorted(CLIPS))
def test_clip_classes_match_jax(name):
    jpg, tpg, gs = _pairs()
    jout = CLIPS[name](paddle.nn)(jpg)
    tout = CLIPS[name](tnn)(tpg)
    for i, ((_, jg), (_, tg)) in enumerate(zip(jout, tout)):
        if jg is None:
            assert tg is None
            continue
        want = np.asarray(jg._data)
        if i == 1:                       # need_clip=False: untouched
            np.testing.assert_array_equal(tg.numpy(), gs[1])
        np.testing.assert_allclose(tg.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    if name == "global_norm":
        clipped = [tg for i, (_, tg) in enumerate(tout) if i in (0, 2)]
        norm = float(tnn.ClipGradByGlobalNorm(2.0).global_norm(clipped))
        assert norm == pytest.approx(2.0, rel=1e-6)
    if name == "global_norm_loose":
        for (_, tg), g in zip(tout[:3], gs):
            np.testing.assert_array_equal(tg.numpy(), g)


@pytest.mark.parametrize("norm_type", [2.0, float("inf")])
def test_clip_grad_norm_matches_jax(norm_type):
    jpg, tpg, gs = _pairs(1)
    jps, tps = [p for p, _ in jpg], [p for p, _ in tpg]
    for jp, tp, g in zip(jps, tps, gs):
        jp.grad = JTensor(jnp.asarray(g))
        tp.grad = torch.from_numpy(g.copy())
    jtotal = jclip.clip_grad_norm_(jps, 1.0, norm_type=norm_type)
    ttotal = tnn.clip_grad_norm_(tps, 1.0, norm_type=norm_type)
    assert float(ttotal) == pytest.approx(float(jtotal.numpy()), rel=1e-6)
    for jp, tp in zip(jps, tps):
        want = np.asarray(jp.grad._data)
        np.testing.assert_allclose(tp.grad.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    tnn.clip_grad_value_(tps, 0.01)
    jclip.clip_grad_value_(jps, 0.01)
    for jp, tp in zip(jps, tps):
        np.testing.assert_array_equal(tp.grad.numpy(),
                                      np.asarray(jp.grad._data))


@pytest.mark.parametrize("reg", ["L1Decay", "L2Decay"])
def test_regularizers_match_jax(reg):
    rng = np.random.RandomState(2)
    p = rng.standard_normal((5, 3)).astype(np.float32)
    p[0, 0] = 0.0
    g = rng.standard_normal((5, 3)).astype(np.float32)
    want = np.asarray(getattr(paddle.regularizer, reg)(0.3)(
        jnp.asarray(p), jnp.asarray(g)))
    got = getattr(treg, reg)(0.3)(torch.from_numpy(p), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)


def test_param_attr_sets_regularizer_and_need_clip():
    reg = treg.L1Decay(0.1)
    layer = tnn.Linear(3, 2, weight_attr=tnn.ParamAttr(regularizer=reg,
                                                        need_clip=False))
    assert layer.weight.regularizer is reg
    assert layer.weight.need_clip is False
    assert layer.bias.regularizer is None and layer.bias.need_clip is True
    jlayer = paddle.nn.Linear(3, 2, weight_attr=paddle.ParamAttr(
        regularizer=paddle.regularizer.L1Decay(0.1), need_clip=False))
    assert jlayer.weight.need_clip is False
