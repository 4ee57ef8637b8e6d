"""Parity of the port's optimizers beyond Adam/AdamW (the SGD family,
Adamax, Lamb, Lars, LBFGS; amsgrad, lazy_mode, parameter groups,
regularizers, need_clip) and of its optimizer checkpoints with the JAX
package's.

The JAX side runs its eager ``step()`` (regularizers, clip, then its
``_update_arrays``, called without ``jax.jit``) on parameters whose
``grad`` is set from seeded numpy arrays, step after step as the port's
``step()`` sees the same gradients. Tolerances: f32 parameters and
state within 1e-6 of the largest value (f32 arithmetic in another
order); bf16 values within one bf16 ulp. LBFGS runs on a small
least-squares problem through each package's autograd, with and without
the strong-Wolfe line search, 2 steps of 3 iterations (short of the
minimum, where each side's stopping tests would meet rounding noise):
the parameters within 1e-5 of the largest value and the counts of
iterations and loss evaluations equal; Lars 4 steps on the same
problem within the f32 tolerance. Checkpoints: a port ``state_dict`` restored into a fresh optimizer steps
as the original does (bitwise); missing and unexpected keys warn with
the JAX package's messages; a JAX optimizer's ``state_dict()`` after 2
steps, carried over by ``convert.load_jax_optimizer_state``, steps to
the JAX's step 3 within the f32 tolerance.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter as JParam
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import regularizer as treg
from paddle_tpu_torch.convert import (load_jax_optimizer_state,
                                      load_jax_params)

# tiny cases: torch's intra-op threads would only contend with the other
# test workers
torch.set_num_threads(1)

SHAPES = [(16, 24), (24,), (8, 3, 5)]
STEPS = 3


def _names(i):
    return f"layer_{i}.{'bias' if len(SHAPES[i]) == 1 else 'weight'}"


def _case(seed=0):
    rng = np.random.RandomState(seed)
    ps = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    gs = [[rng.standard_normal(s).astype(np.float32) * 0.1 for s in SHAPES]
          for _ in range(STEPS)]
    return ps, gs


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _jax_params(ps, dtype):
    return [JParam(jnp.asarray(p).astype(jnp.dtype(dtype)), name=_names(i))
            for i, p in enumerate(ps)]


def _port_params(ps, dtype):
    out = []
    for i, p in enumerate(ps):
        t = torch.nn.Parameter(torch.from_numpy(p.copy()).to(
            getattr(torch, dtype)))
        t.param_name = _names(i)
        t.optimize_attr = {"learning_rate": 1.0}
        out.append(t)
    return out


def _groups(params):
    return [{"params": params[:2]},
            {"params": params[2:], "learning_rate": 0.5}]


# name -> (dtype, constructor(module, params, regularizer module), setup)
# ``setup(params, reg)`` sets per-parameter attributes on either side
def _l1_on_first(params, reg):
    params[0].regularizer = reg.L1Decay(0.02)


def _l2_on_bias(params, reg):
    params[1].regularizer = reg.L2Decay(0.3)


def _no_clip_on_last(params, reg):
    params[2].need_clip = False


CASES = {
    "sgd": ("float32", lambda m, ps, r, c: m.SGD(0.1, parameters=ps), None),
    "sgd_float_decay": ("float32", lambda m, ps, r, c: m.SGD(
        0.1, parameters=ps, weight_decay=0.05), None),
    "sgd_l1_decay": ("float32", lambda m, ps, r, c: m.SGD(
        0.1, parameters=ps, weight_decay=r.L1Decay(0.05)), None),
    "sgd_own_regularizer_first": ("float32", lambda m, ps, r, c: m.SGD(
        0.1, parameters=ps, weight_decay=r.L2Decay(0.05)), _l2_on_bias),
    "momentum": ("float32", lambda m, ps, r, c: m.Momentum(
        0.1, momentum=0.9, parameters=ps), None),
    "momentum_nesterov_groups": ("float32", lambda m, ps, r, c: m.Momentum(
        0.1, momentum=0.8, parameters=_groups(ps), use_nesterov=True),
        None),
    "adagrad": ("float32", lambda m, ps, r, c: m.Adagrad(
        0.1, parameters=ps, initial_accumulator_value=0.1), None),
    "adadelta": ("float32", lambda m, ps, r, c: m.Adadelta(
        1.0, parameters=ps), None),
    "rmsprop": ("float32", lambda m, ps, r, c: m.RMSProp(
        0.01, parameters=ps), None),
    "rmsprop_centered": ("float32", lambda m, ps, r, c: m.RMSProp(
        0.01, momentum=0.5, centered=True, parameters=ps), None),
    "rprop": ("float32", lambda m, ps, r, c: m.Rprop(
        0.01, parameters=ps), None),
    "adam_amsgrad": ("float32", lambda m, ps, r, c: m.Adam(
        0.01, parameters=ps, amsgrad=True), None),
    "adam_lazy_mode": ("float32", lambda m, ps, r, c: m.Adam(
        0.01, parameters=ps, lazy_mode=True), None),
    "adam_amsgrad_master_bf16_moments": ("bfloat16", lambda m, ps, r, c:
                                         m.Adam(0.01, parameters=ps,
                                                amsgrad=True,
                                                multi_precision=True,
                                                moment_dtype="bfloat16"),
                                         None),
    "adamw_l2decay_object": ("float32", lambda m, ps, r, c: m.AdamW(
        0.01, parameters=ps, weight_decay=r.L2Decay(0.2)), None),
    "adamw_own_l1": ("float32", lambda m, ps, r, c: m.AdamW(
        0.01, parameters=ps, weight_decay=0.1), _l1_on_first),
    "adamax": ("float32", lambda m, ps, r, c: m.Adamax(
        0.01, parameters=ps), None),
    "lamb": ("float32", lambda m, ps, r, c: m.Lamb(
        0.01, parameters=ps), None),
    "lars": ("float32", lambda m, ps, r, c: m.Lars(
        0.1, parameters=ps, exclude_from_weight_decay=["bias"]), None),
    "clip_global_need_clip": ("float32", lambda m, ps, r, c: m.Momentum(
        0.1, parameters=ps, grad_clip=c.ClipGradByGlobalNorm(0.2)),
        _no_clip_on_last),
    "clip_norm_l1": ("float32", lambda m, ps, r, c: m.SGD(
        0.1, parameters=ps, weight_decay=r.L1Decay(0.5),
        grad_clip=c.ClipGradByNorm(0.3)), None),
    "clip_value": ("float32", lambda m, ps, r, c: m.SGD(
        0.1, parameters=ps, grad_clip=c.ClipGradByValue(0.05, -0.02)),
        None),
}


def _run_jax(case, ps, gs):
    dtype, make, setup = CASES[case]
    params = _jax_params(ps, dtype)
    if setup:
        setup(params, paddle.regularizer)
    opt = make(paddle.optimizer, params, paddle.regularizer, paddle.nn)
    opt._jit_update = opt._update_arrays        # eager, not compiled
    for g in gs:
        for p, x in zip(params, g):
            p.grad = JTensor(jnp.asarray(x).astype(p._data.dtype))
        opt.step()
    return params, [opt._accumulators[id(p)] for p in params]


def _run_port(case, ps, gs):
    dtype, make, setup = CASES[case]
    params = _port_params(ps, dtype)
    if setup:
        setup(params, treg)
    opt = make(topt, params, treg, tnn)
    for g in gs:
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x).to(p.dtype)
        opt.step()
    return params, [opt._accumulators[id(p)] for p in params], opt


def _close(got, want, what):
    if got.dtype == torch.bfloat16:
        g, w = got.float().numpy(), _np(want)
        err = np.abs(g - w)
        np.testing.assert_array_less(err, np.abs(w) * 2.0 ** -7 + 1e-30
                                     + (err == 0), err_msg=what)
        return
    w = _np(want)
    scale = max(float(np.abs(w).max()), 1e-30)
    np.testing.assert_allclose(got.float().numpy(), w, rtol=0,
                               atol=1e-6 * scale, err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_jax_step(case):
    ps, gs = _case()
    jp, js = _run_jax(case, ps, gs)
    tp, ts, _ = _run_port(case, ps, gs)
    for i, (a, b) in enumerate(zip(tp, jp)):
        assert str(a.dtype).split(".")[1] == str(b._data.dtype), i
        _close(a.detach(), b._data, f"{case} param {i}")
    for i, (a, b) in enumerate(zip(ts, js)):
        assert set(a) == set(b), (case, set(a), set(b))
        for k in b:
            if torch.is_tensor(a[k]):
                assert str(a[k].dtype).split(".")[1] == str(b[k].dtype), \
                    (case, i, k)
                _close(a[k], b[k], f"{case} state {i} {k}")
            else:
                assert a[k] == b[k]


def test_lazy_mode_is_the_dense_update_and_groups_flatten():
    ps, gs = _case(1)
    a = _run_port("adam_lazy_mode", ps, gs)[0]
    params = _port_params(ps, "float32")
    opt = topt.Adam(0.01, parameters=params)
    for g in gs:
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x)
        opt.step()
    for x, y in zip(a, params):
        assert torch.equal(x, y)
    opt = _run_port("momentum_nesterov_groups", ps, gs)[2]
    assert [len(g["params"]) for g in opt._param_groups] == [2, 1]
    assert len(opt._parameter_list) == 3


# ---------------------------------------------------------------------
# LBFGS
# ---------------------------------------------------------------------

def _lsq():
    rng = np.random.RandomState(5)
    a = rng.standard_normal((12, 6)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    x0 = rng.standard_normal(6).astype(np.float32) * 0.1
    c = rng.standard_normal((2, 3)).astype(np.float32)
    y0 = np.zeros((2, 3), np.float32)
    return a, b, x0, c, y0


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_matches_jax(line_search):
    a, b, x0, c, y0 = _lsq()
    kw = dict(learning_rate=1.0, max_iter=3, history_size=4,
              line_search_fn=line_search)
    jx, jy = JParam(jnp.asarray(x0)), JParam(jnp.asarray(y0))
    jopt = paddle.optimizer.LBFGS(parameters=[jx, jy], **kw)
    ja, jb, jc = (paddle.to_tensor(v) for v in (a, b, c))

    def jclosure():
        jopt.clear_grad()
        r = paddle.matmul(ja, jx) - jb
        loss = 0.5 * (r * r).sum() + ((jy - jc) ** 2).sum()
        loss.backward()
        return loss

    tx = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    ty = torch.nn.Parameter(torch.from_numpy(y0.copy()))
    t_opt = topt.LBFGS(parameters=[tx, ty], **kw)
    ta, tb, tc = (torch.from_numpy(v) for v in (a, b, c))

    def tclosure():
        t_opt.clear_grad()
        r = ta @ tx - tb
        loss = 0.5 * (r * r).sum() + ((ty - tc) ** 2).sum()
        loss.backward()
        return loss

    for _ in range(2):
        jl = float(jopt.step(jclosure).numpy())
        tl = float(t_opt.step(tclosure).detach())
        assert tl == pytest.approx(jl, rel=1e-5)
    for tp, jp in ((tx, jx), (ty, jy)):
        want = np.asarray(jp._data)
        np.testing.assert_allclose(tp.detach().numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    for k in ("n_iter", "n_func_evals"):
        assert t_opt._state[k] == jopt._state[k], k
    sd = t_opt.state_dict()
    other = topt.LBFGS(parameters=[tx, ty], **kw)
    other.set_state_dict(sd)
    assert other._state["n_iter"] == t_opt._state["n_iter"]
    assert torch.equal(other._state["d"], t_opt._state["d"])


def test_lars_on_the_quadratic_matches_jax():
    """Lars on the least-squares problem, its gradients from each
    package's autograd: 4 steps, the bias-like ``y`` excluded from the
    trust ratio by name."""
    a, b, x0, c, y0 = _lsq()
    jx = JParam(jnp.asarray(x0), name="fc.weight")
    jy = JParam(jnp.asarray(y0), name="fc.bias")
    tx = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    ty = torch.nn.Parameter(torch.from_numpy(y0.copy()))
    tx.param_name, ty.param_name = "fc.weight", "fc.bias"
    kw = dict(learning_rate=0.5, momentum=0.9, lars_coeff=0.01,
              lars_weight_decay=0.001, exclude_from_weight_decay=["bias"])
    jopt = paddle.optimizer.Lars(parameters=[jx, jy], **kw)
    jopt._jit_update = jopt._update_arrays
    t_opt = topt.Lars(parameters=[tx, ty], **kw)
    ja, jb, jc = (paddle.to_tensor(v) for v in (a, b, c))
    ta, tb, tc = (torch.from_numpy(v) for v in (a, b, c))
    for _ in range(4):
        jopt.clear_grad()
        r = paddle.matmul(ja, jx) - jb
        (0.5 * (r * r).sum() + ((jy - jc) ** 2).sum()).backward()
        jopt.step()
        t_opt.clear_grad()
        r = ta @ tx - tb
        (0.5 * (r * r).sum() + ((ty - tc) ** 2).sum()).backward()
        t_opt.step()
    for tp, jp in ((tx, jx), (ty, jy)):
        assert not np.array_equal(np.asarray(jp._data),
                                  x0 if tp is tx else y0)
        _close(tp.detach(), jp._data, "lars param")
        _close(t_opt._accumulators[id(tp)]["velocity"],
               jopt._accumulators[id(jp)]["velocity"], "lars velocity")


# ---------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------

def test_state_dict_round_trip_steps_bitwise():
    ps, gs = _case(2)
    sched = topt.lr.StepDecay(0.01, step_size=1, gamma=0.5)
    params = _port_params(ps, "bfloat16")
    opt = topt.AdamW(sched, parameters=params, multi_precision=True,
                     amsgrad=True)
    for p, x in zip(params, gs[0]):
        p.grad = torch.from_numpy(x).to(p.dtype)
    opt.step()
    sched.step()
    sd = opt.state_dict()
    assert sd["global_step"] == 1 and "LR_Scheduler" in sd
    assert f"{_names(0)}__master" in sd and f"{_names(0)}_moment2_max" in sd
    saved = [p.detach().clone() for p in params]
    opt.step()
    after = [p.detach().clone() for p in params]
    # restore parameters and optimizer, then the same step again
    for p, s in zip(params, saved):
        p.data.copy_(s)
    sched2 = topt.lr.StepDecay(0.01, step_size=1, gamma=0.5)
    opt2 = topt.AdamW(sched2, parameters=params, multi_precision=True,
                      amsgrad=True)
    opt2.set_state_dict(sd)
    assert sched2.last_epoch == 1 and opt2.get_lr() == opt.get_lr()
    opt2.step()
    for p, want in zip(params, after):
        assert torch.equal(p.detach(), want)
    # the checkpoint is a copy: stepping did not change it
    assert not torch.equal(sd[f"{_names(0)}_moment1"],
                           opt2._accumulators[id(params[0])]["moment1"])


def _warned(fn):
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        fn()
    return sorted(str(w.message) for w in got)


def test_set_state_dict_warns_as_jax():
    ps, gs = _case(4)
    jparams = _jax_params(ps, "float32")
    jopt = paddle.optimizer.Adam(0.01, parameters=jparams)
    jopt._jit_update = jopt._update_arrays
    tparams = _port_params(ps, "float32")
    t_opt = topt.Adam(0.01, parameters=tparams)
    for jp, tp, x in zip(jparams, tparams, gs[0]):
        jp.grad = JTensor(jnp.asarray(x))
        tp.grad = torch.from_numpy(x)
    jopt.step()
    t_opt.step()
    jsd, tsd = dict(jopt.state_dict()), dict(t_opt.state_dict())
    assert sorted(jsd) == sorted(tsd)
    for sd in (jsd, tsd):
        del sd[f"{_names(1)}_moment2"]
        sd["stray_key"] = 1
    want = _warned(lambda: paddle.optimizer.Adam(
        0.01, parameters=jparams).set_state_dict(jsd))
    got = _warned(lambda: topt.Adam(
        0.01, parameters=tparams).set_state_dict(tsd))
    assert got == want and len(got) == 2


class _JaxMLP(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = paddle.nn.Linear(8, 16)
        self.ln = paddle.nn.LayerNorm(16)
        self.fc2 = paddle.nn.Linear(16, 4)


class _PortMLP(tnn.Layer):
    def __init__(self):
        super().__init__()
        self.fc1 = tnn.Linear(8, 16)
        self.ln = tnn.LayerNorm(16)
        self.fc2 = tnn.Linear(16, 4)


def test_load_jax_optimizer_state_continues_the_jax_run():
    paddle.seed(1)
    _JaxMLP()                       # move the JAX name counters on
    jmodel = _JaxMLP()
    tmodel = _PortMLP()
    assert {p.name for p in jmodel.parameters()} != \
        {p.param_name for p in tmodel.parameters()}

    def sched(m):
        return m.lr.LinearWarmup(0.01, warmup_steps=2, start_lr=0.001,
                                 end_lr=0.01)
    jsched = sched(paddle.optimizer)
    jopt = paddle.optimizer.AdamW(jsched, parameters=jmodel.parameters(),
                                  weight_decay=0.05, amsgrad=True)
    jopt._jit_update = jopt._update_arrays
    rng = np.random.RandomState(7)
    names = [n for n, _ in jmodel.named_parameters()]
    grads = [{n: rng.standard_normal(p.shape).astype(np.float32)
              for n, p in jmodel.named_parameters()} for _ in range(3)]

    def jstep(g):
        for n, p in jmodel.named_parameters():
            p.grad = JTensor(jnp.asarray(g[n]))
        jopt.step()
        jsched.step()
    jstep(grads[0])
    jstep(grads[1])
    state = {k: (np.asarray(v._data) if isinstance(v, JTensor) else v)
             for k, v in jopt.state_dict().items()}
    load_jax_params(tmodel, {n: np.asarray(p._data)
                             for n, p in jmodel.state_dict().items()})
    tsched = sched(topt)
    t_opt = topt.AdamW(tsched, parameters=tmodel.parameters(),
                       weight_decay=0.05, amsgrad=True)
    load_jax_optimizer_state(t_opt, state, jmodel, tmodel)
    assert t_opt._global_step == 2 and tsched.last_epoch == 2
    assert t_opt.get_lr() == jopt.get_lr()
    jstep(grads[2])
    for n, p in tmodel.named_parameters():
        p.grad = torch.from_numpy(grads[2][n])
    t_opt.step()
    jparams = dict(jmodel.named_parameters())
    for n in names:
        p = dict(tmodel.named_parameters())[n]
        _close(p.detach(), jparams[n]._data, n)
        for k, v in jopt._accumulators[id(jparams[n])].items():
            _close(t_opt._accumulators[id(p)][k], v, f"{n} {k}")
    with pytest.raises(KeyError, match="no parameter"):
        load_jax_optimizer_state(t_opt, {"nowhere_moment1": 0}, jmodel,
                                 tmodel)
