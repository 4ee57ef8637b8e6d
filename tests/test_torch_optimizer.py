"""Parity of paddle_tpu_torch's Adam/AdamW with paddle_tpu's.

The JAX side is the optimizer's pure update, ``_update_arrays`` (what
its compiled step and ``TrainStep`` run), fed the same seeded numpy
parameters and gradients step after step as the port's ``step()``.
Cases: f32; bf16 moments; bf16 parameters with lazy f32 master weights;
decoupled weight decay with a no-decay mask; ``lr_mult``; and
master-free bf16 parameters with stochastic rounding, where both sides
round with the noise ``jax.random.bits`` draws for the JAX update.
Tolerances: f32 parameters and moments within 1e-6 of the largest value
(f32 arithmetic in another order); bf16 values within one bf16 ulp
(an f32 difference of one ulp can move a rounding). Dtypes of every
parameter and state entry are equal. ``stochastic_round_bf16`` is held
to the JAX function bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import Parameter as JParam
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.optimizer.optimizer import _stochastic_round_bf16
from paddle_tpu_torch.optimizer import Adam, AdamW, stochastic_round_bf16

# tiny cases: torch's intra-op threads would only contend with the other
# test workers
torch.set_num_threads(1)

SHAPES = [(16, 24), (24,), (8, 3, 5)]
STEPS = 3


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _case(dtype, seed=0):
    rng = np.random.RandomState(seed)
    ps = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    gs = [[rng.standard_normal(s).astype(np.float32) * 0.1 for s in SHAPES]
          for _ in range(STEPS)]
    return ps, gs


def _names(i):
    return f"layer_{i}.{'bias' if len(SHAPES[i]) == 1 else 'weight'}"


def _run_jax(ps, gs, dtype, kw, multi_precision, lr_mults, decay_fun):
    jd = jnp.dtype(dtype)
    params = [JParam(jnp.asarray(p).astype(jd), name=_names(i))
              for i, p in enumerate(ps)]
    for p, m in zip(params, lr_mults):
        p.optimize_attr["learning_rate"] = m
    opt = JAdamW(1e-2, parameters=params, weight_decay=0.1,
                 apply_decay_param_fun=decay_fun, **kw)
    opt._multi_precision = multi_precision
    if decay_fun is not None:
        opt._no_decay_ids = {id(p) for p in params
                             if not decay_fun(p.name)}
    arrays = [p._data for p in params]
    states = [opt._state_for(p) for p in params]
    per = [opt._per_param_hyper(p) for p in params]
    for step, g in enumerate(gs):
        hyper = opt._hyper()
        g_arr = [jnp.asarray(x).astype(jd) for x in g]
        arrays, states = opt._update_arrays(arrays, g_arr, states, hyper,
                                            per)
        opt._global_step += 1
    return arrays, states


def _run_port(ps, gs, dtype, kw, multi_precision, lr_mults, decay_fun,
              noise=None):
    td = getattr(torch, dtype)
    params = []
    for i, (p, m) in enumerate(zip(ps, lr_mults)):
        t = torch.nn.Parameter(torch.from_numpy(p.copy()).to(td))
        t.param_name = _names(i)
        t.optimize_attr = {"learning_rate": m}
        params.append(t)
    opt = AdamW(1e-2, parameters=params, weight_decay=0.1,
                apply_decay_param_fun=decay_fun, **kw)
    opt._multi_precision = multi_precision
    if noise is not None:
        opt._sr_noise = lambda p: noise(opt._global_step,
                                        [id(q) for q in params].index(id(p)),
                                        p.shape)
    for g in gs:
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x).to(td)
        opt.step()
    return params, [opt._state_for(p) for p in params]


def _ulp_close(got, want, what):
    got, want = got.float().numpy(), _np(want)
    err = np.abs(got - want)
    np.testing.assert_array_less(err, np.abs(want) * 2.0 ** -7 + 1e-30
                                 + (err == 0), err_msg=what)


def _compare(j_arrays, j_states, t_params, t_states, bf16):
    for i, (ja, tp) in enumerate(zip(j_arrays, t_params)):
        assert str(tp.dtype).split(".")[1] == str(ja.dtype), i
        if bf16:
            _ulp_close(tp.detach(), ja, f"param {i}")
        else:
            np.testing.assert_allclose(tp.detach().numpy(), _np(ja),
                                       rtol=0, atol=1e-6 * float(
                                           np.abs(_np(ja)).max()))
    for i, (js, ts) in enumerate(zip(j_states, t_states)):
        assert set(js) == set(ts), (set(js), set(ts))
        for k in js:
            jv, tv = js[k], ts[k]
            assert str(tv.dtype).split(".")[1] == str(jv.dtype), (i, k)
            if tv.dtype == torch.bfloat16:
                _ulp_close(tv, jv, f"state {i} {k}")
            else:
                scale = max(float(np.abs(_np(jv)).max()), 1e-30)
                np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=0,
                                           atol=1e-6 * scale,
                                           err_msg=f"state {i} {k}")


def _no_bias_decay(name):
    return not name.endswith("bias")


CASES = {
    "fp32": ("float32", {}, False, [1.0, 1.0, 1.0], None),
    "bf16_moments": ("float32", {"moment_dtype": "bfloat16"}, False,
                     [1.0, 1.0, 1.0], None),
    "lazy_master": ("bfloat16", {}, True, [1.0, 1.0, 1.0], None),
    "master_bf16_moments": ("bfloat16", {"moment_dtype": "bfloat16"}, True,
                            [1.0, 1.0, 1.0], None),
    "no_decay_mask": ("float32", {}, False, [1.0, 1.0, 1.0],
                      _no_bias_decay),
    "lr_mult": ("float32", {}, False, [1.0, 0.5, 3.0], _no_bias_decay),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_adamw_matches_jax_update_arrays(case):
    dtype, kw, mp, lr_mults, fun = CASES[case]
    ps, gs = _case(dtype)
    j = _run_jax(ps, gs, dtype, kw, mp, lr_mults, fun)
    t = _run_port(ps, gs, dtype, kw, mp, lr_mults, fun)
    _compare(*j, *t, bf16=dtype == "bfloat16")


def test_no_decay_mask_changes_the_masked_params_only():
    ps, gs = _case("float32")
    a = _run_port(ps, gs, "float32", {}, False, [1.0] * 3, None)[0]
    b = _run_port(ps, gs, "float32", {}, False, [1.0] * 3,
                  _no_bias_decay)[0]
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y) == (len(SHAPES[i]) != 1)


def _jax_sr_noise(step, i, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(step), i)
    bits = jax.random.bits(key, tuple(shape), dtype=jnp.uint16)
    return torch.from_numpy(np.asarray(bits).astype(np.int32))


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_stochastic_rounding_update_matches_jax(moment_dtype):
    """Master-free bf16 params: the rule in f32, written back with the
    noise the JAX update draws (its key is the step, folded with the
    parameter's index)."""
    kw = {"stochastic_rounding": True, "moment_dtype": moment_dtype}
    ps, gs = _case("bfloat16", seed=3)
    j = _run_jax(ps, gs, "bfloat16", kw, False, [1.0] * 3, None)
    t = _run_port(ps, gs, "bfloat16", kw, False, [1.0] * 3, None,
                  noise=_jax_sr_noise)
    _compare(*j, *t, bf16=True)


def test_stochastic_round_bf16_is_the_jax_function_bitwise():
    rng = np.random.RandomState(11)
    x = np.concatenate([
        rng.standard_normal(4000).astype(np.float32) * 10.0 ** rng.randint(
            -30, 30, 4000),
        np.array([0.0, -0.0, 1.0, -1.0, 3.0e38, -3.0e38, 1e-40, -1e-40,
                  np.inf, -np.inf], np.float32)]).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(_stochastic_round_bf16(jnp.asarray(x), key)) \
        .view(np.uint16)
    noise = np.asarray(jax.random.bits(key, x.shape, dtype=jnp.uint16))
    got = stochastic_round_bf16(torch.from_numpy(x),
                                torch.from_numpy(noise.astype(np.int32)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy()
                                  .view(np.uint16), want)


def test_stochastic_rounding_is_unbiased_and_seeded():
    x = torch.full((200000,), 1.0 + 2.0 ** -9)     # between two bf16s
    p = torch.nn.Parameter(x.to(torch.bfloat16))
    opt = AdamW(0.0, parameters=[p], weight_decay=0.0,
                stochastic_rounding=True)
    a = stochastic_round_bf16(x, opt._sr_noise(p)).float()
    assert abs(float(a.mean()) - float(x[0])) < 2e-5
    opt2 = AdamW(0.0, parameters=[p], weight_decay=0.0,
                 stochastic_rounding=True)
    assert torch.equal(opt2._sr_noise(p), AdamW(
        0.0, parameters=[p], weight_decay=0.0,
        stochastic_rounding=True)._sr_noise(p))


def test_unported_options_name_their_slice():
    p = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(NotImplementedError, match="grad-clip"):
        AdamW(parameters=[p], grad_clip=object())
    with pytest.raises(NotImplementedError, match="amsgrad"):
        AdamW(parameters=[p], amsgrad=True)
    with pytest.raises(NotImplementedError, match="sparse"):
        AdamW(parameters=[p], lazy_mode=True)
    with pytest.raises(NotImplementedError, match="multi-tensor"):
        Adam(parameters=[p], use_multi_tensor=True)
    with pytest.raises(NotImplementedError, match="checkpoint"):
        AdamW(parameters=[p]).state_dict()
