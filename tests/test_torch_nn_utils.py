"""The port's ``nn.utils`` against the JAX package's
(``paddle_tpu_torch/nn/utils.py`` against ``paddle_tpu/nn/utils.py``).

- ``parameters_to_vector`` of a layer's parameters equals JAX's (and is
  differentiable); ``vector_to_parameters`` writes the same values in
  place, each cast to its parameter's dtype.
- ``weight_norm`` over ``dim`` 0, 1 and None: the ``weight_g`` and
  ``weight_v`` parameters (names and values) and the layer's output
  equal JAX's (1e-5), the gradients of g and v within 1e-4;
  ``remove_weight_norm`` restores one ``weight`` parameter holding
  ``g * v / |v|``.
- The clip helpers are the ones of ``nn.clip``, and clip as JAX's do.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.utils as jutils
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.nn import clip as tclip
from paddle_tpu_torch.nn import utils as tutils

torch.set_num_threads(1)


def _pair(make, seed=0):
    paddle.seed(seed)
    j = make(jnn)
    t = make(tnn)
    load_jax_params(t, {k: np.array(v.numpy())
                        for k, v in j.state_dict().items()})
    return j, t


def _x(*shape, seed=1):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, tol, what):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.array(want.numpy() if hasattr(want, "numpy") else want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _net(nn):
    return nn.Sequential(nn.Linear(5, 4), nn.LayerNorm(4), nn.Linear(4, 3))


def test_parameters_to_vector_matches_jax():
    j, t = _pair(_net)
    tv = tutils.parameters_to_vector(t.parameters())
    jv = jutils.parameters_to_vector(j.parameters())
    assert tuple(tv.shape) == (5 * 4 + 4 + 4 + 4 + 4 * 3 + 3,)
    np.testing.assert_array_equal(tv.detach().numpy(), np.array(jv.numpy()))
    tv.square().sum().backward()
    assert torch.equal(t[0].weight.grad, 2 * t[0].weight.detach())


def test_vector_to_parameters_in_place_matches_jax():
    j, t = _pair(_net)
    vec = _x(51, seed=3)
    ptrs = [p.data_ptr() for p in t.parameters()]
    tutils.vector_to_parameters(torch.from_numpy(vec), t.parameters())
    jutils.vector_to_parameters(paddle.to_tensor(vec), j.parameters())
    assert [p.data_ptr() for p in t.parameters()] == ptrs
    for (n, tp), jp in zip(t.named_parameters(), j.parameters()):
        np.testing.assert_array_equal(tp.detach().numpy(),
                                      np.array(jp.numpy()), n)
    half = tnn.Linear(3, 2)
    half.to(torch.bfloat16)
    tutils.vector_to_parameters(torch.arange(8.0), half.parameters())
    assert half.weight.dtype == torch.bfloat16
    assert half.bias.tolist() == [6.0, 7.0]


@pytest.mark.parametrize("dim", [0, 1, None])
def test_weight_norm_matches_jax(dim):
    j, t = _pair(lambda nn: nn.Linear(6, 4))
    jutils.weight_norm(j, dim=dim)
    tutils.weight_norm(t, dim=dim)
    jp = dict(j.named_parameters())
    assert [n for n, _ in t.named_parameters()] == list(jp) == \
        ["bias", "weight_g", "weight_v"]
    for n, p in t.named_parameters():
        _close(p, jp[n], 1e-6, n)
    x = _x(3, 6)
    jx = paddle.to_tensor(x)
    # a new g moves the weight on the next call
    with torch.no_grad():
        t.weight_g.mul_(2.0)
    j.weight_g.set_value(np.array(j.weight_g.numpy()) * 2.0)
    jo, to = j(jx), t(torch.from_numpy(x))
    _close(to, jo, 1e-5, "output")
    r = _x(3, 4, seed=5)
    (jo * paddle.to_tensor(r)).sum().backward()
    (to * torch.from_numpy(r)).sum().backward()
    for n in ("weight_g", "weight_v"):
        _close(getattr(t, n).grad, jp[n].grad, 1e-4, f"grad {n}")


def test_remove_weight_norm_restores_the_weight():
    j, t = _pair(lambda nn: nn.Linear(6, 4))
    for m, u in ((j, jutils), (t, tutils)):
        u.weight_norm(m, dim=1)
        u.remove_weight_norm(m)
    jp = dict(j.named_parameters())
    assert sorted(n for n, _ in t.named_parameters()) == sorted(jp) == \
        ["bias", "weight"]
    assert isinstance(t.weight, torch.nn.Parameter)
    _close(t.weight, jp["weight"], 1e-6, "weight")
    x = _x(2, 6)
    _close(t(torch.from_numpy(x)), j(paddle.to_tensor(x)), 1e-5, "output")
    assert not t._forward_pre_hooks


def test_clip_helpers_match_jax():
    assert tutils.clip_grad_norm_ is tclip.clip_grad_norm_
    assert tutils.clip_grad_value_ is tclip.clip_grad_value_
    j, t = _pair(_net)
    x = _x(4, 5)
    for m, xx in ((j, paddle.to_tensor(x)), (t, torch.from_numpy(x))):
        (m(xx) * 3.0).sum().backward()
    jn = jutils.clip_grad_norm_(list(j.parameters()), 0.5)
    tn = tutils.clip_grad_norm_(list(t.parameters()), 0.5)
    _close(tn, jn, 1e-5, "total norm")
    jutils.clip_grad_value_(list(j.parameters()), 0.01)
    tutils.clip_grad_value_(list(t.parameters()), 0.01)
    for (n, tp), jp in zip(t.named_parameters(), j.parameters()):
        _close(tp.grad, jp.grad, 1e-5, f"clipped grad {n}")
