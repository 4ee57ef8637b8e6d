"""ResNet-18 of the port (``paddle_tpu_torch.vision.models.resnet18``)
against the JAX package's at 2 x 3 x 32 x 32, 10 classes, in f32.

The JAX model is built with its initializers answered by numpy zeros
(its random initializers compile a program per shape on the CPU, tens
of seconds), then both models take the same seeded numpy weights and BN
statistics (``set_state_dict`` on the JAX side, ``load_jax_params`` on
the port's, parameters and buffers by their JAX names).

- Eval: the logits within 1e-4 of the largest |logit| (f32 convolutions
  summed in another order, 20 layers deep).
- One training step (train mode, batch statistics,
  ``CrossEntropyLoss``) at 2 x 3 x 64 x 64: the loss and every gradient
  within twice the witness (the port's own step on an input a random
  half of which is one f32 ulp away; at least 1e-5 relative for the
  loss, 1e-4 relative L2 for a gradient), every BN running statistic
  after the step within 5e-5 relatively. At 32 x 32 the last stage's BN
  would normalize two values a channel (batch 2, 1 x 1), whose backward
  nearly cancels: every earlier gradient then moves by 2-4% under a
  one-ulp input change, in either package, and says nothing of the
  port; at 64 x 64 it normalizes eight and both packages agree to 1e-5.
- The O1 census of one eval forward, on the ops the port hooks
  (``conv2d``, ``batch_norm``, ``linear``), equals the JAX census
  exactly: ``conv2d<bfloat16>``, ``batch_norm<float32>``,
  ``linear<bfloat16>``.
- ``pretrained=True`` raises in both; without ``device="cpu"`` and
  without a card the port's constructor raises.
"""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu.nn import initializer as jinit
from paddle_tpu.vision.models import resnet18 as jresnet18
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.amp import debugging as tdbg
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.vision.models import resnet18 as tresnet18

torch.set_num_threads(1)

CLASSES = 10
HOOKED = ("conv2d", "batch_norm", "linear")


def _zeros(self, shape, dtype="float32"):
    return jnp.asarray(np.zeros(tuple(int(s) for s in shape), np.float32))


def _weights(sd):
    """Seeded numpy values for every key: He-scaled convolution weights,
    BN weights near 1, small biases, positive variances."""
    r = np.random.RandomState(0)
    out = {}
    for k, v in sd.items():
        shape = tuple(v.shape)
        if k.endswith("_variance"):
            a = r.rand(*shape) + 0.5
        elif k.endswith("_mean"):
            a = r.randn(*shape) * 0.1
        elif len(shape) == 4:
            a = r.randn(*shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        elif len(shape) == 2:
            a = r.randn(*shape) * 0.05
        elif k.endswith("weight"):
            a = 1.0 + 0.1 * r.randn(*shape)
        else:
            a = 0.1 * r.randn(*shape)
        out[k] = a.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def models():
    with mock.patch.object(jinit.KaimingUniform, "__call__", _zeros), \
            mock.patch.object(jinit.Uniform, "__call__", _zeros), \
            mock.patch.object(jinit.XavierNormal, "__call__", _zeros):
        jm = jresnet18(num_classes=CLASSES)
    arrays = _weights(jm.state_dict())
    jm.set_state_dict(arrays)
    tm = tresnet18(num_classes=CLASSES, device="cpu")
    load_jax_params(tm, arrays)
    r = np.random.RandomState(1)
    x = r.randn(2, 3, 32, 32).astype(np.float32)
    labels = np.array([3, 7], np.int64)
    return jm, tm, arrays, x, labels


#: the training step's input (see the module note)
TRAIN_SHAPE = (2, 3, 64, 64)


def test_eval_logits_match(models):
    jm, tm, _, x, _ = models
    jm.eval()
    tm.eval()
    j = np.array(jm(paddle.to_tensor(x)).numpy())
    with torch.no_grad():
        t = tm(torch.from_numpy(x)).numpy()
    assert t.shape == (2, CLASSES)
    np.testing.assert_allclose(t, j, atol=1e-4 * np.abs(j).max(), rtol=0)


def _port_step(tm, arrays, x, labels):
    """Loss, gradients and running statistics of one training step of
    the port's model from ``arrays``."""
    load_jax_params(tm, arrays)
    tm.train()
    tm.zero_grad()
    loss = tnn.CrossEntropyLoss()(tm(torch.from_numpy(x)),
                                  torch.from_numpy(labels))
    loss.backward()
    grads = {n: p.grad.numpy().copy() for n, p in tm.named_parameters()}
    stats = {k: v.numpy().copy() for k, v in tm.state_dict().items()
             if k.endswith(("_mean", "_variance"))}
    tm.zero_grad()
    return float(loss.detach()), grads, stats


def _nudged(x):
    """``x`` with a random half of its entries one f32 ulp further from
    zero."""
    flip = np.random.RandomState(2).rand(*x.shape) < 0.5
    return (x.view(np.int32) + flip.astype(np.int32)).view(np.float32)


def test_training_step_loss_gradients_and_bn_stats(models):
    jm, tm, arrays, _, labels = models
    x = np.random.RandomState(3).randn(*TRAIN_SHAPE).astype(np.float32)
    jm.set_state_dict(arrays)
    jm.train()
    jloss = jnn.CrossEntropyLoss()(jm(paddle.to_tensor(x)),
                                   paddle.to_tensor(labels))
    jloss.backward()
    loss, grads, stats = _port_step(tm, arrays, x, labels)
    # the witness: the port's own step on an input one ulp away
    wloss, wgrads, _ = _port_step(tm, arrays, _nudged(x), labels)
    j = float(np.array(jloss.numpy()))
    assert abs(loss - j) <= max(2 * abs(wloss - loss), 1e-5 * abs(j)), \
        (loss, j, wloss)
    jp = dict(jm.named_parameters())

    def rel(a, b):
        return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
    for name, g in grads.items():
        jg = np.array(jp[name].grad.numpy())
        limit = max(2 * rel(wgrads[name], g), 1e-4)
        assert rel(g, jg) <= limit, (name, rel(g, jg), limit)
    jsd = jm.state_dict()
    for k, v in stats.items():
        np.testing.assert_allclose(v, np.array(jsd[k].numpy()), atol=1e-6,
                                   rtol=5e-5, err_msg=k)
    for p in jm.parameters():
        p.clear_gradient()


def test_o1_census_matches_jax(models):
    jm, tm, _, x, _ = models
    jm.eval()
    tm.eval()
    jdbg.enable_operator_stats_collection()
    try:
        with paddle.amp.auto_cast(level="O1"):
            jm(paddle.to_tensor(x))
        jc = {k: v for k, v in jdbg._op_stats["counts"].items()
              if k.split("<")[0] in HOOKED}
    finally:
        jdbg.disable_operator_stats_collection()
    tdbg.enable_operator_stats_collection()
    try:
        with torch.no_grad(), tamp.auto_cast(level="O1"):
            out = tm(torch.from_numpy(x))
        tc = dict(tdbg._op_stats["counts"])
    finally:
        tdbg.disable_operator_stats_collection()
    assert out.dtype == torch.bfloat16
    # 20 convolutions (x, weight), 20 BNs in eval (x, the running mean
    # and variance, weight, bias), one linear (x, weight, bias)
    assert tc == jc == {"conv2d<bfloat16>": 40, "batch_norm<float32>": 100,
                        "linear<bfloat16>": 3}


def test_pretrained_and_device_rules():
    with pytest.raises(NotImplementedError, match="pretrained"):
        jresnet18(pretrained=True)
    with pytest.raises(NotImplementedError, match="pretrained"):
        tresnet18(pretrained=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tresnet18()
