"""The port's ``nn`` layer library against the JAX package's: names,
``state_dict`` keys (buffers included), containers, modes and weights
carried across.

- Every layer class and functional of the JAX package's ``nn.layers``
  (activation, common, conv, loss, norm, pooling) and
  ``nn.functional`` (but attention's) exists in the port under the same
  name.
- A small model using the containers (``Sequential`` with named and
  unnamed entries, ``LayerList``, ``LayerDict``, ``ParameterList``) and
  most layer kinds gives the same ``state_dict`` keys and shapes in both
  packages, BN's ``_mean``/``_variance`` among them, a non-persistable
  buffer left out; ``train()``/``eval()`` reach every sublayer.
- ``load_jax_params`` carries parameters and buffers by their JAX names,
  strictly (a missing buffer raises), copying in place (each tensor
  keeps its storage, which a captured program reads); the model then
  computes the JAX model's outputs in eval and in training (1e-5, f32).
- ``set_state_dict`` copies in place and reports missing and
  unexpected keys; ``SyncBatchNorm.convert_sync_batchnorm`` shares the
  parameters and buffers.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch.nn as tnn
from paddle_tpu_torch.convert import load_jax_params
from paddle_tpu_torch.nn import functional as TF

torch.set_num_threads(1)


def test_every_layer_and_functional_name_is_ported():
    import importlib

    for mod in ("activation", "common", "conv", "loss", "norm", "pooling",
                "rnn", "transformer"):
        names = importlib.import_module(f"paddle_tpu.nn.layers.{mod}") \
            .__all__
        assert [n for n in names if not hasattr(tnn, n)] == [], mod
    attention = set(importlib.import_module(
        "paddle_tpu.nn.functional.attention").__all__)
    assert [n for n in JF.__all__ if n not in attention
            and not hasattr(TF, n)] == []


def _model(nn):
    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.stem = nn.Sequential(
                ("conv", nn.Conv2D(3, 8, 3, padding=1)),
                ("bn", nn.BatchNorm2D(8)), ("act", nn.ReLU()))
            self.blocks = nn.LayerList([
                nn.Sequential(nn.Conv2D(8, 8, 3, padding=1, groups=2,
                                        bias_attr=False),
                              nn.GroupNorm(4, 8), nn.PReLU(8)),
                nn.Sequential(nn.Conv2DTranspose(8, 8, 2, stride=2),
                              nn.InstanceNorm2D(8), nn.Hardswish()),
            ])
            self.heads = nn.LayerDict({"pool": nn.AdaptiveAvgPool2D(1),
                                       "flat": nn.Flatten()})
            self.scales = nn.ParameterList([self.create_parameter(
                [8], default_initializer=nn.initializer.Constant(1.0))])
            self.norm1d = nn.BatchNorm1D(8)
            self.fc = nn.Linear(8, 4)

        def forward(self, x):
            x = self.stem(x)
            for blk in self.blocks:
                x = blk(x)
            x = self.heads["flat"](self.heads["pool"](x)) * self.scales[0]
            return self.fc(self.norm1d(x))
    return Net()


def _shapes(sd):
    return {k: tuple(v.shape) for k, v in sd.items()}


def _jax_arrays(m):
    return {k: np.array(v.numpy()) for k, v in m.state_dict().items()}


def _seeded(arrays, seed=0):
    """The same keys with seeded values: weights small normals, BN
    variances positive."""
    r = np.random.RandomState(seed)
    out = {}
    for k, v in arrays.items():
        if k.endswith("_variance"):
            out[k] = (r.rand(*v.shape) + 0.5).astype(v.dtype)
        else:
            out[k] = (r.randn(*v.shape) * 0.3).astype(v.dtype)
    return out


def test_state_dict_keys_containers_and_modes():
    jm = _model(jnn)
    tm = _model(tnn).to("cpu")
    jsd, tsd = jm.state_dict(), tm.state_dict()
    assert _shapes(tsd) == {k: tuple(v.shape) for k, v in jsd.items()}
    assert {"stem.bn._mean", "stem.bn._variance", "norm1d._mean",
            "norm1d._variance", "scales.0"} <= set(tsd)
    tm.stem.bn.register_buffer("scratch", torch.zeros(2), persistable=False)
    assert "stem.bn.scratch" not in tm.state_dict()
    assert "stem.bn.scratch" in dict(tm.named_buffers())
    tm.eval()
    assert not any(m.training for m in tm.sublayers(include_self=True))
    tm.train()
    assert all(m.training for m in tm.sublayers(include_self=True))
    assert len(tm.stem) == 3 and isinstance(tm.stem[1], tnn.BatchNorm2D)
    assert list(tm.heads.keys()) == ["pool", "flat"]


def test_load_jax_params_with_buffers_in_place_and_outputs():
    jm = _model(jnn)
    tm = _model(tnn).to("cpu")
    arrays = _seeded(_jax_arrays(jm))
    jm.set_state_dict(arrays)
    ptrs = {k: v.data_ptr() for k, v in tm.state_dict().items()}
    load_jax_params(tm, arrays)
    assert {k: v.data_ptr() for k, v in tm.state_dict().items()} == ptrs
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), arrays[k])
    x = np.random.RandomState(1).randn(3, 3, 6, 6).astype(np.float32)
    for train in (False, True):
        jm.train() if train else jm.eval()
        tm.train() if train else tm.eval()
        j = np.array(jm(paddle.to_tensor(x)).numpy())
        t = tm(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-5)
    # one training forward moved the running statistics the same way
    np.testing.assert_allclose(tm.stem.bn._mean.numpy(),
                               np.array(jm.stem.bn._mean.numpy()),
                               atol=1e-6)
    with pytest.raises(KeyError, match="stem.bn._mean"):
        load_jax_params(tm, {k: v for k, v in arrays.items()
                             if k != "stem.bn._mean"})


def test_set_state_dict_and_convert_sync_batchnorm():
    tm = _model(tnn).to("cpu")
    sd = {k: torch.full_like(v, 0.5) for k, v in tm.state_dict().items()}
    sd["unknown"] = torch.zeros(1)
    ptr = tm.fc.weight.data_ptr()
    missing, unexpected = tm.set_state_dict(
        {k: v for k, v in sd.items() if k != "fc.bias"})
    assert missing == ["fc.bias"] and unexpected == ["unknown"]
    assert tm.fc.weight.data_ptr() == ptr and float(tm.fc.weight[0, 0].detach()) == 0.5
    with pytest.raises(ValueError, match="shape mismatch"):
        tm.set_state_dict({"fc.bias": torch.zeros(5)})
    bn = tm.stem.bn
    tnn.SyncBatchNorm.convert_sync_batchnorm(tm)
    assert isinstance(tm.stem.bn, tnn.SyncBatchNorm)
    assert tm.stem.bn.weight is bn.weight and tm.stem.bn._mean is bn._mean
    assert isinstance(tm.norm1d, tnn.SyncBatchNorm)
