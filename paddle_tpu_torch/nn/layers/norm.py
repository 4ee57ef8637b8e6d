"""Normalization layers (counterpart of ``paddle_tpu/nn/layers/norm.py``):
the ``BatchNorm`` family with its running statistics as the persistable
buffers ``_mean`` and ``_variance`` (f32, zeros and ones), updated in
place in training; ``SyncBatchNorm`` (local statistics in one process, as
the JAX package's eager path has) and its ``convert_sync_batchnorm``;
``LayerNorm``, ``RMSNorm``, ``GroupNorm``, ``InstanceNorm1D/2D/3D``,
``LocalResponseNorm`` and ``SpectralNorm``."""
from __future__ import annotations

import math

import torch

from .. import functional as F
from .. import initializer as I
from ..layer_base import Layer

__all__ = [
    "BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
    "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
    "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm", "RMSNorm",
    "SpectralNorm",
]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            shape=[num_features], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            shape=[num_features], attr=bias_attr, is_bias=True)
        dev = torch.get_default_device()
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=torch.float32, device=dev))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=torch.float32, device=dev))

    def forward(self, x):
        return F.batch_norm(
            x, self._mean, self._variance, self.weight, self.bias,
            training=self.training, momentum=self._momentum,
            epsilon=self._epsilon, data_format=self._data_format,
            use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return f"num_features={self._num_features}, momentum={self._momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class SyncBatchNorm(_BatchNormBase):
    """Batch norm whose statistics would span the data-parallel group;
    in one process they are the local batch's, as in the JAX package's
    eager path."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every batch-norm sublayer replaced by a
        ``SyncBatchNorm`` sharing its parameters and buffers."""
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            new = cls(layer._num_features, layer._momentum, layer._epsilon,
                      data_format=layer._data_format)
            new.weight = layer.weight
            new.bias = layer.bias
            new.register_buffer("_mean", layer._mean)
            new.register_buffer("_variance", layer._variance)
            return new
        for name, sub in list(layer._modules.items()):
            if sub is not None:
                layer._modules[name] = cls.convert_sync_batchnorm(sub)
        return layer


class LayerNorm(Layer):
    """Layer normalization over the trailing ``normalized_shape`` axes
    with a weight (ones) and a bias (zeros)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            shape=self._normalized_shape, attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            shape=self._normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)

    def extra_repr(self):
        return f"normalized_shape={self._normalized_shape}"


class RMSNorm(Layer):
    def __init__(self, hidden_size, epsilon=1e-6, weight_attr=None,
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        self.weight = self.create_parameter(
            shape=[hidden_size], attr=weight_attr,
            default_initializer=I.Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups = num_groups
        self._epsilon = epsilon
        self._data_format = data_format
        self.weight = self.create_parameter(
            shape=[num_channels], attr=weight_attr,
            default_initializer=I.Constant(1.0))
        self.bias = self.create_parameter(
            shape=[num_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class _InstanceNormBase(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._epsilon = epsilon
        if weight_attr is False or bias_attr is False:
            self.scale = None
            self.bias = None
        else:
            self.scale = self.create_parameter(
                shape=[num_features], attr=weight_attr,
                default_initializer=I.Constant(1.0))
            self.bias = self.create_parameter(
                shape=[num_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.scale, bias=self.bias,
                               eps=self._epsilon)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self._data_format = data_format

    def forward(self, x):
        return F.local_response_norm(x, self.size, self.alpha, self.beta,
                                     self.k, self._data_format)


class SpectralNorm(Layer):
    """A weight over its largest singular value, estimated by
    ``power_iters`` power iterations from the vectors ``weight_u``
    (``[shape[dim]]``) and ``weight_v`` (the rest), normal draws that are
    not trained and not updated (as in the JAX package)."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32"):
        super().__init__()
        self._dim = dim
        self._power_iters = power_iters
        self._eps = eps
        h = weight_shape[dim]
        w = math.prod(weight_shape) // h
        self.weight_u = self.create_parameter(
            shape=[h], default_initializer=I.Normal(0, 1))
        self.weight_u.requires_grad_(False)
        self.weight_v = self.create_parameter(
            shape=[w], default_initializer=I.Normal(0, 1))
        self.weight_v.requires_grad_(False)

    def forward(self, weight):
        wm = weight.movedim(self._dim, 0).reshape(weight.shape[self._dim],
                                                  -1)
        u, v = self.weight_u.detach(), self.weight_v.detach()
        for _ in range(self._power_iters):
            v = wm.T @ u
            v = v / (torch.linalg.norm(v) + self._eps)
            u = wm @ v
            u = u / (torch.linalg.norm(u) + self._eps)
        return weight / (u @ wm @ v)
