"""``Layer``: the port's base of Paddle-shaped layers (counterpart of
``paddle_tpu/nn/layer_base.py``).

A ``Layer`` is a ``torch.nn.Module`` with Paddle's parameter surface:
``create_parameter`` (a ``ParamAttr`` or ``False`` for none, a default
initializer, the per-parameter learning-rate multiplier in
``p.optimize_attr``, the regularizer and ``need_clip`` the optimizer
reads as ``p.regularizer`` and ``p.need_clip``), ``named_sublayers``
and structured parameter names (``"linear_0.weight"``, by class and
construction order, as the JAX package names them for
``apply_decay_param_fun`` and optimizer checkpoints; kept as
``p.param_name``, since a torch tensor's ``name`` is read-only).
Parameters are created on the default device (``with
torch.device(...)``), from that device's generator.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import initializer as I

__all__ = ["ParamAttr", "Layer", "LayerList"]


class ParamAttr:
    """Parameter attribute bundle."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, I.Initializer):
            return ParamAttr(initializer=attr)
        if attr is False:
            return False
        raise TypeError(f"cannot convert {type(attr)} to ParamAttr")


_layer_instance_counters: Dict[str, int] = {}


class Layer(torch.nn.Module):
    def __init__(self, name_scope: str = None, dtype: str = "float32"):
        super().__init__()
        self._dtype = dtype
        tag = (name_scope or type(self).__name__).lower()
        idx = _layer_instance_counters.get(tag, 0)
        _layer_instance_counters[tag] = idx + 1
        self._full_name = f"{tag}_{idx}"

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A new ``torch.nn.Parameter`` (``None`` when ``attr`` is
        ``False``): ``attr``'s initializer, else ``default_initializer``,
        else zeros for a bias and Xavier-normal for a weight."""
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        init = attr.initializer or default_initializer or (
            I.Constant(0.0) if is_bias else I.XavierNormal())
        data = init(tuple(int(s) for s in shape), dtype or self._dtype,
                    torch.get_default_device())
        p = torch.nn.Parameter(data, requires_grad=attr.trainable)
        p.param_name = attr.name
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def __setattr__(self, name, value):
        if isinstance(value, torch.nn.Parameter) and \
                getattr(value, "param_name", None) is None:
            value.param_name = f"{self._full_name}.{name}"
        super().__setattr__(name, value)

    def named_sublayers(self, prefix: str = "", include_self: bool = False):
        """``(name, layer)`` of every sublayer, depth first; the layer
        itself first (as ``prefix``) with ``include_self``."""
        if include_self:
            yield prefix, self
        for name, sub in self._modules.items():
            if sub is None:
                continue
            p = f"{prefix}.{name}" if prefix else name
            yield from sub.named_sublayers(prefix=p, include_self=True) \
                if isinstance(sub, Layer) else ((p, sub),)


class LayerList(Layer):
    """An indexable list of sublayers named ``"0"``, ``"1"``, ..."""

    def __init__(self, sublayers=None):
        super().__init__()
        for layer in sublayers or ():
            self.append(layer)

    def __getitem__(self, idx):
        layers = list(self._modules.values())
        if isinstance(idx, slice):
            return LayerList(layers[idx])
        return layers[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_module(str(len(self)), layer)
        return self
