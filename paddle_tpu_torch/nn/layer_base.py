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
torch.device(...)``), from that device's generator. Buffers take the JAX
names (``register_buffer(name, t, persistable=)``); ``state_dict`` holds
the parameters and the persistable buffers under the JAX package's keys
(``"bn1._mean"``), and ``set_state_dict`` copies into them in place, so
storage a captured CUDA graph reads stays where it is. ``train()`` and
``eval()`` reach every sublayer. The containers are ``Sequential``,
``LayerList``, ``ParameterList`` and ``LayerDict``. ``clone_layer``
deep-copies a layer under fresh names.
"""
from __future__ import annotations

import copy
from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from . import initializer as I

__all__ = ["ParamAttr", "Layer", "Sequential", "LayerList",
           "ParameterList", "LayerDict", "clone_layer"]


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

#: what ``create_parameter`` sets on a parameter beside its name
_PARAM_ATTRS = ("optimize_attr", "regularizer", "need_clip")


def _next_full_name(tag: str) -> str:
    idx = _layer_instance_counters.get(tag, 0)
    _layer_instance_counters[tag] = idx + 1
    return f"{tag}_{idx}"


class Layer(torch.nn.Module):
    def __init__(self, name_scope: str = None, dtype: str = "float32"):
        super().__init__()
        self._dtype = dtype
        self._name_tag = (name_scope or type(self).__name__).lower()
        self._full_name = _next_full_name(self._name_tag)

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

    def sublayers(self, include_self: bool = False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    def add_sublayer(self, name: str, sublayer):
        self.add_module(name, sublayer)
        return sublayer

    def add_parameter(self, name: str, parameter):
        if parameter is not None and \
                getattr(parameter, "param_name", None) is None:
            parameter.param_name = f"{self._full_name}.{name}"
        self.register_parameter(name, parameter)
        return parameter

    def register_buffer(self, name: str, tensor, persistable: bool = True):
        """A buffer under ``name``; a persistable one is in
        ``state_dict`` (Paddle's ``persistable``, torch's
        ``persistent``)."""
        super().register_buffer(name, tensor, persistent=persistable)
        return tensor

    def set_state_dict(self, state_dict, use_structured_name: bool = True):
        """Copy ``state_dict``'s entries (tensors or arrays) into the
        parameters and persistable buffers of the same keys, in place and
        in their own dtype; raises on a shape mismatch. Returns
        ``(missing, unexpected)`` keys."""
        own = self.state_dict(keep_vars=True)
        missing = [k for k in own if k not in state_dict]
        unexpected = [k for k in state_dict if k not in own]
        with torch.no_grad():
            for k, v in state_dict.items():
                if k not in own:
                    continue
                t = own[k]
                src = v if torch.is_tensor(v) else torch.from_numpy(
                    np.asarray(v))
                if tuple(src.shape) != tuple(t.shape):
                    raise ValueError(f"shape mismatch for {k}: "
                                     f"{tuple(src.shape)} vs "
                                     f"{tuple(t.shape)}")
                t.copy_(src)
        return missing, unexpected


def clone_layer(layer: Layer) -> Layer:
    """A deep copy of ``layer`` (parameters, buffers, modes) whose
    layers take fresh structured names, as constructing them again
    would give, and whose parameters keep their ``ParamAttr`` settings
    under names of their new layers. A torch deep copy alone keeps no
    attribute of a parameter, and optimizer state is keyed by
    ``param_name``: the copies of one layer in a stack
    (``TransformerEncoder``'s) must not share names."""
    new = copy.deepcopy(layer)
    pairs = zip(new.named_sublayers(include_self=True),
                layer.named_sublayers(include_self=True))
    for (_, sub), (_, src) in pairs:
        if not isinstance(sub, Layer):
            continue
        sub._full_name = _next_full_name(src._name_tag)
        for name, p in sub._parameters.items():
            if p is None:
                continue
            old = src._parameters[name]
            for attr in _PARAM_ATTRS:
                if hasattr(old, attr):
                    value = getattr(old, attr)
                    setattr(p, attr, dict(value) if isinstance(value, dict)
                            else value)
            p.param_name = f"{sub._full_name}.{name}"
    return new


class Sequential(Layer):
    """Sublayers called in order: ``Sequential(a, b)`` names them
    ``"0"``, ``"1"``; ``(name, layer)`` pairs, or one list of them, name
    them."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                len(layers[0]) and isinstance(layers[0][0], tuple):
            layers = layers[0]
        for i, layer in enumerate(layers):
            if isinstance(layer, tuple):
                self.add_sublayer(layer[0], layer[1])
            else:
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        layers = list(self._modules.values())
        if isinstance(idx, slice):
            return Sequential(*layers[idx])
        return layers[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


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

    def __setitem__(self, idx, layer):
        self.add_module(str(idx % len(self)), layer)

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def append(self, layer):
        self.add_module(str(len(self)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._modules.values())
        layers.insert(index, layer)
        self._modules.clear()
        for i, sub in enumerate(layers):
            self.add_module(str(i), sub)

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class ParameterList(Layer):
    """An indexable list of parameters named ``"0"``, ``"1"``, ..."""

    def __init__(self, parameters=None):
        super().__init__()
        for p in parameters or ():
            self.append(p)

    def __getitem__(self, idx):
        return list(self._parameters.values())[idx]

    def __setitem__(self, idx, p):
        self.add_parameter(str(idx % len(self)), p)

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, p):
        self.add_parameter(str(len(self)), p)
        return self


class LayerDict(Layer):
    """Sublayers by name, in insertion order."""

    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._modules[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._modules[key]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules)

    def __contains__(self, key):
        return key in self._modules

    def clear(self):
        self._modules.clear()

    def pop(self, key):
        return self._modules.pop(key)

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def values(self):
        return self._modules.values()

    def update(self, sublayers):
        items = sublayers.items() if isinstance(
            sublayers, (dict, OrderedDict, LayerDict)) else sublayers
        for k, v in items:
            self[k] = v
        return self
