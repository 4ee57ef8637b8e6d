"""``nn.utils`` (counterpart of ``paddle_tpu/nn/utils.py``): the gradient
clip helpers, ``parameters_to_vector`` / ``vector_to_parameters`` and
the weight-norm reparameterization (``weight = g * v / |v|``)."""
from __future__ import annotations

import torch

from .clip import clip_grad_norm_, clip_grad_value_

__all__ = ["clip_grad_norm_", "clip_grad_value_", "parameters_to_vector",
           "vector_to_parameters", "weight_norm", "remove_weight_norm"]


def parameters_to_vector(parameters, name=None):
    """Every parameter flattened and concatenated, in order, as one 1-D
    tensor (differentiable)."""
    return torch.cat([p.reshape(-1) for p in parameters])


def vector_to_parameters(vec, parameters, name=None):
    """Copy consecutive slices of ``vec`` into ``parameters`` in place,
    each cast to its parameter's dtype."""
    vec = torch.as_tensor(vec)
    offset = 0
    with torch.no_grad():
        for p in parameters:
            n = p.numel()
            p.copy_(vec[offset:offset + n].reshape(p.shape))
            offset += n


def _norm_except(w, dim, keepdim=True):
    """The L2 norm of ``w`` over every axis but ``dim`` (over all of them
    when ``dim`` is None: a 0-d tensor)."""
    if dim is None:
        return w.square().sum().sqrt()
    axes = [i for i in range(w.ndim) if i != dim]
    if not axes:
        return w.abs()
    return w.square().sum(dim=axes, keepdim=keepdim).sqrt()


def weight_norm(layer, name="weight", dim=0):
    """Replace ``layer``'s parameter ``name`` by ``name_g`` (its norm
    over every axis but ``dim``; ``[1]`` when ``dim`` is None) and
    ``name_v`` (its value); a forward pre-hook sets ``layer.name = g *
    v / |v|`` before each call (and once now). Returns ``layer``."""
    w = getattr(layer, name).detach()
    g0 = _norm_except(w, dim, keepdim=False)
    if dim is None:
        g0 = g0.reshape(1)
    layer.add_parameter(name + "_g", torch.nn.Parameter(g0.clone()))
    layer.add_parameter(name + "_v", torch.nn.Parameter(w.clone()))
    del layer._parameters[name]

    def compute(layer_, _inputs):
        v = layer_._parameters[name + "_v"]
        g = layer_._parameters[name + "_g"]
        shape = [1] * v.ndim
        if dim is not None:
            shape[dim] = -1
        layer_.__dict__[name] = v * (g.reshape(shape)
                                     / _norm_except(v, dim))

    layer.__dict__["_weight_norm_hook_" + name] = \
        layer.register_forward_pre_hook(compute)
    compute(layer, None)
    return layer


def remove_weight_norm(layer, name="weight"):
    """Undo ``weight_norm``: ``name`` becomes a parameter again, holding
    the last computed ``g * v / |v|``. Returns ``layer``."""
    hook = layer.__dict__.pop("_weight_norm_hook_" + name, None)
    if hook is not None:
        hook.remove()
    v = layer._parameters.pop(name + "_v", None)
    g = layer._parameters.pop(name + "_g", None)
    if v is not None and g is not None:
        w = layer.__dict__.pop(name, None)
        layer.add_parameter(name, torch.nn.Parameter(
            (w if w is not None else v).detach().clone()))
    return layer
