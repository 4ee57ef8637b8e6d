"""Neural-network building blocks of the port: the Paddle-shaped
``Layer`` base and its containers, the layers (activations, common,
convolutions, losses, normalizations, pooling, recurrent, transformer),
their initializers, gradient clipping (``clip``), ``utils`` and
``functional``."""
from . import clip, functional, initializer, layers, utils
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer_base import (Layer, LayerDict, LayerList, ParamAttr,
                         ParameterList, Sequential)
from .layers import *  # noqa: F401,F403

__all__ = (["functional", "initializer", "clip", "layers", "utils", "Layer",
            "LayerList", "LayerDict", "ParameterList", "Sequential",
            "ParamAttr", "ClipGradByValue", "ClipGradByNorm",
            "ClipGradByGlobalNorm", "clip_grad_norm_", "clip_grad_value_"]
           + list(layers.__all__))
