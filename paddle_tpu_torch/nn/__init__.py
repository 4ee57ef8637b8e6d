"""Neural-network building blocks of the port: the Paddle-shaped
``Layer`` base, the layers of the training path (``Linear``,
``Embedding``, ``LayerNorm``), their initializers, gradient clipping
(``clip``) and ``functional``."""
from . import clip, functional, initializer
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
                   clip_grad_norm_, clip_grad_value_)
from .layer_base import Layer, LayerList, ParamAttr
from .layers import Embedding, LayerNorm, Linear

__all__ = ["functional", "initializer", "clip", "Layer", "LayerList",
           "ParamAttr", "Linear", "Embedding", "LayerNorm",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_"]
