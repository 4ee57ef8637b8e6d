"""Neural-network building blocks of the port: the Paddle-shaped
``Layer`` base, the layers of the training path (``Linear``,
``Embedding``, ``LayerNorm``), their initializers, and ``functional``."""
from . import functional, initializer
from .layer_base import Layer, LayerList, ParamAttr
from .layers import Embedding, LayerNorm, Linear

__all__ = ["functional", "initializer", "Layer", "LayerList", "ParamAttr",
           "Linear", "Embedding", "LayerNorm"]
