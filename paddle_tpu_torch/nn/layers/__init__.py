"""Layers of the port: ``Linear``, ``Embedding``, ``LayerNorm``."""
from .common import Embedding, Linear
from .norm import LayerNorm

__all__ = ["Linear", "Embedding", "LayerNorm"]
