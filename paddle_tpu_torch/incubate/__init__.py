"""Incubating APIs of the port: the fused serving transformer (``nn``)
and the mixture-of-experts layer (``moe``)."""
from . import moe, nn
from .moe import MoELayer

__all__ = ["moe", "nn", "MoELayer"]
