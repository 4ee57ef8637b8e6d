"""Mixture of experts."""
from .moe_layer import ExpertFFN, GShardGate, MoELayer, NaiveGate, SwitchGate

__all__ = ["ExpertFFN", "GShardGate", "MoELayer", "NaiveGate", "SwitchGate"]
