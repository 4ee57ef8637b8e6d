"""Optimizers of the port: ``Adam`` and ``AdamW``."""
from .adam import Adam, AdamW
from .optimizer import Optimizer, stochastic_round_bf16

__all__ = ["Optimizer", "Adam", "AdamW", "stochastic_round_bf16"]
