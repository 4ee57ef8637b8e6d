"""Optimizers of the port (counterpart of ``paddle_tpu/optimizer``):
the SGD and Adam families, ``Lars``, ``LBFGS`` and the LR schedulers
(``lr``)."""
from . import lr
from .adam import Adam, Adamax, AdamW, Lamb
from .lars import Lars
from .lbfgs import LBFGS
from .optimizer import (Adadelta, Adagrad, Momentum, Optimizer, RMSProp,
                        Rprop, SGD, stochastic_round_bf16)

__all__ = ["Optimizer", "SGD", "Momentum", "Adagrad", "Adadelta",
           "RMSProp", "Rprop", "Adam", "AdamW", "Adamax", "Lamb", "LBFGS",
           "Lars", "lr", "stochastic_round_bf16"]
