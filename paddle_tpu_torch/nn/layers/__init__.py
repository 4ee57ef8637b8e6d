"""Layers of the port (counterpart of ``paddle_tpu/nn/layers``):
activations, the common layers, convolutions, losses, normalizations and
pooling."""
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403

from . import activation, common, conv, loss, norm, pooling

__all__ = (list(activation.__all__) + list(common.__all__)
           + list(conv.__all__) + list(loss.__all__) + list(norm.__all__)
           + list(pooling.__all__))
