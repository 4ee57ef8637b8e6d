"""Layers of the port (counterpart of ``paddle_tpu/nn/layers``):
activations, the common layers, convolutions, losses, normalizations,
pooling, the recurrent layers and the transformer layers."""
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403

from . import activation, common, conv, loss, norm, pooling, rnn, transformer

__all__ = (list(activation.__all__) + list(common.__all__)
           + list(conv.__all__) + list(loss.__all__) + list(norm.__all__)
           + list(pooling.__all__) + list(rnn.__all__)
           + list(transformer.__all__))
