"""The op layer of the port (counterpart of ``paddle_tpu/ops``): the
274 functions of Paddle's tensor API with Paddle's signatures, thin
over torch, each registered under the JAX package's name
(``registry``).

The JAX package's eager machinery is not ported: ``ops/dispatch.py``
(its vjp and forward caches, ``eager_apply``) and the tape of
``core/engine.py``. torch's dispatcher runs each op and
``torch.autograd`` differentiates it. ``ops/indexing.py`` has no module
here either: a tensor's ``[]`` is torch's indexing (basic slices,
integer tensors, boolean masks), which the tests pin against the JAX
package's.
"""
from . import registry  # noqa: F401
from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .math import increment_  # noqa: F401
from .manipulation import astype  # noqa: F401

from . import (creation, extras, linalg, logic, manipulation,  # noqa: F401
               math, random)

__all__ = (
    list(creation.__all__) + list(math.__all__) + list(manipulation.__all__)
    + list(logic.__all__) + list(linalg.__all__) + list(random.__all__)
    + list(extras.__all__)
)
