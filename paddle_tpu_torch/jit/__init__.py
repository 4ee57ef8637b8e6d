"""``jit`` of the port: ``to_static`` (one captured program per input
signature; CUDA graphs on the card), the training step, ``TrainStep``,
and deployment: ``save``/``load`` (``torch.export`` programs that call
the kernels' ops) and ``TranslatedLayer``."""
from .api import TranslatedLayer, load, save
from .graph_break import GraphBreakError
from .static_function import StaticFunction, not_to_static, to_static
from .train_step import TrainStep

__all__ = ["to_static", "not_to_static", "save", "load", "StaticFunction",
           "TranslatedLayer", "GraphBreakError", "TrainStep",
           "enable_to_static", "ignore_module"]


def enable_to_static(flag: bool = True):
    """Globally on (default) or off: off, every ``to_static`` function
    runs its eager Python."""
    StaticFunction._globally_enabled = bool(flag)


def ignore_module(modules):
    """Accepted for Paddle's API: the port captures whatever a function
    calls, so there is no module to leave out."""
    return None
