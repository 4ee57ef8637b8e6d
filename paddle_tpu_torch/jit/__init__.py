"""``jit`` of the port: ``to_static`` (one captured program per input
signature; CUDA graphs on the card) and the training step,
``TrainStep``."""
from .graph_break import GraphBreakError
from .static_function import StaticFunction, not_to_static, to_static
from .train_step import TrainStep

__all__ = ["to_static", "not_to_static", "StaticFunction",
           "GraphBreakError", "TrainStep"]
