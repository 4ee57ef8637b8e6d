"""paddle_tpu_torch.static (counterpart of ``paddle_tpu/static``):
``InputSpec``, the signature type of ``jit.save``.

The rest of the JAX package's static surface (``Program``,
``Executor``, ``program_guard``, ``save_inference_model``, the
``static.nn`` and ``static.quantization`` modules, ...) is ROADMAP
item A12 of the port: each of those names raises ``NotImplementedError``
naming it.
"""
from .input_spec import InputSpec

__all__ = ["InputSpec"]

#: the JAX package's static names that come with A12
_A12 = ("nn", "quantization", "Program", "program_guard",
        "default_main_program", "default_startup_program", "data",
        "Executor", "scope_guard", "save_inference_model",
        "load_inference_model", "CompiledProgram")


def __getattr__(name):
    if name in _A12:
        raise NotImplementedError(
            f"paddle_tpu_torch.static.{name}: the static-graph API "
            "(Program, Executor, static.nn, static.quantization) is ROADMAP "
            "A12 of the port; deploy a model with jit.save / jit.load or "
            "inference.create_predictor")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
