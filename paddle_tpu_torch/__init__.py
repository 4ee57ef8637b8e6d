"""paddle_tpu_torch — the PyTorch/CUDA port of the paddle_tpu package.

A second package beside the JAX reference (``paddle_tpu``): the same
module paths and names, PyTorch tensors and ``nn.Module``s underneath,
and hand-written CUDA kernels for Hopper (``csrc/``, built with nvcc at
first use by ``_kernels``) where the JAX package runs Pallas kernels on
the TPU. ``import paddle_tpu_torch as paddle`` gives Paddle's tensor
API: the dtypes (``paddle.float32``), the places (``set_device``,
``CUDAPlace``, ``CPUPlace``), ``to_tensor``, ``Tensor`` and
``Parameter`` (torch's own classes), the 274 functions of ``ops``
(``matmul``, ``where``, ``arange``, ``concat``, ...) with Paddle's
signatures, ``linalg``, ``autograd`` with ``grad`` and ``no_grad``, and
``get_rng_state``/``set_rng_state``. On it: the serving path
(``FusedCausalLM`` under ``GenerationEngine`` /
``ContinuousBatchingEngine`` / ``ServingEngine``, quantized, MoE and
multi-LoRA), the GPT training step (``nn``, ``optimizer``, ``amp``,
``jit.TrainStep``, ``bench.build_model`` / ``run_config``) with the
training loop's core (AMP O1, ``GradScaler``, the LR schedulers,
gradient clipping, ``regularizer``, optimizer checkpoints, every
optimizer), the no-drop MoE training step, the ``nn`` layer library
with the sequence layers, ``vision.models.resnet18``, ``jit.to_static``
(one captured CUDA graph per input signature) and ``text.models``
(BERT, ``bench.run_bert_bench``). Everything runs on the current place:
the CUDA card unless the caller asks for the CPU (``set_device("cpu")``
or ``device="cpu"``), where every kernel runs its plain PyTorch
version; without a card and without that request it raises.
"""
from __future__ import annotations

from .core.dtype import (  # noqa: F401
    bfloat16, bool_, complex64, complex128, dtype, float16, float32, float64,
    get_default_dtype, int8, int16, int32, int64, set_default_dtype, uint8,
    uint16, uint32, uint64,
)
from .core.dtype import bool_ as bool  # noqa: F401,A001
from .core.place import (  # noqa: F401
    CPUPlace, CUDAPlace, Place, TPUPlace, device_count, get_device,
    is_compiled_with_cuda, is_compiled_with_tpu, set_device,
)
from .core.flags import get_flags, set_flags  # noqa: F401
from .core.generator import get_rng_state, seed, set_rng_state  # noqa: F401
from .core.tensor import Parameter, Tensor, to_tensor  # noqa: F401
from .autograd import (  # noqa: F401
    enable_grad, grad, is_grad_enabled, no_grad, set_grad_enabled,
)

from .ops import *  # noqa: F401,F403
from .ops import astype, increment_  # noqa: F401
from .ops import registry as _op_registry  # noqa: F401

from . import (amp, autograd, jit, linalg, nn, optimizer,  # noqa: F401
               regularizer)
from . import text, vision  # noqa: F401
from .bench import build_model, run_config  # noqa: F401
from .jit import TrainStep, to_static  # noqa: F401
from .nn.layer_base import ParamAttr  # noqa: F401
from .ops import __all__ as _ops_all

__all__ = [
    "bfloat16", "bool", "bool_", "complex64", "complex128", "dtype",
    "float16", "float32", "float64", "get_default_dtype", "int8", "int16",
    "int32", "int64", "set_default_dtype", "uint8", "uint16", "uint32",
    "uint64", "CPUPlace", "CUDAPlace", "Place", "TPUPlace", "device_count",
    "get_device", "is_compiled_with_cuda", "is_compiled_with_tpu",
    "set_device", "get_flags", "set_flags", "get_rng_state", "seed",
    "set_rng_state", "Parameter", "Tensor", "to_tensor", "enable_grad",
    "grad", "is_grad_enabled", "no_grad", "set_grad_enabled", "amp",
    "autograd", "jit", "linalg", "nn", "optimizer", "regularizer", "text",
    "vision", "TrainStep", "to_static", "ParamAttr", "build_model",
    "run_config",
] + [n for n in _ops_all if n != "to_tensor"]
