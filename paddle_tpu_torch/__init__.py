"""paddle_tpu_torch — the PyTorch/CUDA port of the paddle_tpu package.

A second package beside the JAX reference (``paddle_tpu``): the same
module paths and names, PyTorch tensors and ``nn.Module``s underneath,
and hand-written CUDA kernels for Hopper (``csrc/``, built with nvcc at
first use by ``_kernels``) where the JAX package runs Pallas kernels on
the TPU. Ported so far: the serving path (``FusedCausalLM`` under
``GenerationEngine`` / ``ContinuousBatchingEngine`` / ``ServingEngine``,
quantized, MoE and multi-LoRA) and the GPT training step (``nn``,
``optimizer``, ``amp``, ``jit.TrainStep``, ``bench.build_model`` /
``run_config``). Entry points run on the CUDA card unless the caller
passes ``device="cpu"``, where every kernel runs its plain PyTorch
version.
"""
from __future__ import annotations

from . import amp, jit, nn, optimizer
from .bench import build_model, run_config
from .core.generator import seed
from .jit import TrainStep

__all__ = ["seed", "nn", "optimizer", "amp", "jit", "TrainStep",
           "build_model", "run_config"]
