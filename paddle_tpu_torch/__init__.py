"""paddle_tpu_torch — the PyTorch/CUDA port of the paddle_tpu package.

A second package beside the JAX reference (``paddle_tpu``): the same
module paths and names, PyTorch tensors and ``nn.Module``s underneath,
and hand-written CUDA kernels for Hopper (``csrc/``, built with nvcc at
first use by ``_kernels``) where the JAX package runs Pallas kernels on
the TPU. This slice ports the serving path: ``FusedCausalLM`` under
``GenerationEngine`` / ``ContinuousBatchingEngine`` with the paged KV
pool. Entry points run on the CUDA card unless the caller passes
``device="cpu"``, where every kernel runs its plain PyTorch version.
"""
from __future__ import annotations

from .core.generator import seed

__all__ = ["seed"]
