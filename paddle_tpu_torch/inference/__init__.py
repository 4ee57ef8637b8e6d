"""paddle_tpu_torch.inference — the deployment predictor and the serving
engines.

Counterpart of ``paddle_tpu/inference/``. The predictor API (``Config``,
``create_predictor``, ``Predictor``, ``PredictorTensor``) loads a
``jit.save`` artifact (a ``torch.export`` program that calls the
kernels' ops, and its state) onto the card, or onto the CPU after
``Config.disable_gpu()``, and runs it. Beside it: the fused causal LM,
the generation and continuous-batching engines, the paged KV block
manager, and speculative decoding (drafters and the batched verify
pass).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .engine import (DEFAULT_DECODE_CHUNK, ContinuousBatchingEngine,
                     FusedCausalLM, GenerationEngine, GenRequest)
from .kv_cache import BlockKVCacheManager
from .speculative import (Drafter, DraftModelDrafter, ScheduledDrafter,
                          SelfDraftHeads, SpeculativeDecoder,
                          build_speculative_decoder)

__all__ = ["Config", "create_predictor", "Predictor", "PredictorTensor",
           "to_host",
           "FusedCausalLM", "GenerationEngine", "BlockKVCacheManager",
           "ContinuousBatchingEngine", "GenRequest", "DEFAULT_DECODE_CHUNK",
           "Drafter", "DraftModelDrafter", "SelfDraftHeads",
           "ScheduledDrafter", "SpeculativeDecoder",
           "build_speculative_decoder"]


class Config:
    """Predictor configuration (the JAX ``Config``, Paddle's
    ``inference.Config``), by the JAX package's method names. "The
    accelerator" is the card: the predictor runs there unless
    ``disable_gpu()`` (or its alias ``disable_tpu()``) selects the CPU,
    and without a card it raises. The precision and optimization
    switches are recorded: the saved program runs as it was exported."""

    def __init__(self, prog_file: str, params_file: Optional[str] = None):
        # the jit.save prefix or the .pdmodel path
        if prog_file.endswith(".pdmodel"):
            prog_file = prog_file[: -len(".pdmodel")]
        self._prefix = prog_file
        self._use_gpu = True
        self._precision = "float32"
        self._memory_optim = True
        self._ir_optim = True

    def model_path(self) -> str:
        return self._prefix

    # --- device toggles ---
    def enable_use_gpu(self, *a, **k):
        self._use_gpu = True

    def disable_gpu(self):
        self._use_gpu = False

    def use_gpu(self) -> bool:
        return self._use_gpu

    def enable_tpu(self):
        """The JAX package's name for ``enable_use_gpu``."""
        self.enable_use_gpu()

    def disable_tpu(self):
        """The JAX package's name for ``disable_gpu``."""
        self.disable_gpu()

    def use_tpu(self) -> bool:
        return self.use_gpu()

    # --- precision / optimization toggles ---
    def enable_bf16(self):
        self._precision = "bfloat16"

    def switch_ir_optim(self, flag: bool = True):
        self._ir_optim = flag

    def enable_memory_optim(self, flag: bool = True):
        self._memory_optim = flag

    def set_cpu_math_library_num_threads(self, n: int):
        pass    # torch's own thread pool

    def summary(self) -> str:
        return (f"Config(model={self._prefix!r}, gpu={self._use_gpu}, "
                f"precision={self._precision})")


def to_host(t) -> np.ndarray:
    """``t`` as a numpy array on the host: bf16 widened to f32 on its
    device first (numpy has no bf16), a card's tensor copied into
    page-locked memory (from the caching host allocator), which the copy
    engine writes directly, where a copy to pageable memory goes through
    a staging buffer."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy()


class PredictorTensor:
    """An input or output handle (Paddle's zero-copy tensor):
    ``copy_from_cpu`` stages a host array on the predictor's device;
    after ``run()``, ``copy_to_cpu`` reads the output back."""

    def __init__(self, name: str, device):
        self.name = name
        self._device = torch.device(device)
        self._tensor = None
        self._shape = None

    def reshape(self, shape):
        self._shape = tuple(int(s) for s in shape)
        if self._tensor is not None:
            self._tensor = self._tensor.reshape(self._shape)

    def copy_from_cpu(self, arr: np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self._shape is not None:
            t = t.reshape(self._shape)  # reshape-then-copy order
        self._tensor = t.to(self._device)

    def copy_to_cpu(self) -> np.ndarray:
        if self._tensor is None:
            raise RuntimeError(f"output {self.name!r} not computed yet")
        return to_host(self._tensor)

    def shape(self):
        return None if self._tensor is None else tuple(self._tensor.shape)


class Predictor:
    """A predictor over a ``jit.save`` artifact (Paddle's
    ``AnalysisPredictor``): inputs ``input_0..``, outputs
    ``output_0..``, one ``run()`` a batch."""

    def __init__(self, config: Config):
        from .. import jit

        self._config = config
        if config.use_gpu() and not torch.cuda.is_available():
            raise RuntimeError(
                "create_predictor: the predictor runs on the CUDA card and "
                "none is visible; call Config.disable_gpu() to run it on "
                "the CPU")
        self._device = torch.device("cuda" if config.use_gpu() else "cpu")
        self._layer = jit.load(config.model_path(), device=self._device)
        self._input_names = [f"input_{i}" for i in
                             range(self._layer.input_count or 1)]
        self._inputs: Dict[str, PredictorTensor] = {
            n: PredictorTensor(n, self._device) for n in self._input_names}
        self._outputs: Dict[str, PredictorTensor] = {}
        self._output_names: List[str] = []

    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_input_handle(self, name: str) -> PredictorTensor:
        return self._inputs[name]

    def run(self) -> bool:
        args = []
        for n in self._input_names:
            h = self._inputs[n]
            if h._tensor is None:
                raise RuntimeError(f"input {n!r} was not set")
            args.append(h._tensor)
        out = self._layer(*args)
        outs = out if isinstance(out, tuple) else (out,)
        self._output_names = [f"output_{i}" for i in range(len(outs))]
        self._outputs = {}
        for n, o in zip(self._output_names, outs):
            h = PredictorTensor(n, self._device)
            h._tensor = o
            self._outputs[n] = h
        return True

    def get_output_names(self) -> List[str]:
        return list(self._output_names) or ["output_0"]

    def get_output_handle(self, name: str) -> PredictorTensor:
        return self._outputs[name]


def create_predictor(config: Config) -> Predictor:
    """Paddle's ``paddle_infer::CreatePredictor``."""
    return Predictor(config)
