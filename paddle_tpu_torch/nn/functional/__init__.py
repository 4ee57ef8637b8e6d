"""Functional ops of the port, with their CUDA kernels: paged decode
attention (``paged_attention``), the weight-streaming linears
(``stream_linear``), paged prefill attention (``flash_varlen``), the
ragged grouped GEMM of the MoE FFN (``grouped_gemm``), the batched
LoRA delta (``lora``) and dense flash attention (``attention``).
Import those submodules; their names are also the names of their main
functions. The functionals of the JAX package's ``nn.functional``
surface (``activation``, ``common``, ``conv``, ``pooling``, ``norm``,
``loss``) are also here by name."""
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .attention import flash_attention, scaled_dot_product_attention

from . import activation, common, conv, loss, norm, pooling
# the kernels' modules, which register their ``torch.library`` ops
from . import (attention, flash_varlen, grouped_gemm, lora,  # noqa: F401
               paged_attention, stream_linear)

__all__ = (
    list(activation.__all__) + list(common.__all__) + list(conv.__all__)
    + list(pooling.__all__) + list(norm.__all__) + list(loss.__all__)
    + ["flash_attention", "scaled_dot_product_attention"]
)
