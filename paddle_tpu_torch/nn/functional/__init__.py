"""Functional ops of the port, with their CUDA kernels: paged decode
attention (``paged_attention``), the weight-streaming linears
(``stream_linear``), paged prefill attention (``flash_varlen``), the
ragged grouped GEMM of the MoE FFN (``grouped_gemm``), the batched
LoRA delta (``lora``) and dense flash attention (``attention``).
Import those submodules; their names are also the names of their main
functions. The training path's functionals are also here by name."""
from .activation import gelu
from .attention import flash_attention, scaled_dot_product_attention
from .common import dropout, embedding, linear
from .loss import cross_entropy
from .norm import layer_norm

__all__ = ["gelu", "flash_attention", "scaled_dot_product_attention",
           "dropout", "embedding", "linear", "cross_entropy", "layer_norm"]
