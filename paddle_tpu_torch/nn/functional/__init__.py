"""Functional ops of the port, with their CUDA kernels: paged decode
attention (``paged_attention``), the weight-streaming linears
(``stream_linear``), paged prefill attention (``flash_varlen``), the
ragged grouped GEMM of the MoE FFN (``grouped_gemm``) and the batched
LoRA delta (``lora``).
Import the submodules; their names are also the names of their main
functions."""
