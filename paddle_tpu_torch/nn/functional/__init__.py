"""Functional ops of the port, with their CUDA kernels: paged decode
attention (``paged_attention``), the weight-streaming linears
(``stream_linear``) and paged prefill attention (``flash_varlen``).
Import the submodules; their names are also the names of their main
functions."""
