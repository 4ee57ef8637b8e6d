"""Functional ops of the port, with their CUDA kernels: paged decode
attention (``paged_attention``) and the weight-streaming linears
(``stream_linear``). Import the submodules; their names are also the
names of their main functions."""
