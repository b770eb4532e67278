"""Tensor ops of the port: attention and the hand-written CUDA kernels
with their wrappers (``paged_decode``, ``fused_block``, ``flash``) and
build (``_build``)."""
