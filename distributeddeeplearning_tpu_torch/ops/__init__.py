"""Tensor ops of the port: plain attention and the hand-written CUDA
kernels with their wrappers (``paged_decode``, ``fused_block``) and
build (``_build``)."""
