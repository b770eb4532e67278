"""Tensor ops of the port: plain attention and the hand-written CUDA
kernels with their wrappers (``paged_decode``) and build (``_build``)."""
