"""PyTorch/CUDA port of ``distributeddeeplearning_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package re-implements it
slice by slice in PyTorch, with every Pallas TPU kernel on a ported path
replaced by a kernel written by hand for ``sm_90a`` (``csrc/``).

Ported so far:

* data-parallel ResNet training: ``config`` (``TrainConfig``),
  ``native`` (the splitmix64 fill), ``data`` (synthetic images,
  staging), ``models`` (ResNet v1 with flax-semantics BatchNorm,
  ``fused=True`` through ``ops/fused_block.py`` + ``csrc/fused_block.cu``)
  and ``training`` (state, schedules, SGD, the dp train step over
  ``torch.distributed``);
* LM serving: ``models`` (decoder-only LM in decode mode),
  ``inference``, ``serving`` (slot engine, paged KV pool, prefix cache,
  scheduler) and the paged-decode attention kernel
  (``ops/paged_decode.py`` + ``csrc/paged_decode.cu``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (the CPU tier's parity tests do). Importing the package
imports neither ``jax`` nor ``distributeddeeplearning_tpu``, and builds
no kernel: kernels are compiled with ``nvcc`` on first launch.
"""

__all__ = ["config", "data", "inference", "models", "native", "obs", "ops", "serving",
           "training", "utils"]
