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
  (``ops/paged_decode.py`` + ``csrc/paged_decode.cu``), with the
  quantized tiers (``ops/quant.py``: int8 / fp8 KV pools, dequantized in
  the kernel's registers, and int8 / fp8 weights) and speculative
  decoding (``serving/spec.py``: int8 self-draft or n-gram drafts, one
  ``[slots, K+1]`` verify through the kernel);
* data-parallel LM training: ``data`` (synthetic tokens), the LM with
  ``attn_impl="pallas"`` through the flash-attention kernels
  (``ops/flash.py`` + ``csrc/flash.cu``: forward, dq, dk/dv) and the
  same train step;
* data-parallel ViT training: ``models`` (ViT with ``attn_impl="fused"``
  through the packed-QKV attention kernels, ``ops/flash_packed.py`` +
  ``csrc/flash_packed.cu``, and ``FUSED_DENSE_GRAD=1`` through the
  dW+db kernel, ``ops/fused_grads.py`` + ``csrc/fused_grads.cu``) and
  the same train step;
* the training loop and the harness: ``training.loop.fit`` /
  ``evaluate`` over the dp engine (``training/engines.py``) with the
  on-device metric accumulator, in-step and multi-step gradient
  accumulation, checkpoints with JAX's manifest, callbacks, the loop's
  fault plan (``faults``) and host-sync ledger (``utils/hostsync``), and
  ``python -m distributeddeeplearning_tpu_torch.bench``, ``bench.py``'s
  one-line record;
* the real-data plane: ``FAKE=False`` with ``DATA_DIR`` through
  ``data.make_dataset`` into ``data.imagenet`` (ImageFolder, tf.data and
  TF-free TFRecord readers), ``data.stream`` (token and record shards,
  the checkpointable cursor, host read-ahead), ``native`` (crc32c and
  TFRecord framing over ``csrc/ddl_native.cpp``) and ``data.prepare``;
  ``streamgen``, ``stream_bench`` and ``real_data_bench``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (the CPU tier's parity tests do). Importing the package
imports neither ``jax`` nor ``distributeddeeplearning_tpu``, and builds
no kernel: kernels are compiled with ``nvcc`` on first launch.
"""

__all__ = ["bench", "config", "data", "faults", "inference", "models", "native", "obs", "ops",
           "parallel", "serving", "training", "utils"]
