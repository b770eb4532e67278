"""Pretrain on token shards -> checkpoint -> restore -> serve, one JSON
line: the port's twin of ``scripts/stream_bench.py``.

    python -m distributeddeeplearning_tpu_torch.stream_bench

1. build a seeded synthetic token shard set (``data/stream``) in a temp
   dir, the writer path ``streamgen`` exposes;
2. pretrain ``BENCH_MODEL`` on it through ``training.loop.fit`` with the
   ``DATA_FORMAT=stream`` reader (``TokenStreamDataset``, host prefetch,
   the checkpointable shuffle cursor) and step-granular checkpoints, so
   every manifest carries the ``data_cursor``;
3. restore the final checkpoint from disk into a fresh, zeroed state and
   **gate** that the restored parameters equal the trained ones bit for
   bit and that the manifest carries the stream cursor;
4. load the restored parameters into a ``SlotEngine`` behind
   ``serving.Server`` (``SERVE_KV_LAYOUT``, ``SERVE_DECODE_KERNEL``: the
   ``SERVE_*`` env of ``ServeConfig``) and serve greedy continuations of
   ``SERVE_SLOTS`` prompts; **gate**: every stream equals
   ``inference.generate`` on the same restored parameters.

Record: ``lm_stream_pretrain_tokens_per_sec`` (training throughput on
the streamed reader), with the gates and the data-plane detail, as the
JAX script's. Non-zero exit on any gate failure.

Knobs (env), the JAX script's with its defaults: ``BENCH_MODEL``
(lm_tiny), ``STREAM_RECORDS`` (512), ``STREAM_SEQ_LEN`` (64),
``STREAM_VOCAB`` (256), ``STREAM_SHARD_RECORDS`` (128),
``STREAM_SHUFFLE_BLOCK`` (64), ``STREAM_BATCH`` (8, per device),
``STREAM_EPOCHS`` (2), ``PREFETCH_HOST_BATCHES`` (2), ``SERVE_MAX_NEW``
(16), ``SERVE_SLOTS`` (4), ``SERVE_PROMPT_LEN`` (8); and the port's
bench knob ``BENCH_DEVICE`` (``cuda``; ``cpu`` asks for the CPU, as the
tests do). The device picks the training run's attention and dtype: the
flash kernels (``pallas``) in ``bfloat16``, which they take, on the card;
``xla`` in ``float32``, the JAX script's, on the CPU. Serving runs in
float32, as the JAX script's does, from the f32 parameters the
checkpoint holds.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, Tuple


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def run() -> Tuple[Dict[str, Any], bool, Dict[str, Any]]:
    """The protocol: ``(record, ok, info)``. ``info`` holds what a caller
    on the card reads besides the record: ``serve_launches_by_store``
    (the decode kernel's launches while serving, the captured members'
    replays included) and ``fit_perf``."""
    import numpy as np
    import torch

    from distributeddeeplearning_tpu_torch import bench
    from distributeddeeplearning_tpu_torch.config import TrainConfig
    from distributeddeeplearning_tpu_torch.data.stream import (
        TokenStreamDataset,
        synthetic_rows,
        write_token_shards,
    )
    from distributeddeeplearning_tpu_torch.inference import generate
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.ops import paged_decode
    from distributeddeeplearning_tpu_torch.parallel import collectives
    from distributeddeeplearning_tpu_torch.serving import Request, ServeConfig, Server
    from distributeddeeplearning_tpu_torch.training import (
        create_optimizer,
        create_train_state,
        loop,
    )
    from distributeddeeplearning_tpu_torch.training.checkpoint import CheckpointManager

    device = bench._device()
    on_card = device.type == "cuda"
    model_name = os.environ.get("BENCH_MODEL", "lm_tiny")
    records = _env_int("STREAM_RECORDS", 512)
    seq_len = _env_int("STREAM_SEQ_LEN", 64)
    vocab = _env_int("STREAM_VOCAB", 256)
    shard_records = _env_int("STREAM_SHARD_RECORDS", 128)
    shuffle_block = _env_int("STREAM_SHUFFLE_BLOCK", 64)
    batch = _env_int("STREAM_BATCH", 8)
    epochs = _env_int("STREAM_EPOCHS", 2)
    host_prefetch = _env_int("PREFETCH_HOST_BATCHES", 2)
    max_new = _env_int("SERVE_MAX_NEW", 16)
    slots = _env_int("SERVE_SLOTS", 4)
    prompt_len = _env_int("SERVE_PROMPT_LEN", 8)
    attn_impl = "pallas" if on_card else "xla"
    compute_dtype = "bfloat16" if on_card else "float32"
    max_seq = max(seq_len, prompt_len + max_new)

    with tempfile.TemporaryDirectory(prefix="lm_stream_") as tmp:
        shard_dir = os.path.join(tmp, "shards")
        write_token_shards(
            shard_dir, synthetic_rows(records, seq_len=seq_len, vocab_size=vocab, seed=42),
            seq_len=seq_len, vocab_size=vocab, shard_records=shard_records)
        ckpt_dir = os.path.join(tmp, "ckpt")
        cfg = TrainConfig(
            model=model_name, num_classes=vocab, batch_size_per_device=batch, epochs=epochs,
            compute_dtype=compute_dtype, attn_impl=attn_impl, weight_decay=0.0,
            log_every_steps=0, data_format="stream", data_dir=shard_dir, fake=False,
            stream_shuffle_block=shuffle_block, prefetch_host_batches=host_prefetch,
            model_dir=ckpt_dir, checkpoint_every_steps=2, checkpoint_async=False)
        data = TokenStreamDataset(
            shard_dir, global_batch_size=cfg.global_batch_size, seed=cfg.seed,
            process_index=collectives.rank(), process_count=collectives.size(),
            shuffle_block=shuffle_block)
        model = get_model(model_name, **cfg.model_kwargs(), max_seq_len=max_seq, device=device)
        result = loop.fit(model, cfg, data, device=device, add_default_logger=False)
        train_tps = result.images_per_sec * seq_len  # rows/s x tokens/row
        perf = dict(result.perf)

        # Portability leg: restore the artifact FROM DISK into a fresh,
        # zeroed state and gate the round trip and the manifest's cursor.
        fresh = get_model(model_name, **cfg.model_kwargs(), max_seq_len=max_seq,
                          device=device)
        tx, _ = create_optimizer(cfg, data.steps_per_epoch)
        restored = create_train_state(fresh, cfg, tx, device=device)
        with torch.no_grad():
            for p in fresh.parameters():
                p.zero_()
        mgr = CheckpointManager(ckpt_dir, save_every_steps=2)
        restored = mgr.restore(restored)
        manifest = mgr.last_manifest or {}
        cursor = manifest.get("data_cursor")
        mgr.close()
        trained_sd = result.state.model.state_dict()
        params = {k: v.detach().clone() for k, v in restored.model.state_dict().items()}
        roundtrip_ok = trained_sd.keys() == params.keys() and all(
            torch.equal(trained_sd[k], params[k]) for k in trained_sd)
        del result, restored, fresh, model

        # Serve the trained artifact (f32): greedy streams through the
        # slot engine against the sequential reference on the same
        # restored parameters.
        prompts = data.index.read("tokens", np.arange(slots))[:, :prompt_len].astype(np.int32)
        serve_model = get_model(model_name, num_classes=vocab, dtype="float32",
                                max_seq_len=max_seq, device=device)
        server = Server.build(serve_model, params, ServeConfig.from_env(), device=device,
                              max_len=prompt_len + max_new)
        engine = server.engine
        engine.warmup()
        launches0 = dict(paged_decode.launches_by_store)
        replayed0 = engine.replayed_launches_by_store()
        t0 = time.perf_counter()
        handles = [server.submit(Request(prompt=p, max_new_tokens=max_new)) for p in prompts]
        server.drain()
        serve_s = time.perf_counter() - t0
        launches = {k: n - launches0.get(k, 0) for k, n in paged_decode.launches_by_store.items()}
        for k, n in engine.replayed_launches_by_store().items():
            launches[k] = launches.get(k, 0) + n - replayed0.get(k, 0)
        served = np.asarray([h.new_tokens for h in handles])
        reference = generate(engine.model, prompts, max_new_tokens=max_new)
        reference = reference[:, prompt_len:].cpu().numpy()
        serve_match = bool(served.shape == reference.shape
                           and np.array_equal(served, reference))

    ok = roundtrip_ok and serve_match and cursor is not None and train_tps > 0
    record = {
        "metric": "lm_stream_pretrain_tokens_per_sec",
        "value": round(train_tps, 1) if ok else 0.0,
        "unit": "tokens/sec",
        "vs_baseline": 0.0,  # new scenario: no reference point
        "host_sync_count": perf.get("host_sync_count"),
        "detail": {
            "platform": device.type,
            "devices": collectives.size(),
            "model": model_name,
            "attn_impl": attn_impl,
            "compute_dtype": compute_dtype,
            "data_format": "stream",
            "records": records,
            "seq_len": seq_len,
            "vocab": vocab,
            "shuffle_block": shuffle_block,
            "epochs": epochs,
            "per_device_batch": batch,
            "prefetch_host_batches": host_prefetch,
            "serve_match": serve_match,
            "restore_roundtrip": roundtrip_ok,
            "manifest_data_cursor": cursor,
            "serve_max_new": max_new,
            "serve_slots": slots,
            "serve_kv_layout": engine.kv_layout,
            "serve_decode_kernel": engine.decode_kernel,
            "serve_s": serve_s,
        },
    }
    info = {"serve_launches_by_store": {k: n for k, n in launches.items() if n},
            "fit_perf": perf}
    return record, ok, info


def main(argv=None) -> int:
    record, ok, _ = run()
    print(json.dumps(record), flush=True)
    if not ok:
        d = record["detail"]
        print(f"FAIL: roundtrip={d['restore_roundtrip']} serve_match={d['serve_match']} "
              f"cursor={'present' if d['manifest_data_cursor'] else 'MISSING'}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
