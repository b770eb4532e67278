"""Train a decoder-only Transformer LM on synthetic tokens — explicit
loop: the port's twin of ``examples/lm_synthetic_tpu.py``. The
long-context counterpart of the ImageNet examples: the same engine,
per-token cross-entropy, causal attention through the configurable impl
(``ATTN_IMPL=pallas`` runs the flash kernels on the card).

Run on the card::

    FAKE_DATA_LENGTH=2048 EPOCHS=1 BATCHSIZE=4 MODEL=lm_tiny \\
        SEQ_LEN=128 VOCAB=1024 \\
        python -m distributeddeeplearning_tpu_torch.examples.lm_synthetic

``DDL_PLATFORM=cpu`` runs it on the CPU. Under a mesh engine
(``ENGINE=pjit|sp|pp`` with ``MESH_AXES``/``MESH_SHAPE``) each rank
reads its data shard's rows (``parallel.mesh.batch_sharding``).
"""

import os

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data.synthetic import SyntheticTokenDataset
from distributeddeeplearning_tpu_torch.frontends import explicit
from distributeddeeplearning_tpu_torch.models import get_model
from distributeddeeplearning_tpu_torch.parallel import collectives, distributed
from distributeddeeplearning_tpu_torch.parallel.mesh import batch_sharding
from distributeddeeplearning_tpu_torch.training.engines import resolve_mesh
from distributeddeeplearning_tpu_torch.utils.logging import get_logger, log_summary
from distributeddeeplearning_tpu_torch.utils.timer import Timer


def main():
    distributed.maybe_initialize()
    device = distributed.default_device()

    seq_len = int(os.environ.get("SEQ_LEN", "128"))
    vocab = int(os.environ.get("VOCAB", "32000"))
    # lm_tiny is only the default — MODEL=lm_base etc. must win (from_env
    # overrides beat the env, so don't pass model as an override).
    defaults = {} if "MODEL" in os.environ else {"model": "lm_tiny"}
    config = TrainConfig.from_env(num_classes=vocab, **defaults)
    logger = get_logger()
    logger.info("LM training: %s (seq_len=%d)", config.model, seq_len)

    model = get_model(config.model, **{**config.model_kwargs(), "num_classes": vocab},
                      max_seq_len=seq_len, device=device)
    mesh = resolve_mesh(config)
    shard, shards = ((collectives.rank(), collectives.size()) if mesh is None
                     else batch_sharding(mesh))
    data = SyntheticTokenDataset(
        length=config.fake_data_length,
        global_batch_size=config.global_batch_size,
        seq_len=seq_len,
        vocab_size=vocab,
        seed=config.seed,
        process_index=shard,
        process_count=shards,
    )
    pieces, state = explicit.setup(model, config, device=device, mesh=mesh,
                                   steps_per_epoch=data.steps_per_epoch)

    timer = Timer().start()
    for epoch in range(config.epochs):
        state = explicit.train_epoch(pieces, state, data, epoch)
    timer.stop()

    tokens = config.epochs * data.steps_per_epoch * config.global_batch_size
    log_summary(
        data_length=tokens,
        duration_s=timer.elapsed,
        batch_size_per_device=config.batch_size_per_device,
        num_devices=shards,
        dataset_kind="synthetic-tokens",
    )


if __name__ == "__main__":
    main()
