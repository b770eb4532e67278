"""Train ResNet50 — explicit-loop front-end (you own the loop): the
port's twin of ``examples/imagenet_explicit_tpu.py``, the counterpart of
the reference's ``HorovodPytorch/src/imagenet_pytorch_horovod.py``
(main() :267-359, train() :204-221, validate() :224-239), with
checkpointing added.

Run on the card::

    FAKE=True FAKE_DATA_LENGTH=2048 EPOCHS=1 BATCHSIZE=32 \\
        python -m distributeddeeplearning_tpu_torch.examples.imagenet_explicit

``DDL_PLATFORM=cpu`` runs it on the CPU; ``DDL_COORDINATOR``,
``DDL_NUM_PROCESSES`` and ``DDL_PROCESS_ID`` (or ``DISTRIBUTED=True``
with torch's ``env://`` variables) form a multi-process world.
"""

from distributeddeeplearning_tpu_torch.config import TrainConfig
from distributeddeeplearning_tpu_torch.data import make_dataset
from distributeddeeplearning_tpu_torch.frontends import explicit
from distributeddeeplearning_tpu_torch.models import get_model
from distributeddeeplearning_tpu_torch.parallel import collectives, distributed
from distributeddeeplearning_tpu_torch.training.checkpoint import CheckpointManager
from distributeddeeplearning_tpu_torch.utils.logging import get_logger, log_summary
from distributeddeeplearning_tpu_torch.utils.timer import Timer


def main():
    distributed.maybe_initialize()
    config = TrainConfig.from_env(model="resnet50")
    device = distributed.default_device()
    logger = get_logger()
    logger.info("explicit-loop training: %s", config)

    model = get_model(config.model, **config.model_kwargs(), device=device)
    train_data = make_dataset(config, train=True)
    pieces, state = explicit.setup(model, config, device=device,
                                   steps_per_epoch=train_data.steps_per_epoch)
    ckpt = CheckpointManager(config.model_dir, save_every_epochs=config.checkpoint_every_epochs)
    if config.resume and ckpt.enabled:
        state, start_epoch = ckpt.maybe_restore(state)
    else:
        start_epoch = 0

    timer = Timer().start()
    for epoch in range(start_epoch, config.epochs):
        state = explicit.train_epoch(pieces, state, train_data, epoch)
        if config.validation:
            metrics = explicit.validate(pieces, state, make_dataset(config, train=False))
            logger.info("validation: %s", metrics, extra={"epoch": epoch})
        ckpt.save(epoch, state)
    timer.stop()
    ckpt.wait()

    epochs_run = config.epochs - start_epoch
    log_summary(
        data_length=epochs_run * train_data.steps_per_epoch * config.global_batch_size,
        duration_s=timer.elapsed,
        batch_size_per_device=config.batch_size_per_device,
        num_devices=collectives.size(),
        dataset_kind="synthetic" if config.fake else "real",
    )


if __name__ == "__main__":
    main()
